"""The harness finds a configuration, a mix, a limit, a reference and a
metric's reader by name, and a new file is found without an edit."""
import json
import shutil

import pytest

from perfbench import registry
from perfbench.tests.conftest import TINY_DIR, bench

# What each cell reports (its end-to-end metrics, its per-layer metrics)
# and the reference that judges it, as the benchmark has them
CELLS = {
    "olmoe-1b-7b.long-prompt": (
        ["prompt_tokens_per_s", "ttft_p95_ms", "setup_s"],
        ["prefill_ms_per_ktok.long-prompt", "mfu.long-prompt",
         "flash_attention_roofline", "device_idle.long-prompt"], "moe.py"),
    "mamba2-1.3b.long-prompt": (
        ["prompt_tokens_per_s", "ttft_p95_ms", "setup_s"],
        ["prefill_ms_per_ktok.long-prompt", "mfu.long-prompt",
         "ssd_scan_roofline", "device_idle.long-prompt"], "ssm.py"),
    "olmoe-1b-7b.chat": (
        ["output_tokens_per_s", "ttft_p95_ms", "itl_p95_ms", "setup_s"],
        ["decode_step_ms.chat", "mfu.chat", "device_idle.chat"], "moe.py"),
    "mamba2-1.3b.chat": (
        ["output_tokens_per_s", "ttft_p95_ms", "itl_p95_ms", "setup_s"],
        ["decode_step_ms.chat", "mfu.chat", "device_idle.chat"], "ssm.py"),
    "minicpm3-4b.chat": (
        ["output_tokens_per_s", "ttft_p95_ms", "setup_s"],
        ["decode_step_ms.chat", "device_idle.chat", "mla_mfu.chat"],
        "dense.py"),
}


def test_every_name_in_the_benchmark_resolves():
    b = bench()
    for cfg in b["configs"]:
        c = registry.config(cfg["name"])
        assert c["name"] == cfg["name"]
        assert cfg["file"] == f"perfbench/configs/{cfg['name']}.json"
        registry.reference_of(c)
    for w in b["workloads"]:
        registry.mix(w["traffic"])
        limits = registry.limits(w["name"])
        assert limits and set(limits) <= {"max_logit_gap", "mean_logit_gap",
                                          "mean_kv_error"}
        assert all(v > 0 for v in limits.values())
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(registry.metric(m["name"]).read)


def test_each_cell_reports_setup_a_rate_and_a_layer_metric():
    b = bench()
    for w in b["workloads"]:
        e2e = {m["name"] for m in registry.cell_metrics(b, w["name"], False)}
        layer = registry.cell_metrics(b, w["name"], True)
        assert "setup_s" in e2e and len(e2e) >= 2
        assert layer and all(m["moves"] in e2e for m in layer)
    lp = {m["name"] for m in registry.cell_metrics(
        b, "olmoe-1b-7b.long-prompt", True)}
    assert "flash_attention_roofline" in lp and "ssd_scan_roofline" not in lp


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_each_cell_keeps_its_metrics_and_reference(cell):
    e2e, layer, ref = CELLS[cell]
    b = bench()
    assert [m["name"] for m in registry.cell_metrics(b, cell, False)] == e2e
    assert [m["name"] for m in registry.cell_metrics(b, cell, True)] == layer
    w = next(w for w in b["workloads"] if w["name"] == cell)
    c = registry.config(w["config"])
    assert registry.reference_of(c).__file__ == \
        str(registry.ROOT / "reference" / ref)


def test_a_configuration_names_its_reference(tmp_path):
    """``reference`` in a configuration file names the module; without
    the key the family does; a name with no file raises."""
    (tmp_path / "reference").mkdir()
    (tmp_path / "reference" / "mla_dense.py").write_text("KIND = 'mla'\n")
    (tmp_path / "reference" / "dense.py").write_text("KIND = 'dense'\n")
    c = dict(registry.config("minicpm3-4b"))
    assert registry.reference_of(c, tmp_path).KIND == "dense"
    assert registry.reference_of(dict(c, reference="mla_dense"),
                                 tmp_path).KIND == "mla"
    with pytest.raises(FileNotFoundError):
        registry.reference_of(dict(c, reference="absent"), tmp_path)
    with pytest.raises(ValueError):
        registry.reference_of(dict(c, reference="../dense"), tmp_path)


def test_every_cell_has_a_tiny_size():
    """Each configuration, mix and cell of the benchmark has its overlay
    under ``tests/tiny``, so that no CPU test runs a published width; an
    overlay names only what the benchmark has, and its limits only the
    numbers the committed limits name."""
    b = bench()
    want = {"configs": {w["config"] for w in b["workloads"]},
            "mixes": {w["traffic"] for w in b["workloads"]},
            "limits": {w["name"] for w in b["workloads"]}}
    for kind, names in want.items():
        have = {p.stem for p in (TINY_DIR / kind).glob("*.json")}
        assert have == names, kind
    for cell in want["limits"]:
        tiny = json.loads((TINY_DIR / "limits" / f"{cell}.json").read_text())
        assert set(tiny) == set(registry.limits(cell))
    for name in want["configs"]:
        c = registry.config(name)
        tiny = json.loads((TINY_DIR / "configs" / f"{name}.json")
                          .read_text())
        assert set(tiny) <= set(c) and tiny["hidden_size"] <= 128


def test_a_new_file_is_found_without_an_edit(tmp_path):
    shutil.copytree(registry.ROOT, tmp_path, dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    c = registry.config("olmoe-1b-7b")
    c["name"] = "olmoe-1b-7b-wide"
    (tmp_path / "configs" / "olmoe-1b-7b-wide.json").write_text(json.dumps(c))
    m = registry.mix("chat")
    m["name"] = "burst-chat"
    (tmp_path / "mixes" / "burst-chat.json").write_text(json.dumps(m))
    (tmp_path / "metrics" / "queue_wait_ms.py").write_text(
        "def read(run):\n    return 4.25\n")
    (tmp_path / "limits" / "olmoe-1b-7b-wide.burst-chat.json").write_text(
        '{"max_logit_gap": 0.5}')
    assert registry.config("olmoe-1b-7b-wide", tmp_path)["name"] == \
        "olmoe-1b-7b-wide"
    assert registry.mix("burst-chat", tmp_path)["clients"] == 64
    assert registry.limits("olmoe-1b-7b-wide.burst-chat",
                           tmp_path)["max_logit_gap"] == 0.5
    assert registry.metric("queue_wait_ms", tmp_path).read(None) == 4.25
    # a split name falls back to the reader of its first part
    assert registry.metric("queue_wait_ms.chat", tmp_path).read(None) == 4.25
    with pytest.raises(FileNotFoundError):
        registry.metric("queue_wait_ms", registry.ROOT)
    with pytest.raises(FileNotFoundError):
        registry.mix("burst-chat")


@pytest.mark.parametrize("bad", ["../x", "a/b", "", " x", "a b", "é"])
def test_names_never_leave_the_folder(bad):
    with pytest.raises(ValueError):
        registry.config(bad)
