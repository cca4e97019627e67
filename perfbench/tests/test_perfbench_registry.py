"""The harness finds a configuration, a mix, a limit, a reference and a
metric's reader by name, and a new file is found without an edit."""
import json
import shutil

import pytest

from perfbench import registry
from perfbench.tests.conftest import bench


def test_every_name_in_the_benchmark_resolves():
    b = bench()
    for cfg in b["configs"]:
        c = registry.config(cfg["name"])
        assert c["name"] == cfg["name"]
        assert cfg["file"] == f"perfbench/configs/{cfg['name']}.json"
        registry.reference(c["family"])
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
