"""A configuration enters the benchmark as new files only. In a copy of
the benchmark's folder, minicpm3-4b's configuration under a new name,
naming its own reference (a copy of ``reference/dense.py`` under a new
name), with its committed limit, its tiny overlay and its tiny limit,
runs as a cell on the CPU and comes out correct; no file the copy had
before changes."""
import hashlib
import json
import shutil
import time

from perfbench import registry
from perfbench.cell import run_cell
from perfbench.tests.conftest import bench, make_tiny

NEW = "minicpm3-4b-mla"
CELL = f"{NEW}.chat"


def digests(folder):
    return {p.relative_to(folder).as_posix():
            hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def with_cell(b):
    """The benchmark with the new configuration and its cell, entered
    beside minicpm3-4b's and reporting what its cell reports."""
    b["configs"].append(dict(
        next(x for x in b["configs"] if x["name"] == "minicpm3-4b"),
        name=NEW, file=f"perfbench/configs/{NEW}.json"))
    b["workloads"].append(dict(
        next(w for w in b["workloads"] if w["name"] == "minicpm3-4b.chat"),
        name=CELL, config=NEW))
    for m in b["end_to_end"] + b["per_layer"]:
        if "minicpm3-4b.chat" in m.get("workloads", []):
            m["workloads"].append(CELL)
    return b


def test_a_configuration_enters_as_files_only(tmp_path):
    src = tmp_path / "perfbench"
    shutil.copytree(registry.ROOT, src,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = digests(src)
    c = registry.config("minicpm3-4b", src)
    c.update(name=NEW, reference="mla_dense")
    tiny = src / "tests" / "tiny"
    added = {
        f"configs/{NEW}.json": json.dumps(c),
        "reference/mla_dense.py": (src / "reference" / "dense.py")
        .read_text(),
        f"limits/{CELL}.json": (src / "limits" / "minicpm3-4b.chat.json")
        .read_text(),
        f"tests/tiny/configs/{NEW}.json": (tiny / "configs" /
                                           "minicpm3-4b.json").read_text(),
        f"tests/tiny/limits/{CELL}.json": (tiny / "limits" /
                                           "minicpm3-4b.chat.json")
        .read_text(),
    }
    for rel, text in added.items():
        assert rel not in before
        (src / rel).write_text(text)

    root = make_tiny(src, tmp_path / "tiny", tiny=tiny)
    assert registry.reference_of(registry.config(NEW, root), root) \
        .__file__ == str(root / "reference" / "mla_dense.py")
    assert registry.config(NEW, root)["hidden_size"] == 64
    r = run_cell(with_cell(bench()), CELL, 2 ** 31 + 23, 1.0, False,
                 t_launch=time.perf_counter(), device="cpu", root=root)
    assert r["correct"] is True and r["failed"] == 0
    assert r["window"]["judged_tokens"] >= 40
    assert set(r["metrics"]) == {"output_tokens_per_s", "ttft_p95_ms",
                                 "setup_s"}
    assert set(r["checks"]) == set(registry.limits(CELL, src))

    after = digests(src)
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) == set(added)
