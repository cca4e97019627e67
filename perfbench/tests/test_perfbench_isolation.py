"""Nothing the harness or the reference imports has the top-level name
``jax``, ``jaxlib``, ``flax`` or ``repro`` (whole names: ``repro_torch``
begins with ``repro``), and the reference imports nothing of the program.
The card-only paths decide inside the run, never at import."""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import registry

HERE = Path(registry.ROOT)
REPO = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources(folder: Path):
    return sorted(p for p in folder.rglob("*.py") if "tests" not in p.parts)


def test_no_source_imports_jax_or_the_jax_package():
    for p in sources(HERE):
        assert not top_level_imports(p) & FORBIDDEN, p


def test_reference_imports_plain_pytorch_only():
    for p in sources(HERE / "reference"):
        assert top_level_imports(p) <= {"__future__", "math", "torch",
                                        "perfbench"}, p
        text = p.read_text()
        assert "repro_torch" not in text.replace("``repro_torch``", ""), p


def run_py(code, **kw):
    env = dict(os.environ, PYTHONPATH=f"{REPO / 'src'}:{REPO}")
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=600, **kw)


def test_reference_loads_nothing_of_the_program():
    out = run_py(
        "import sys, torch\n"
        "from perfbench import registry\n"
        "for n in ('olmoe-1b-7b', 'mamba2-1.3b', 'minicpm3-4b'):\n"
        "    registry.reference_of(registry.config(n))\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))")
    assert out.returncode == 0, out.stderr
    loaded = set(json.loads(out.stdout.strip().replace("'", '"')))
    assert not loaded & (FORBIDDEN | {"repro_torch"})


def test_a_whole_run_loads_no_jax(tiny_root):
    out = run_py(
        "import sys, time, json, torch\n"
        "torch.set_num_threads(2)\n"
        "from perfbench.cell import run_cell\n"
        "from perfbench.run import forbidden_modules\n"
        f"bench = json.load(open({str(REPO / 'BENCHMARK.json')!r}))\n"
        "r = run_cell(bench, 'olmoe-1b-7b.chat', 3, 0.5, True,\n"
        "             t_launch=time.perf_counter(), device='cpu',\n"
        f"             root={str(tiny_root)!r})\n"
        "print(json.dumps([r['correct'], forbidden_modules(),\n"
        "    'repro_torch' in sys.modules]))")
    assert out.returncode == 0, out.stderr[-2000:]
    correct, found, program = json.loads(out.stdout.strip().splitlines()[-1])
    assert correct and found == [] and program


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from perfbench.run import forbidden_modules
    monkeypatch.setitem(sys.modules, "repro_torch_x", sys)
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert forbidden_modules() == ["repro"]


def test_run_refuses_without_a_card(tmp_path):
    """Here there is no card: the run exits non-zero and prints no
    result. The same in a directory that holds only the benchmark."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for cwd in (REPO, tmp_path):
        out = subprocess.run(
            [sys.executable, "perfbench/run.py", "--workload",
             "olmoe-1b-7b.long-prompt", "--seed", str(2 ** 31 + 9),
             "--seconds", "1", "--trace", "0"], cwd=cwd,
            capture_output=True, text=True, timeout=300)
        assert out.returncode != 0 and out.stdout.strip() == ""
