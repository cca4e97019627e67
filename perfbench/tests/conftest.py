"""Shared fixtures of the benchmark's CPU tests:

    PYTHONPATH=src python -m pytest -q perfbench/tests

``tiny_root`` is a copy of the benchmark's folder whose configurations and
mixes are cut to a size the CPU runs in seconds, with the limits of that
size: one file each under ``tiny/`` (``configs/<config>.json`` and
``mixes/<mix>.json``, widths laid over the committed file's;
``limits/<cell>.json``, the cell's limits in place of the committed
ones). A configuration enters with its files there; nothing here lists
them. The dtype stays as stated: bfloat16.

Each tiny limit holds the numbers the committed limits name, set as the
committed ones are, between the sound program's largest and the
control's smallest reading over 6 seeds at the tiny size (8 for
minicpm3): olmoe long-prompt ``mean_logit_gap`` 0.00003-0.0022 against
0.0095-0.0199 and ``mean_kv_error`` 0.0035-0.0051 against 0.044-0.048;
olmoe chat 0.00015-0.0033 against 0.0118-0.0288; mamba2
``max_logit_gap`` 0.011-0.034 against 0.30-0.64 (long-prompt) and
0.003-0.031 against 0.29-0.45 (chat); minicpm3 chat ``mean_logit_gap``
0.0000094-0.00055 against 0.0127-0.031 (``max_logit_gap`` 0.0016-0.047
against 0.43-0.84). Each fault of :mod:`perfbench.faults` reads above one
of a cell's limits: olmoe at least 0.034 (chat; long-prompt's cache left
unwritten reads a ``mean_kv_error`` of 1.0), mamba2 at least 4.2,
minicpm3 a ``mean_logit_gap`` of at least 0.33. minicpm3's tiny widths
cut every width, q through a latent as published.
"""
import json
import os
import shutil
import sys
from pathlib import Path

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..", "..")
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import torch  # noqa: E402

torch.set_num_threads(2)

TINY_DIR = Path(__file__).resolve().parent / "tiny"


def overlays(kind: str) -> dict:
    """{name: overlay} of every ``tiny/<kind>/<name>.json``."""
    return {p.stem: json.loads(p.read_text())
            for p in sorted((TINY_DIR / kind).glob("*.json"))}


TINY, TINY_MIX = overlays("configs"), overlays("mixes")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def make_tiny(src, root, tiny=TINY_DIR):
    """Copy the benchmark's folder ``src`` (its tests left out) to
    ``root`` and lay every overlay under ``tiny`` over the copy: a
    configuration's and a mix's widths over the committed file's, a
    cell's limits in place of the committed ones (the same numbers, each
    with its tiny limit)."""
    from perfbench import registry
    shutil.copytree(src, root, dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    for kind, read in (("configs", registry.config), ("mixes", registry.mix)):
        for p in sorted((Path(tiny) / kind).glob("*.json")):
            full = read(p.stem, src)
            full.update(json.loads(p.read_text()))
            (Path(root) / kind / p.name).write_text(json.dumps(full))
    for p in sorted((Path(tiny) / "limits").glob("*.json")):
        limits = json.loads(p.read_text())
        assert set(limits) == set(registry.limits(p.stem, src)), p
        (Path(root) / "limits" / p.name).write_text(json.dumps(limits))
    return Path(root)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    from perfbench import registry
    return make_tiny(registry.ROOT, tmp_path_factory.mktemp("perfbench"))
