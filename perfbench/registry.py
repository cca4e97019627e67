"""Where the harness finds what a cell names, by name alone.

* a configuration: ``configs/<name>.json``
* a traffic mix: ``mixes/<name>.json``
* the limits of a cell's comparison: ``limits/<cell>.json``
* a configuration's plain reference: ``reference/<name>.py``, ``name``
  the file's ``reference`` key, else its ``family``
* a metric's reader: ``metrics/<name>.py``, or, where that file is
  missing, ``metrics/<the name up to its first dot>.py``, so that a
  quantity split by the end-to-end metric it moves (``mfu.chat``,
  ``mfu.long-prompt``) shares one reader.

A later change adds a configuration, a mix, a reference or a metric by
adding its file; nothing here lists them.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _path(root: Path, folder: str, name: str, suffix: str) -> Path:
    if not NAME.match(name):
        raise ValueError(f"not a name: {name!r}")
    return Path(root) / folder / f"{name}{suffix}"


def _json(root, folder, name) -> dict:
    path = _path(root, folder, name, ".json")
    if not path.exists():
        raise FileNotFoundError(f"no {folder[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def config(name: str, root=ROOT) -> dict:
    return _json(root, "configs", name)


def mix(name: str, root=ROOT) -> dict:
    return _json(root, "mixes", name)


def limits(cell: str, root=ROOT) -> dict:
    return _json(root, "limits", cell)


def _module(path: Path, tag: str):
    spec = importlib.util.spec_from_file_location(
        f"perfbench._found.{tag}.{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference(name: str, root=ROOT):
    """The plain reference module ``reference/<name>.py``."""
    path = _path(root, "reference", name, ".py")
    if not path.exists():
        raise FileNotFoundError(f"no reference named {name!r} ({path})")
    return _module(path, "reference")


def reference_of(c: dict, root=ROOT):
    """The plain reference that judges configuration file ``c``: the one
    its ``reference`` key names, else its ``family``'s. The harness finds
    a configuration's reference only through this."""
    return reference(c.get("reference", c["family"]), root)


def metric(name: str, root=ROOT):
    """The module whose ``read(run)`` gives metric ``name``."""
    path = _path(root, "metrics", name, ".py")
    if not path.exists():
        path = _path(root, "metrics", name.split(".")[0], ".py")
    if not path.exists():
        raise FileNotFoundError(f"no reader for metric {name!r}")
    return _module(path, "metrics")


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metrics a run of ``cell`` reports: its end-to-end metrics with
    ``trace`` 0, its per-layer metrics with ``trace`` 1. A metric without
    ``workloads`` belongs to every cell (a per-layer one: every cell that
    reports the end-to-end metric it moves)."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads",
                             [cell] if m["moves"] in moved else [])]
