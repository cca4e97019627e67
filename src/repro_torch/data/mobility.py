# Copied from src/repro/data/mobility.py; only the import paths differ.
"""Synthetic mobility traces for the ``trace_file:`` collection policy.

The paper's ``trace`` policy replays one fixed per-mule allocation every
window; real SmartMule fleets move. This module generates a deterministic
random-waypoint trace — static sensors scattered over a unit square, a
mule fleet walking waypoint to waypoint — and records, per window, how
many sensors each mule serves (every sensor uploads to its nearest mule,
so window loads shift as the fleet moves). The trace is a plain JSON
artifact:

    {"schema": 1, "windows": W, "mules": M, "seed": S,
     "speed": ..., "sensors": N, "loads": [[w0m0, w0m1, ...], ...]}

``loads`` is a ``(W, M)`` non-negative integer matrix with positive row
sums (every window someone collects). The generated filename embeds a
content digest, so a trace file referenced from a ``ScenarioConfig``
(and therefore from the sweep service's exact-result-cache key, which
hashes the config including the path) can never silently change content
under a stable name.

Consumption happens in :mod:`repro.core.scenario` via the
``trace_file:path=...`` collection policy: window ``t`` apportions the
mule share of the window's observations over ``loads[t % W]`` by largest
remainder — a *windowed cursor* over the trace, wrapping when the
scenario outlives it.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import Optional

import numpy as np

TRACE_SCHEMA = 1


def _waypoint_positions(rng: np.random.Generator, windows: int, mules: int,
                        speed: float) -> np.ndarray:
    """Random-waypoint mule positions, one (M, 2) snapshot per window:
    each mule walks toward a waypoint at ``speed`` per window (unit-square
    units) and draws a fresh waypoint on arrival."""
    pos = rng.random((mules, 2))
    target = rng.random((mules, 2))
    out = np.empty((windows, mules, 2), np.float64)
    for t in range(windows):
        out[t] = pos
        delta = target - pos
        dist = np.linalg.norm(delta, axis=1)
        arrive = dist <= speed
        step = np.where(dist[:, None] > 0, delta / np.maximum(dist, 1e-12)
                        [:, None] * speed, 0.0)
        pos = np.where(arrive[:, None], target, pos + step)
        if arrive.any():
            target[arrive] = rng.random((int(arrive.sum()), 2))
    return out


def make_trace_loads(windows: int = 24, mules: int = 6, sensors: int = 36,
                     seed: int = 0, speed: float = 0.12) -> np.ndarray:
    """The ``(windows, mules)`` load matrix of a random-waypoint trace:
    per window, each static sensor counts toward its nearest mule."""
    if windows < 1 or mules < 1 or sensors < 1:
        raise ValueError(f"need windows/mules/sensors >= 1, got "
                         f"{windows}/{mules}/{sensors}")
    if speed <= 0:
        raise ValueError(f"mule speed must be positive, got {speed}")
    rng = np.random.default_rng([int(seed), 0x7EACE])
    sensor_xy = rng.random((sensors, 2))
    mule_xy = _waypoint_positions(rng, windows, mules, speed)
    loads = np.zeros((windows, mules), np.int64)
    for t in range(windows):
        d = np.linalg.norm(sensor_xy[:, None, :] - mule_xy[t][None, :, :],
                           axis=2)
        nearest = np.argmin(d, axis=1)          # ties -> lowest mule id
        loads[t] = np.bincount(nearest, minlength=mules)
    return loads


def _payload_digest(payload: dict) -> str:
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:12]


def generate_trace(out_dir: str, *, windows: int = 24, mules: int = 6,
                   sensors: int = 36, seed: int = 0,
                   speed: float = 0.12) -> str:
    """Write a trace file under ``out_dir`` and return its path.

    Deterministic: the same parameters always produce the same payload,
    digest and therefore the same path — regenerating is idempotent (the
    write is atomic, so concurrent generators agree too). The digest in
    the filename is what keeps ``trace_file:path=...`` specs (and the
    result-cache keys hashing them) honest about content.
    """
    loads = make_trace_loads(windows=windows, mules=mules, sensors=sensors,
                             seed=seed, speed=speed)
    payload = {"schema": TRACE_SCHEMA, "windows": int(windows),
               "mules": int(mules), "sensors": int(sensors),
               "seed": int(seed), "speed": float(speed),
               "loads": [[int(v) for v in row] for row in loads]}
    digest = _payload_digest(payload)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(
        out_dir, f"trace_w{windows}_m{mules}_s{seed}_{digest}.json")
    if not os.path.exists(path):
        fd, tmp = tempfile.mkstemp(dir=out_dir, prefix=".trace.",
                                   suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f, indent=1)
        os.replace(tmp, path)
    return path


def load_trace(path: str) -> np.ndarray:
    """Read and validate a trace file; returns the ``(W, M)`` load matrix.
    Raises :class:`ValueError` on schema/shape violations — the collection
    policy resolves traces at config-validation time, so a bad file fails
    before any window runs."""
    with open(path) as f:
        payload = json.load(f)
    if payload.get("schema") != TRACE_SCHEMA:
        raise ValueError(f"unsupported trace schema "
                         f"{payload.get('schema')!r} in {path} (this build "
                         f"reads {TRACE_SCHEMA})")
    loads = np.asarray(payload.get("loads", []), np.float64)
    if loads.ndim != 2 or loads.shape[0] < 1 or loads.shape[1] < 1:
        raise ValueError(f"trace {path} needs a (windows, mules) loads "
                         f"matrix, got shape {loads.shape}")
    if (loads < 0).any():
        raise ValueError(f"trace {path} has negative loads")
    if (loads.sum(axis=1) <= 0).any():
        raise ValueError(f"trace {path} has a window with zero total load "
                         f"(someone must collect every window)")
    return loads
