# Copied from src/repro/data/synthetic_covtype.py; only the import paths differ.
"""Synthetic CovType-like dataset (the real UCI dataset is a data gate —
this container is offline; see DESIGN.md §2 "Data gate").

Mimics the paper's preprocessed dataset: 54 features = 10 continuous
(cartographic) + 4 one-hot wilderness-area + 40 one-hot soil-type; 7 classes,
class-balanced (paper: 19 229 pts, ~2 700/class, 80/20 train/test split).

Class structure is calibrated so that a *linear* model saturates around
F1 ~ 0.6-0.65, matching the paper's reported centralised ceiling of 0.63:
continuous features are class-conditional Gaussians with heavy overlap, and
categorical features carry class-skewed (but noisy) distributions.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import numpy as np

NUM_FEATURES = 54
NUM_CLASSES = 7
NUM_CONTINUOUS = 10
NUM_WILDERNESS = 4
NUM_SOIL = 40


class Dataset(NamedTuple):
    x_train: np.ndarray
    y_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray


def make_covtype_like(n_total: int = 19229, seed: int = 0,
                      test_frac: float = 0.2,
                      class_sep: float = 1.05) -> Dataset:
    rng = np.random.default_rng(seed)
    per_class = n_total // NUM_CLASSES
    n_total = per_class * NUM_CLASSES

    # class means for continuous features; overlap controlled by class_sep
    means = rng.normal(0.0, class_sep, size=(NUM_CLASSES, NUM_CONTINUOUS))
    # shared anisotropic covariance (elevation-like dominant directions)
    scales = rng.uniform(0.6, 1.8, size=NUM_CONTINUOUS)

    # class-conditional categorical distributions, mixed with uniform noise so
    # a linear model cannot fully separate classes
    wild_p = rng.dirichlet(np.ones(NUM_WILDERNESS) * 0.6, size=NUM_CLASSES)
    wild_p = 0.6 * wild_p + 0.4 / NUM_WILDERNESS
    soil_p = rng.dirichlet(np.ones(NUM_SOIL) * 0.3, size=NUM_CLASSES)
    soil_p = 0.55 * soil_p + 0.45 / NUM_SOIL

    xs, ys = [], []
    for c in range(NUM_CLASSES):
        cont = means[c] + rng.normal(0, 1, (per_class, NUM_CONTINUOUS)) * scales
        wa = rng.choice(NUM_WILDERNESS, size=per_class, p=wild_p[c])
        st = rng.choice(NUM_SOIL, size=per_class, p=soil_p[c])
        wa_oh = np.eye(NUM_WILDERNESS, dtype=np.float64)[wa]
        st_oh = np.eye(NUM_SOIL, dtype=np.float64)[st]
        xs.append(np.concatenate([cont, wa_oh, st_oh], axis=1))
        ys.append(np.full(per_class, c, dtype=np.int32))
    x = np.concatenate(xs)
    y = np.concatenate(ys)

    perm = rng.permutation(n_total)
    x, y = x[perm], y[perm]
    # standardize continuous block (paper preprocesses cartographic features)
    mu = x[:, :NUM_CONTINUOUS].mean(0)
    sd = x[:, :NUM_CONTINUOUS].std(0) + 1e-9
    x[:, :NUM_CONTINUOUS] = (x[:, :NUM_CONTINUOUS] - mu) / sd

    n_test = int(n_total * test_frac)
    return Dataset(x[n_test:], y[n_test:], x[:n_test], y[:n_test])


# ---------------------------------------------------------------------------
# Concept drift (DESIGN.md §13). A drift transform rewrites the *stream* a
# scenario draws — never the train/test pools — as a pure function of
# (stream, windows, obs_per_window, seed), so every engine that builds the
# same stream sees the same drifted stream (fleet/scan/city parity by
# construction). Drift randomness comes from its own `default_rng([seed,
# const])` streams: the scenario's main rng is never consumed, so
# `drift="none"` configs remain bitwise identical to pre-drift builds.
#
# Two paper-motivated schedules, addressable by spec string (grammar in
# repro.core.registry, like transports/collection policies):
#
# * ``rotate[:rate=R]`` — gradual covariate drift: the standardized
#   continuous block rotates in a fixed random 2-plane by angle ``R * t`` at
#   window ``t`` (norms preserved; the one-hot blocks are untouched, keeping
#   them valid one-hots).
# * ``prior[:at=A,gamma=G]`` — abrupt label-prior shift: from window
#   ``floor(A * windows)`` on, the stream is resampled (with replacement,
#   from the same drawn stream segment) under class weights ``G ** y`` —
#   G < 1 tilts the prior towards low class ids.
# * ``rotate_prior[:rate=,at=,gamma=]`` — both, rotation applied first.
# ---------------------------------------------------------------------------

DriftFn = Callable[[np.ndarray, np.ndarray, int, int, int],
                   Tuple[np.ndarray, np.ndarray]]


def _rotate_drift(rate: float = 0.05) -> DriftFn:
    if not 0.0 <= rate <= np.pi:
        raise ValueError(f"rotation rate must be in [0, pi] rad/window, "
                         f"got {rate}")

    def drift(x, y, windows, obs_per_window, seed):
        drng = np.random.default_rng([int(seed), 0xD21F7])
        u = drng.normal(size=NUM_CONTINUOUS)
        u /= np.linalg.norm(u)
        v = drng.normal(size=NUM_CONTINUOUS)
        v -= u * (u @ v)
        v /= np.linalg.norm(v)
        x = np.array(x, np.float64, copy=True)
        block = x[:, :NUM_CONTINUOUS]
        a, b = block @ u, block @ v
        t = np.repeat(np.arange(windows, dtype=np.float64),
                      obs_per_window)[:len(x)]
        cos, sin = np.cos(rate * t), np.sin(rate * t)
        block += ((a * (cos - 1.0) - b * sin)[:, None] * u
                  + (a * sin + b * (cos - 1.0))[:, None] * v)
        x[:, :NUM_CONTINUOUS] = block
        return x, y
    return drift


def _prior_drift(at: float = 0.5, gamma: float = 0.5) -> DriftFn:
    if not 0.0 <= at <= 1.0:
        raise ValueError(f"prior-shift onset must be in [0, 1], got {at}")
    if not gamma > 0.0:
        raise ValueError(f"prior-shift gamma must be positive, got {gamma}")

    def drift(x, y, windows, obs_per_window, seed):
        cut = int(at * windows) * obs_per_window
        if cut >= len(x) or gamma == 1.0:
            return x, y
        drng = np.random.default_rng([int(seed), 0xD21F8])
        w = gamma ** np.asarray(y[cut:], np.float64)
        idx = cut + drng.choice(len(x) - cut, size=len(x) - cut,
                                replace=True, p=w / w.sum())
        x = np.concatenate([x[:cut], x[idx]])
        y = np.concatenate([y[:cut], y[idx]])
        return x, y
    return drift


def _rotate_prior_drift(rate: float = 0.05, at: float = 0.5,
                        gamma: float = 0.5) -> DriftFn:
    rot, pri = _rotate_drift(rate), _prior_drift(at, gamma)

    def drift(x, y, windows, obs_per_window, seed):
        x, y = rot(x, y, windows, obs_per_window, seed)
        return pri(x, y, windows, obs_per_window, seed)
    return drift


def _no_drift() -> DriftFn:
    return lambda x, y, windows, obs_per_window, seed: (x, y)


DRIFT_FACTORIES: Dict[str, Callable[..., DriftFn]] = {
    "none": _no_drift,
    "rotate": _rotate_drift,
    "prior": _prior_drift,
    "rotate_prior": _rotate_prior_drift,
}

_DRIFT_CACHE: Dict[str, DriftFn] = {}


def register_drift(name: str, factory: Callable[..., DriftFn]) -> None:
    """Register a drift-schedule factory under a spec name."""
    # lazy import: repro.core.__init__ imports back into this module
    from repro_torch.core.registry import register_factory
    register_factory(DRIFT_FACTORIES, name, factory, "drift schedule")


def get_drift(spec: str) -> DriftFn:
    """Resolve a drift spec string to a (cached) drift transform.
    Raises :class:`KeyError` on unknown names/parameters, so
    ``validate_config`` keeps its fail-fast contract."""
    from repro_torch.core.registry import resolve_spec
    return resolve_spec(spec, DRIFT_FACTORIES, _DRIFT_CACHE,
                        "drift schedule")


def observation_bytes(label_bytes: int = 1, feature_bytes: int = 8) -> int:
    """Wire size of one observation: 54 float64 features + 1-byte label.

    Calibrated against the paper's Edge-Only benchmark (34 477 mJ over
    10 000 observations via NB-IoT) and mule-collection cost (1 728 mJ via
    802.15.4); see DESIGN.md §2.
    """
    return NUM_FEATURES * feature_bytes + label_bytes
