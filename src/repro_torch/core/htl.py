"""A2AHTL and StarHTL (paper Algorithms 1 & 2) over an energy ledger.

Each window, every Data Collector (DC) holds a disjoint local dataset.
A2AHTL: local SVM -> all-to-all model exchange -> GreedyTL at every DC ->
gather refined models at one DC -> average. StarHTL: local SVM -> entropy
based center election -> models to the center only -> GreedyTL at the center.

All model transfers, index exchanges and raw-data aggregations are charged
through the :class:`~repro_torch.core.topology.Topology` message patterns
(unicast / broadcast / gather / exchange_all), which encode the
per-technology relay and mains-power conventions once for every engine.

This module is the *loop* engine: one trainer/refiner call per DC. The
batched engine in :mod:`repro_torch.core.fleet` must stay numerically on top
of it. Port of ``repro.core.htl``: the host-side control flow (AP and
center election, subsampling, every ledger charge) is the reference's,
line for line, so ledgers match it exactly; the models are trained on
``device`` and come back as numpy float32 arrays.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from repro_torch.core.energy import (INDEX_BYTES, Ledger, MODEL_BYTES,
                                     OBS_BYTES)
from repro_torch.core.greedytl import greedytl
from repro_torch.core.metrics import trimmed_mean
from repro_torch.core.svm import pad_local, sample_cap, train_svm
from repro_torch.core.topology import Topology, fleet_nodes

M_CAP = 16        # max source hypotheses per GreedyTL call (padded, masked)


@dataclass
class DC:
    name: str
    x: np.ndarray
    y: np.ndarray
    is_es: bool = False

    @property
    def n(self) -> int:
        return len(self.y)


def label_entropy(y: np.ndarray, num_classes: int) -> float:
    """Information entropy with log base |K| (paper Section 4, StarHTL)."""
    if len(y) == 0:
        return 0.0
    counts = np.bincount(y, minlength=num_classes).astype(np.float64)
    p = counts / counts.sum()
    p = p[p > 0]
    return float(-(p * np.log(p) / np.log(num_classes)).sum())


def _train_base(dc: DC, cap: int, num_classes: int,
                device="cuda") -> np.ndarray:
    # bucketed sample capacity: padded rows are dead compute (masked rows
    # contribute zero gradient), and the fleet engine buckets identically
    x, y, m = pad_local(dc.x, dc.y, sample_cap(dc.n, cap))
    w = train_svm(x, y, m, num_classes=num_classes, device=device)
    return w.cpu().numpy()


def _subsample(dc: DC, n_per_class: Optional[int], num_classes: int,
               rng: np.random.Generator) -> DC:
    """Paper Section 7: GreedyTL retrained on n points per class."""
    if n_per_class is None or dc.n == 0:
        return dc
    keep = []
    for c in range(num_classes):
        idx = np.where(dc.y == c)[0]
        if len(idx) > n_per_class:
            idx = rng.choice(idx, n_per_class, replace=False)
        keep.append(idx)
    keep = np.concatenate(keep) if keep else np.arange(0)
    return dataclasses.replace(dc, x=dc.x[keep], y=dc.y[keep])


def _greedy_refine(dc: DC, sources: List[np.ndarray], cap: int,
                   num_classes: int, device="cuda") -> np.ndarray:
    x, y, m = pad_local(dc.x, dc.y, sample_cap(dc.n, cap))
    src, src_mask = build_source_pool(sources, None)
    w_eff, _ = greedytl(x, y, m, src, src_mask, num_classes=num_classes,
                        device=device)
    return w_eff.cpu().numpy()


def apply_aggregation_heuristic(dcs: List[DC], ledger: Ledger, tech: str
                                ) -> List[DC]:
    """Paper Section 6.3: DCs with local data below 2x the model size ship
    raw data to one of them (the largest under-provisioned mule), which alone
    joins the learning round."""
    thresh_obs = int(np.ceil(2 * MODEL_BYTES / OBS_BYTES))
    small = [d for d in dcs if not d.is_es and d.n < thresh_obs]
    big = [d for d in dcs if d.is_es or d.n >= thresh_obs]
    if len(small) <= 1:
        return dcs
    small.sort(key=lambda d: -d.n)
    sink = small[0]
    xs, ys = [sink.x], [sink.y]
    topo = Topology(ledger, tech, fleet_nodes(dcs, _ap_name(dcs)))
    for d in small[1:]:
        if d.n == 0:
            continue
        topo.unicast(topo.node(d.name), topo.node(sink.name),
                     d.n * OBS_BYTES, what="raw-data aggregation")
        xs.append(d.x)
        ys.append(d.y)
    merged = DC(sink.name, np.concatenate(xs), np.concatenate(ys))
    return big + [merged]


def _ap_name(dcs: List[DC]) -> Optional[str]:
    mules = [d for d in dcs if not d.is_es]
    if not mules:
        return None
    return max(mules, key=lambda d: d.n).name


def build_source_pool(base: List[np.ndarray],
                      prev_global: Optional[np.ndarray]):
    """The shared GreedyTL source pool of a window: every base model plus the
    previous global model, truncated to M_CAP. Returns padded
    (src (M_CAP, F+1, C), src_mask (M_CAP,)) — shared by both engines."""
    sources = list(base)
    if prev_global is not None:
        sources = sources + [prev_global]
    sources = sources[:M_CAP]
    F1, C = sources[0].shape
    src = np.zeros((M_CAP, F1, C), np.float32)
    src_mask = np.zeros((M_CAP,), np.float32)
    for i, w in enumerate(sources):
        src[i] = w
        src_mask[i] = 1.0
    return src, src_mask


def run_window_a2a(dcs: List[DC], prev_global: Optional[np.ndarray],
                   ledger: Ledger, tech: str, *, cap: int, num_classes: int,
                   n_subsample: Optional[int] = None,
                   rng: Optional[np.random.Generator] = None,
                   robust: float = 0.0, device="cuda") -> np.ndarray:
    """One A2AHTL round (Algorithm 1). Returns the new global model.
    ``robust`` is the combine step's trim fraction
    (:func:`repro.core.metrics.trimmed_mean`; 0.0 = the paper's mean)."""
    rng = rng or np.random.default_rng(0)
    dcs = [d for d in dcs if d.n > 0]
    if not dcs:
        return prev_global
    ap = _ap_name(dcs)

    base = {d.name: _train_base(d, cap, num_classes, device)
            for d in dcs}
    if len(dcs) == 1:
        only = base[dcs[0].name]
        return only if prev_global is None else 0.5 * (only + prev_global)
    topo = Topology(ledger, tech, fleet_nodes(dcs, ap))

    # Step 1: every DC sends its base model to every other DC
    topo.exchange_all(MODEL_BYTES, what="m0 exchange")

    # Step 2: GreedyTL at every DC (prev global model joins the shared pool)
    sources = [base[o.name] for o in dcs]
    if prev_global is not None:
        sources = sources + [prev_global]
    refined = [_greedy_refine(_subsample(d, n_subsample, num_classes, rng),
                              sources, cap, num_classes, device)
               for d in dcs]

    # Step 3: send refined models to one DC (the AP / largest mule)
    center = next((d for d in dcs if d.name == ap), dcs[0])
    topo.gather(topo.node(center.name), MODEL_BYTES, what="m1 gather")

    # Step 4: average (or trimmed mean, byzantine-robust combine)
    return trimmed_mean(np.stack(refined), robust)


def run_window_star(dcs: List[DC], prev_global: Optional[np.ndarray],
                    ledger: Ledger, tech: str, *, cap: int, num_classes: int,
                    n_subsample: Optional[int] = None,
                    rng: Optional[np.random.Generator] = None,
                    robust: float = 0.0, device="cuda") -> np.ndarray:
    """One StarHTL round (Algorithm 2). ``robust`` is accepted for engine
    interchangeability but is a no-op: StarHTL has no multi-model combine
    (the center's GreedyTL output IS the round's model)."""
    rng = rng or np.random.default_rng(0)
    dcs = [d for d in dcs if d.n > 0]
    if not dcs:
        return prev_global
    ap = _ap_name(dcs)

    base = {d.name: _train_base(d, cap, num_classes, device)
            for d in dcs}
    if len(dcs) == 1:
        only = base[dcs[0].name]
        return only if prev_global is None else 0.5 * (only + prev_global)
    topo = Topology(ledger, tech, fleet_nodes(dcs, ap))

    # Step 1: entropy index exchange + center id broadcast (tiny messages)
    topo.exchange_all(INDEX_BYTES, what="entropy index")
    center = max(dcs, key=lambda d: label_entropy(d.y, num_classes))
    topo.broadcast(topo.node(center.name), INDEX_BYTES, what="center id")

    # Step 2: base models to the center only
    topo.gather(topo.node(center.name), MODEL_BYTES, what="m0 to center")

    # Step 3: GreedyTL at the center only
    sources = [base[d.name] for d in dcs]
    if prev_global is not None:
        sources = sources + [prev_global]
    return _greedy_refine(_subsample(center, n_subsample, num_classes, rng),
                          sources, cap, num_classes, device)
