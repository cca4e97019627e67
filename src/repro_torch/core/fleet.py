"""Batched fleet-round engine: one window = O(1) trainer/refiner calls.

Port of ``repro.core.fleet``. The loop engine in :mod:`repro_torch.core.htl`
issues one ``train_svm`` and (for A2AHTL) one ``greedytl`` call *per Data
Collector*. This engine groups the per-window DC fleet by bucketed sample
capacity (:func:`repro_torch.core.svm.sample_cap`), pads each group's DC
count to a bucketed fleet capacity, and runs

* base training as one :func:`~repro_torch.core.svm.train_svm_fleet` per
  sample bucket (the DC axis is a batch dimension), and
* the refine step as one
  :func:`~repro_torch.core.greedytl.greedytl_fleet_stacked` per sample
  bucket — one ``loo_trials`` kernel launch per greedy step for the whole
  bucket.

**The port's fleet==loop contract.** The reference gets bitwise
fleet==loop refines from ``lax.map``. Here both engines run the same
batched code, the loop engine with a batch of one, and batched
``torch.bmm``/``torch.linalg`` need not round exactly as a batch of one
does. So the contract is: ledgers are EXACTLY equal (every charge is
host-side and identical in both engines), and models agree to float32
roundoff, which keeps F1 curves within the reference's own fleet-vs-loop
bar of 1e-4 (tests/test_torch_scenario.py holds both engines to it).

The ``*_stacked`` runners extend the same trick across scenario replicas
(ROADMAP: batched multi-seed rounds): every replica's fleet concatenates
into the flat DC axis — with per-DC source pools, since each replica
exchanged its own base models — so one dispatch per bucket serves a whole
seed/config group of a sweep, while per-replica ledgers, rng streams and
host-side control flow stay exactly as in the unstacked runners.

Election/subsampling policies are resolved through the
:mod:`~repro_torch.core.htl` module at call time, so policy ablations that
monkey-patch the loop engine apply to this engine too.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core import htl
from repro_torch.core.energy import INDEX_BYTES, Ledger, MODEL_BYTES
from repro_torch.core.greedytl import greedytl_fleet_stacked
from repro_torch.core.htl import DC, build_source_pool
from repro_torch.core.metrics import trimmed_mean
from repro_torch.core.svm import pad_fleet, sample_cap, train_svm_fleet
from repro_torch.core.topology import Topology, fleet_nodes

FLEET_BUCKETS = (1, 2, 4, 8, 16)   # padded DC-axis caps (cover Poisson(7))


def fleet_cap(n_dcs: int) -> int:
    """Bucketed DC-axis capacity: Poisson-varying fleet sizes land on a
    handful of stable shapes (multiples of 32 beyond the largest bucket, so
    stacked multi-replica fleets stay near-dense), keeping the set of
    shapes tiny and padding waste low."""
    for b in FLEET_BUCKETS:
        if n_dcs <= b:
            return b
    return -(-n_dcs // 32) * 32


def _sample_groups(dcs: Sequence[DC], cap: int) -> dict:
    """{bucketed sample capacity: [index into dcs]} — the dispatch plan."""
    groups: dict = {}
    for i, d in enumerate(dcs):
        groups.setdefault(sample_cap(d.n, cap), []).append(i)
    return groups


def train_base_bucketed(dcs: Sequence[DC], cap: int, num_classes: int,
                        device="cuda") -> List[np.ndarray]:
    """Base SVMs for an arbitrary DC list (one fleet or several stacked
    replicas) in O(1) dispatches: one ``train_svm_fleet`` per sample
    bucket, DC counts padded to bucketed fleet capacities. Masked rows and
    padding DCs contribute nothing, so each model equals its individually
    trained counterpart to float roundoff. Returns one (F+1, C) per DC."""
    out: List[Optional[np.ndarray]] = [None] * len(dcs)
    for b, idxs in sorted(_sample_groups(dcs, cap).items()):
        sel = [dcs[i] for i in idxs]
        x, y, m, _ = pad_fleet([d.x for d in sel], [d.y for d in sel],
                               b, fleet_cap(len(sel)))
        w = train_svm_fleet(x, y, m, num_classes=num_classes,
                            device=device).cpu().numpy()
        for j, i in enumerate(idxs):
            out[i] = w[j]
    return out


def refine_bucketed(dcs: Sequence[DC], srcs: Sequence[np.ndarray],
                    src_masks: Sequence[np.ndarray], cap: int,
                    num_classes: int, device="cuda") -> List[np.ndarray]:
    """GreedyTL for an arbitrary DC list, each against ITS OWN source pool,
    in O(1) dispatches (one ``greedytl_fleet_stacked`` per sample bucket).
    Padding DCs carry all-zero masks and never accept a source. Returns one
    (F+1, C) per DC. The greedy loop inside runs the incremental factor
    carry for a fixed ``min(k_max, M)`` steps: one ``loo_trials`` launch
    per step for the whole bucket, however many sources are accepted."""
    out: List[Optional[np.ndarray]] = [None] * len(dcs)
    for b, idxs in sorted(_sample_groups(dcs, cap).items()):
        sel = [dcs[i] for i in idxs]
        lcap = fleet_cap(len(sel))
        x, y, m, _ = pad_fleet([d.x for d in sel], [d.y for d in sel],
                               b, lcap)
        src = np.zeros((lcap,) + srcs[idxs[0]].shape, np.float32)
        sm = np.zeros((lcap,) + src_masks[idxs[0]].shape, np.float32)
        for j, i in enumerate(idxs):
            src[j] = srcs[i]
            sm[j] = src_masks[i]
        w, _ = greedytl_fleet_stacked(x, y, m, src, sm,
                                      num_classes=num_classes, device=device)
        w = w.cpu().numpy()
        for j, i in enumerate(idxs):
            out[i] = w[j]
    return out


def run_window_a2a(dcs: List[DC], prev_global: Optional[np.ndarray],
                   ledger: Ledger, tech: str, *, cap: int, num_classes: int,
                   n_subsample: Optional[int] = None,
                   rng: Optional[np.random.Generator] = None,
                   robust: float = 0.0, device="cuda") -> np.ndarray:
    """One A2AHTL round (Algorithm 1), batched. Returns the new global
    model. Drop-in replacement for
    :func:`repro_torch.core.htl.run_window_a2a` (``robust`` = the combine's
    trim fraction, 0.0 = plain mean)."""
    out = run_window_a2a_stacked([dcs], [prev_global], [ledger], [tech],
                                 cap=cap, num_classes=num_classes,
                                 n_subsamples=[n_subsample],
                                 rngs=None if rng is None else [rng],
                                 robusts=[robust], device=device)
    return out[0]


def run_window_star(dcs: List[DC], prev_global: Optional[np.ndarray],
                    ledger: Ledger, tech: str, *, cap: int, num_classes: int,
                    n_subsample: Optional[int] = None,
                    rng: Optional[np.random.Generator] = None,
                    robust: float = 0.0, device="cuda") -> np.ndarray:
    """One StarHTL round (Algorithm 2), batched base training. Drop-in
    replacement for :func:`repro_torch.core.htl.run_window_star` (``robust``
    accepted for interchangeability; StarHTL has no combine)."""
    out = run_window_star_stacked([dcs], [prev_global], [ledger], [tech],
                                  cap=cap, num_classes=num_classes,
                                  n_subsamples=[n_subsample],
                                  rngs=None if rng is None else [rng],
                                  robusts=[robust], device=device)
    return out[0]


# ---------------------------------------------------------------------------
# replica-stacked rounds: one dispatch set serves every replica of a sweep
# group (seed replicas, or configs differing only in collection/energy
# parameters) — per-replica ledgers and control flow stay separate
# ---------------------------------------------------------------------------

def _split_live(fleets):
    """(replica, non-empty DCs) pairs for the replicas that reach a
    learning round; a replica whose window collected nothing keeps its
    previous global model."""
    live = [(s, [d for d in dcs if d.n > 0]) for s, dcs in enumerate(fleets)]
    return [(s, dcs) for s, dcs in live if dcs]


def _base_and_singles(fleets, prev_globals, cap, num_classes, out, device):
    """Shared head of both stacked rounds: flat-stacked base training for
    every live replica, then the single-DC early exit (that DC's base model,
    averaged with the previous global model if any) resolved host-side.
    Returns [(replica, dcs, base models)] for replicas with >= 2 DCs."""
    live = _split_live(fleets)
    if not live:
        return []
    flat = [d for _, dcs in live for d in dcs]
    base = train_base_bucketed(flat, cap, num_classes, device)
    multi, ofs = [], 0
    for s, dcs in live:
        b = base[ofs:ofs + len(dcs)]
        ofs += len(dcs)
        if len(dcs) == 1:
            only = b[0]
            out[s] = (only if prev_globals[s] is None
                      else 0.5 * (only + prev_globals[s]))
        else:
            multi.append((s, dcs, b))
    return multi


def run_window_a2a_stacked(fleets: List[List[DC]],
                           prev_globals: List[Optional[np.ndarray]],
                           ledgers: List[Ledger], techs: List[str], *,
                           cap: int, num_classes: int,
                           n_subsamples: Optional[List[Optional[int]]] = None,
                           rngs: Optional[List[np.random.Generator]] = None,
                           robusts: Optional[List[float]] = None,
                           device="cuda") -> List[Optional[np.ndarray]]:
    """One A2AHTL round for every replica — O(1) dispatches TOTAL.

    ``fleets[s]``/``ledgers[s]``/``techs[s]``/... belong to replica s; all
    host-side control flow (AP election, topology charging, early exits,
    subsampling rng, combine trim fraction ``robusts[s]``) is per replica,
    exactly as in the unstacked round, so each replica's ledger and model
    trajectory match a sequential run. Returns the new global model per
    replica.
    """
    S = len(fleets)
    rngs = rngs or [np.random.default_rng(0) for _ in range(S)]
    n_subsamples = n_subsamples or [None] * S
    robusts = robusts or [0.0] * S
    out: List[Optional[np.ndarray]] = list(prev_globals)
    multi = _base_and_singles(fleets, prev_globals, cap, num_classes, out,
                              device)
    if not multi:
        return out

    # host side per replica: m0 exchange charge, source pool, subsample
    topos, subs, srcs, smasks, counts = [], [], [], [], []
    for s, dcs, b in multi:
        topo = Topology(ledgers[s], techs[s],
                        fleet_nodes(dcs, htl._ap_name(dcs)))
        topo.exchange_all(MODEL_BYTES, what="m0 exchange")
        topos.append(topo)
        src, src_mask = build_source_pool(list(b), prev_globals[s])
        for d in dcs:
            subs.append(htl._subsample(d, n_subsamples[s], num_classes,
                                       rngs[s]))
            srcs.append(src)
            smasks.append(src_mask)
        counts.append(len(dcs))

    # refine every replica's fleet against its own pool — O(buckets) calls
    refined = refine_bucketed(subs, srcs, smasks, cap, num_classes, device)

    ofs = 0
    for i, (s, dcs, _) in enumerate(multi):
        r = np.stack(refined[ofs:ofs + counts[i]])
        ofs += counts[i]
        ap = htl._ap_name(dcs)
        center = next((d for d in dcs if d.name == ap), dcs[0])
        topos[i].gather(topos[i].node(center.name), MODEL_BYTES,
                        what="m1 gather")
        out[s] = trimmed_mean(r, robusts[s])
    return out


def run_window_star_stacked(fleets: List[List[DC]],
                            prev_globals: List[Optional[np.ndarray]],
                            ledgers: List[Ledger], techs: List[str], *,
                            cap: int, num_classes: int,
                            n_subsamples: Optional[List[Optional[int]]]
                            = None,
                            rngs: Optional[List[np.random.Generator]] = None,
                            robusts: Optional[List[float]] = None,
                            device="cuda") -> List[Optional[np.ndarray]]:
    """One StarHTL round for every replica — O(1) dispatches TOTAL.

    Center election and all message charging stay per replica; the
    per-replica GreedyTL "batch of one" calls stack into the flat DC axis
    with per-replica source pools. ``robusts`` is accepted for signature
    interchangeability with the A2A runner (StarHTL has no combine).
    """
    S = len(fleets)
    rngs = rngs or [np.random.default_rng(0) for _ in range(S)]
    n_subsamples = n_subsamples or [None] * S
    out: List[Optional[np.ndarray]] = list(prev_globals)
    multi = _base_and_singles(fleets, prev_globals, cap, num_classes, out,
                              device)
    if not multi:
        return out

    sids, subs, srcs, smasks = [], [], [], []
    for s, dcs, b in multi:
        topo = Topology(ledgers[s], techs[s],
                        fleet_nodes(dcs, htl._ap_name(dcs)))
        topo.exchange_all(INDEX_BYTES, what="entropy index")
        c_idx = int(np.argmax([htl.label_entropy(d.y, num_classes)
                               for d in dcs]))
        center = dcs[c_idx]
        topo.broadcast(topo.node(center.name), INDEX_BYTES, what="center id")
        topo.gather(topo.node(center.name), MODEL_BYTES, what="m0 to center")
        src, src_mask = build_source_pool(list(b), prev_globals[s])
        subs.append(htl._subsample(center, n_subsamples[s], num_classes,
                                   rngs[s]))
        srcs.append(src)
        smasks.append(src_mask)
        sids.append(s)

    refined = refine_bucketed(subs, srcs, smasks, cap, num_classes, device)
    for i, s in enumerate(sids):
        out[s] = refined[i]
    return out
