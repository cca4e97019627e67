"""What decides ``correct``: the served tokens against the plain
reference.

Once the window has closed and the program's state is freed, a sample of
the requests the window finished, drawn from the seed, is judged: the
request with the most served tokens and the one with the longest context
always, then others in the seed's order until the sample holds at least
the mix's ``check_requests`` requests and ``check_tokens`` served
tokens. For each, the reference runs once over
the prompt and the served tokens (all but the last) and gives the
float32 logits at every served position. A served token's gap is how far
its reference logit lies below the reference's best at that position;
the number compared is the widest gap in the sample (``max_logit_gap``),
against the cell's limit (``limits/<cell>.json``). The served tokens come
from batch-1 prefills and batched decode steps through the spliced
cache, so the sample judges embedding, attention or the SSD mixer, the
MoE experts, norms, head, the cache and the splice at once.

The control (``control=True``; calibration and its test only): the same
reference in fake float8 (``reference/common.py``) reads the same
sequences, and at each position the gap of the token it puts first is
read against the float32 logits.

Where a cell's limits name ``mean_kv_error`` (an attention cell whose
requests decode few tokens after long prompts, where a cache left
unwritten barely moves a served token), :class:`CacheReadback` also
reads back, after every decode step of the window, the keys and values
the step wrote into the cache it returned, at each busy slot's position;
the reference works them out again at the same positions, and a judged
entry's error is ``|program - reference| / |reference|`` over one
layer's keys and values. ``mean_kv_error`` is the mean over every judged
request's decode positions and layers.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.traffic import seed_words


def sample(finished, target_tokens: int, target_requests: int, seed: int):
    """The judged requests (module doc), in a fixed order."""
    if not finished:
        return []
    most = max(finished, key=lambda r: (len(r.out), r.rid))
    longest = max(finished, key=lambda r: (len(r.tokens) + len(r.out),
                                           r.rid))
    picked = [most] + ([longest] if longest is not most else [])
    rest = [r for r in finished if r is not most and r is not longest]
    rng = np.random.default_rng(seed_words(seed, 3))
    n = sum(len(r.out) for r in picked)
    for i in rng.permutation(len(rest)):
        if n >= target_tokens and len(picked) >= target_requests:
            break
        picked.append(rest[i])
        n += len(rest[i].out)
    return picked


class CacheReadback:
    """Installed on the model as its ``decode_step``: after each step,
    the keys and values it wrote (every layer, every slot at its own
    position) read back from the cache the step returned, kept on the
    device; on the host, which request and position each busy slot
    held."""

    def __init__(self, model, batcher):
        self.batcher = batcher
        self.steps = []           # (layers, slots, 2 * kv heads * head_dim)
        self.where = {}           # rid -> [(step, slot, position)]
        inner = model.decode_step

        def decode_step(cache, tokens, pos):
            logits, cache = inner(cache, tokens, pos)
            self._record(cache, pos)
            return logits, cache
        model.decode_step = decode_step

    def _record(self, cache, pos):
        b = self.batcher
        slots = torch.arange(b.slots, device=pos.device)
        k, v = cache["k"][:, slots, pos], cache["v"][:, slots, pos]
        self.steps.append(torch.cat([k.flatten(2), v.flatten(2)], -1))
        i = len(self.steps) - 1
        for s, req in enumerate(b.active):
            if req is not None:
                self.where.setdefault(req.rid, []).append(
                    (i, s, int(b.pos[s])))

    def written(self, rids) -> dict:
        """{rid: (positions, (n, layers, 2 kv heads head_dim) on the
        host)} of the requests ``rids`` that decoded."""
        out = {}
        for rid in rids:
            w = self.where.get(rid)
            if w:
                rows = torch.stack([self.steps[i][:, s] for i, s, _ in w])
                out[rid] = ([p for _, _, p in w], rows.cpu())
        return out


def _kv_errors(got, want):
    """Per (position, layer): |got - want| / |want| of the entry."""
    got = got.to(want.device, torch.float32)
    return (got - want).norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)


def gaps(ref, c: dict, weights: dict, reqs, device, control=False,
         written=None):
    """Per request: the widest and the summed gap of its served tokens,
    the summed error of the cache entries it wrote where ``written``
    ({rid: (positions, entries)}, :class:`CacheReadback`) holds them,
    and with ``control`` the same of the control's."""
    out = []
    written = written or {}
    for r in reqs:
        served = torch.as_tensor(np.asarray(r.out, np.int64), device=device)
        seq = torch.cat([torch.as_tensor(np.asarray(r.tokens, np.int64),
                                         device=device), served[:-1]])
        first = len(r.tokens) - 1
        at = None
        if r.rid in written:
            positions, entries = written[r.rid]
            at = torch.as_tensor(positions, device=device)
        logits, kv = _forward(ref, c, weights, seq, first, "float32", at)
        best = logits.max(dim=-1).values
        g = best - logits.gather(-1, served[:, None])[:, 0]
        row = {"rid": r.rid, "prompt": len(r.tokens), "served": len(r.out),
               "gap": float(g.max()), "gap_sum": float(g.sum())}
        if kv is not None:
            e = _kv_errors(entries, kv)
            row.update(kv_n=e.numel(), kv_err_sum=float(e.sum()))
        if control:
            low, low_kv = _forward(ref, c, weights, seq, first, "fp8", at)
            g = best - logits.gather(-1, low.argmax(-1)[:, None])[:, 0]
            row["control_gap"] = float(g.max())
            row["control_gap_sum"] = float(g.sum())
            if kv is not None:
                row["control_kv_err_sum"] = float(_kv_errors(low_kv,
                                                             kv).sum())
            del low, low_kv
        out.append(row)
        del logits, kv
    return out


def _forward(ref, c, weights, seq, first, prec, at):
    """(logits, the reference's cache entries at positions ``at``, or
    None)."""
    if at is None:
        return ref.forward(c, weights, seq, first, prec), None
    return ref.forward(c, weights, seq, first, prec, kv_at=at)


def numbers(rows, prefix=""):
    """The numbers a cell's limits may name: ``max_logit_gap``, the widest
    gap of any judged token; ``mean_logit_gap``, the gaps summed over
    every judged token over their count; and, where the rows hold cache
    entries, ``mean_kv_error``, the entries' errors summed over their
    count."""
    n = sum(r["served"] for r in rows)
    if not n:
        return {"max_logit_gap": float("inf"),
                "mean_logit_gap": float("inf")}
    out = {"max_logit_gap": max(r[prefix + "gap"] for r in rows),
           "mean_logit_gap": sum(r[prefix + "gap_sum"] for r in rows) / n}
    m = sum(r.get("kv_n", 0) for r in rows)
    if m:
        out["mean_kv_error"] = sum(r.get(prefix + "kv_err_sum", 0.0)
                                   for r in rows) / m
    return out


def judge(got: dict, limits: dict):
    """(correct, checks): each number a limit names beside its limit; a
    number the rows cannot give reads infinite."""
    checks = {k: {"value": got.get(k, float("inf")), "limit": v}
              for k, v in limits.items()}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
