"""Hypothesis-Transfer training for large models — the paper's technique at
datacenter scale (port of ``repro.core.htl_trainer``; DESIGN.md §3).

Frequent synchronous gradient exchange stays on cheap links; the
expensive boundary (the paper's long-range radio link) carries only
*hypotheses* (whole models), once every ``local_steps`` steps.

Mechanics (paper Algorithms 1 & 2, hypotheses = parameter trees):

* L virtual Data Collectors hold a **stacked** parameter tree, {reference
  path: tensor with a leading (L, ...) collector dim}; the optimizer's
  ``count`` is one shared scalar and its moments are stacked too.
* *Step 0*: every DC runs ``local_steps`` AdamW steps on its own disjoint
  token stream. The reference ``vmap``s the DCs; here a Python loop runs
  them one after another, each a ``torch.func.functional_call`` of the
  model's loss on the DC's slice (views, so AdamW updates the stacked
  tensors in place), and each clips its own gradients.
* *Step 1/2* (A2A): every DC learns simplex mixing weights over the L
  hypotheses by minimising its local loss of the mixed model (softmax-
  parametrised gradient descent through the mixture, ``"gd"``, or the
  first-order ``"loss_softmax"``: weights exp(-loss / tau));
* *Step 3/4* (A2A): the refined hypotheses are averaged.
* *StarHTL*: a center is elected by maximum local token entropy (the
  paper's election index; the first DC on a tie) and only the center
  mixes; the result is broadcast.
* After a transfer first moments are halved (a warm restart); second
  moments stay.
* ``sync`` mode is the centralised baseline: plain AdamW on one unstacked
  tree (the paper's Edge-Only).

The loss is the model's training loss, so it takes the plain route of
every mixer (``Model.loss_fn``). The traffic ledger counts logical
transfers as the paper's energy ledger counts radio transfers. The
production local phase (``local_phase_podwise``) needs the mesh of ROADMAP
Queue 1 item 10.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
from torch.func import functional_call

from repro_torch.configs.base import HTLConfig, OptimizerConfig
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update
from repro_torch.optim.schedule import cosine_warmup_schedule
from repro_torch.sharding.partitioning import init_params, template_bytes


class HTLState(NamedTuple):
    params: Dict[str, torch.Tensor]   # {path: (L, ...)} (sync: unstacked)
    opt: AdamWState                   # shared count, stacked moments
    step: torch.Tensor                # 0-d int32


def _row(tree, i: int):
    """Collector ``i``'s slice of a stacked tree (views)."""
    return {k: x[i] for k, x in tree.items()}


class HTLTrainer:
    """Model-agnostic hypothesis-transfer trainer on the model's device.
    ``model`` supplies the loss and the template; the trainer keeps its
    own parameter trees and evaluates the loss under them. State passed
    to :meth:`local_phase` and :meth:`transfer_phase` is updated in place
    and returned."""

    def __init__(self, model: Model, opt_cfg: OptimizerConfig,
                 htl_cfg: HTLConfig):
        self.model = model
        self.opt_cfg = opt_cfg
        self.htl = htl_cfg
        self._sched = cosine_warmup_schedule(opt_cfg)

    # ------------------------------------------------------------------ init
    def init(self, seed: int = 0) -> HTLState:
        """Parameters drawn from ``seed`` (the port's stream), stacked over
        the collectors and de-correlated by 1% of each leaf's standard
        deviation of noise per DC, unless the mode is sync."""
        model = self.model
        params = init_params(model.template(), seed, model.dtype,
                             model.device)
        if self.htl.mode != "sync":
            L = self.htl.num_collectors
            gen = torch.Generator(device=model.device)
            out = {}
            for i, (k, leaf) in enumerate(params.items()):
                gen.manual_seed(seed * 1_000_003 + 1000 + i)
                x = leaf.float()
                noise = 0.01 * torch.randn((L,) + tuple(leaf.shape),
                                           generator=gen,
                                           device=model.device)
                out[k] = (x + noise * x.std(correction=0)).to(leaf.dtype)
            params = out
        return HTLState(params, adamw_init(params),
                        torch.zeros((), dtype=torch.int32,
                                    device=model.device))

    # ----------------------------------------------------------------- loss
    def _loss(self, params, batch):
        """(total loss, metrics) of the model under ``params`` (one
        hypothesis, {path: tensor in the reference's shape})."""
        return functional_call(self.model,
                               self.model.named_from_tree(params), (batch,))

    def _loss_and_grads(self, params, batch):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        with torch.enable_grad():
            total, metrics = self._loss(leaves, batch)
            grads = torch.autograd.grad(total, list(leaves.values()))
        return metrics["loss"], dict(zip(leaves, grads))

    # ----------------------------------------------------------- local steps
    def _one_local_step(self, params, opt, batch, step):
        """One AdamW step of every DC (of the one tree in sync mode).
        Returns (opt, loss per DC)."""
        lr = self._sched(step)

        def single(p, o, b):
            loss, grads = self._loss_and_grads(p, b)
            _, o, _ = adamw_update(grads, o, p, lr, self.opt_cfg)
            return o.count, loss

        if self.htl.mode == "sync":
            count, loss = single(params, opt, batch)
            return AdamWState(count, opt.mu, opt.nu), loss
        losses = []
        for i in range(self.htl.num_collectors):
            o_i = AdamWState(opt.count, _row(opt.mu, i), _row(opt.nu, i))
            count, loss = single(_row(params, i), o_i, _row(batch, i))
            losses.append(loss)
        # the count is shared: every DC advanced it from the same value
        return AdamWState(count, opt.mu, opt.nu), torch.stack(losses)

    def local_phase(self, state: HTLState, batches) -> Tuple[HTLState,
                                                             torch.Tensor]:
        """batches: {"tokens", "targets"} with leading (H, L, ...) dims
        (H local steps; (H, ...) in sync mode). Returns (state, losses
        (H, L) or (H,))."""
        params, opt, step = state
        losses = []
        for h in range(batches["tokens"].shape[0]):
            opt, loss = self._one_local_step(params, opt, _row(batches, h),
                                             step)
            step = step + 1
            losses.append(loss)
        return HTLState(params, opt, step), torch.stack(losses)

    def local_phase_podwise(self, state: HTLState, batches, mesh):
        """The production local phase (one hypothesis per pod of a mesh,
        zero cross-pod traffic): needs the mesh of ROADMAP Queue 1 item
        10, which the port does not have yet."""
        raise NotImplementedError(
            "local_phase_podwise needs a device mesh: ROADMAP Queue 1 item "
            "10 (mesh, dry-run and roofline)")

    # ------------------------------------------------------- mixing (GreedyTL)
    @staticmethod
    def _mix(stacked_params, weights):
        """weights: (L,) simplex -> the mixed tree, in float32, rounded to
        each leaf's dtype."""
        w = weights.float()
        return {k: torch.einsum("i,i...->...", w, x.float()).to(x.dtype)
                for k, x in stacked_params.items()}

    def _mixing_weights(self, stacked_params, mix_batch, self_idx: int):
        """GreedyTL analogue: simplex weights minimising the local loss."""
        L = self.htl.num_collectors
        if self.htl.mixing_mode == "loss_softmax":
            with torch.no_grad():
                losses = torch.stack([
                    self._loss(_row(stacked_params, i), mix_batch)[0]
                    for i in range(L)])
            return torch.softmax(-losses / self.htl.mixing_tau, dim=0)

        dev = next(iter(stacked_params.values())).device
        z = (torch.arange(L, device=dev) == self_idx).float()
        for _ in range(self.htl.mixing_steps):
            z = z.detach().requires_grad_(True)
            with torch.enable_grad():
                mixed = self._mix(stacked_params, torch.softmax(z, dim=0))
                loss, _ = self._loss(mixed, mix_batch)
                g, = torch.autograd.grad(loss, z)
            z = z.detach() - self.htl.mixing_lr * g
        return torch.softmax(z, dim=0)

    @staticmethod
    def _token_entropy(tokens, nbins: int = 256):
        """Paper's election index: label entropy -> token-histogram
        entropy (float32)."""
        counts = torch.bincount((tokens % nbins).reshape(-1).long(),
                                minlength=nbins).float()
        p = counts / torch.clamp(counts.sum(), min=1.0)
        return -torch.sum(torch.where(p > 0, p * torch.log(p), 0.0))

    # ------------------------------------------------------- transfer round
    @torch.no_grad()
    def transfer_phase(self, state: HTLState, mix_batches) -> HTLState:
        """mix_batches: {"tokens", "targets"} with a leading (L, ...) dim,
        one mixing batch per DC. Every DC's hypothesis becomes the A2A
        average of the refined hypotheses, or the Star center's mixture;
        first moments are halved."""
        mode = self.htl.mode
        if mode == "sync":
            return state
        L = self.htl.num_collectors
        params = state.params
        if mode == "a2a":
            # every DC mixes all hypotheses against its local batch, then
            # the refined hypotheses are averaged (paper Step 4)
            total = None
            for i in range(L):
                w = self._mixing_weights(params, _row(mix_batches, i), i)
                refined = {k: v.float() for k, v in
                           self._mix(params, w).items()}
                total = refined if total is None else \
                    {k: total[k] + refined[k] for k in total}
            new = {k: (total[k] / L).to(params[k].dtype) for k in params}
        else:  # star
            ent = torch.stack([self._token_entropy(t)
                               for t in mix_batches["tokens"]])
            center = int(torch.argmax(ent))
            w = self._mixing_weights(params, _row(mix_batches, center),
                                     center)
            new = self._mix(params, w)
        for k, x in params.items():
            x.copy_(new[k].unsqueeze(0).expand_as(x))
        # hypotheses changed discontinuously: second moments stay (scale
        # info), first moments are damped like a warm restart
        for m in state.opt.mu.values():
            m.mul_(0.5)
        return state

    # ------------------------------------------------------------ accounting
    def round_traffic_bytes(self) -> Dict[str, float]:
        """Logical inter-collector transfers per HTL round against the sync
        baseline (paper-style ledger)."""
        mb = template_bytes(self.model.template(), self.model.cfg.dtype)
        L, H = self.htl.num_collectors, self.htl.local_steps
        out = {"model_bytes": float(mb)}
        if self.htl.mode == "a2a":
            out["htl_round_bytes"] = float(mb) * (L * (L - 1) + (L - 1))
        elif self.htl.mode == "star":
            out["htl_round_bytes"] = float(mb) * (L - 1 + L)  # in + bcast
        else:
            out["htl_round_bytes"] = 0.0
        # sync baseline: ring all-reduce of grads every step ~ 2x model bytes
        out["sync_bytes_same_steps"] = 2.0 * float(mb) * H
        out["traffic_ratio_vs_sync"] = (
            out["htl_round_bytes"] / max(1.0, out["sync_bytes_same_steps"]))
        return out
