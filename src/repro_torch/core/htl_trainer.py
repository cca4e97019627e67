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
transfers as the paper's energy ledger counts radio transfers.

Under a mesh (``launch/htl_dryrun.py``) the stacked collector dim is the
'pod' axis: :meth:`HTLTrainer.local_phase_podwise` trains each pod's rows
with no cross-pod collective, and :meth:`HTLTrainer.transfer_phase`
gathers the hypotheses across pods once (the transfer itself) before it
mixes them.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
from torch.func import functional_call

from repro_torch.configs.base import HTLConfig, OptimizerConfig
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update
from repro_torch.optim.schedule import cosine_warmup_schedule
from repro_torch.sharding.partitioning import (
    P, init_params, mesh_axes, template_bytes, to_placements,
    use_compute_mesh,
)


class HTLState(NamedTuple):
    params: Dict[str, torch.Tensor]   # {path: (L, ...)} (sync: unstacked)
    opt: AdamWState                   # shared count, stacked moments
    step: torch.Tensor                # 0-d int32


def _row(tree, i: int):
    """Collector ``i``'s slice of a stacked tree (views)."""
    return {k: x[i] for k, x in tree.items()}


def _pick(tree, i: torch.Tensor):
    """The slice at a 0-d index tensor (no host sync)."""
    return {k: x.index_select(0, i.reshape(1)).squeeze(0)
            for k, x in tree.items()}


def _by_collector(fn, x):
    """``fn`` of a stacked (L, ...) tensor, row by row: a DTensor sharded
    over 'pod' is computed where its rows live (a manual region: the
    pod-local rows in, an (L, ...) DTensor sharded over pods out)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor) or "pod" not in (
            x.device_mesh.mesh_dim_names or ()):
        return fn(x)
    mesh = x.device_mesh
    on_pods = to_placements(P("pod"), mesh)
    local = x.redistribute(mesh, on_pods).to_local()
    return DTensor.from_local(fn(local), mesh, on_pods, run_check=False)


def _gather_hypotheses(x):
    """A stacked leaf with every collector's hypothesis on every rank: a
    DTensor sharded over 'pod' is gathered across pods (the hypothesis
    transfer), anything else comes back as it is."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor) or "pod" not in (
            x.device_mesh.mesh_dim_names or ()):
        return x
    pl = list(x.placements)
    pl[x.device_mesh.mesh_dim_names.index("pod")] = Replicate()
    return x.redistribute(x.device_mesh, pl)


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
        for i in range(batch["tokens"].shape[0]):
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
        """The production local phase: a manual region over the 'pod' axis
        of ``mesh`` (a ``DeviceMesh`` with axes ("pod", "data", "model")).
        Each pod trains its own L/pods rows of the stacked state on its
        ("data", "model") sub-mesh, with no cross-pod collective by
        construction; the optimizer's count stays shared (every pod
        advances it alike). batches: {"tokens", "targets"} (H, L, ...).

        DTensor leaves are laid out with their stacked dim over the pods
        (their other dims keep their layout), and each rank's shard is seen
        on the pod's sub-mesh without a copy, so the steps update the
        returned state in place; the losses come back as an (L, H) DTensor
        (the reference's out_specs P("pod"); :meth:`local_phase` gives
        (H, L)). Plain leaves, the same full state on every rank, have this
        pod's rows updated in place (the other pods' rows stay as they
        were), and the losses are this pod's (L/pods, H) rows."""
        from torch.distributed.tensor import DTensor, Replicate, Shard
        L = self.htl.num_collectors
        n_pod = mesh_axes(mesh)["pod"]
        if L % n_pod:
            raise ValueError(f"{L} collectors do not split over {n_pod} pods")
        pod, per = mesh.get_local_rank("pod"), L // n_pod
        i_pod = mesh.mesh_dim_names.index("pod")
        sub = mesh["data", "model"]

        def on_pods(t, dim=0):
            """``t`` with its ``dim`` split over the pods."""
            if not isinstance(t, DTensor):
                return t
            pl = list(t.placements)
            pl[i_pod] = Shard(dim)
            return t if tuple(pl) == tuple(t.placements) else \
                t.redistribute(mesh, pl)

        def pod_rows(t, dim=0):
            """This pod's rows: a DTensor's shard on the sub-mesh (a view),
            or a view of a plain tensor."""
            if not isinstance(t, DTensor):
                return t.narrow(dim, pod * per, per)
            pl = [p for i, p in enumerate(t.placements) if i != i_pod]
            return DTensor.from_local(t.to_local(), sub, pl, run_check=False)

        trees = {name: {k: on_pods(v) for k, v in tree.items()}
                 for name, tree in (("params", state.params),
                                    ("mu", state.opt.mu),
                                    ("nu", state.opt.nu))}
        work = {name: {k: pod_rows(v) for k, v in tree.items()}
                for name, tree in trees.items()}
        b = {k: pod_rows(on_pods(v, 1), 1) for k, v in batches.items()}
        opt, step = AdamWState(state.opt.count, work["mu"], work["nu"]), \
            state.step
        losses = []
        with use_compute_mesh(sub):
            for h in range(b["tokens"].shape[0]):
                opt, loss = self._one_local_step(work["params"], opt,
                                                 _row(b, h), step)
                step = step + 1
                losses.append(loss)
        losses = torch.stack(losses).t()                  # (L/pods, H)
        if isinstance(losses, DTensor):
            pl = [Replicate()] * mesh.ndim
            pl[i_pod] = Shard(0)
            losses = DTensor.from_local(losses.full_tensor(), mesh, pl,
                                        run_check=False)
        return HTLState(trees["params"], AdamWState(
            opt.count, trees["mu"], trees["nu"]), step), losses

    # ------------------------------------------------------- mixing (GreedyTL)
    @staticmethod
    def _mix(stacked_params, weights):
        """weights: (L,) simplex -> the mixed tree, in float32, rounded to
        each leaf's dtype. A DTensor leaf is mixed as a weighted sum over
        its leading dim (``einsum`` would flatten its sharded dims, which
        DTensor cannot view back)."""
        from torch.distributed.tensor import DTensor
        w = weights.float()

        def mix(x):
            if isinstance(x, DTensor):
                wb = w.reshape((-1,) + (1,) * (x.dim() - 1))
                return (wb * x.float()).sum(dim=0).to(x.dtype)
            return torch.einsum("i,i...->...", w, x.float()).to(x.dtype)
        return {k: mix(x) for k, x in stacked_params.items()}

    def _mixing_weights(self, stacked_params, mix_batch, self_idx):
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
        return HTLTrainer._token_entropies(tokens[None], nbins)[0]

    @staticmethod
    def _token_entropies(tokens, nbins: int = 256):
        """:meth:`_token_entropy` of every DC's tokens (L, ...) -> (L,), in
        one pass (under a mesh each pod keeps its rows)."""
        idx = (tokens % nbins).reshape(tokens.shape[0], -1).long()
        counts = torch.zeros((tokens.shape[0], nbins), dtype=torch.long,
                             device=idx.device).scatter_add_(
            1, idx, torch.ones_like(idx)).float()
        p = counts / torch.clamp(counts.sum(dim=-1, keepdim=True), min=1.0)
        return -torch.sum(torch.where(p > 0, p * torch.log(p), 0.0), dim=-1)

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
        params = {k: _gather_hypotheses(v) for k, v in state.params.items()}
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
            ent = _by_collector(self._token_entropies,
                                mix_batches["tokens"])
            center = torch.argmax(ent)           # stays on the device
            w = self._mixing_weights(params, _pick(mix_batches, center),
                                     center)
            new = self._mix(params, w)
        for k, x in state.params.items():
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
