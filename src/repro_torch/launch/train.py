"""Training step factory and single-card training driver (port of
``repro.launch.train``).

    python -m repro_torch.launch.train --arch llama3.2-3b --full --steps 8
        trains llama3.2-3b at full width on the card (``--device cpu``
        runs on the CPU; without ``--full`` the reduced config)

:func:`make_train_step` builds the update that :func:`train_loop` and the
HTL trainer's examples run: the loss (the plain route of every mixer,
``cfg.remat`` honoured: :meth:`~repro_torch.models.model.Model.loss_fn`),
its gradients by autograd, then AdamW in place on the model's parameters.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import (checkpoint_step, load_train_state,
                                    save_checkpoint)
from repro_torch.configs.base import OptimizerConfig, get_config
from repro_torch.data.pipeline import TokenStream
from repro_torch.models.model import Model, build_model
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.optim.schedule import cosine_warmup_schedule


def make_train_step(model: Model, opt_cfg: OptimizerConfig):
    """``train_step(opt_state, batch, step) -> (opt_state, metrics)``:
    one AdamW step of ``model``'s parameters, which the factory makes
    trainable (``requires_grad``) and the step updates in place (the
    reference's step returns new parameters). ``step`` (int or tensor)
    sets the learning rate; metrics are the loss's plus ``gnorm`` (before
    clipping) and ``lr``, 0-d tensors on the model's device."""
    sched = cosine_warmup_schedule(opt_cfg)
    params = model.param_tree()
    model.requires_grad_(True)
    model.zero_grad(set_to_none=True)

    def grad(t):
        # a stacked group without layers is an empty placeholder that no
        # gradient reaches
        return torch.zeros_like(t) if t.grad is None else t.grad

    def train_step(opt_state, batch, step):
        total, metrics = model.loss_fn(batch)
        total.backward()
        del total
        grads = {k: [grad(t) for t in leaf] if isinstance(leaf, list)
                 else grad(leaf) for k, leaf in params.items()}
        lr = sched(step).to(model.device)
        _, opt_state, gnorm = adamw_update(grads, opt_state, params, lr,
                                           opt_cfg)
        model.zero_grad(set_to_none=True)
        return opt_state, dict(metrics, gnorm=gnorm, lr=lr)

    return train_step


def train_loop(arch: str, *, steps: int = 100, batch: int = 8,
               seq_len: int = 256, reduced: bool = True, seed: int = 0,
               log_every: int = 10, opt_cfg: OptimizerConfig = None,
               ckpt_dir: str = None, ckpt_every: int = 0, device="cuda"):
    """Single-card training loop (on the card unless ``device`` asks for
    the CPU). Weights are drawn from ``seed`` (the port's stream), tokens
    come from :class:`TokenStream`, and the vlm and audio inputs are
    zeros, as in the reference. With ``ckpt_dir`` set it saves parameters
    and optimizer state every ``ckpt_every`` steps and resumes from the
    latest checkpoint, reseeding the stream with ``seed + start`` as the
    reference does. Returns (the trained model, logged losses)."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, device=dev).init(seed)
    opt_cfg = opt_cfg or OptimizerConfig(lr=1e-3, warmup_steps=20,
                                         total_steps=steps)
    step_fn = make_train_step(model, opt_cfg)
    opt_state = adamw_init(model.param_tree())
    start = 0
    if ckpt_dir and checkpoint_step(ckpt_dir) is not None:
        opt_state, start = load_train_state(ckpt_dir, model)
        print(f"resumed from step {start}")

    it = TokenStream(cfg.vocab_size, seed=seed + start).batches(
        batch, seq_len, device=dev)
    history = []
    t0 = time.time()
    for i in range(start, steps):
        b = next(it)
        if cfg.family == "vlm":
            b["frontend_embeds"] = torch.zeros(
                (batch, cfg.frontend.num_tokens, cfg.d_model), device=dev)
        if cfg.family == "audio":
            b["encoder_embeds"] = torch.zeros(
                (batch, cfg.encoder_seq_len, cfg.d_model), device=dev)
        opt_state, m = step_fn(opt_state, b, i)
        if (i + 1) % log_every == 0 or i == start:
            loss = float(m["loss"])
            history.append(loss)
            print(f"step {i + 1:5d} loss {loss:.4f} "
                  f"({(time.time() - t0) / (i - start + 1) * 1e3:.0f} "
                  f"ms/step)")
        if ckpt_dir and ckpt_every and (i + 1) % ckpt_every == 0:
            save_checkpoint(ckpt_dir, {"params": model.param_tree(),
                                       "opt": opt_state}, step=i + 1)
    return model, history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--full", action="store_true",
                    help="use the full (non-reduced) config")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return train_loop(args.arch, steps=args.steps, batch=args.batch,
                      seq_len=args.seq_len, reduced=not args.full,
                      device=args.device)


if __name__ == "__main__":
    main()
