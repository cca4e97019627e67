#!/usr/bin/env python
"""What one AdamW step does to a full-width model on the card, to tell a
wrong gradient from a step that is too large for the model's width.

    python scripts/torch_train_probe.py [--arch llama3.2-3b] [--batch 4]
        [--seq 2048] [--lrs 1e-6,5e-6,2e-5,5e-5] [--peaks 1e-3,1e-4,1e-5]

The model (``--arch``) at full width and depth, in its config's dtype and
``remat``, weights from the port's seeded initialiser, batches from
``TokenStream`` (seed 0), as ``chip_smoke.py``'s ``train`` phase. Prints
one JSON line per part, in this order:

* ``one_step``: from the same weights, one step of ``make_train_step`` at
  each constant learning rate of ``--lrs``, then the loss on that step's
  batch and on a held-out batch (no gradient);
* ``schedule``: ``chip_smoke``'s 8 steps under ``train_loop``'s schedule
  (20 warmup steps, cosine over 8) at each peak lr of ``--peaks``, the
  per-step losses and gnorms;
* ``breakdown``: one step split by synchronised host clocks (forward,
  forward and backward, the AdamW update) and one step under
  ``torch.profiler``: device kernel time and the 20 kernels that take
  the most of it;
* ``gradient``: the loss's gradient against a float32 twin holding the
  same weights, per leaf the cosine similarity and the norm ratio, and
  the float32 loss after a plain gradient step of 1e-3 / |g| (it must
  fall if the gradient points downhill).

Needs a CUDA device; imports neither JAX nor ``repro``.
"""
import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import torch  # noqa: E402


def flat_grads(model, batch):
    """{path: gradient} (stacked leaves stacked) of the loss on batch."""
    model.requires_grad_(True)
    total, _ = model.loss_fn(batch)
    leaves = model.param_tree()
    params = [t for v in leaves.values()
              for t in (v if isinstance(v, list) else [v])]
    grads = iter(torch.autograd.grad(total, params))
    out = {k: (torch.stack([next(grads) for _ in v]) if isinstance(v, list)
               else next(grads)) for k, v in leaves.items()}
    return float(total.detach()), out


@torch.no_grad()
def loss_of(model, batch):
    return float(model.loss_fn(batch)[0])


def timed(fn):
    """(result, seconds) of ``fn()`` between two synchronisations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def breakdown(model, batch):
    """The ``breakdown`` line: one step split by synchronised host clocks
    (the loss forward alone, forward and backward, the AdamW update
    alone), then one whole step under ``torch.profiler``: its device
    kernel time and the kernels that take the most of it."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.launch.train import make_train_step
    from repro_torch.optim import adamw_init, adamw_update

    cfg = OptimizerConfig(lr=1e-5, warmup_steps=0, total_steps=1,
                          min_lr_ratio=1.0)
    step = make_train_step(model, cfg)
    opt = adamw_init(model.param_tree())
    opt, _ = step(opt, batch, 0)                      # warm-up
    _, fwd_s = timed(lambda: loss_of(model, batch))

    def fwd_bwd():
        total, _ = model.loss_fn(batch)
        total.backward()
    _, fwd_bwd_s = timed(fwd_bwd)
    params = model.param_tree()
    grads = {k: [t.grad for t in v] if isinstance(v, list) else v.grad
             for k, v in params.items()}
    _, opt_s = timed(lambda: adamw_update(grads, opt, params, 1e-5, cfg))
    model.zero_grad(set_to_none=True)
    del grads
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, step_s = timed(lambda: step(opt, batch, 1))
    kernels = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n, us = kernels.get(e.name, (0, 0.0))
            kernels[e.name] = (n + 1, us + e.time_range.elapsed_us())
    total_us = sum(us for _, us in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:20]
    return {"part": "breakdown", "forward_s": fwd_s,
            "forward_backward_s": fwd_bwd_s, "adamw_s": opt_s,
            "profiled_step_s": step_s, "device_kernel_s": total_us / 1e6,
            "kernel_launches": sum(n for n, _ in kernels.values()),
            "top_kernels": [{"name": k[:120], "calls": n, "ms": us / 1e3,
                             "share": us / total_us}
                            for k, (n, us) in top]}


def gradient_part(model, cfg, batch, init):
    """The ``gradient`` line: ``model``'s gradient on ``batch`` against a
    float32 twin loaded with ``init`` (its weights)."""
    from repro_torch.models import build_model

    loss, g = flat_grads(model, batch)
    twin = build_model(cfg, dtype=torch.float32)
    twin.load_state_dict(init)
    loss32, g32 = flat_grads(twin, batch)
    leaves = {}
    for k in g:
        a, b = g[k].float().flatten(), g32[k].flatten()
        leaves[k] = {"cos": float(a @ b / (a.norm() * b.norm() + 1e-30)),
                     "norm_ratio": float(a.norm() / (b.norm() + 1e-30))}
    del g
    gn = torch.sqrt(sum(v.square().sum() for v in g32.values()))
    with torch.no_grad():
        for k, v in twin.param_tree().items():
            for t, gt in zip(v if isinstance(v, list) else [v],
                             g32[k] if isinstance(v, list) else [g32[k]]):
                t.sub_(1e-3 / gn * gt)
    return {"part": "gradient", "loss": loss, "loss_f32": loss32,
            "loss_f32_after_descent_step": loss_of(twin, batch),
            "gnorm_f32": float(gn),
            "min_cos": min(v["cos"] for v in leaves.values()),
            "leaves": leaves}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--lrs", default="1e-6,5e-6,2e-5,5e-5")
    ap.add_argument("--peaks", default="1e-3,1e-4,1e-5")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_train_probe: needs a CUDA device")

    from chip_smoke import TRAIN_STEPS, nvidia_smi_line
    from repro_torch.configs import get_config
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init

    print(nvidia_smi_line(), flush=True)
    cfg = get_config(args.arch)
    it = TokenStream(cfg.vocab_size, seed=0).batches(args.batch, args.seq)
    batches = [next(it) for _ in range(TRAIN_STEPS + 1)]
    held_out = batches[-1]
    model = build_model(cfg).init(seed=0)
    # the initial weights, kept on the host (the card holds the model,
    # its optimizer state and a step's transients)
    init = {k: v.detach().to("cpu", copy=True)
            for k, v in model.state_dict().items()}

    def reset():
        with torch.no_grad():
            for k, v in model.state_dict().items():
                v.copy_(init[k])

    # one step from the same weights at constant learning rates
    rows = []
    for lr in [float(x) for x in args.lrs.split(",")]:
        reset()
        step = make_train_step(model, OptimizerConfig(
            lr=lr, warmup_steps=0, total_steps=1, min_lr_ratio=1.0))
        opt = adamw_init(model.param_tree())
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        opt, m = step(opt, batches[0], 0)
        rows.append({"lr": lr, "allocated_before_bytes": before,
                     "peak_bytes": torch.cuda.max_memory_allocated(),
                     "loss_before": float(m["loss"]),
                     "gnorm": float(m["gnorm"]),
                     "loss_after_same_batch": loss_of(model, batches[0]),
                     "loss_after_held_out": loss_of(model, held_out)})
        del step, m, opt
        gc.collect()
    reset()
    rows.append({"lr": 0.0, "loss_held_out_at_init": loss_of(model,
                                                             held_out)})
    print(json.dumps({"part": "one_step", "rows": rows}), flush=True)

    # chip_smoke's 8 steps under train_loop's schedule at each peak lr
    for peak in [float(x) for x in args.peaks.split(",")]:
        reset()
        step = make_train_step(model, OptimizerConfig(
            lr=peak, warmup_steps=20, total_steps=TRAIN_STEPS))
        opt = adamw_init(model.param_tree())
        losses, gnorms = [], []
        for i, b in enumerate(batches[:TRAIN_STEPS]):
            opt, m = step(opt, b, i)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["gnorm"]))
        print(json.dumps({"part": "schedule", "peak_lr": peak,
                          "losses": losses, "gnorms": gnorms,
                          "loss_after_held_out": loss_of(model, held_out)}),
              flush=True)
        del step, opt
        gc.collect()

    print(json.dumps(breakdown(model, batches[0])), flush=True)
    gc.collect()

    # last: the float32 twin needs the card's memory that the optimizer
    # state held
    reset()
    print(json.dumps(gradient_part(model, cfg, batches[0], init)),
          flush=True)


if __name__ == "__main__":
    main()
