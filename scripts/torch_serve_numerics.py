#!/usr/bin/env python
"""How far bfloat16 serving drifts from float32 on the card, to set the
bounds that ``chip_smoke.py``'s serve phase holds the flash kernel and
decode to.

    python scripts/torch_serve_numerics.py [--batch 4] [--prompt 2048]

llama3.2-3b at full width and depth, weights from the port's seeded
initialiser in bfloat16, and a float32 twin holding the same values.
For each dtype it computes prefill logits with the flash kernel and with
the plain version swapped in, and one-step decode logits against the
cache of the first ``prompt - 1`` tokens; it prints one JSON line of
relative logit errors (max |a - b| / max |b|, as
``tests/test_decode_equivalence.py``'s ``_err``) between them. Needs a
CUDA device; imports neither JAX nor ``repro``.
"""
import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import torch  # noqa: E402


def logits(model, batch, S):
    """(prefill with the kernel, prefill with the plain version, one-step
    decode after S - 1 tokens) last-position logits, as float32."""
    from chip_smoke import PlainAttention
    from repro_torch.serving import pad_cache

    kern, _ = model.prefill(batch)
    with PlainAttention():
        plain, _ = model.prefill(batch)
    B = batch["tokens"].shape[0]
    _, cache = model.prefill({"tokens": batch["tokens"][:, :S - 1]})
    cache = pad_cache(model, cache, 1, B, S - 1)
    dec, _ = model.decode_step(cache, batch["tokens"][:, S - 1:], S - 1)
    return kern.float(), plain.float(), dec.float()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=2048)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_serve_numerics: needs a CUDA device")

    from chip_smoke import rel_err
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_lm_batch
    from repro_torch.models import build_model

    cfg = get_config(args.arch)
    m16 = build_model(cfg).init(seed=0)
    batch = make_lm_batch(cfg.vocab_size, args.batch, args.prompt, seed=0)
    k16, p16, d16 = logits(m16, batch, args.prompt)
    m32 = build_model(cfg, dtype=torch.float32)
    m32.load_state_dict(m16.state_dict())          # casts bf16 -> f32
    del m16
    k32, p32, d32 = logits(m32, batch, args.prompt)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({
        "arch": args.arch, "batch": args.batch, "prompt": args.prompt,
        "nvidia_smi": smi, "max_abs_logit_f32": float(p32.abs().max()),
        "bf16_kernel_vs_bf16_plain": rel_err(k16, p16),
        "bf16_kernel_vs_f32_plain": rel_err(k16, p32),
        "bf16_plain_vs_f32_plain": rel_err(p16, p32),
        "f32_kernel_vs_f32_plain": rel_err(k32, p32),
        "bf16_decode_vs_bf16_kernel": rel_err(d16, k16),
        "bf16_decode_vs_f32_plain": rel_err(d16, p32),
        "f32_decode_vs_f32_kernel": rel_err(d32, k32)}), flush=True)


if __name__ == "__main__":
    main()
