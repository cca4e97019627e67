#!/usr/bin/env python
"""How far bfloat16 serving drifts from float32 on the card, to set the
bounds that ``chip_smoke.py``'s serve phases hold the kernels and decode
to.

    python scripts/torch_serve_numerics.py [--arch llama3.2-3b]
        [--batch 4] [--prompt 2048]

The model (``--arch``: llama3.2-3b, mamba2-1.3b or recurrentgemma-9b) at
full width and depth, weights from the port's seeded initialiser in
bfloat16, and a float32 twin holding the same values. For each dtype it
computes prefill logits with the kernels and with their plain versions
swapped in, and the logits of a prefill of ``prompt + 1`` tokens against
a prefill of the first ``prompt`` and one decode step; it prints one JSON
line of relative logit errors (max |a - b| / max |b|, as
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


def logits(model, batch, chk):
    """(prefill with the kernels, prefill with the plain versions, full
    prefill of ``chk``, prefill of all but its last token plus one decode
    step) last-position logits, as float32."""
    from chip_smoke import PlainKernels, decode_vs_prefill

    kern, _ = model.prefill(batch)
    with PlainKernels():
        plain, _ = model.prefill(batch)
    full, dec = decode_vs_prefill(model, chk)
    return kern.float(), plain.float(), full.float(), dec.float()


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
    chk = make_lm_batch(cfg.vocab_size, args.batch, args.prompt + 1,
                        seed=2)["tokens"]
    k16, p16, f16, d16 = logits(m16, batch, chk)
    m32 = build_model(cfg, dtype=torch.float32)
    m32.load_state_dict(m16.state_dict())          # casts bf16 -> f32
    del m16
    k32, p32, f32, d32 = logits(m32, batch, chk)
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
        "bf16_decode_vs_bf16_prefill": rel_err(d16, f16),
        "bf16_prefill_vs_f32_prefill": rel_err(f16, f32),
        "bf16_decode_vs_f32_prefill": rel_err(d16, f32),
        "f32_decode_vs_f32_prefill": rel_err(d32, f32)}), flush=True)


if __name__ == "__main__":
    main()
