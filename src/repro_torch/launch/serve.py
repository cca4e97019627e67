"""Serving launcher of the port (port of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b --run
        runs a reduced-config batched generation on the card
        (``--device cpu`` runs it on the CPU)

The reference's other path lowers ``decode_step`` ahead of time under a
512-device mesh; the port has no mesh yet, so without ``--run`` this
raises, naming ROADMAP Queue 1 item 10.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="decode_32k",
                    choices=["decode_32k", "long_500k", "prefill_32k"])
    ap.add_argument("--run", action="store_true",
                    help="run a reduced local generation instead of lowering")
    ap.add_argument("--mesh", default="pod1", choices=["pod1", "pod2"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if not args.run:
        raise NotImplementedError(
            "ahead-of-time lowering under the production mesh is not ported "
            "yet: ROADMAP Queue 1 item 10 (mesh, dry-run and roofline)")

    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_lm_batch
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine

    dev = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    model = build_model(cfg, device=dev).init(seed=0)
    batch = make_lm_batch(cfg.vocab_size, 2, 32, d_model=cfg.d_model,
                          device=dev)
    out = ServeEngine(model, max_new_tokens=8).generate(batch)
    print("generated:", out.tolist())
    return out


if __name__ == "__main__":
    main()
