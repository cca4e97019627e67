"""Serving launcher of the port (port of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-72b --shape decode_32k
        traces decode_step under the production mesh (as the dry-run does,
        with weight-stationary decode rules) and prints the record
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b --run
        runs a reduced-config batched generation on the card
        (``--device cpu`` runs it on the CPU)

Without ``--run`` the process becomes rank 0 of a fake world
(:func:`repro_torch.launch.dryrun.run_combo`), so run it as its own
process.
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
    ap.add_argument("--out", default=None,
                    help="where the traced record is written (default "
                         "results/dryrun_torch)")
    args = ap.parse_args(argv)

    if not args.run:
        import json

        from repro_torch.launch import dryrun
        rec = dryrun.run_and_save(args.arch, args.shape, args.mesh,
                                  args.out or dryrun.RESULTS_DIR,
                                  weight_stationary_decode=True)
        print(json.dumps(rec, indent=1))
        return rec

    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_lm_batch
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine

    dev = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    model = build_model(cfg, device=dev).init(seed=0)
    batch = make_lm_batch(
        cfg.vocab_size, 2, 32, d_model=cfg.d_model,
        frontend_tokens=(cfg.frontend.num_tokens
                         if cfg.family == "vlm" else 0),
        encoder_len=(cfg.encoder_seq_len if cfg.family == "audio" else 0),
        device=dev)
    out = ServeEngine(model, max_new_tokens=8).generate(batch)
    print("generated:", out.tolist())
    return out


if __name__ == "__main__":
    main()
