#!/usr/bin/env python
"""How far one MLA decode step lands from a full prefill, in the JAX
package and in the port, at an MLA architecture's full width, on the CPU.

    PYTHONPATH=src python scripts/mla_rope_cache.py [--arch minicpm3-4b]
        [--layers 2] [--prompt 128]

The reference's prefill caches MLA's shared rope key before RoPE, while
its absorbed decode reads every cached key as rotated; the port caches
the rotated key (ROADMAP Queue 3). Both packages build the architecture
at full width with ``--layers`` layers in float32 (MoE configs with 8
experts, at capacity factor 8, so that no assignment is dropped), the
port on the reference's weights; each prefills ``prompt + 1`` tokens, and
separately the first ``prompt`` and one decode step. Prints one JSON line
of relative logit errors (max |a - b| / max |b|, as
``tests/test_decode_equivalence.py``'s ``_err``). At reduced width the
rope key's share of the scores is small, which is why the reference's
own test (5e-3) passes.
"""
import argparse
import dataclasses
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))


def cut(cfg, layers):
    kw = dict(num_layers=layers, dtype="float32")
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=8, first_k_dense=min(1, layers - 1),
            capacity_factor=8.0)
        kw["num_mtp_modules"] = 0
    return dataclasses.replace(cfg, **kw)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="minicpm3-4b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--prompt", type=int, default=128)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from repro.checkpoint.checkpointer import _path_str
    from repro.configs import get_config as j_config
    from repro.models import build_model as j_build
    from repro.serving import pad_cache as j_pad
    from repro_torch.configs import get_config as t_config
    from repro_torch.core.convert import lm_from_reference
    from repro_torch.serving import pad_cache as t_pad

    S = args.prompt
    jc = cut(j_config(args.arch), args.layers)
    jm = j_build(jc)
    params = jm.init(jax.random.PRNGKey(0))
    arrays = {_path_str(p): np.asarray(leaf) for p, leaf in
              jax.tree_util.tree_flatten_with_path(params)[0]}
    tm = lm_from_reference(cut(t_config(args.arch), args.layers), arrays,
                           device="cpu")
    toks = np.random.default_rng(3).integers(
        0, jc.vocab_size, (1, S + 1)).astype(np.int32)

    full, _ = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(toks)})
    _, cache = jax.jit(jm.prefill)(params,
                                   {"tokens": jnp.asarray(toks[:, :S])})
    inc, _ = jax.jit(jm.decode_step)(params, j_pad(jm, cache, 1, 1, S),
                                     jnp.asarray(toks[:, S:]),
                                     jnp.asarray(S, jnp.int32))
    t_toks = torch.from_numpy(toks)
    t_full, _ = tm.prefill({"tokens": t_toks})
    _, t_cache = tm.prefill({"tokens": t_toks[:, :S]})
    t_inc, _ = tm.decode_step(t_pad(tm, t_cache, 1, 1, S), t_toks[:, S:], S)

    def err(a, b):
        a, b = np.asarray(a), np.asarray(b)
        return float(np.abs(a - b).max() / np.abs(b).max())

    print(json.dumps({
        "arch": args.arch, "layers": args.layers, "prompt": S,
        "d_model": jc.d_model, "device": "cpu (float32)",
        "reference_decode_vs_prefill": err(inc, full),
        "port_decode_vs_prefill": err(t_inc.numpy(), t_full.numpy()),
        "port_vs_reference_prefill": err(t_full.numpy(), full)}),
        flush=True)


if __name__ == "__main__":
    main()
