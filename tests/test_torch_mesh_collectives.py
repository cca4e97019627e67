"""The port's manual regions on a real process group: the expert-parallel
MoE FFN (``models.blocks.moe_ffn_shard_map``) and the HTL trainer's
pod-wise local phase (``core.htl_trainer.HTLTrainer.local_phase_podwise``)
against their unsharded counterparts, each rank a ``gloo`` process on the
CPU (a file store in a temporary directory: no network).

Bounds: the MoE output within the reference's 1e-5 of ``moe_ffn`` (its
aux loss within 1e-6: ``tests/test_moe_shard_map.py``), on a (2, 4)
("data", "model") mesh of 8 processes, olmoe-1b-7b reduced with 8 experts,
top-2 and capacity factor 8. The pod-wise phase on a (2, 1, 1) ("pod",
"data", "model") mesh of 2 processes: every rank's rows of the
parameters, within PR 22's HTL bar (1e-5 of each leaf's max plus 1% of
the summed learning rates: ``tests/test_torch_htl_trainer.py``), its
moments within 1e-4 of the leaf's max, its losses within 1e-5 relative,
against the local phase run on the whole state in the same process.
"""
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(__file__), "..")

PRELUDE = r"""
import dataclasses, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                        world_size=world)
from torch.distributed.device_mesh import init_device_mesh
"""

MOE = PRELUDE + r"""
from repro_torch.configs import get_config
from repro_torch.models.blocks import moe_ffn, moe_ffn_shard_map, moe_template
from repro_torch.sharding.partitioning import init_params, use_compute_mesh
mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
cfg = get_config("olmoe-1b-7b").reduced()
cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
    cfg.moe, num_experts=8, top_k=2, capacity_factor=8.0))
p = init_params(moe_template(cfg), seed=0, device="cpu")
x = torch.from_numpy(np.random.default_rng(1).normal(
    size=(4, 32, cfg.d_model)).astype(np.float32))
y_ref, aux_ref = moe_ffn(p, x, cfg)
with use_compute_mesh(mesh):
    y_sm, aux_sm = moe_ffn_shard_map(p, x, cfg)
err = float((y_ref - y_sm).abs().max())
aerr = abs(float(aux_ref) - float(aux_sm))
assert err < 1e-5, err
assert aerr < 1e-6, aerr
print("OK", rank, err, aerr)
dist.destroy_process_group()
"""

PODWISE = PRELUDE + r"""
from repro_torch.configs import get_config
from repro_torch.configs.base import HTLConfig, OptimizerConfig
from repro_torch.core.htl_trainer import HTLTrainer
from repro_torch.models import build_model
L, H, B, S = 2, 3, 2, 32
cfg = dataclasses.replace(get_config("llama3.2-3b").reduced(), num_layers=2,
                          d_model=64, num_heads=2, num_kv_heads=2,
                          head_dim=32, d_ff=128, vocab_size=256)
opt = OptimizerConfig(lr=3e-3, warmup_steps=2, total_steps=50)
tr = HTLTrainer(build_model(cfg, device="cpu"), opt,
                HTLConfig(mode="a2a", num_collectors=L, local_steps=H))
toks = torch.from_numpy(np.random.default_rng(7).integers(
    0, cfg.vocab_size, (H, L, B, S + 1)).astype(np.int32))
batches = {"tokens": toks[..., :-1], "targets": toks[..., 1:]}
mesh = init_device_mesh("cpu", (2, 1, 1),
                        mesh_dim_names=("pod", "data", "model"))
want_state, want = tr.local_phase(tr.init(0), batches)
got_state, got = tr.local_phase_podwise(tr.init(0), batches, mesh)
pod = mesh.get_local_rank("pod")
lr_sum = float(sum(tr._sched(torch.tensor(s)) for s in range(H)))
assert got.shape == (1, H)
torch.testing.assert_close(got[0], want[:, pod], rtol=1e-5, atol=0)
for k in want_state.params:
    w, g = want_state.params[k][pod], got_state.params[k][pod]
    bound = 1e-5 * float(w.abs().max()) + 1e-2 * lr_sum
    assert float((w - g).abs().max()) <= bound, k
    for name in ("mu", "nu"):
        wm = getattr(want_state.opt, name)[k][pod]
        gm = getattr(got_state.opt, name)[k][pod]
        assert float((wm - gm).abs().max()) <= 1e-4 * float(
            wm.abs().max()) + 1e-12, (k, name)
assert int(got_state.opt.count) == int(want_state.opt.count) == H
assert int(got_state.step) == H
print("OK", rank)
dist.destroy_process_group()
"""


def _run_world(script, world, tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    store = str(tmp_path / "store")
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r),
                               str(world), store], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(world)]
    outs = [p.communicate(timeout=300) for p in procs]
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}: {err[-2000:]}"
        assert f"OK {r}" in out, out


def test_moe_shard_map_matches_moe_ffn_on_eight_ranks(tmp_path):
    _run_world(MOE, 8, tmp_path)


def test_local_phase_podwise_matches_local_phase_on_two_pods(tmp_path):
    _run_world(PODWISE, 2, tmp_path)
