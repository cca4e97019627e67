"""The port's dry-runs, each in its own process (the process becomes rank
0 of a fake world of 256 or 512 ranks, which cannot happen inside the
pytest process): ``repro_torch.launch.dryrun`` on one combo (the
counterpart of the reference's ``tests/test_dryrun_subprocess.py``), and
``repro_torch.launch.htl_dryrun`` on the two-pod mesh, where the
hypothesis-transfer round's traffic between pods must come in below the
synchronous baseline's at H = 4.
"""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                OMP_NUM_THREADS="1")


def test_dryrun_one_combo_subprocess(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "mamba2-1.3b", "--shape", "long_500k", "--mesh", "pod1", "--out",
         str(tmp_path)], env=_env(), capture_output=True, text=True,
        timeout=540)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    rec = json.load(open(tmp_path / "mamba2-1.3b_long_500k_pod1.json"))
    assert rec["status"] == "ok"
    assert rec["num_devices"] == 256
    assert rec["hlo_flops"] > 0 and rec["flops"] == rec["hlo_flops"]
    assert "collectives" in rec and rec["collectives"]["n_ops"] > 0
    # every layer's scan is counted by its region, once
    assert "ssd_scan" not in rec["regions"]     # decode runs no scan
    assert rec["model_flops"] == 2.0 * rec["active_param_count"]
    assert rec["memory"]["argument_size_in_bytes"] > 0


HTL = r"""
import json, sys
from repro_torch.launch import htl_dryrun
r = htl_dryrun.run_all(["sync", "star", "a2a"], 4, reduced=True, seq=64,
                       global_batch=64, podwise=True,
                       mixing_mode="loss_softmax")
print("RESULT", json.dumps(r))
"""


@pytest.mark.slow
def test_htl_round_crosses_pods_less_than_sync():
    """Reduced llama3.2-3b on the (2, 16, 16) mesh, the pod-wise local
    phase (no cross-pod collective by construction) and the first-order
    ``loss_softmax`` mixing (the reference's ``REPRO_MIXING`` option; a
    trace of the gradient mixing takes minutes longer): Star's and A2A's
    bytes across pods per round below sync training's over the same 4
    steps, and nothing crosses pods in the local phase."""
    proc = subprocess.run([sys.executable, "-c", HTL], env=_env(),
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT ")][-1]
    r = json.loads(line[len("RESULT "):])
    sync = r["sync"]["dcn_bytes_per_round"]
    assert sync > 0 and r["sync"]["total_bytes_per_round"] >= sync
    for mode in ("star", "a2a"):
        assert r[mode]["podwise"] and r[mode]["num_collectors"] == 2
        assert r[mode]["dcn_local"] == 0.0
        assert 0 < r[mode]["dcn_bytes_per_round"] < sync, (mode, r[mode])
        assert r[mode]["dcn_ratio_vs_sync"] == \
            r[mode]["dcn_bytes_per_round"] / sync


def test_one_hot_embedding_gives_the_gathers_logits():
    """``htl_dryrun``'s ``onehot_embed`` (the reference's
    ``embedding_impl="one_hot"``): a matmul with a one-hot matrix in place
    of the gather, the same prefill logits bit for bit."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_lm_batch
    from repro_torch.models import build_model

    cfg = get_config("llama3.2-3b").reduced()
    batch = make_lm_batch(cfg.vocab_size, 2, 16, device="cpu")
    gather = build_model(cfg, device="cpu").init(seed=0)
    onehot = build_model(dataclasses.replace(cfg, embedding_impl="one_hot"),
                         device="cpu").init(seed=0)
    assert torch.equal(onehot.prefill(batch)[0], gather.prefill(batch)[0])
