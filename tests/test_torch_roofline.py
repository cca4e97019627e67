"""The port's roofline (``repro_torch.roofline``) against the JAX
package's, and the traced cost of a step.

Parity (exact, the reference's ``HW`` numbers handed to the port's
``Hardware``: its ICI rate as the fast link, its DCN rate as the slow
one): ``roofline_from_record``, ``model_flops_for`` and
``analytic_memory_bytes`` on every arch x shape. ``analyze_trace`` on a
synthetic program (``tests/test_roofline.py:test_analyze_synthetic_hlo``'s
program: 10 looped matmuls plus one, an all-reduce in a group inside a
pod, an all-gather across pods) in a 512-rank fake world: FLOPs x11,
bytes by op and ``dcn_bytes`` exactly. A reduced llama prefill's traced
FLOPs equal 2 x (its layers' matmul parameters) x tokens, plus the head
at the last position, plus its layers' ``flash_cost`` FLOPs, exactly, on
either route.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import get_config as j_config
from repro.roofline import analysis as j_analysis
from repro_torch.configs import ALL_ARCHS, INPUT_SHAPES, get_config
from repro_torch.models import build_model
from repro_torch.roofline import analysis, costs, report
from repro_torch.roofline.trace import analyze_trace, region

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
J_HW = analysis.Hardware(peak_flops=j_analysis.HW.peak_flops,
                         hbm_bw=j_analysis.HW.hbm_bw,
                         nvlink_bw=j_analysis.HW.ici_bw,
                         ib_bw=j_analysis.HW.dcn_bw)


def _record(arch, shape, cfg, seed):
    """A dry-run record with made-up traced numbers (the same for both
    packages)."""
    n = 256 if seed % 2 else 512
    return {"arch": arch, "shape": shape, "num_devices": n,
            "flops": 1e12 * (seed + 1), "bytes_accessed": 3e11 * (seed + 2),
            "analytic_bytes": analysis.analytic_memory_bytes(
                cfg, INPUT_SHAPES[shape], n),
            "collectives": {"total_bytes": 2e10 * (seed + 1),
                            "dcn_bytes": 5e9 * seed},
            "model_flops": analysis.model_flops_for(cfg, INPUT_SHAPES[shape])}


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_roofline_terms_model_flops_and_bytes_equal_the_reference(arch):
    for seed, shape in enumerate(INPUT_SHAPES):
        cfg, jcfg = get_config(arch), j_config(arch)
        assert analysis.model_flops_for(cfg, INPUT_SHAPES[shape]) == \
            j_analysis.model_flops_for(jcfg, J_SHAPES[shape])
        for n in (1, 256, 512):
            assert analysis.analytic_memory_bytes(
                cfg, INPUT_SHAPES[shape], n) == \
                j_analysis.analytic_memory_bytes(jcfg, J_SHAPES[shape], n)
        rec = _record(arch, shape, cfg, seed)
        want = j_analysis.roofline_from_record(rec)
        assert analysis.roofline_from_record(rec, J_HW) == want
        # a port record: the pod-crossing bytes are the slow link's
        rec["collectives"]["internode_bytes"] = \
            rec["collectives"]["dcn_bytes"]
        assert analysis.roofline_from_record(rec, J_HW) == want


def test_roofline_terms_on_the_h100():
    hw = analysis.HW
    assert (hw.peak_flops, hw.hbm_bw, hw.nvlink_bw, hw.ib_bw) == \
        (989e12, 3.35e12, 450e9, 50e9)
    rec = {"num_devices": 256, "flops": 989e12, "bytes_accessed": 3.35e12,
           "analytic_bytes": 3.35e12,
           "collectives": {"total_bytes": 500e9, "dcn_bytes": 50e9,
                           "internode_bytes": 50e9},
           "model_flops": 989e12 * 256 * 0.5}
    out = analysis.roofline_from_record(rec)
    assert out["compute_s"] == pytest.approx(1.0)
    assert out["memory_s"] == pytest.approx(1.0)
    assert out["collective_s"] == pytest.approx(2.0)   # 450/450 + 50/50
    assert out["dominant"] == "collective"
    assert out["useful_fraction"] == pytest.approx(0.5)


SYNTH = r"""
import json
import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.launch.mesh import fake_world
from repro_torch.roofline.trace import analyze_trace
fake_world(512)
mesh = init_device_mesh("cpu", (2, 16, 16),
                        mesh_dim_names=("pod", "data", "model"))
in_pod, across = mesh.get_group("data"), mesh.get_group("pod")

def program(x, w, a, b):
    d0 = x @ w                                   # entry dot
    for _ in range(10):                          # the loop body, 10 trips
        d = a @ b
        funcol.wait_tensor(funcol.all_reduce(d, "sum", in_pod))
    return funcol.wait_tensor(funcol.all_gather_tensor(d0, 0, across))

args = [torch.zeros(s) for s in ((128, 256), (256, 64), (128, 256),
                                 (256, 64))]
print(json.dumps(analyze_trace(program, *args)))
"""


def test_analyze_trace_synthetic_program():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", SYNTH], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    a = json.loads(proc.stdout.strip().splitlines()[-1])
    dot_flops = 2 * 128 * 64 * 256
    assert a["flops"] == dot_flops * 11
    coll = a["collectives"]
    ar_bytes = 128 * 64 * 4
    assert coll["by_op"] == {"all-reduce": ar_bytes * 10,
                             "all-gather": 2 * ar_bytes}  # 2 ranks' rows
    assert coll["n_ops"] == 11
    assert coll["total_bytes"] == 12 * ar_bytes
    # only the pod group {0, 256} crosses pods; both groups span nodes
    assert coll["dcn_bytes"] == 2 * ar_bytes
    assert coll["internode_bytes"] == 12 * ar_bytes


@pytest.mark.parametrize("profiled", [False, True])
def test_region_counts_its_cost_once_and_none_of_its_ops(profiled):
    """Also under a profiler, where the region is the span
    ``repro_torch.mixer``: the same counts."""
    x, w = torch.zeros(8, 16), torch.zeros(16, 4)

    def fn():
        with region("mixer", (100.0, 1000.0)):
            for _ in range(3):
                x @ w
        x @ w
    if profiled:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            a = analyze_trace(fn)
        assert [e.name for e in prof.events()
                if e.name.startswith("repro_torch.")] == ["repro_torch.mixer"]
    else:
        a = analyze_trace(fn)
    assert a["flops"] == 1000.0 + 2 * 8 * 4 * 16
    assert a["regions"] == {"mixer": {"bytes": 100.0, "flops": 1000.0,
                                      "calls": 1}}
    with region("outside", lambda: 1 / 0):       # no trace: not called
        pass


def test_region_costs_are_the_kernel_counts():
    q, k = torch.zeros(2, 96, 4, 32), torch.zeros(2, 96, 2, 32)
    assert costs.attention_cost(q, k, causal=True, window=16) == \
        costs.flash_cost((2, 4, 2, 96, 96, 32, True, 16, 0, "float32"))
    x, bm = torch.zeros(2, 70, 4, 8, dtype=torch.bfloat16), \
        torch.zeros(2, 70, 16)
    assert costs.ssd_scan_cost(x, bm, 32) == \
        costs.ssd_cost((2, 70, 4, 8, 16, 32, "bfloat16"))
    assert costs.rglru_scan_cost(torch.zeros(3, 5, 7)) == \
        costs.rglru_cost((3, 5, 7))


@pytest.mark.parametrize("plain", [True, False])
def test_reduced_llama_prefill_flops_are_exact(plain):
    cfg = dataclasses.replace(get_config("llama3.2-3b").reduced(),
                              num_layers=3)
    # the plain route traces on meta tensors; the kernel route's wrappers
    # take CPU tensors (their plain versions) and refuse meta ones
    dev = "meta" if plain else "cpu"
    model = build_model(cfg, device=dev)
    if not plain:
        model.init(0)
    B, S = 2, 96
    tokens = torch.zeros(B, S, dtype=torch.int32, device=dev)
    a = analyze_trace(model.prefill, {"tokens": tokens}, plain=plain)
    layer = model.layers[0]
    mats = sum(t.numel() for name, t in layer.named_parameters()
               if t.dim() >= 2)
    head = cfg.d_model * cfg.vocab_size
    attn = costs.flash_cost((B, cfg.num_heads, cfg.num_kv_heads, S, S,
                             cfg.head_dim, True, 0, 0, "float32"))[1]
    want = cfg.num_layers * (2 * mats * B * S + attn) + 2 * head * B
    assert a["flops"] == want
    assert a["regions"]["attention"]["calls"] == cfg.num_layers


def test_report_reads_records_and_prints_the_table(tmp_path, capsys):
    recs = [dict(_record("llama3.2-3b", "decode_32k",
                         get_config("llama3.2-3b"), 1), mesh="pod1",
                 status="ok", hlo_flops=2e12, hlo_bytes_accessed=1e12),
            {"arch": "whisper-medium", "shape": "long_500k", "mesh": "pod1",
             "status": "skipped"}]
    for i, r in enumerate(recs):
        (tmp_path / f"r{i}.json").write_text(json.dumps(r))
    rows = report.main(["--dir", str(tmp_path), "--markdown"])
    out = capsys.readouterr().out
    assert len(rows) == 1 and "| llama3.2-3b | decode_32k | pod1 |" in out
    assert rows[0]["compute_s"] == 2e12 / analysis.HW.peak_flops
    assert rows[0]["memory_s"] == analysis.analytic_memory_bytes(
        get_config("llama3.2-3b"), INPUT_SHAPES["decode_32k"], 256) / \
        analysis.HW.hbm_bw
