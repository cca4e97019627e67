"""The port stands alone: importing every module of ``repro_torch`` and
``chip_smoke``'s helpers loads neither JAX nor the JAX package ``repro``
(checked in a fresh interpreter), and the port's entry points default to
CUDA and refuse to fall back to the CPU quietly."""
import dataclasses
import json
import math
import os
import pkgutil
import subprocess
import sys
import tempfile
import types

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SRC = os.path.join(ROOT, "src")


def _port_modules():
    import repro_torch

    names = ["repro_torch"]
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(info.name)
    return names


def test_port_modules_import_without_jax_or_repro():
    names = _port_modules()
    assert {"repro_torch.core.greedytl", "repro_torch.core.convert",
            "repro_torch.kernels.loo_trials",
            "repro_torch.data.mobility", "repro_torch.configs",
            "repro_torch.sharding.partitioning", "repro_torch.data.pipeline",
            "repro_torch.kernels.flash_attention",
            "repro_torch.models.blocks", "repro_torch.models.model",
            "repro_torch.serving.cache_utils", "repro_torch.serving.engine",
            "repro_torch.serving.scheduler", "repro_torch.launch.serve",
            "repro_torch.checkpoint.checkpointer",
            "repro_torch.kernels.ssd_scan", "repro_torch.kernels.rglru_scan",
            "repro_torch.models.ssd", "repro_torch.models.rglru",
            "repro_torch.configs.mamba2_1_3b",
            "repro_torch.configs.recurrentgemma_9b",
            "repro_torch.configs.minicpm3_4b",
            "repro_torch.configs.olmoe_1b_7b",
            "repro_torch.configs.deepseek_v3_671b",
            "repro_torch.configs.llava_next_mistral_7b",
            "repro_torch.configs.whisper_medium",
            "repro_torch.core.cityscan",
            "repro_torch.configs.covtype_htl",
            "repro_torch.core.parallel", "repro_torch.core.launcher",
            "repro_torch.core.pareto", "repro_torch.service",
            "repro_torch.service.statsd", "repro_torch.service.cache",
            "repro_torch.service.server",
            "repro_torch.service.client", "repro_torch.optim",
            "repro_torch.optim.adamw", "repro_torch.optim.schedule",
            "repro_torch.launch.train",
            "repro_torch.core.htl_trainer", "repro_torch.launch.mesh",
            "repro_torch.launch.specs", "repro_torch.launch.validate",
            "repro_torch.launch.dryrun", "repro_torch.launch.htl_dryrun",
            "repro_torch.roofline", "repro_torch.roofline.costs",
            "repro_torch.roofline.trace", "repro_torch.roofline.analysis",
            "repro_torch.roofline.report"} <= set(names)
    code = "\n".join(
        ["import importlib, sys"]
        + [f"importlib.import_module({n!r})" for n in names]
        + ["import chip_smoke",
           "from chip_smoke import kernel_inputs, kernel_cost, compare",
           "from chip_smoke import (flash_inputs, flash_cost, flash_pairs,",
           "    PrefillTally, PlainKernels, batcher_requests,",
           "    reduced_card_vs_cpu, phase_flash, phase_serve, phase_ssd,",
           "    phase_rglru, ssd_inputs, ssd_cost, rglru_inputs,",
           "    rglru_cost, decode_vs_prefill, kernel_shares_of_prefill,",
           "    phase_scan_parity, phase_paper_scan, phase_city,",
           "    small_city_card_vs_cpu, city_ledger_mismatches,",
           "    city_learning_counts, pair_counts, ShapeLog,",
           "    normalised_json, lm_batch, cache_len, serve_config)",
           "from chip_smoke import (phase_orchestration, phase_backends,",
           "    phase_hosts, phase_service, phase_pareto, PARETO_SEARCHES)",
           "from chip_smoke import (phase_train, phase_train_card_vs_cpu,",
           "    phase_train_resume, phase_htl, train_card_vs_cpu,",
           "    htl_config)",
           "bad = sorted(m for m in sys.modules",
           "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))",
           "assert not bad, bad",
           "print('clean', len(sys.modules))"])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, ROOT]))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")


def test_entry_points_default_to_cuda(monkeypatch):
    from repro_torch import resolve_device
    from repro_torch.core import experiment, scenario, svm
    from repro_torch.core.pareto import get_search
    from repro_torch.service.server import SweepService
    from repro_torch.data.synthetic_covtype import make_covtype_like

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((8, 54), np.float32)
    y = np.zeros(8, np.int32)
    m = np.ones(8, np.float32)
    data = make_covtype_like(n_total=700, seed=0)
    cfg = scenario.ScenarioConfig(windows=1)
    calls = [
        lambda: svm.train_svm(x, y, m, num_classes=7),
        lambda: svm.train_svm_fleet(x[None], y[None], m[None],
                                    num_classes=7),
        lambda: scenario.run_scenario(cfg, data),
        lambda: scenario.run_sweep([cfg], data),
        lambda: experiment.get_preset("smoke", windows=1,
                                      n_seeds=1).run(data),
        lambda: experiment.get_preset("smoke", windows=1, n_seeds=1).run(
            data, parallel="processes:n=2"),
        lambda: experiment.get_preset("smoke", windows=1, n_seeds=1).run(
            data, parallel="hosts:channel=inline,n=2"),
        lambda: get_search("exhaustive").run(
            experiment.get_preset("smoke", windows=1, n_seeds=1), data),
        lambda: SweepService(),
        lambda: resolve_device("cuda:0"),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert svm.train_svm(x, y, m, num_classes=7, iters=2,
                         device="cpu").shape == (55, 7)


def test_scan_and_city_entry_points_default_to_cuda(monkeypatch):
    from repro_torch.core import cityscan, experiment, scenario
    from repro_torch.data.synthetic_covtype import make_covtype_like

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = make_covtype_like(n_total=700, seed=0)
    scan = scenario.ScenarioConfig(windows=1, engine="scan")
    city = scenario.ScenarioConfig(windows=1, engine="scan", fleet_size=40,
                                   train_iters=5)
    calls = [
        lambda: scenario.run_scenario(scan, data),
        lambda: scenario.run_scenario(city, data),
        lambda: cityscan.run_scenario_scan(scan, data),
        lambda: cityscan.run_city(city, data),
        lambda: cityscan.run_city_perwindow(city, data),
        lambda: experiment.get_preset("city", fleet_size=40,
                                      windows=1).run(data),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_package_turns_tf32_off():
    import repro_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_serving_entry_points_default_to_cuda(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.core.convert import lm_from_reference
    from repro_torch.data.pipeline import TokenStream, make_lm_batch
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine
    from repro_torch.serving.scheduler import ContinuousBatcher

    cfg = get_config("llama3.2-3b").reduced()
    cpu_model = build_model(cfg, device="cpu").init(0)
    cuda = torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: build_model(cfg),
        lambda: lm_from_reference(cfg, {}),
        lambda: make_lm_batch(cfg.vocab_size, 1, 4),
        lambda: next(TokenStream(cfg.vocab_size).batches(1, 4)),
        lambda: serve.main(["--arch", "llama3.2-3b", "--run"]),
        lambda: serve.main(["--arch", "mamba2-1.3b", "--run"]),
        lambda: serve.main(["--arch", "recurrentgemma-9b", "--run"]),
        # a model that lives on the card (stand-in: no card here)
        lambda: ServeEngine(types.SimpleNamespace(device=cuda)),
        lambda: ContinuousBatcher(types.SimpleNamespace(device=cuda)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    # asking for the CPU works everywhere
    for arch in ("llama3.2-3b", "mamba2-1.3b", "recurrentgemma-9b",
                 "minicpm3-4b", "olmoe-1b-7b", "deepseek-v3-671b",
                 "llava-next-mistral-7b", "whisper-medium"):
        out = serve.main(["--arch", arch, "--run", "--device", "cpu"])
        assert tuple(out.shape) == (2, 8)
    assert ContinuousBatcher(cpu_model, slots=2).slots == 2
    # without --run: decode_step traced on the production mesh (a fake
    # world of 256 ranks, its own process)
    with tempfile.TemporaryDirectory() as out:
        code = ("import json; from repro_torch.launch import serve; "
                f"rec = serve.main(['--arch', 'llama3.2-3b', '--out', {out!r}]);"
                " print('RECORD', json.dumps(rec))")
        proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                              env=dict(os.environ, PYTHONPATH=SRC,
                                       OMP_NUM_THREADS="1"),
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-2000:]
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("RECORD ")][-1]
        rec = json.loads(line[len("RECORD "):])
        assert (rec["status"], rec["shape"], rec["num_devices"]) == (
            "ok", "decode_32k", 256), rec.get("traceback")
        assert rec["flops"] > 0 and rec["weight_stationary_decode"]
        assert os.path.exists(os.path.join(
            out, "llama3.2-3b_decode_32k_pod1.json"))


def test_unported_families_raise_naming_their_roadmap_item():
    """Every architecture of the reference is registered, builds and
    trains (a finite loss and gradients on the CPU); the HTL trainer's
    pod-wise local phase, which used to wait for the mesh of ROADMAP Queue
    1 item 10, runs on a mesh and equals the local phase on a one-pod
    world."""
    import repro_torch.configs as configs
    from repro_torch.configs import ALL_ARCHS, get_config
    from repro_torch.configs.base import HTLConfig, OptimizerConfig
    from repro_torch.core.htl_trainer import HTLTrainer
    from repro_torch.data.pipeline import make_lm_batch
    from repro_torch.models import build_model

    assert not hasattr(configs, "NOT_PORTED")
    assert len(ALL_ARCHS) == 10
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-5")
    for arch in ALL_ARCHS:
        cfg = get_config(arch).reduced()
        model = build_model(cfg, device="cpu").init(0).requires_grad_(True)
        batch = make_lm_batch(
            cfg.vocab_size, 1, 16, d_model=cfg.d_model,
            frontend_tokens=(cfg.frontend.num_tokens
                             if cfg.family == "vlm" else 0),
            encoder_len=(cfg.encoder_seq_len
                         if cfg.family == "audio" else 0), device="cpu")
        total, _ = model.loss_fn(batch)
        total.backward()
        assert bool(torch.isfinite(total)), arch
        assert model.top["embed"].grad is not None, arch
    # the pod-wise local phase runs on a mesh: on a one-pod world it is
    # the local phase, its losses (L, H)
    from repro_torch.launch.mesh import fake_world, make_production_mesh
    trainer = HTLTrainer(model, OptimizerConfig(),
                         HTLConfig(num_collectors=2))
    model.requires_grad_(False)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 2, 1, 17)).astype(np.int32))
    batches = {"tokens": toks[..., :-1], "targets": toks[..., 1:]}
    want_state, want = trainer.local_phase(trainer.init(0), batches)
    fake_world(1)
    try:
        mesh = make_production_mesh(multi_pod=True, shape=(1, 1, 1))
        got_state, got = trainer.local_phase_podwise(trainer.init(0),
                                                     batches, mesh)
    finally:
        torch.distributed.destroy_process_group()
    assert torch.equal(got, want.t())
    assert all(torch.equal(got_state.params[k], want_state.params[k])
               for k in want_state.params)
    assert int(got_state.step) == int(want_state.step) == 2


def test_training_modules_import_with_jax_blocked():
    """The optimiser, the train driver and the HTL trainer import in an
    interpreter where importing ``jax`` (or ``repro``) fails."""
    code = "\n".join([
        "import sys",
        "class Block:",
        "    def find_spec(self, name, path=None, target=None):",
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):",
        "            raise ImportError('blocked: ' + name)",
        "sys.meta_path.insert(0, Block())",
        "import repro_torch.optim, repro_torch.launch.train",
        "import repro_torch.core.htl_trainer, repro_torch.checkpoint",
        "from repro_torch.optim import adamw_update, cosine_warmup_schedule",
        "from repro_torch.launch.train import make_train_step, train_loop",
        "from repro_torch.core.htl_trainer import HTLTrainer, HTLState",
        "import repro_torch.sharding.partitioning, repro_torch.launch.mesh",
        "import repro_torch.launch.specs, repro_torch.launch.validate",
        "import repro_torch.launch.dryrun, repro_torch.launch.htl_dryrun",
        "import repro_torch.roofline.costs, repro_torch.roofline.trace",
        "import repro_torch.roofline.analysis, repro_torch.roofline.report",
        "try:",
        "    import jax",
        "except ImportError:",
        "    print('blocked')"])
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "blocked"


def test_training_entry_points_default_to_cuda(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import HTLConfig, OptimizerConfig
    from repro_torch.core.htl_trainer import HTLTrainer
    from repro_torch.launch import train
    from repro_torch.models import build_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("llama3.2-3b").reduced()
    calls = [
        lambda: train.train_loop("llama3.2-3b", steps=1),
        lambda: train.main(["--arch", "llama3.2-3b", "--steps", "1"]),
        lambda: HTLTrainer(build_model(cfg), OptimizerConfig(),
                           HTLConfig()),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


REFERENCE_ARCHS = ["whisper-medium", "llava-next-mistral-7b", "mamba2-1.3b",
                   "qwen2-72b", "recurrentgemma-9b", "minicpm3-4b",
                   "llama3.2-3b", "olmoe-1b-7b", "granite-3-8b",
                   "deepseek-v3-671b"]


@pytest.mark.parametrize("arch", REFERENCE_ARCHS)
def test_every_reference_arch_builds_on_meta(arch):
    """Each architecture of the JAX package, at full size, builds on the
    meta device with the reference's parameter template (paths, shapes,
    axes, initialisers) and config."""
    import jax

    from repro.checkpoint.checkpointer import _path_str
    from repro.configs import ALL_ARCHS as J_ARCHS
    from repro.configs import get_config as j_config
    from repro.models import build_model as j_build
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.sharding.partitioning import flatten

    assert sorted(J_ARCHS) == sorted(REFERENCE_ARCHS)
    cfg = get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(j_config(arch))
    model = build_model(cfg, device="meta")
    assert model.device.type == "meta"
    want = {_path_str(p): (tuple(s.shape), tuple(s.axes), s.init)
            for p, s in jax.tree_util.tree_flatten_with_path(
                j_build(j_config(arch)).template(),
                is_leaf=lambda x: hasattr(x, "axes"))[0]}
    got = {p: (s.shape, s.axes, s.init) for p, s in flatten(model.template())}
    assert got == want
    n_params = sum(p.numel() for p in model.parameters())
    assert n_params == sum(math.prod(s[0]) for s in want.values())


def test_parameter_initialisers_default_to_cuda(monkeypatch):
    """iter_init / init_params run on the card unless the CPU is asked
    for, as every other entry point of the port."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.sharding.partitioning import init_params, iter_init

    tmpl = build_model(get_config("mamba2-1.3b").reduced(),
                       device="meta").template()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(tmpl)
    with pytest.raises(RuntimeError, match="CUDA"):
        next(iter_init(tmpl))
    for arch in ("mamba2-1.3b", "recurrentgemma-9b"):
        with pytest.raises(RuntimeError, match="CUDA"):
            build_model(get_config(arch).reduced())
    assert init_params(tmpl, device="cpu")["embed"].device.type == "cpu"
