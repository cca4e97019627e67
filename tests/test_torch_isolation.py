"""The port stands alone: importing every module of ``repro_torch`` and
``chip_smoke``'s helpers loads neither JAX nor the JAX package ``repro``
(checked in a fresh interpreter), and the port's entry points default to
CUDA and refuse to fall back to the CPU quietly."""
import os
import pkgutil
import subprocess
import sys

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
            "repro_torch.data.mobility"} <= set(names)
    code = "\n".join(
        ["import importlib, sys"]
        + [f"importlib.import_module({n!r})" for n in names]
        + ["import chip_smoke",
           "from chip_smoke import kernel_inputs, kernel_cost, compare",
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
        lambda: resolve_device("cuda:0"),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert svm.train_svm(x, y, m, num_classes=7, iters=2,
                         device="cpu").shape == (55, 7)


def test_package_turns_tf32_off():
    import repro_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
