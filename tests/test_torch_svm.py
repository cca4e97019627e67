"""The port's SVM trainers against the JAX package's on the same numpy
inputs.

Tolerance: weights within atol 1e-4. The two packages compute the same
float32 arithmetic but sum matrix products in different orders (XLA vs
PyTorch's CPU BLAS); over 200 momentum steps that leaves differences of a
few 1e-6 on these inputs. The bound is looser because a 1-ulp difference
can move a sample across a hinge kink, which changes one step's
subgradient by lr/n."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import svm as j_svm
from repro.data.synthetic_covtype import make_covtype_like
from repro_torch.core import svm as t_svm

# The tier-1 run puts 6 pytest workers on the CPU: one intra-op thread
# each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

C = 7
ATOL = 1e-4
DATA = make_covtype_like(n_total=3000, seed=0)


def _fleet(n_cap, seed, L=4):
    """L DCs of covtype rows padded to n_cap; the last DC is padding."""
    rng = np.random.default_rng(seed)
    xs, ys = [], []
    for _ in range(L - 1):
        idx = rng.choice(len(DATA.y_train), rng.integers(3, n_cap + 1),
                         replace=False)
        xs.append(DATA.x_train[idx].astype(np.float32))
        ys.append(DATA.y_train[idx].astype(np.int32))
    x, y, m, _ = t_svm.pad_fleet(xs, ys, n_cap, L)
    return x, y, m


@pytest.mark.parametrize("n_cap,seed", [(16, 0), (64, 1), (160, 2)])
def test_train_svm_fleet_matches_jax(n_cap, seed):
    x, y, m = _fleet(n_cap, seed)
    assert m[-1].sum() == 0                       # an all-zero padding DC
    want = np.asarray(j_svm.train_svm_fleet(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(m), num_classes=C))
    got = t_svm.train_svm_fleet(x, y, m, num_classes=C, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (4, 55, C)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_train_svm_warm_start_matches_jax():
    """The edge-only path: warm start w0 and 300 iterations."""
    x, y, m = (a[0] for a in _fleet(128, 3, L=2))
    w0 = np.asarray(j_svm.train_svm(jnp.asarray(x), jnp.asarray(y),
                                    jnp.asarray(m), num_classes=C))
    want = np.asarray(j_svm.train_svm(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(m), num_classes=C,
        iters=300, w0=jnp.asarray(w0)))
    got = t_svm.train_svm(x, y, m, num_classes=C, iters=300, w0=w0,
                          device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_hinge_tie_takes_half_the_gradient_like_jax():
    """A sample whose margin is exactly 0 in every class: jax.grad splits
    the max's gradient 0.5/0.5; one step of both trainers must agree
    exactly."""
    n, F = 4, 54
    x = np.zeros((n, F), np.float32)
    y = np.array([0, 3, 6, 2], np.int32)
    m = np.array([1, 1, 1, 0], np.float32)
    w0 = np.zeros((F + 1, C), np.float32)
    w0[F] = 1.0               # bias 1: y_pm * s = 1 for the true class ...
    y_pm_true = 2.0 * np.eye(C, dtype=np.float32)[y] - 1.0
    assert (1.0 - y_pm_true[:3, 0] * w0[F, 0] == 0).any()
    want = np.asarray(j_svm.train_svm(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(m), num_classes=C,
        iters=1, w0=jnp.asarray(w0)))
    got = t_svm.train_svm(x, y, m, num_classes=C, iters=1, w0=w0,
                          device="cpu").numpy()
    assert np.array_equal(got, want)
    assert not np.array_equal(got, w0)


def test_scores_predict_and_sample_caps():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(55, C)).astype(np.float32)
    x = rng.normal(size=(30, 54)).astype(np.float32)
    np.testing.assert_allclose(
        t_svm.svm_scores(torch.from_numpy(w), torch.from_numpy(x)).numpy(),
        np.asarray(j_svm.svm_scores(jnp.asarray(w), jnp.asarray(x))),
        rtol=1e-6, atol=1e-5)
    assert np.array_equal(
        t_svm.svm_predict(torch.from_numpy(w), torch.from_numpy(x)).numpy(),
        np.asarray(j_svm.svm_predict(jnp.asarray(w), jnp.asarray(x))))
    for n in range(0, 200, 7):
        for cap in (16, 64, 160):
            assert t_svm.sample_cap(n, cap) == j_svm.sample_cap(n, cap)
    xs = [x[:5], x[5:30]]
    ys = [np.arange(5) % C, np.arange(25) % C]
    for a, b in zip(t_svm.pad_fleet(xs, ys, 32, 4),
                    j_svm.pad_fleet(xs, ys, 32, 4)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
