"""The port's GreedyTL against the JAX package's, on the random systems of
tests/test_greedytl_props.py, and against the float64 refactor oracle.

Tolerances: selections must be EQUAL; w_eff within atol 1e-4 (float32
Cholesky/triangular solves in another summation order; observed ~1e-6).
Against the float64 oracle, selections equal on well-conditioned systems
(the reference's own property)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import greedytl as j_gtl
from repro_torch.core import greedytl as t_gtl
from repro_torch.kernels.loo_trials import greedy_select_refactor_reference

# The tier-1 run puts 6 pytest workers on the CPU: one intra-op thread
# each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

F, C, M_CAP = 54, 7, 16
ATOL = 1e-4


def _problem(n, n_src, seed, scale=1.0):
    """tests/test_greedytl_props.py::_run's padded problem."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, F)).astype(np.float32)
    y = rng.integers(0, C, n).astype(np.int32)
    cap = max(32, n)
    xp = np.zeros((cap, F), np.float32)
    xp[:n] = x
    yp = np.zeros(cap, np.int32)
    yp[:n] = y
    mp = np.zeros(cap, np.float32)
    mp[:n] = 1
    src = np.zeros((M_CAP, F + 1, C), np.float32)
    sm = np.zeros(M_CAP, np.float32)
    for i in range(n_src):
        src[i] = rng.normal(0, scale, (F + 1, C))
        sm[i] = 1
    return xp, yp, mp, src, sm


def _deep_problem(n=160, n_src=12, seed=0):
    """Many sources, each explaining a disjoint feature block of the true
    boundary, so the greedy loop accepts several of them."""
    r = np.random.default_rng(seed)
    src = np.zeros((M_CAP, F + 1, C), np.float32)
    sm = np.zeros(M_CAP, np.float32)
    w_total = np.zeros((F + 1, C), np.float32)
    for i, blk in enumerate(np.array_split(np.arange(F), n_src)):
        w = np.zeros((F + 1, C), np.float32)
        w[blk] = r.normal(0, 1.0, (len(blk), C))
        src[i] = w
        sm[i] = 1.0
        w_total += w
    x = r.normal(size=(n, F)).astype(np.float32)
    y = np.argmax(x @ w_total[:-1] + w_total[-1], axis=1).astype(np.int32)
    return x, y, np.ones(n, np.float32), src, sm


def _jax(args, **kw):
    w, sel = j_gtl.greedytl(*(jnp.asarray(a) for a in args), num_classes=C,
                            **kw)
    return np.asarray(w), np.asarray(sel)


@pytest.mark.parametrize("n,n_src,seed", [
    (4, 0, 1), (12, 3, 5), (40, 8, 9), (60, 16, 13), (25, 1, 40)])
def test_greedytl_matches_jax_on_random_systems(n, n_src, seed):
    args = _problem(n, n_src, seed)
    w_j, sel_j = _jax(args)
    w_t, sel_t = t_gtl.greedytl(*args, num_classes=C, device="cpu")
    assert np.array_equal(sel_t.numpy(), sel_j)
    np.testing.assert_allclose(w_t.numpy(), w_j, rtol=0, atol=ATOL)
    assert (sel_t.numpy()[n_src:] == 0).all()


@pytest.mark.parametrize("k_max", [1, 4, 16])
def test_deep_refine_matches_jax_and_refactor_path(k_max):
    args = _deep_problem()
    w_j, sel_j = _jax(args, k_max=k_max)
    w_t, sel_t = t_gtl.greedytl(*args, num_classes=C, k_max=k_max,
                                device="cpu")
    w_r, sel_r = t_gtl.greedytl(*args, num_classes=C, k_max=k_max,
                                incremental=False, device="cpu")
    assert sel_j.sum() == min(k_max, 12) or k_max == 16
    assert np.array_equal(sel_t.numpy(), sel_j)
    assert torch.equal(sel_t, sel_r)
    np.testing.assert_allclose(w_t.numpy(), w_j, rtol=0, atol=ATOL)
    np.testing.assert_allclose(w_r.numpy(), w_t.numpy(), rtol=0, atol=1e-5)


def test_fleet_stacked_matches_jax_per_dc():
    """One batched call over DCs with their own pools (a padding DC among
    them) against the reference's stacked lax.map call."""
    probs = [_problem(30, 5, 1), _problem(32, 9, 2), _deep_problem(32, 12, 3)]
    probs.append(tuple(np.zeros_like(a) for a in probs[0]))  # padding DC
    stk = [np.stack(col) for col in zip(*probs)]
    w_j, sel_j = j_gtl.greedytl_fleet_stacked(
        *(jnp.asarray(a) for a in stk), num_classes=C)
    w_t, sel_t = t_gtl.greedytl_fleet_stacked(*stk, num_classes=C,
                                              device="cpu")
    assert np.array_equal(sel_t.numpy(), np.asarray(sel_j))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=0,
                               atol=ATOL)
    assert sel_t[3].sum() == 0 and torch.isfinite(w_t).all()
    # shared-pool entry point == stacked with the pool broadcast
    x, y, m = stk[0][:3], stk[1][:3], stk[2][:3]
    src, sm = probs[0][3], probs[0][4]
    w_f, sel_f = t_gtl.greedytl_fleet(x, y, m, src, sm, num_classes=C,
                                      device="cpu")
    w_s, sel_s = t_gtl.greedytl_fleet_stacked(
        x, y, m, np.broadcast_to(src, (3,) + src.shape),
        np.broadcast_to(sm, (3,) + sm.shape), num_classes=C, device="cpu")
    assert torch.equal(sel_f, sel_s) and torch.equal(w_f, w_s)


def _stage1(args):
    """Stage-1 Gram system exactly as the port's _greedytl builds it."""
    x, y, m, src, sm = (torch.as_tensor(a)[None] for a in args)
    xm = x * m[:, :, None]
    H = t_gtl.svm_scores(src.float(), xm[:, None]) * m[:, None, :, None]
    s = torch.sqrt(torch.sum(H ** 2, dim=(2, 3))
                   / (torch.clamp(m.sum(1), min=1.0) * C)[:, None]) + 1e-6
    Hn = H / s[:, :, None, None]
    n = x.shape[1]
    A = torch.cat([Hn.permute(0, 2, 3, 1).reshape(1, n * C, M_CAP),
                   torch.eye(C).repeat(n, 1)[None]], dim=2)
    Y = (2.0 * torch.nn.functional.one_hot(y.long(), C) - 1.0) \
        * m[:, :, None]
    rmask = torch.repeat_interleave(m, C, dim=1)
    A_rm = A * rmask[:, :, None]
    lam_d = torch.cat([torch.full((M_CAP,), 0.1), torch.full((C,), 2.0)]) \
        + 1e-4
    return (A_rm.transpose(1, 2) @ A_rm,
            (A_rm.transpose(1, 2) @ (Y.reshape(1, -1) * rmask)[:, :, None]
             )[:, :, 0], A_rm, Y.reshape(1, -1), rmask, sm, lam_d)


@pytest.mark.parametrize("problem", ["deep", "random"])
def test_selection_matches_float64_refactor_oracle(problem):
    args = _deep_problem(seed=4) if problem == "deep" \
        else _problem(60, 10, 21)
    AtA, Aty, A_rm, yr, rmask, sm, lam_d = _stage1(args)
    sel_inc, _ = t_gtl._greedy_select_incremental(
        AtA, Aty, A_rm, yr, rmask, sm, lam_d, M=M_CAP, C=C, k_max=16)
    sel64, traj = greedy_select_refactor_reference(
        AtA[0], Aty[0], A_rm[0], yr[0], rmask[0], sm[0], lam_d, M_CAP)
    assert np.array_equal(sel_inc[0].numpy(), sel64)
    assert len(traj) == 1 + int(sel64.sum())
    assert all(b < a for a, b in zip(traj, traj[1:]))


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _problem(10, 2, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_gtl.greedytl(*args, num_classes=C)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_gtl.greedytl_fleet_stacked(*(a[None] for a in args),
                                     num_classes=C)
