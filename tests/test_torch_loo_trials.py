"""The port's ``loo_trials`` (plain PyTorch version on the CPU) against the
JAX package's pure-jnp oracle and its Pallas kernel in interpret mode, the
float64 inverse oracle, and the wrapper's contracts. The CUDA kernel
itself is held against the plain version by tests/test_torch_cuda.py
(card only) and by chip_smoke.py.

Tolerances: rtol 1e-5 with an atol floor of 1e-5 between float32
implementations (different summation orders; at R=1 the reference's own
kernel and oracle already differ by a relative 5.7e-6); 1e-5 relative to
the float64 inverse oracle on valid candidates, as the reference's own
test holds its factorized scorer."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import loo_trials as j_loo
from repro.kernels import ref as j_ref
from repro_torch.kernels import loo_trials as t_loo

# The tier-1 run puts 6 pytest workers on the CPU: one intra-op thread
# each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-5
C = 7


def _system(R, M, seed, n_active=0):
    """A random column-masked ridge system (stacked Stage-1 layout: M
    candidate columns then C bias columns)."""
    rng = np.random.default_rng(seed)
    D = M + C
    A = rng.normal(size=(R, D)).astype(np.float32)
    y = rng.normal(size=R).astype(np.float32)
    rmask = (rng.random(R) < 0.8).astype(np.float32)
    sel = np.zeros(M, np.float32)
    sel[rng.permutation(M)[:n_active]] = 1.0
    cmask = np.concatenate([sel, np.ones(C, np.float32)])
    lam_d = (np.abs(rng.normal(0.5, 0.2, D)) + 1e-3).astype(np.float32)
    A_rm = A * rmask[:, None]
    return (A_rm.T @ A_rm, A_rm.T @ (y * rmask), A_rm, y, rmask, cmask,
            lam_d)


def _carry_inputs(R, D, M, seed):
    """Kernel arguments as the incremental refine hands them over at its
    first step: the bias-only factor in the first C of D carry slots."""
    AtA, Aty, A_rm, y, rmask, _, lam_d = _system(R, M, seed)
    Lb = np.linalg.cholesky(AtA[M:, M:].astype(np.float64)
                            + np.diag(lam_d[M:]))
    Utb = np.linalg.solve(Lb, A_rm[:, M:].T.astype(np.float64)).T
    zb = np.linalg.solve(Lb, Aty[M:].astype(np.float64))
    Ccb = np.linalg.solve(Lb, AtA[M:, :M].astype(np.float64))
    ut = np.zeros((R, D), np.float32)
    ut[:, :C] = Utb
    cc = np.zeros((D, M), np.float32)
    cc[:C] = Ccb
    dsq = np.diag(AtA)[:M] + lam_d[:M] - np.sum(Ccb ** 2, axis=0)
    dinv = (1.0 / np.sqrt(np.maximum(dsq, 1e-8))).astype(np.float32)
    dinv[::5] = 0.0                                 # masked candidates
    zj = ((Aty[:M] - Ccb.T @ zb) * dinv).astype(np.float32)
    return tuple(np.ascontiguousarray(v, np.float32) for v in (
        ut, cc, A_rm[:, :M], Utb @ zb, np.sum(Utb ** 2, -1), y, rmask, zj,
        dinv))


def _torch(args):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in args)


@pytest.mark.parametrize("R", [1, 112, 448, 1120])
@pytest.mark.parametrize("D", [11, 23])
def test_plain_matches_jax_oracle_and_pallas_interpret(R, D):
    args = _carry_inputs(R, D, 16, seed=R + D)
    ours = t_loo.loo_trials_single(*_torch(args)).numpy()
    jargs = tuple(jnp.asarray(a) for a in args)
    oracle = np.asarray(j_loo.loo_trials_ref(*jargs))
    pallas = np.asarray(j_loo.loo_trials(*jargs, block_r=256,
                                         interpret=True))
    np.testing.assert_allclose(ours, oracle, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ours, pallas, rtol=RTOL, atol=ATOL)


def test_fleet_batched_equals_per_system():
    """The (L,R,D) contract: row l of one batched call is the single-system
    call on DC l (to float32 roundoff), padding DCs included."""
    systems = [_carry_inputs(448, 23, 16, seed=s) for s in range(4)]
    systems[3] = tuple(np.zeros_like(a) for a in systems[3])  # padding DC
    stacked = tuple(torch.from_numpy(np.stack(col)) for col in
                    zip(*systems))
    batched = t_loo.loo_trials(*stacked)
    assert batched.shape == (4, 16)
    for l, args in enumerate(systems):
        single = t_loo.loo_trials_single(*_torch(args))
        torch.testing.assert_close(batched[l], single, rtol=1e-6, atol=0)
    assert torch.equal(batched[3], torch.zeros(16))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matches_float64_inverse_oracle(seed):
    """Scored through the port's own factorized trial path, every valid
    candidate's LOO equals the float64 inverse formulation (port and JAX
    oracle alike) to 1e-5 relative."""
    from repro_torch.core.greedytl import _score_trials

    system = _system(1120, 16, seed, n_active=5)
    AtA, Aty, A_rm, y, rmask, cmask, lam_d = system
    t = [torch.from_numpy(np.ascontiguousarray(a))[None]
         for a in system[:-1]]
    fac = _score_trials(*t, torch.from_numpy(lam_d), 16)[0].numpy()
    inv64 = t_loo.loo_trials_inv_reference(*system, 16).numpy()
    # the JAX oracle runs in float32 (x64 off): same values to 1e-4
    jinv = np.asarray(j_ref.loo_trials_inv_reference(
        *(jnp.asarray(a) for a in system), 16))
    valid = cmask[:16] == 0
    np.testing.assert_allclose(inv64[valid], jinv[valid], rtol=1e-4)
    rel = np.abs(fac - inv64)[valid] / np.maximum(np.abs(inv64[valid]), 1e-6)
    assert rel.max() < 1e-5, rel.max()


def test_wrapper_rejects_bad_inputs():
    args = list(_torch(_carry_inputs(64, 23, 16, seed=0)))
    batched = [a[None] for a in args]
    with pytest.raises(TypeError):
        t_loo.loo_trials(*(batched[:1] + [batched[1].double()]
                           + batched[2:]))
    with pytest.raises(ValueError):
        t_loo.loo_trials(*(batched[:2] + [batched[2][:, :10]]
                           + batched[3:]))
    with pytest.raises(ValueError):
        t_loo.loo_trials(*args)                     # missing the DC axis
    with pytest.raises(ValueError):                 # no implementation
        t_loo.loo_trials(*(a.to("meta") for a in batched))


def test_cpu_path_never_counts_launches():
    t_loo.reset_launches()
    t_loo.loo_trials_single(*_torch(_carry_inputs(32, 11, 16, seed=1)))
    assert t_loo.launches == 0



# ---------------------------------------------------------------------------
# the fused greedy step (prologue + scorer) and the kernel's launch plan
# ---------------------------------------------------------------------------

def _step_inputs(L, R, D, M, seed):
    """``loo_trials_step``'s arguments for L DCs at the incremental
    refine's first step (bias-only factor in the first C of D slots),
    numpy float32: every fifth candidate selected, every tenth source
    masked out, and (L > 1) the last DC a padding DC."""
    cols = {k: [] for k in ("ut", "cc", "a_cand", "fitted", "h", "y",
                            "rmask", "diag_g", "aty_m", "z")}
    for l in range(L):
        AtA, Aty, A_rm, y, rmask, _, lam_d = _system(R, M, seed + l)
        if L > 1 and l == L - 1:
            rmask = np.zeros_like(rmask)
            A_rm = A_rm * 0.0
            AtA, Aty = A_rm.T @ A_rm, A_rm.T @ (y * rmask)
        Lb = np.linalg.cholesky(AtA[M:, M:].astype(np.float64)
                                + np.diag(lam_d[M:]))
        Utb = np.linalg.solve(Lb, A_rm[:, M:].T.astype(np.float64)).T
        zb = np.linalg.solve(Lb, Aty[M:].astype(np.float64))
        ut = np.zeros((R, D))
        ut[:, :C] = Utb
        cc = np.zeros((D, M))
        cc[:C] = np.linalg.solve(Lb, AtA[M:, :M].astype(np.float64))
        z = np.zeros(D)
        z[:C] = zb
        for k, v in (("ut", ut), ("cc", cc), ("a_cand", A_rm[:, :M]),
                     ("fitted", Utb @ zb), ("h", np.sum(Utb ** 2, -1)),
                     ("y", y), ("rmask", rmask),
                     ("diag_g", np.diag(AtA)[:M] + lam_d[:M]),
                     ("aty_m", Aty[:M]), ("z", z)):
            cols[k].append(v)
    sel = np.zeros((L, M))
    sel[:, ::5] = 1.0
    src_mask = np.ones((L, M))
    src_mask[:, ::10] = 0.0
    out = [np.stack(v) for v in cols.values()] + [sel, src_mask]
    return tuple(np.ascontiguousarray(a, np.float32) for a in out)


def _jax_step(ut, cc, a_cand, fitted, h, y, rmask, diag_g, aty_m, z, sel,
              src_mask, pallas=False):
    """The JAX package's incremental step on one DC, as its loop body
    writes it (``repro.core.greedytl._greedy_select_incremental``): the
    prologue, then the scorer (its pure-jnp reference, or the Pallas kernel
    in interpret mode)."""
    import jax

    active = sel * src_mask
    dsq = diag_g - jnp.sum(cc ** 2, axis=0)
    dinv = jax.lax.rsqrt(jnp.maximum(dsq, 1e-8)) * (1.0 - active)
    zj = (aty_m - cc.T @ z) * dinv
    args = (ut, cc, a_cand, fitted, h, y, rmask, zj, dinv)
    objs = (j_loo.loo_trials(*args, block_r=256, interpret=True) if pallas
            else j_loo.loo_trials_ref(*args))
    return objs, dinv, zj


@pytest.mark.parametrize("R,D", [(1, 11), (112, 23), (1120, 23)])
def test_step_ref_matches_unfused_and_jax_step(R, D):
    """``loo_trials_step_ref`` equals the unfused prologue followed by
    ``loo_trials_ref``, and the JAX package's step (jnp scorer, and the
    Pallas kernel in interpret mode on one DC): dinv, zj and objs."""
    args = _step_inputs(3, R, D, 16, seed=R + D)
    objs, dinv, zj = (t.numpy() for t in
                      t_loo.loo_trials_step_ref(*_torch(args)))
    ut, cc, a_cand, fitted, h, y, rmask, diag_g, aty_m, z, sel, src = \
        _torch(args)
    dinv_u = torch.rsqrt(torch.clamp(diag_g - torch.sum(cc ** 2, dim=1),
                                     min=1e-8)) * (1.0 - sel * src)
    zj_u = (aty_m - torch.einsum("ldm,ld->lm", cc, z)) * dinv_u
    objs_u = t_loo.loo_trials_ref(ut, cc, a_cand, fitted, h, y, rmask, zj_u,
                                  dinv_u)
    for got, want in ((objs, objs_u), (dinv, dinv_u), (zj, zj_u)):
        np.testing.assert_allclose(got, want.numpy(), rtol=RTOL, atol=ATOL)
    assert np.all(dinv[:, 5::10] == 0.0) and np.all(dinv[:, ::10] > 0.0)
    for l in range(3):
        for pallas in (False, True):
            if pallas and l:
                continue
            jo, jd, jz = (np.asarray(v) for v in _jax_step(
                *(jnp.asarray(a[l]) for a in args), pallas=pallas))
            np.testing.assert_allclose(dinv[l], jd, rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(zj[l], jz, rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(objs[l], jo, rtol=RTOL, atol=ATOL)


def test_step_wrapper_dispatch_checks_and_counts():
    """On the CPU the fused entry runs its plain version (no launch
    counted); it checks shapes, dtypes and devices like the scorer."""
    args = list(_torch(_step_inputs(2, 64, 23, 16, seed=3)))
    t_loo.reset_launches()
    got = t_loo.loo_trials_step(*args)
    want = t_loo.loo_trials_step_ref(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert t_loo.launches == 0 and t_loo.step_launches == 0
    with pytest.raises(ValueError, match="z has shape"):
        t_loo.loo_trials_step(*args[:9], args[9][:, :5], *args[10:])
    with pytest.raises(ValueError, match="sel has shape"):
        t_loo.loo_trials_step(*args[:10], args[10][:, :4], args[11])
    with pytest.raises(TypeError):
        t_loo.loo_trials_step(*args[:7], args[7].double(), *args[8:])
    with pytest.raises(ValueError):                 # no implementation
        t_loo.loo_trials_step(*(a.to("meta") for a in args))


def test_incremental_refine_runs_the_fused_step(monkeypatch):
    """The incremental greedy loop calls ``loo_trials_step`` once per step
    and never the unfused scorer; the refactorising oracle keeps the
    unfused ``loo_trials``."""
    from repro_torch.core import greedytl as t_gtl

    calls = {"loo_trials": 0, "loo_trials_step": 0}
    for name in calls:
        fn = getattr(t_loo, name)

        def counted(*a, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(*a)
        monkeypatch.setattr(t_loo, name, counted)
    system = _system(200, 8, seed=4)
    AtA, Aty, A_rm, y, rmask, _, lam_d = (
        torch.from_numpy(np.ascontiguousarray(a)) for a in system)
    batched = [a[None] for a in (AtA, Aty, A_rm, y, rmask)]
    src = torch.ones((1, 8))
    t_gtl._greedy_select_incremental(*batched, src, lam_d, M=8, C=C,
                                     k_max=5)
    assert calls == {"loo_trials": 0, "loo_trials_step": 5}
    t_gtl._greedy_select_refactor(*batched, src, lam_d, M=8, C=C, k_max=3)
    assert calls == {"loo_trials": 3, "loo_trials_step": 5}


@pytest.mark.parametrize("L", [1, 8, 16, 32, 64])
@pytest.mark.parametrize("R", [1, 63, 64, 112, 1120, 5000])
def test_launch_plan_gives_every_row_to_one_block(L, R):
    """Every row of a DC goes to exactly one block of its cluster, in
    whole row tiles; no cluster exceeds the portable 8 blocks, none has a
    block without rows, and no block holds more than 192 rows (one pass of
    the kernel's 256 threads) wherever 8 blocks allow it."""
    for D in (11, 23, 128):
        for M in (16, 17, 128):
            plan = t_loo.launch_plan(L, R, D, M)
            assert 1 <= plan.cluster <= t_loo.MAX_CLUSTER
            assert plan.cluster <= plan.row_tiles
            assert plan.d_bucket >= D and plan.d_bucket in t_loo.D_BUCKETS
            assert plan.m_tiles * t_loo.CAND_TILE >= M
            owner = np.zeros(R, np.int64)
            longest = 0
            for rank in range(plan.cluster):
                lo, hi = t_loo.block_rows(plan, R, rank)
                assert lo < hi and lo % t_loo.ROW_TILE == 0
                owner[lo:hi] += 1
                longest = max(longest, hi - lo)
            assert np.all(owner == 1)
            if R <= t_loo.MAX_CLUSTER * t_loo.BLOCK_ROWS:
                assert longest <= t_loo.BLOCK_ROWS <= 256
    # the main path's widest calls: at most 192 rows per block
    assert t_loo.launch_plan(16, 1120, 23, 16).cluster == 6
    assert t_loo.launch_plan(32, 1120, 23, 16).cluster == 6
    assert t_loo.launch_plan(1, 1120, 11, 16).cluster == 8


def test_launch_plan_refuses_wide_rows():
    with pytest.raises(ValueError, match="D <= 128"):
        t_loo.launch_plan(1, 64, 129, 16)
