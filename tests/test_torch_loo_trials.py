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

