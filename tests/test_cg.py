"""CG family end-to-end tests — BASELINE config #1 and variants.

Mirrors the reference's solver integration tests
(packages/tpetra/core/test/PerformanceCGSolve/cg_solve_file.hpp,
packages/belos/tpetra/test/BlockCG/): solve Galeri problems to rtol and
assert the true residual meets the tolerance.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from trilinos_tpu.galeri import laplace1d, laplace2d, laplace3d
from trilinos_tpu.ops import formats as F
from trilinos_tpu.ops import matvec as S
from trilinos_tpu.solvers import cg, cg_pipeline, cg_single_reduce


def make_problem(a_csr, nrhs=0, seed=3, fmt="dia", dtype=None):
    dev = (F.csr_to_dia(a_csr, dtype=dtype) if fmt == "dia"
           else F.csr_to_ell(a_csr, dtype=dtype))
    n = a_csr.shape[0]
    npad = dev.n_rows_pad
    rng = np.random.default_rng(seed)
    shape = (npad,) if nrhs == 0 else (npad, nrhs)
    b = np.zeros(shape)
    b[:n] = rng.standard_normal((n,) if nrhs == 0 else (n, nrhs))
    op = lambda x: S.spmv(dev, x)
    bj = jnp.asarray(b, dtype=dtype) if dtype is not None else jnp.asarray(b)
    return op, bj, a_csr.to_dense(), n


@pytest.mark.parametrize("solver", [cg, cg_single_reduce, cg_pipeline])
def test_cg_laplace2d_100x100(solver):
    """BASELINE config #1: Galeri Laplace2D 100x100, unprec CG, rtol 1e-8."""
    a = laplace2d(100, 100)
    op, b, dense, n = make_problem(a)
    res = solver(op, b, rtol=1e-8, maxiter=1000)
    x = np.asarray(res.x)[:n]
    true_res = np.linalg.norm(np.asarray(b)[:n] - dense @ x)
    assert true_res <= 1.1e-8 * np.linalg.norm(np.asarray(b)[:n])
    assert bool(res.converged.all())
    assert 100 < int(res.iters) < 600  # CG on 100^2 Laplacian ~ O(hundreds)


@pytest.mark.parametrize("solver", [cg, cg_single_reduce, cg_pipeline])
def test_cg_multivector(solver):
    a = laplace2d(20, 20)
    op, b, dense, n = make_problem(a, nrhs=3)
    res = solver(op, b, rtol=1e-10, maxiter=2000)
    x = np.asarray(res.x)[:n]
    r = np.asarray(b)[:n] - dense @ x
    rel = np.linalg.norm(r, axis=0) / np.linalg.norm(np.asarray(b)[:n], axis=0)
    assert (rel <= 1.1e-10).all()


def test_cg_variants_agree_iteration_counts():
    """Single-reduce and pipelined CG are algebraically equivalent to CG;
    iteration counts should match within a couple of iters."""
    a = laplace2d(30, 30)
    op, b, dense, n = make_problem(a)
    k0 = int(cg(op, b, rtol=1e-8).iters)
    k1 = int(cg_single_reduce(op, b, rtol=1e-8).iters)
    k2 = int(cg_pipeline(op, b, rtol=1e-8).iters)
    assert abs(k1 - k0) <= 3
    assert abs(k2 - k0) <= 3


def test_cg_with_jacobi_prec():
    a = laplace3d(8, 8, 8)
    op, b, dense, n = make_problem(a)
    dinv = np.zeros(b.shape[0])
    dinv[:n] = 1.0 / np.diag(dense)
    dinv[n:] = 1.0
    dinv = jnp.asarray(dinv)
    prec = lambda x: dinv * x
    res = cg(op, b, prec=prec, rtol=1e-8)
    x = np.asarray(res.x)[:n]
    true_res = np.linalg.norm(np.asarray(b)[:n] - dense @ x)
    assert true_res <= 1.1e-8 * np.linalg.norm(np.asarray(b)[:n])


def test_cg_x0_and_exact_start():
    a = laplace1d(50)
    op, b, dense, n = make_problem(a)
    x_exact = np.zeros(b.shape[0])
    x_exact[:n] = np.linalg.solve(dense, np.asarray(b)[:n])
    res = cg(op, b, x0=jnp.asarray(x_exact), rtol=1e-8)
    assert int(res.iters) == 0
    assert bool(res.converged.all())


def test_cg_maxiter_stops():
    a = laplace2d(40, 40)
    op, b, dense, n = make_problem(a)
    res = cg(op, b, rtol=1e-12, maxiter=5)
    assert int(res.iters) == 5
    assert not bool(res.converged.all())


def test_pipelined_cg_f32_residual_replacement():
    """f32 pipelined CG must reach 1e-5 on Laplace3D 64^3 — the classic
    pipelined-CG drift stalls ~1e-2 without the residual-replacement
    safeguard (VERDICT round 1; BelosStatusTestImpResNorm.hpp:47-88)."""
    from trilinos_tpu.galeri import laplace3d as l3d

    op_st = l3d(64, 64, 64, dtype=np.float32, fmt="stencil")
    n, npad = op_st.n_rows, op_st.n_rows_pad
    rng = np.random.default_rng(5)
    b = np.zeros(npad, np.float32)
    b[:n] = rng.standard_normal(n)
    op = lambda v: S.spmv(op_st, v)
    res = cg_pipeline(op, jnp.asarray(b), rtol=1e-5, maxiter=500)
    assert bool(res.converged.all()), float(res.resnorm)
    # certified resnorm is the TRUE residual (explicit recompute)
    r_true = np.asarray(b) - np.asarray(op(res.x))
    assert abs(np.linalg.norm(r_true) - float(res.resnorm)) <= \
        1e-3 * float(res.resnorm) + 1e-8
    k_plain = int(cg(op, jnp.asarray(b), rtol=1e-5, maxiter=500).iters)
    assert abs(int(res.iters) - k_plain) <= max(5, k_plain // 10)


def test_certified_resnorm_is_true_residual():
    """converged/resnorm come from an explicit residual for every CG
    variant (not the recurrence value)."""
    a = laplace2d(30, 30)
    op, b, dense, n = make_problem(a)
    for solver in (cg, cg_single_reduce, cg_pipeline):
        res = solver(op, b, rtol=1e-8)
        x = np.asarray(res.x)[:n]
        true_norm = np.linalg.norm(np.asarray(b)[:n] - dense @ x)
        np.testing.assert_allclose(float(res.resnorm), true_norm,
                                   rtol=1e-6, atol=1e-13)


class TestCgCondest:
    """Free Lanczos condition estimate from CG's own coefficients —
    the AZ_cg_condnum output (aztecoo az_aztec_defs.h:266-272)."""

    def test_matches_dense_kappa(self):
        a = laplace2d(16, 16)
        op, b, dense, n = make_problem(a)
        w = np.linalg.eigvalsh(dense)
        true_kappa = w[-1] / w[0]
        res = cg(op, b, rtol=1e-10, maxiter=500, condest_window=200)
        assert bool(res.converged)
        est = float(res.condest)
        # Ritz interlacing: estimate <= true kappa, tight once CG has
        # resolved both spectrum ends
        assert est <= true_kappa * (1 + 1e-8)
        np.testing.assert_allclose(est, true_kappa, rtol=1e-6)

    def test_multivector_and_prec_invariance(self):
        a = laplace2d(16, 16)
        op, b, dense, n = make_problem(a, nrhs=3)
        res = cg(op, b, rtol=1e-10, maxiter=500, condest_window=200)
        est = np.asarray(res.condest)
        assert est.shape == (3,)
        w = np.linalg.eigvalsh(dense)
        np.testing.assert_allclose(est, w[-1] / w[0], rtol=1e-6)
        # Jacobi prec on the constant-diagonal Laplacian rescales the
        # operator uniformly: kappa(M A) == kappa(A)
        op1, b1, _, _ = make_problem(a)
        rp = cg(op1, b1, prec=lambda v: 0.25 * v, rtol=1e-10,
                maxiter=500, condest_window=200)
        np.testing.assert_allclose(float(rp.condest), w[-1] / w[0],
                                   rtol=1e-6)

    def test_window_smaller_than_iters(self):
        """A truncated window still gives a sound lower-bound estimate."""
        a = laplace2d(30, 30)
        op, b, dense, n = make_problem(a)
        w = np.linalg.eigvalsh(dense)
        true_kappa = w[-1] / w[0]
        res = cg(op, b, rtol=1e-8, maxiter=500, condest_window=20)
        est = float(res.condest)
        assert est <= true_kappa * (1 + 1e-8)
        assert est >= 0.25 * true_kappa  # 20 Lanczos steps get close

    def test_seam_retry_lower_bound(self):
        """Across certified_solve tighten-retries the recorded T must be
        the direct sum of genuine Lanczos blocks (seam beta zeroed) —
        otherwise spurious coupling pushes Ritz values OUTSIDE the
        spectrum (observed +11-13% over true kappa pre-fix). f32 with an
        unattainable rtol forces all 4 retry passes."""
        a = laplace2d(48, 48)
        op, b32, dense, n = make_problem(a, dtype=jnp.float32)
        w = np.linalg.eigvalsh(dense)
        true_kappa = w[-1] / w[0]
        res = cg(op, b32, rtol=3e-7, maxiter=4000, condest_window=400)
        assert not bool(res.converged)  # retries exhausted (f32 floor)
        est = float(res.condest)
        # f32 coefficient roundoff gives ~1e-5 slack; 1e-3 is the
        # regression margin against the pre-fix 1.11x overshoot
        assert est <= true_kappa * (1 + 1e-3)
        assert est >= 0.9 * true_kappa

    def test_off_by_default(self):
        a = laplace2d(10, 10)
        op, b, dense, n = make_problem(a)
        assert cg(op, b, rtol=1e-8).condest is None

    def test_factory_param(self):
        from trilinos_tpu.solvers.factory import SolverManager
        from trilinos_tpu.solvers.linear_problem import LinearProblem

        a = laplace2d(16, 16)
        op, b, dense, n = make_problem(a)
        mgr = SolverManager("CG", {"Convergence Tolerance": 1e-10,
                                   "Estimate Condition Number": 200})
        res = mgr.solve(LinearProblem(op=op, b=b))
        w = np.linalg.eigvalsh(dense)
        np.testing.assert_allclose(float(res.condest), w[-1] / w[0],
                                   rtol=1e-6)
