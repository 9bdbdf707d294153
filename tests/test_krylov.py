"""GMRES / BiCGStab / MINRES / TFQMR integration tests.

Mirrors packages/belos/tpetra/test/{BlockGmres,BiCGStab,Minres,TFQMR}
drivers: solve Galeri problems to tolerance, assert the TRUE residual.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from trilinos_tpu.galeri import laplace2d, recirc2d
from trilinos_tpu.ops import formats as F
from trilinos_tpu.ops import matvec as S
from trilinos_tpu.solvers.gmres import fgmres, gmres
from trilinos_tpu.solvers.bicgstab import bicgstab
from trilinos_tpu.solvers.minres import minres
from trilinos_tpu.solvers.tfqmr import tfqmr


def make_problem(a_csr, nrhs=0, seed=5):
    dev = F.csr_to_dia(a_csr)
    n, npad = a_csr.shape[0], dev.n_rows_pad
    rng = np.random.default_rng(seed)
    shape = (npad,) if nrhs == 0 else (npad, nrhs)
    b = np.zeros(shape)
    b[:n] = rng.standard_normal((n,) if nrhs == 0 else (n, nrhs))
    op = lambda x: S.spmv(dev, x)
    return op, jnp.asarray(b), a_csr.to_dense(), n


def true_rel_res(b, dense, x, n):
    r = np.asarray(b)[:n] - dense @ np.asarray(x)[:n]
    return np.linalg.norm(r, axis=0) / np.linalg.norm(np.asarray(b)[:n], axis=0)


class TestGmres:
    @pytest.mark.parametrize("ortho", ["CGS2", "DGKS"])
    def test_laplace2d(self, ortho):
        a = laplace2d(30, 30)
        op, b, dense, n = make_problem(a)
        res = gmres(op, b, restart=30, rtol=1e-8, maxiter=900, ortho=ortho)
        assert true_rel_res(b, dense, res.x, n) <= 1.1e-8
        assert bool(res.converged)

    def test_nonsymmetric_recirc2d(self):
        a = recirc2d(20, 20, diff=1e-2)
        op, b, dense, n = make_problem(a)
        res = gmres(op, b, restart=40, rtol=1e-8, maxiter=2000)
        assert true_rel_res(b, dense, res.x, n) <= 1e-6

    def test_multivector_pseudo_block(self):
        a = laplace2d(16, 16)
        op, b, dense, n = make_problem(a, nrhs=3)
        res = gmres(op, b, restart=30, rtol=1e-8, maxiter=600)
        assert (true_rel_res(b, dense, res.x, n) <= 1.1e-8).all()
        assert bool(res.converged.all())

    def test_right_preconditioned(self):
        a = laplace2d(20, 20)
        op, b, dense, n = make_problem(a)
        dinv = np.zeros(b.shape[0])
        dinv[:n] = 1.0 / np.diag(dense)
        dinv[n:] = 1.0
        dinv = jnp.asarray(dinv)
        res = gmres(op, b, prec=lambda v: dinv * v, restart=30, rtol=1e-8,
                    maxiter=600)
        assert true_rel_res(b, dense, res.x, n) <= 1.1e-8

    def test_x0_nonzero(self):
        a = laplace2d(12, 12)
        op, b, dense, n = make_problem(a)
        x0 = jnp.ones_like(b) * 0.1
        x0 = x0.at[n:].set(0)
        res = gmres(op, b, x0=x0, restart=30, rtol=1e-10, maxiter=600)
        assert true_rel_res(b, dense, res.x, n) <= 1e-9

    def test_restart_smaller_than_needed(self):
        """GMRES(5) must still converge through restarts on SPD problem."""
        a = laplace2d(10, 10)
        op, b, dense, n = make_problem(a)
        res = gmres(op, b, restart=5, rtol=1e-8, maxiter=3000)
        assert true_rel_res(b, dense, res.x, n) <= 1e-7

    def test_fgmres_with_variable_prec(self):
        a = laplace2d(16, 16)
        op, b, dense, n = make_problem(a)
        # inner CG as (nonlinear) preconditioner — classic FGMRES use
        from trilinos_tpu.solvers import cg

        def prec(v):
            return cg(op, v, rtol=1e-2, maxiter=5).x

        res = fgmres(op, b, prec=prec, restart=20, rtol=1e-8, maxiter=400)
        assert true_rel_res(b, dense, res.x, n) <= 1.1e-8


class TestGmresCondest:
    """Free κ₂ estimate from the Arnoldi Hessenberg — the AZ_condnum
    output of AztecOO's AZ_pgmres_condnum (az_gmres_condnum.c). Here
    computed from the RECTANGULAR H̄ whose singular values provably lie
    inside [σmin, σmax] of the preconditioned operator, so the estimate
    is a lower bound on κ₂ even for nonsymmetric matrices."""

    def test_spd_matches_kappa2(self):
        a = laplace2d(16, 16)
        op, b, dense, n = make_problem(a)
        k2 = np.linalg.cond(dense, 2)
        res = gmres(op, b, rtol=1e-10, restart=80, maxiter=400,
                    condest=True)
        assert bool(res.converged)
        est = float(res.condest)
        assert est <= k2 * (1 + 1e-8)
        np.testing.assert_allclose(est, k2, rtol=0.05)

    def test_restarted_keeps_widest_bracket(self):
        """Across restart cycles the running max-σmax/min-σmin bracket
        stays a sound (and tightening) lower bound."""
        a = laplace2d(16, 16)
        op, b, dense, n = make_problem(a)
        k2 = np.linalg.cond(dense, 2)
        res = gmres(op, b, rtol=1e-10, restart=20, maxiter=600,
                    condest=True)
        est = float(res.condest)
        assert est <= k2 * (1 + 1e-8)
        assert est >= 0.9 * k2

    def test_nonsym_lower_bound(self):
        a = recirc2d(16, 16)
        op, b, dense, n = make_problem(a)
        k2 = np.linalg.cond(dense, 2)
        res = gmres(op, b, rtol=1e-10, restart=60, maxiter=600,
                    condest=True)
        est = float(res.condest)
        assert est <= k2 * (1 + 1e-8)
        assert est >= 0.5 * k2

    def test_multivector_and_default_off(self):
        a = laplace2d(12, 12)
        op, b, dense, n = make_problem(a, nrhs=2)
        res = gmres(op, b, rtol=1e-9, restart=40, condest=True)
        est = np.asarray(res.condest)
        assert est.shape == (2,)
        k2 = np.linalg.cond(dense, 2)
        np.testing.assert_allclose(est, k2, rtol=0.05)
        assert gmres(op, b, rtol=1e-9, restart=40).condest is None

    def test_factory_param(self):
        from trilinos_tpu.solvers.factory import SolverManager
        from trilinos_tpu.solvers.linear_problem import LinearProblem

        a = laplace2d(12, 12)
        op, b, dense, n = make_problem(a)
        mgr = SolverManager("GMRES", {"Convergence Tolerance": 1e-9,
                                      "Num Blocks": 40,
                                      "Estimate Condition Number": 1})
        res = mgr.solve(LinearProblem(op, b))
        k2 = np.linalg.cond(dense, 2)
        np.testing.assert_allclose(float(res.condest), k2, rtol=0.05)


class TestBicgstab:
    def test_laplace2d(self):
        a = laplace2d(20, 20)
        op, b, dense, n = make_problem(a)
        res = bicgstab(op, b, rtol=1e-8, maxiter=2000)
        assert true_rel_res(b, dense, res.x, n) <= 1e-7

    def test_nonsymmetric(self):
        a = recirc2d(16, 16, diff=1e-2)
        op, b, dense, n = make_problem(a)
        res = bicgstab(op, b, rtol=1e-9, maxiter=4000)
        assert true_rel_res(b, dense, res.x, n) <= 1e-7

    def test_multivector(self):
        a = laplace2d(12, 12)
        op, b, dense, n = make_problem(a, nrhs=2)
        res = bicgstab(op, b, rtol=1e-9, maxiter=2000)
        assert (true_rel_res(b, dense, res.x, n) <= 1e-7).all()

    def test_jacobi_prec(self):
        a = recirc2d(14, 14, diff=1e-1)
        op, b, dense, n = make_problem(a)
        dinv = np.zeros(b.shape[0])
        dinv[:n] = 1.0 / np.diag(dense)
        dinv[n:] = 1.0
        res = bicgstab(op, b, prec=lambda v: jnp.asarray(dinv) * v,
                       rtol=1e-9, maxiter=2000)
        assert true_rel_res(b, dense, res.x, n) <= 1e-7


class TestMinres:
    def test_spd(self):
        a = laplace2d(20, 20)
        op, b, dense, n = make_problem(a)
        res = minres(op, b, rtol=1e-8, maxiter=2000)
        assert true_rel_res(b, dense, res.x, n) <= 1e-6

    def test_indefinite(self):
        """MINRES' raison d'être: symmetric indefinite (shifted Laplacian)."""
        a = laplace2d(14, 14)
        dense0 = a.to_dense()
        shift = 1.5  # inside the spectrum -> indefinite
        coo_rows, coo_cols = np.nonzero(dense0)
        vals = dense0[coo_rows, coo_cols]
        shifted = F.CsrHost.from_coo(
            np.concatenate([coo_rows, np.arange(196)]),
            np.concatenate([coo_cols, np.arange(196)]),
            np.concatenate([vals, -shift * np.ones(196)]), (196, 196))
        op, b, dense, n = make_problem(shifted)
        assert (np.linalg.eigvalsh(dense) < 0).any()
        res = minres(op, b, rtol=1e-8, maxiter=3000)
        assert true_rel_res(b, dense, res.x, n) <= 1e-6


class TestTfqmr:
    def test_laplace2d(self):
        a = laplace2d(16, 16)
        op, b, dense, n = make_problem(a)
        res = tfqmr(op, b, rtol=1e-8, maxiter=3000)
        assert true_rel_res(b, dense, res.x, n) <= 1e-6

    def test_nonsymmetric(self):
        a = recirc2d(12, 12, diff=1e-1)
        op, b, dense, n = make_problem(a)
        res = tfqmr(op, b, rtol=1e-9, maxiter=3000)
        assert true_rel_res(b, dense, res.x, n) <= 1e-6


class TestSstepGmres:
    @pytest.mark.parametrize("s", [2, 4])
    def test_matches_gmres_quality(self, s):
        from trilinos_tpu.solvers.sstep_gmres import sstep_gmres

        a = laplace2d(16, 16)
        op, b, dense, n = make_problem(a)
        res = sstep_gmres(op, b, s=s, t_blocks=30 // s, max_restarts=30,
                          rtol=1e-8)
        assert true_rel_res(b, dense, res.x, n) <= 1e-7
        assert bool(res.converged)

    def test_nonsymmetric(self):
        from trilinos_tpu.solvers.sstep_gmres import sstep_gmres

        a = recirc2d(14, 14, diff=1e-2)
        op, b, dense, n = make_problem(a)
        res = sstep_gmres(op, b, s=4, t_blocks=10, max_restarts=40,
                          rtol=1e-8)
        assert true_rel_res(b, dense, res.x, n) <= 1e-6

    def test_with_prec(self):
        from trilinos_tpu.solvers.sstep_gmres import sstep_gmres

        a = laplace2d(14, 14)
        op, b, dense, n = make_problem(a)
        dinv = np.ones(b.shape[0]) * 0.25
        res = sstep_gmres(op, b, s=3, t_blocks=8, max_restarts=20,
                          prec=lambda v: jnp.asarray(dinv) * v, rtol=1e-8)
        assert true_rel_res(b, dense, res.x, n) <= 1e-7

    def test_powers_fn_basis_matches_loop(self):
        """A matrix-powers generator (``powers_fn``, the hook the
        one-exchange distributed basis uses) built from
        stencil_powers_xla reproduces the loop basis: same per-cycle
        residual trajectory, so resnorm/iters match."""
        from trilinos_tpu.galeri import laplace3d
        from trilinos_tpu.ops.stencil import (monomial_stages,
                                              stencil_powers_xla)
        from trilinos_tpu.solvers.sstep_gmres import sstep_gmres

        op = laplace3d(32, 32, 8, dtype=np.float32, fmt="stencil")
        npad = op.n_rows_pad
        b = np.zeros(npad, np.float32)
        b[:op.n_rows] = np.random.default_rng(5).standard_normal(
            op.n_rows)
        bj = jnp.asarray(b)
        sigma = 12.0
        stages = monomial_stages(4, sigma)

        def powers(q, sig):
            return stencil_powers_xla(op, stages, q).T

        kw = dict(s=4, t_blocks=4, max_restarts=8, rtol=1e-4, sigma=sigma)
        r_loop = sstep_gmres(op, bj, **kw)
        r_pow = sstep_gmres(op, bj, powers_fn=powers, **kw)
        assert int(r_pow.iters) == int(r_loop.iters)
        np.testing.assert_allclose(float(r_pow.resnorm),
                                   float(r_loop.resnorm), rtol=1e-5)

    def test_powers_fn_needs_sigma_and_no_prec(self):
        from trilinos_tpu.solvers.sstep_gmres import sstep_gmres

        a = laplace2d(14, 14)
        op, b, dense, n = make_problem(a)
        powers = lambda q, sig: jnp.stack([q] * 4, axis=1)
        with pytest.raises(ValueError, match="sigma"):
            sstep_gmres(op, b, powers_fn=powers)
        with pytest.raises(ValueError, match="prec"):
            sstep_gmres(op, b, powers_fn=powers, sigma=4.0,
                        prec=lambda v: v)


def test_certified_resnorm_nonsym_family():
    """BiCGStab/MINRES/TFQMR report explicit-residual-certified
    convergence (the recurrence/quasi-residual values can under- or
    over-estimate; Belos cross-checks with the ImpResNorm
    loss-of-accuracy test, BelosStatusTestImpResNorm.hpp:47-88). In
    particular TFQMR's tau underestimates by up to sqrt(2k+2) — the
    certified retry loop must close that gap."""
    from trilinos_tpu.solvers import bicgstab, minres, tfqmr

    a = laplace2d(30, 30)
    op, b, dense, n = make_problem(a)
    for solver in (bicgstab, minres, tfqmr):
        res = solver(op, b, rtol=1e-8, maxiter=8000)
        assert bool(np.all(np.asarray(res.converged))), solver
        x = np.asarray(res.x)[:n]
        true_norm = np.linalg.norm(np.asarray(b)[:n] - dense @ x)
        np.testing.assert_allclose(float(res.resnorm), true_norm,
                                   rtol=1e-6, atol=1e-13)
        assert true_norm <= 1e-8 * np.linalg.norm(np.asarray(b)[:n])


class TestNewtonBasisSstep:
    """Newton-basis CA-GMRES (Leja-ordered Ritz shifts; conjugate pairs
    fused into real quadratic stages). In exact arithmetic any basis
    spans the same Krylov space, so one f64 cycle must reproduce the
    monomial cycle exactly — while in f32 at larger s the Newton basis
    stays better conditioned."""

    def test_single_cycle_parity_spd(self):
        from trilinos_tpu.solvers.sstep_gmres import (ritz_shifts,
                                                      sstep_gmres)

        a = laplace2d(16, 16)
        op, b, dense, n = make_problem(a)
        sh = ritz_shifts(op, b, 4)
        assert np.abs(sh.imag).max() < 1e-10  # SPD -> real Ritz values
        kw = dict(s=4, t_blocks=3, max_restarts=0, rtol=1e-30)
        r_m = sstep_gmres(op, b, **kw)
        r_n = sstep_gmres(op, b, shifts=sh, **kw)
        np.testing.assert_allclose(np.asarray(r_n.x), np.asarray(r_m.x),
                                   rtol=1e-9, atol=1e-11)

    def test_single_cycle_parity_complex_pairs(self):
        from trilinos_tpu.solvers.sstep_gmres import (ritz_shifts,
                                                      sstep_gmres)

        a = recirc2d(14, 14, diff=1e-2)
        op, b, dense, n = make_problem(a)
        sh = ritz_shifts(op, b, 4)
        assert np.abs(sh.imag).max() > 1e-8  # exercises the pair path
        kw = dict(s=4, t_blocks=3, max_restarts=0, rtol=1e-30)
        r_m = sstep_gmres(op, b, **kw)
        r_n = sstep_gmres(op, b, shifts=sh, **kw)
        np.testing.assert_allclose(np.asarray(r_n.x), np.asarray(r_m.x),
                                   rtol=1e-9, atol=1e-11)

    def test_leja_order_pairs_adjacent(self):
        from trilinos_tpu.solvers.sstep_gmres import leja_order

        vals = np.array([1.0, 2.0 + 1.0j, 2.0 - 1.0j, -3.0, 0.5 + 2.0j,
                         0.5 - 2.0j])
        out = leja_order(vals)
        assert abs(out[0]) == max(abs(vals))
        i = 0
        while i < len(out):
            if abs(out[i].imag) > 1e-12:
                assert abs(out[i + 1] - np.conj(out[i])) < 1e-12
                i += 2
            else:
                i += 1

    def test_newton_converges_s8(self):
        from trilinos_tpu.solvers.sstep_gmres import (ritz_shifts,
                                                      sstep_gmres)

        a = laplace2d(20, 20)
        op, b, dense, n = make_problem(a)
        sh = ritz_shifts(op, b, 8)
        res = sstep_gmres(op, b, s=8, t_blocks=5, max_restarts=30,
                          rtol=1e-8, shifts=sh)
        assert bool(res.converged)
        assert true_rel_res(b, dense, res.x, n) <= 1e-7

    def test_bad_shift_count_rejected(self):
        from trilinos_tpu.solvers.sstep_gmres import sstep_gmres

        a = laplace2d(10, 10)
        op, b, dense, n = make_problem(a)
        with pytest.raises(ValueError, match="shifts"):
            sstep_gmres(op, b, s=4, shifts=[1.0, 2.0])

    def test_unpaired_complex_rejected(self):
        from trilinos_tpu.solvers.sstep_gmres import newton_basis_stages

        with pytest.raises(ValueError, match="conjugate"):
            newton_basis_stages([1.0 + 1.0j, 2.0, 3.0], 1.0)


class TestBf16Basis:
    """Inexact-Krylov basis storage (gmres(basis_dtype=bfloat16)):
    basis HBM traffic halves while the working vectors/Givens stay in b's dtype; TRUE-residual-
    gated restarts act as iterative refinement over the narrow-basis
    cycles. Beyond-reference feature (Belos has no mixed-precision
    basis storage)."""

    def test_loose_tol_converges_certified(self):
        a = laplace2d(24, 24)
        op, b, dense, n = make_problem(a)
        res = gmres(op, b, restart=30, rtol=5e-3, maxiter=400,
                    basis_dtype=jnp.bfloat16)
        assert bool(res.converged)
        assert true_rel_res(b, dense, res.x, n) <= 5e-3

    def test_refinement_reaches_medium_tol(self):
        """Each cycle's reduction is bf16-limited, but restarts recompute
        the true residual in working precision — the outer loop refines
        well past eps(bf16)."""
        a = laplace2d(24, 24)
        op, b, dense, n = make_problem(a)
        res = gmres(op, b, restart=30, rtol=1e-6, maxiter=800,
                    basis_dtype=jnp.bfloat16)
        assert bool(res.converged)
        assert true_rel_res(b, dense, res.x, n) <= 1e-6

    def test_unattainable_reports_honestly(self):
        a = laplace2d(24, 24)
        op, b, dense, n = make_problem(a)
        res = gmres(op, b, restart=10, rtol=1e-12, maxiter=40,
                    basis_dtype=jnp.bfloat16)
        assert not bool(res.converged)

    def test_fgmres_outer_corrects_bf16_inner(self):
        """The FGMRES pattern: full-precision outer + bf16-basis inner
        solver reaches tight tolerance (inexact-Krylov theory)."""
        a = laplace2d(24, 24)
        op, b, dense, n = make_problem(a)
        inner = lambda v: gmres(op, v, restart=10, maxiter=10, rtol=0.0,
                                basis_dtype=jnp.bfloat16).x
        res = fgmres(op, b, prec=inner, restart=20, rtol=1e-8,
                     maxiter=300)
        assert bool(res.converged)
        assert true_rel_res(b, dense, res.x, n) <= 1e-8

    def test_default_path_unchanged(self):
        """basis_dtype=None must be bit-identical to the pre-feature
        solver (the basis array keeps b's dtype)."""
        a = laplace2d(20, 20)
        op, b, dense, n = make_problem(a)
        r1 = gmres(op, b, restart=15, rtol=1e-9)
        r2 = gmres(op, b, restart=15, rtol=1e-9, basis_dtype=b.dtype)
        assert int(r1.iters) == int(r2.iters)
        np.testing.assert_array_equal(np.asarray(r1.x), np.asarray(r2.x))


class TestSstepBf16Basis:
    def test_bf16_basis_refines_and_matches(self):
        """CA-GMRES with a bf16 orthonormal basis: true-residual-gated
        restarts certify 1e-6."""
        from trilinos_tpu.solvers.sstep_gmres import sstep_gmres

        a = laplace2d(20, 20)
        op, b, dense, n = make_problem(a)
        res = sstep_gmres(op, b, s=4, t_blocks=8, max_restarts=200,
                          rtol=1e-6, basis_dtype=jnp.bfloat16)
        assert bool(res.converged)
        assert true_rel_res(b, dense, res.x, n) <= 1e-6

    def test_dist_sstep_bf16(self):
        """basis_dtype through the one-exchange distributed CA driver."""
        import jax
        import numpy as np
        from trilinos_tpu.galeri import laplace3d
        from trilinos_tpu.parallel import driver as drv

        ops = laplace3d(16, 8, 32, dtype=np.float32, fmt="stencil")
        mesh = drv.make_mesh(4)
        rng = np.random.default_rng(3)
        b = np.zeros(ops.n_rows_pad, np.float32)
        b[:ops.n_rows] = rng.standard_normal(ops.n_rows)
        res = drv.dist_sstep_gmres(ops, jnp.asarray(b), mesh=mesh, s=2,
                                   t_blocks=4, max_restarts=100,
                                   rtol=1e-4, basis_dtype=jnp.bfloat16)
        jax.block_until_ready(res.x)
        assert bool(res.converged)


def test_unattainable_rtol_exits_on_stagnation():
    """Loss-of-accuracy guard (Belos ImpResNorm LOA): an unattainable
    rtol must end after the cycle that stops reducing the TRUE residual,
    not burn the whole maxiter budget re-running identical cycles."""
    a = laplace2d(16, 16)
    op, b, dense, n = make_problem(a)
    # 1e-30 is below the f64 attainability floor (~kappa*eps ~ 1e-14):
    # the solve must end when cycles stop reducing the true residual
    res = gmres(op, b, restart=20, rtol=1e-30, maxiter=10000)
    assert not bool(res.converged)
    # stagnation exit: far fewer than the full budget
    assert int(res.iters) < 2000


def test_bf16_basis_multivector_vmap():
    """basis_dtype composes with the pseudo-block (vmap) path: each
    column's basis is stored bf16, per-column convergence certified."""
    a = laplace2d(16, 16)
    op, b, dense, n = make_problem(a, nrhs=3)
    res = gmres(op, b, restart=25, rtol=1e-5, maxiter=600,
                basis_dtype=jnp.bfloat16)
    assert bool(np.asarray(res.converged).all())
    assert (true_rel_res(b, dense, res.x, n) <= 1e-5).all()


def test_sstep_overshoot_cycle_no_corruption():
    """A cycle that captures the residual mid-way leaves rank-deficient
    trailing basis columns; the masked LS must keep x intact (the GCRODR
    happy-breakdown defect class). m = s*t_blocks far beyond what the
    problem needs."""
    from trilinos_tpu.solvers.sstep_gmres import sstep_gmres

    a = laplace2d(6, 6)  # n=36; m=4*12=48 >> n
    op, b, dense, n = make_problem(a)
    res = sstep_gmres(op, b, s=4, t_blocks=12, max_restarts=3, rtol=1e-8)
    assert bool(res.converged)
    assert np.isfinite(np.asarray(res.x)).all()
    assert true_rel_res(b, dense, res.x, n) <= 1e-7
