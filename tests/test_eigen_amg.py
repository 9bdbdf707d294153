"""Eigensolver (Anasazi-shape) and AMG (MueLu-shape) + SpGEMM tests."""
import numpy as np
import pytest

import jax.numpy as jnp

from trilinos_tpu.galeri import laplace1d, laplace2d, laplace3d
from trilinos_tpu.ops import formats as F
from trilinos_tpu.ops import matrix_ops as MO
import trilinos_tpu.ops.matvec as S
from trilinos_tpu import precond
from trilinos_tpu.eigen import lanczos_eigs, lobpcg, power_method
from trilinos_tpu.solvers import cg


def random_csr(rng, m, n, density=0.1):
    nnz = max(int(m * n * density), 1)
    return F.CsrHost.from_coo(rng.integers(0, m, nnz),
                              rng.integers(0, n, nnz),
                              rng.standard_normal(nnz), (m, n))


class TestSpgemm:
    def test_matches_dense(self, rng):
        a = random_csr(rng, 13, 17)
        b = random_csr(rng, 17, 11)
        c = MO.spgemm(a, b)
        np.testing.assert_allclose(c.to_dense(), a.to_dense() @ b.to_dense(),
                                   atol=1e-12)

    def test_spadd(self, rng):
        a = random_csr(rng, 9, 9)
        b = random_csr(rng, 9, 9)
        c = MO.spadd(a, b, 2.0, -0.5)
        np.testing.assert_allclose(c.to_dense(),
                                   2 * a.to_dense() - 0.5 * b.to_dense(),
                                   atol=1e-12)

    def test_ptap(self, rng):
        a = random_csr(rng, 12, 12)
        p = random_csr(rng, 12, 4, density=0.3)
        c = MO.ptap(a, p)
        np.testing.assert_allclose(
            c.to_dense(), p.to_dense().T @ a.to_dense() @ p.to_dense(),
            atol=1e-12)

    def test_empty_product(self):
        a = F.CsrHost.from_coo([], [], [], (3, 3))
        b = F.CsrHost.from_coo([0], [0], [1.0], (3, 3))
        assert MO.spgemm(a, b).nnz == 0


class TestEigen:
    def test_power_method_laplace1d(self):
        a = laplace1d(50)
        dev = F.csr_to_dia(a)
        v0 = jnp.asarray(np.random.default_rng(0).standard_normal(
            dev.n_rows_pad))
        # zero the padding so identity pad rows (eigenvalue 1) don't win
        v0 = v0.at[50:].set(0)
        lam, v, k = power_method(lambda x: S.spmv(dev, x), v0,
                                 maxiter=2000, tol=1e-10)
        exact = np.linalg.eigvalsh(a.to_dense()).max()
        assert abs(float(lam) - exact) / exact < 1e-4

    def test_lanczos_extreme_eigs(self):
        a = laplace2d(10, 10)
        dev = F.csr_to_dia(a)
        v0 = np.zeros(dev.n_rows_pad)
        v0[:100] = np.random.default_rng(1).standard_normal(100)
        theta, vecs = lanczos_eigs(
            lambda x: S.spmv(dev, x), jnp.asarray(v0), nev=3,
            m=60, which="LA")
        exact = np.sort(np.linalg.eigvalsh(a.to_dense()))[::-1][:3]
        np.testing.assert_allclose(np.sort(np.asarray(theta))[::-1], exact,
                                   rtol=1e-6)

    def test_lobpcg_smallest(self):
        a = laplace2d(8, 8)
        dev = F.csr_to_dia(a)
        npad = dev.n_rows_pad
        rng = np.random.default_rng(2)
        x0 = np.zeros((npad, 3))
        x0[:64] = rng.standard_normal((64, 3))
        # Jacobi preconditioner helps: M = D^-1
        res = lobpcg(lambda x: S.spmv(dev, x), jnp.asarray(x0),
                     tol=1e-8, maxiter=300)
        exact = np.sort(np.linalg.eigvalsh(a.to_dense()))[:3]
        got = np.sort(np.asarray(res.eigenvalues))
        # identity padding rows contribute eigenvalue-1 eigenvectors; the
        # smallest Laplace2D(8) eigenvalues are < 1 so they win
        np.testing.assert_allclose(got, exact, rtol=1e-5)

    def test_lobpcg_largest(self):
        a = laplace1d(40)
        dev = F.csr_to_dia(a)
        npad = dev.n_rows_pad
        x0 = np.zeros((npad, 2))
        x0[:40] = np.random.default_rng(3).standard_normal((40, 2))
        res = lobpcg(lambda x: S.spmv(dev, x), jnp.asarray(x0),
                     which="LM", tol=1e-8, maxiter=300)
        exact = np.sort(np.linalg.eigvalsh(a.to_dense()))[::-1][:2]
        got = np.sort(np.asarray(res.eigenvalues))[::-1]
        np.testing.assert_allclose(got, exact, rtol=1e-5)


class TestAmg:
    def test_aggregation_covers(self):
        a = laplace2d(10, 10)
        agg = precond.amg.aggregate(a)
        assert (agg >= 0).all()
        assert int(agg.max()) + 1 < 100  # actually coarsens

    def test_hierarchy_depth(self):
        a = laplace2d(30, 30)
        m = precond.SaAmg(a, {"coarse: max size": 50}).compute()
        assert m.n_levels() >= 3

    def test_vcycle_reduces_error(self):
        a = laplace2d(20, 20)
        m = precond.SaAmg(a).compute()
        dev = F.csr_to_dia(a)
        rng = np.random.default_rng(4)
        b = np.zeros(dev.n_rows_pad)
        b[:400] = rng.standard_normal(400)
        x = m(jnp.asarray(b))  # one V-cycle on A x = b
        r = b[:400] - a.to_dense() @ np.asarray(x)[:400]
        assert np.linalg.norm(r) < 0.35 * np.linalg.norm(b[:400])

    def test_amg_pcg_fast_convergence(self):
        a = laplace2d(24, 24)
        dev = F.csr_to_dia(a)
        m = precond.SaAmg(a).compute()
        rng = np.random.default_rng(5)
        b = np.zeros(dev.n_rows_pad)
        n = 576
        b[:n] = rng.standard_normal(n)
        op = lambda x: S.spmv(dev, x)
        plain = cg(op, jnp.asarray(b), rtol=1e-8, maxiter=3000)
        amgd = cg(op, jnp.asarray(b), prec=m, rtol=1e-8, maxiter=3000)
        x = np.asarray(amgd.x)[:n]
        rel = np.linalg.norm(b[:n] - a.to_dense() @ x) / np.linalg.norm(b[:n])
        assert rel <= 1.1e-8
        assert int(amgd.iters) < 0.4 * int(plain.iters)

    def test_factory_name(self):
        a = laplace2d(6, 6)
        p = precond.create("SA-AMG", a)
        assert isinstance(p, precond.SaAmg)


class TestAmgWcycle:
    def test_w_cycle_at_least_as_good(self):
        a = laplace2d(24, 24)
        v = precond.SaAmg(a, {"coarse: max size": 30}).compute()
        w = precond.SaAmg(a, {"coarse: max size": 30,
                              "cycle type": "W"}).compute()
        dev = F.csr_to_dia(a)
        rng = np.random.default_rng(9)
        b = np.zeros(dev.n_rows_pad)
        n = 576
        b[:n] = rng.standard_normal(n)
        rv = b[:n] - a.to_dense() @ np.asarray(v(jnp.asarray(b)))[:n]
        rw = b[:n] - a.to_dense() @ np.asarray(w(jnp.asarray(b)))[:n]
        assert np.linalg.norm(rw) <= np.linalg.norm(rv) * 1.05


class TestMatrixFreeFineAmg:
    """SA-AMG with a matrix-free stencil fine level (+ fused Chebyshev
    smoothing): the dominant level-0 cost runs on the framework's
    fastest operator."""

    def _setup(self, smoother):
        from trilinos_tpu.galeri import laplace2d

        a = laplace2d(24, 24)
        op = laplace2d(24, 24, fmt="stencil")
        # pin the uncoupled hierarchy: these tests compare the
        # matrix-free fine level against the stored-matrix V-cycle
        # (auto would pick structured aggregation for a StencilOp)
        m = precond.SaAmg(a, {
            "fine: matrix-free operator": op,
            "smoother: type": smoother,
            "aggregation: type": "uncoupled",
        }).compute()
        return a, op, m

    def test_matches_stored_amg_jacobi(self):
        """Same hierarchy, jacobi smoothing: the matrix-free fine level
        reproduces the stored-matrix V-cycle."""
        a, op, m_free = self._setup("jacobi")
        m_stored = precond.SaAmg(a).compute()
        n = a.shape[0]
        rng = np.random.default_rng(6)
        b = np.zeros(op.n_rows_pad)
        b[:n] = rng.standard_normal(n)
        y_free = np.asarray(m_free(jnp.asarray(b)))[:n]
        b2 = np.zeros(m_stored.levels[0]["n_f"])
        b2[:n] = b[:n]
        y_stored = np.asarray(m_stored(jnp.asarray(b2)))[:n]
        np.testing.assert_allclose(y_free, y_stored, rtol=1e-10,
                                   atol=1e-12)

    def test_chebyshev_fine_smoother_cg(self):
        """Fused-Chebyshev fine smoothing: CG converges at AMG speed."""
        a, op, m = self._setup("chebyshev")
        n = a.shape[0]
        rng = np.random.default_rng(7)
        b = np.zeros(op.n_rows_pad)
        b[:n] = rng.standard_normal(n)
        amgd = cg(lambda v: S.spmv(op, v), jnp.asarray(b),
                  prec=m, rtol=1e-8, maxiter=300)
        assert bool(amgd.converged)
        x = np.asarray(amgd.x)[:n]
        rel = (np.linalg.norm(b[:n] - a.to_dense() @ x)
               / np.linalg.norm(b[:n]))
        assert rel <= 1.1e-8
        plain = cg(lambda v: S.spmv(op, v), jnp.asarray(b),
                   rtol=1e-8, maxiter=3000)
        assert int(amgd.iters) < 0.4 * int(plain.iters)

    def test_chebyshev_without_fine_op_rejected(self):
        from trilinos_tpu.galeri import laplace2d

        with np.testing.assert_raises(ValueError):
            precond.SaAmg(laplace2d(8, 8),
                          {"smoother: type": "chebyshev"}).compute()
