"""Sparse direct solver (Amesos2 lifecycle + native Gilbert-Peierls LU;
reference: packages/amesos2/src/Amesos2_SolverCore_decl.hpp,
Amesos2_KLU2_decl.hpp)."""
import numpy as np
import pytest

from trilinos_tpu.galeri import laplace2d, recirc2d
from trilinos_tpu.ops.formats import CsrHost
from trilinos_tpu.solvers.direct import SparseLu, direct_solve


class TestSparseLu:
    def test_spd_laplace(self, rng):
        a = laplace2d(15, 13)
        b = rng.standard_normal(a.shape[0])
        x = direct_solve(a, b)
        np.testing.assert_allclose(a.to_dense() @ x, b, rtol=1e-10,
                                   atol=1e-12)

    def test_nonsymmetric_needs_pivoting(self, rng):
        a = recirc2d(12, 12, diff=1e-3)  # strongly nonsymmetric
        b = rng.standard_normal(a.shape[0])
        x = direct_solve(a, b)
        np.testing.assert_allclose(a.to_dense() @ x, b, rtol=1e-8,
                                   atol=1e-10)

    def test_zero_diagonal_pivoting(self):
        # requires row pivoting: zero on the diagonal
        dense = np.array([[0.0, 2.0, 0.0],
                          [1.0, 0.0, 3.0],
                          [0.0, 4.0, 1.0]])
        a = CsrHost.from_dense(dense)
        b = np.array([2.0, 7.0, 9.0])
        x = direct_solve(a, b)
        np.testing.assert_allclose(dense @ x, b, rtol=1e-12, atol=1e-12)

    def test_multivector_rhs(self, rng):
        a = laplace2d(10, 8)
        b = rng.standard_normal((a.shape[0], 3))
        x = SparseLu(a).factor().solve(b)
        np.testing.assert_allclose(a.to_dense() @ x, b, rtol=1e-10,
                                   atol=1e-12)

    def test_native_matches_scipy(self, rng):
        from trilinos_tpu.native import splu_native

        a = recirc2d(8, 8, diff=1e-2)
        b = rng.standard_normal(a.shape[0])
        slu = SparseLu(a)
        slu.numeric_factorization()
        if slu._factors is None:
            pytest.skip("native toolchain unavailable")
        x_native = slu.solve(b)
        import scipy.sparse as sp
        import scipy.sparse.linalg as spla

        m = sp.csr_matrix((a.vals.astype(np.float64), a.cols, a.row_ptr),
                          shape=a.shape).tocsc()
        x_scipy = spla.splu(m).solve(b)
        np.testing.assert_allclose(x_native, x_scipy, rtol=1e-9, atol=1e-11)


def test_direct_as_preconditioner(rng):
    """Amesos2Wrapper analogue: exact-solve preconditioner => CG in 1-2
    iterations (Ifpack2_Details_Amesos2Wrapper_decl.hpp)."""
    import os
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax.numpy as jnp

    from trilinos_tpu import precond as PC
    from trilinos_tpu.ops import formats as F, matvec as S
    from trilinos_tpu.solvers import cg

    a = laplace2d(12, 10)
    dev = F.csr_to_dia(a)
    n, npad = a.shape[0], dev.n_rows_pad
    b = np.zeros(npad)
    b[:n] = rng.standard_normal(n)
    prec = PC.create("AMESOS2", a).compute()
    res = cg(lambda v: S.spmv(dev, v), jnp.asarray(b),
             prec=prec.apply, rtol=1e-10, maxiter=10)
    assert bool(res.converged.all())
    assert int(res.iters) <= 2, int(res.iters)


class TestSparseCholesky:
    """LL^T direct solver (the Tacho/Cholmod role:
    packages/amesos2/src/Amesos2_Tacho_decl.hpp; native up-looking
    factorization with elimination-tree symbolics)."""

    def test_spd_laplace(self, rng):
        from trilinos_tpu.solvers.direct import SparseCholesky

        a = laplace2d(15, 13)
        b = rng.standard_normal(a.shape[0])
        ch = SparseCholesky(a).factor()
        x = ch.solve(b)
        np.testing.assert_allclose(a.to_dense() @ x, b, rtol=1e-10,
                                   atol=1e-12)
        # LL^T has no pivoting: nnz(L) is at most LU's total fill
        lu = SparseLu(a).factor()
        if ch._fallback is None and lu._factors is not None:
            assert ch.nnz_factors <= lu.nnz_factors

    def test_multivector_rhs(self, rng):
        from trilinos_tpu.solvers.direct import SparseCholesky

        a = laplace2d(10, 8)
        b = rng.standard_normal((a.shape[0], 3))
        x = SparseCholesky(a).factor().solve(b)
        np.testing.assert_allclose(a.to_dense() @ x, b, rtol=1e-10,
                                   atol=1e-12)

    def test_not_spd_raises(self, rng):
        from trilinos_tpu.solvers.direct import SparseCholesky

        dense = np.array([[1.0, 2.0], [2.0, 1.0]])  # indefinite
        a = CsrHost.from_dense(dense)
        ch = SparseCholesky(a)
        from trilinos_tpu.native import lib

        if lib() is None:
            pytest.skip("native toolchain unavailable")
        with pytest.raises(ValueError):
            ch.factor()

    def test_factor_matches_dense_cholesky(self, rng):
        from trilinos_tpu.native import spchol_native

        a = laplace2d(7, 6)
        f = spchol_native(a.shape[0], a.row_ptr, a.cols, a.vals)
        if f is None:
            pytest.skip("native toolchain unavailable")
        l_ptr, l_cols, l_vals = f
        n = a.shape[0]
        dense_l = np.zeros((n, n))
        for j in range(n):
            for q in range(l_ptr[j], l_ptr[j + 1]):
                dense_l[l_cols[q], j] = l_vals[q]
        ref = np.linalg.cholesky(a.to_dense())
        np.testing.assert_allclose(dense_l, ref, rtol=1e-10, atol=1e-12)

    def test_factory_tacho_prec(self, rng):
        import jax.numpy as jnp

        from trilinos_tpu import precond

        a = laplace2d(8, 8)
        m = precond.create("TACHO", a).compute()
        n = a.shape[0]
        npad = m.inv_dense.shape[0]
        r = np.zeros(npad)
        r[:n] = rng.standard_normal(n)
        y = np.asarray(m(jnp.asarray(r)))[:n]
        np.testing.assert_allclose(a.to_dense() @ y, r[:n], rtol=1e-6,
                                   atol=1e-8)
