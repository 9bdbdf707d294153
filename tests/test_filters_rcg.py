"""Matrix filters, condest, debug-mode checks, RCG tests."""
import os

import numpy as np
import pytest

import jax.numpy as jnp

from trilinos_tpu.galeri import laplace2d, laplace1d
from trilinos_tpu.ops import filters, formats as F
import trilinos_tpu.ops.matvec as S


class TestFilters:
    def test_local_filter(self):
        a = laplace2d(6, 6)
        f = filters.local_filter(a, 6, 18)
        assert f.shape == (12, 12)
        np.testing.assert_allclose(f.to_dense(), a.to_dense()[6:18, 6:18])

    def test_diagonal_filter(self):
        a = laplace1d(8)
        f = filters.diagonal_filter(a, absolute_threshold=0.5,
                                    relative_threshold=2.0)
        np.testing.assert_allclose(np.diag(f.to_dense()), 4.5 * np.ones(8))

    def test_drop_filter(self):
        a = F.CsrHost.from_dense(np.array([[2.0, 0.01], [0.5, 3.0]]))
        f = filters.drop_filter(a, 0.1)
        np.testing.assert_allclose(f.to_dense(), [[2.0, 0], [0.5, 3.0]])

    def test_sparsity_filter(self):
        a = laplace2d(5, 5)
        f = filters.sparsity_filter(a, max_entries_per_row=2)
        assert f.row_lengths().max() <= 3  # 2 off-diag + diag

    def test_singleton_filter(self):
        dense = np.array([[1.0, 0, 0], [0, 2.0, -1], [0, -1, 2.0]])
        a = F.CsrHost.from_dense(dense)
        f, kept = filters.singleton_filter(a)
        np.testing.assert_array_equal(kept, [1, 2])
        np.testing.assert_allclose(f.to_dense(), dense[1:, 1:])

    def test_condest(self):
        a = laplace2d(8, 8)
        from trilinos_tpu import precond

        m = precond.Relaxation(a).compute()
        c = filters.condest(m, 64, method="cheap")
        assert 0.2 < c < 0.3  # 1/4 diag inverse
        cp = filters.condest(m, 64, method="power")
        assert 0.2 < cp < 0.3


class TestDebugMode:
    def test_tt_debug_validates_plan(self, monkeypatch):
        from trilinos_tpu.parallel import distmatrix as D
        from trilinos_tpu.utils import behavior

        monkeypatch.setenv("TT_DEBUG", "1")
        behavior.reset_cache()
        try:
            a = laplace2d(10, 10)
            dm = D.distribute(a, 4)  # must not raise
            assert dm.plan.mode == "ppermute"
        finally:
            monkeypatch.delenv("TT_DEBUG")
            behavior.reset_cache()


class TestRcg:
    def _problem(self, seed):
        a = laplace2d(16, 16)
        dev = F.csr_to_dia(a)
        n = 256
        b = np.zeros(dev.n_rows_pad)
        b[:n] = np.random.default_rng(seed).standard_normal(n)
        return (lambda x: S.spmv(dev, x)), jnp.asarray(b), \
            a.to_dense(), n

    def test_converges_faster_than_cg(self):
        from trilinos_tpu.solvers import cg, rcg

        op, b, dense, n = self._problem(0)
        plain = cg(op, b, rtol=1e-8, maxiter=3000)
        res, rec = rcg(op, b, recycle_dim=8, rtol=1e-8, maxiter=3000)
        x = np.asarray(res.x)[:n]
        rel = np.linalg.norm(np.asarray(b)[:n] - dense @ x) / np.linalg.norm(
            np.asarray(b)[:n])
        assert rel <= 1.1e-8
        assert int(res.iters) < int(plain.iters)
        assert rec.size == 8

    def test_recycle_across_solves(self):
        from trilinos_tpu.solvers import rcg

        op, b, dense, n = self._problem(1)
        res1, rec = rcg(op, b, recycle_dim=6, rtol=1e-8)
        op2, b2, _, _ = self._problem(2)
        res2, _ = rcg(op, b2, recycle_dim=6, rtol=1e-8, recycle=rec)
        assert bool(res2.converged)
        # warm solve skips the Lanczos build (~4k+20 operator applies);
        # its CG iterations stay in the same ballpark
        from trilinos_tpu.solvers import cg

        plain = cg(op, b2, rtol=1e-8, maxiter=3000)
        assert int(res2.iters) < int(plain.iters)


class TestPcpg:
    def test_constrained_solve(self):
        from trilinos_tpu.solvers import cg, pcpg
        from trilinos_tpu.eigen import lanczos_eigs

        a = laplace2d(16, 16)
        dev = F.csr_to_dia(a)
        n = 256
        b = np.zeros(dev.n_rows_pad)
        b[:n] = np.random.default_rng(3).standard_normal(n)
        op = lambda x: S.spmv(dev, x)
        # constraint basis: lowest modes (the FETI coarse-space use case)
        _, u = lanczos_eigs(op, jnp.asarray(b), nev=4, m=40, which="SA")
        res = pcpg(op, jnp.asarray(b), u, rtol=1e-8, maxiter=2000)
        plain = cg(op, jnp.asarray(b), rtol=1e-8, maxiter=3000)
        x = np.asarray(res.x)[:n]
        rel = np.linalg.norm(b[:n] - a.to_dense() @ x) / np.linalg.norm(
            b[:n])
        assert rel <= 1.1e-8
        assert int(res.iters) < int(plain.iters)

    def test_factory_requires_basis(self):
        from trilinos_tpu.solvers import LinearProblem, create_solver

        mgr = create_solver("PCPG")
        import jax.numpy as jnp

        with pytest.raises(ValueError, match="constraint_basis"):
            mgr.solve(LinearProblem(lambda x: x, jnp.ones(8)))


def test_condest_lanczos():
    """Two-sided Lanczos condition estimate (AZ_cg_condnum role) matches
    the true spectral condition number of an SPD operator."""
    import numpy as np

    from trilinos_tpu.galeri import laplace2d
    from trilinos_tpu.ops import choose_format, spmv
    from trilinos_tpu.ops.filters import condest

    a = laplace2d(16, 16)
    dev = choose_format(a)
    n, npad = a.shape[0], dev.n_rows_pad

    def op(v):
        # mask padding so the identity pad rows don't pollute the
        # small end of the spectrum
        import jax.numpy as jnp
        mask = jnp.arange(npad) < n
        return jnp.where(mask, spmv(dev, jnp.where(mask, v, 0.0)), 0.0)

    got = condest(op, npad, method="lanczos", iters=30)
    want = float(np.linalg.cond(a.to_dense()))
    assert abs(got - want) / want < 0.05


def test_rcg_recycle_across_changed_matrix():
    """Sequence-of-systems reuse: the deflation factors AU/(U^T A U)^-1
    must be re-mapped onto the CURRENT operator (stale factors from the
    previous system break A-orthogonality and the span(U) correction's
    idempotence — the gcrodr defect class)."""
    import jax.numpy as jnp
    from trilinos_tpu.galeri import laplace2d
    from trilinos_tpu.ops import formats as F
    from trilinos_tpu.ops import matvec as S
    from trilinos_tpu.ops.formats import CsrHost
    from trilinos_tpu.solvers.rcg import rcg

    a1 = laplace2d(20, 20)
    dev1 = F.csr_to_dia(a1)
    n, npad = a1.shape[0], dev1.n_rows_pad
    rng = np.random.default_rng(4)
    b = np.zeros(npad)
    b[:n] = rng.standard_normal(n)
    r1, rec = rcg(lambda v: S.spmv(dev1, v), jnp.asarray(b),
                  recycle_dim=6, rtol=1e-9)
    assert bool(r1.converged)

    bump = 0.5 * (a1.cols == np.repeat(np.arange(n), a1.row_lengths()))
    a2 = CsrHost(a1.row_ptr, a1.cols, a1.vals + bump, a1.shape)
    dev2 = F.csr_to_dia(a2)
    r2, _ = rcg(lambda v: S.spmv(dev2, v), jnp.asarray(b),
                recycle_dim=6, rtol=1e-9, recycle=rec)
    assert bool(r2.converged)
    x = np.asarray(r2.x)[:n]
    rel = np.linalg.norm(b[:n] - a2.to_dense() @ x) / np.linalg.norm(b[:n])
    assert rel <= 1e-8
