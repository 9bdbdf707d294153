"""GCRO-DR recycling tests: deflated restarts + cross-solve recycling.

Mirrors the reference's GCRODR use case — a SEQUENCE of related systems
where the recycle space cuts iterations on later solves
(packages/belos/epetra/example/GCRODR/)."""
import numpy as np
import pytest

import jax.numpy as jnp

from trilinos_tpu.galeri import laplace2d, recirc2d
from trilinos_tpu.ops import formats as F
import trilinos_tpu.ops.matvec as S
from trilinos_tpu.solvers.gcrodr import RecycleSpace, gcrodr


def make_problem(a_csr, seed=0):
    dev = F.csr_to_dia(a_csr)
    n, npad = a_csr.shape[0], dev.n_rows_pad
    b = np.zeros(npad)
    b[:n] = np.random.default_rng(seed).standard_normal(n)
    return (lambda x: S.spmv(dev, x)), jnp.asarray(b), \
        a_csr.to_dense(), n


def test_converges_and_builds_recycle():
    a = recirc2d(16, 16, diff=1e-2)
    op, b, dense, n = make_problem(a)
    res, rec = gcrodr(op, b, num_blocks=25, recycle_dim=6, rtol=1e-8)
    x = np.asarray(res.x)[:n]
    rel = np.linalg.norm(b[:n] - dense @ np.asarray(x)) / np.linalg.norm(
        np.asarray(b)[:n])
    assert rel <= 1e-7
    assert rec.size == 6


def test_recycling_reduces_cycles_on_second_solve():
    a = laplace2d(20, 20)
    op, b, dense, n = make_problem(a, seed=1)
    res1, rec = gcrodr(op, b, num_blocks=15, recycle_dim=8, rtol=1e-8)
    # second solve: same operator, new RHS, recycled space
    _, b2, _, _ = make_problem(a, seed=2)
    res2_cold, _ = gcrodr(op, b2, num_blocks=15, recycle_dim=8, rtol=1e-8)
    res2_warm, _ = gcrodr(op, b2, num_blocks=15, recycle_dim=8, rtol=1e-8,
                          recycle=rec)
    assert bool(res2_warm.converged)
    assert int(res2_warm.iters) <= int(res2_cold.iters)


def test_recycle_space_invariant():
    """A U = C and CᵀC = I must hold for the returned space."""
    a = laplace2d(12, 12)
    op, b, dense, n = make_problem(a)
    _, rec = gcrodr(op, b, num_blocks=12, recycle_dim=4, rtol=1e-8)
    au = np.asarray(op(rec.u))
    c = np.asarray(rec.c)
    np.testing.assert_allclose(c.T @ c, np.eye(4), atol=1e-10)
    np.testing.assert_allclose(au, c @ (c.T @ au), atol=1e-8)


class TestBlockGcrodr:
    """Block GCRO-DR (BelosBlockGCRODRSolMgr analogue): shared Krylov +
    recycle space over all right-hand sides."""

    def _problem(self):
        from trilinos_tpu.galeri import laplace2d
        from trilinos_tpu.ops import choose_format, spmv

        a = laplace2d(16, 16)
        dev = choose_format(a)
        n, npad = a.shape[0], dev.n_rows_pad
        rng = np.random.default_rng(1)
        b = np.zeros((npad, 3))
        b[:n] = rng.standard_normal((n, 3))
        return a, (lambda v: spmv(dev, v)), n, npad, b

    def test_converges_multirhs(self):
        from trilinos_tpu.solvers.block_gcrodr import block_gcrodr

        a, op, n, npad, b = self._problem()
        res, rec = block_gcrodr(op, jnp.asarray(b), num_blocks=15,
                                recycle_dim=6, rtol=1e-10)
        assert bool(np.asarray(res.converged).all())
        x = np.asarray(res.x)[:n]
        for j in range(3):
            want = np.linalg.solve(a.to_dense(), b[:n, j])
            np.testing.assert_allclose(x[:, j], want, rtol=1e-7,
                                       atol=1e-9)
        assert rec.u is not None and rec.u.shape[1] == 6

    def test_recycling_helps_second_solve(self):
        """A second related solve with the returned recycle space takes
        no more cycles than the cold solve (the sequence-of-systems
        feature)."""
        from trilinos_tpu.solvers.block_gcrodr import block_gcrodr

        a, op, n, npad, b = self._problem()
        res1, rec = block_gcrodr(op, jnp.asarray(b), num_blocks=8,
                                 recycle_dim=8, rtol=1e-8)
        rng = np.random.default_rng(2)
        b2 = np.zeros((npad, 3))
        b2[:n] = rng.standard_normal((n, 3))
        cold, _ = block_gcrodr(op, jnp.asarray(b2), num_blocks=8,
                               recycle_dim=8, rtol=1e-8)
        warm, _ = block_gcrodr(op, jnp.asarray(b2), num_blocks=8,
                               recycle_dim=8, rtol=1e-8, recycle=rec)
        assert bool(np.asarray(warm.converged).all())
        assert int(warm.iters) <= int(cold.iters)
        x = np.asarray(warm.x)[:n]
        want = np.linalg.solve(a.to_dense(), b2[:n])
        np.testing.assert_allclose(x, want, rtol=1e-5, atol=1e-7)

    def test_rejects_1d(self):
        from trilinos_tpu.solvers.block_gcrodr import block_gcrodr

        _, op, n, npad, b = self._problem()
        with pytest.raises(ValueError):
            block_gcrodr(op, jnp.asarray(b[:, 0]))

    def test_factory_dispatch(self):
        """'Block GCRODR' must run the BLOCK solver, not the scalar one
        (no silent aliasing)."""
        from trilinos_tpu import solvers as S
        from trilinos_tpu.solvers.factory import create_solver
        from trilinos_tpu.solvers.linear_problem import LinearProblem

        a, op, n, npad, b = self._problem()
        mgr = create_solver("Block GCRODR",
                            {"Convergence Tolerance": 1e-8,
                             "Num Blocks": 10})
        prob = LinearProblem(op, jnp.asarray(b))
        res = mgr.solve(prob)
        assert res.x.shape == (npad, 3)
        assert bool(np.asarray(res.converged).all())
        assert mgr.recycle_space.u is not None


class TestPreconditionedRecyclers:
    """prec= on the recycle drivers (BelosGCRODRSolMgr / BelosRCGSolMgr
    run preconditioned): right-composed for the GMRES-type recyclers
    (residuals of (A.M)y = r0 ARE the true residuals), deflated PCG for
    rcg."""

    def _jacobi(self, dense, npad, n):
        d = np.ones(npad)
        d[:n] = np.diag(dense)
        dinv = jnp.asarray(1.0 / d)
        return lambda v: dinv * v if v.ndim == 1 else dinv[:, None] * v

    def test_gcrodr_prec_converges_and_helps(self):
        a = recirc2d(16, 16, diff=1e-2)
        op, b, dense, n = make_problem(a)
        M = self._jacobi(dense, b.shape[0], n)
        res, rec = gcrodr(op, b, num_blocks=25, recycle_dim=6,
                          rtol=1e-8, prec=M)
        assert bool(res.converged)
        rel = np.linalg.norm(
            np.asarray(b)[:n] - dense @ np.asarray(res.x)[:n]
        ) / np.linalg.norm(np.asarray(b)[:n])
        assert rel <= 1e-7
        # recycle space reuse with the SAME prec still works
        res2, _ = gcrodr(op, b, num_blocks=25, recycle_dim=6,
                         rtol=1e-8, prec=M, recycle=rec)
        assert bool(res2.converged)

    def test_block_gcrodr_prec(self):
        from trilinos_tpu.solvers.block_gcrodr import block_gcrodr

        a = laplace2d(16, 16)
        op, b, dense, n = make_problem(a)
        bb = jnp.stack([b, 0.7 * b], axis=1)
        M = self._jacobi(dense, b.shape[0], n)
        res, _ = block_gcrodr(op, bb, num_blocks=20, recycle_dim=4,
                              max_cycles=40, rtol=1e-8, prec=M)
        assert bool(np.asarray(res.converged).all())
        x = np.asarray(res.x)[:n]
        r = np.asarray(bb)[:n] - dense @ x
        rel = np.linalg.norm(r, axis=0) / np.linalg.norm(
            np.asarray(bb)[:n], axis=0)
        assert (rel <= 1e-7).all()

    def test_rcg_prec_deflated_pcg(self):
        from trilinos_tpu.solvers.rcg import rcg

        a = laplace2d(20, 20)
        op, b, dense, n = make_problem(a, seed=3)
        M = self._jacobi(dense, b.shape[0], n)
        res_p, _ = rcg(op, b, recycle_dim=6, rtol=1e-9, prec=M)
        res_u, _ = rcg(op, b, recycle_dim=6, rtol=1e-9)
        assert bool(res_p.converged) and bool(res_u.converged)
        rel = np.linalg.norm(
            np.asarray(b)[:n] - dense @ np.asarray(res_p.x)[:n]
        ) / np.linalg.norm(np.asarray(b)[:n])
        assert rel <= 1e-8


def test_recycle_across_changed_matrix():
    """The sequence-of-systems case (the reference's GCRODR headline,
    BelosGCRODRSolMgr: C = A U is recomputed per system): reusing the
    recycle space with a DIFFERENT matrix must re-map C = A_new U —
    the stale-C bug diverged to 1e12 before the fix."""
    a1 = laplace2d(20, 20)
    op1, b, dense1, n = make_problem(a1, seed=2)
    res1, rec = gcrodr(op1, b, num_blocks=15, recycle_dim=6, rtol=1e-8)
    assert bool(res1.converged)

    # shifted matrix: same pattern, different values
    from trilinos_tpu.ops.formats import CsrHost

    diag_bump = 0.5 * (a1.cols == np.repeat(
        np.arange(a1.shape[0]), a1.row_lengths()))
    a2 = CsrHost(a1.row_ptr, a1.cols, a1.vals + diag_bump, a1.shape)
    op2, _, dense2, _ = make_problem(a2, seed=2)
    res2, _ = gcrodr(op2, b, num_blocks=15, recycle_dim=6, rtol=1e-8,
                     recycle=rec)
    assert bool(res2.converged)
    x = np.asarray(res2.x)[:n]
    rel = np.linalg.norm(np.asarray(b)[:n] - dense2 @ x) \
        / np.linalg.norm(np.asarray(b)[:n])
    assert rel <= 1e-7
