"""Round-2 solver additions: stochastic CG, block-GMRES early exit.

References: packages/belos/src/BelosPseudoBlockStochasticCGIter.hpp
(stochastic sampler); packages/belos/src/BelosBlockGmresIter.hpp:676
(per-step status testing inside the cycle)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from trilinos_tpu.galeri import laplace1d, laplace2d
from trilinos_tpu.ops import matvec as S
from trilinos_tpu.ops import formats as F
from trilinos_tpu.solvers import block_gmres, stochastic_cg


def make_problem(a_csr, nrhs=0, seed=3):
    dev = F.csr_to_dia(a_csr)
    n = a_csr.shape[0]
    npad = dev.n_rows_pad
    rng = np.random.default_rng(seed)
    shape = (npad,) if nrhs == 0 else (npad, nrhs)
    b = np.zeros(shape)
    b[:n] = rng.standard_normal((n,) if nrhs == 0 else (n, nrhs))
    op = lambda x: S.spmv(dev, x)
    return op, jnp.asarray(b), a_csr.to_dense(), n


class TestStochasticCG:
    def test_solves_system(self):
        a = laplace2d(20, 20)
        op, b, dense, n = make_problem(a)
        res, y = stochastic_cg(op, b, rtol=1e-8, maxiter=2000)
        assert bool(res.converged.all())
        x = np.asarray(res.x)[:n]
        assert np.linalg.norm(np.asarray(b)[:n] - dense @ x) <= \
            1.1e-8 * np.linalg.norm(np.asarray(b)[:n])
        assert y.shape == b.shape and float(jnp.sum(y * y)) > 0

    def test_sample_covariance_is_ainv(self):
        """E[y y'] = A^{-1} for the Parker-Fox sampler (CG run to full
        accuracy => exact in exact arithmetic); statistical check."""
        a = laplace1d(16)
        op, b, dense, n = make_problem(a)
        keys = jax.random.split(jax.random.PRNGKey(7), 400)

        def draw(key):
            _, y = stochastic_cg(op, b, rtol=1e-12, maxiter=100, key=key)
            return y[:n]

        ys = jax.vmap(draw)(keys)  # (K, n)
        cov = np.cov(np.asarray(ys).T, bias=True)
        ainv = np.linalg.inv(dense)
        # sampling error ~ 1/sqrt(K); compare in Frobenius norm
        rel = np.linalg.norm(cov - ainv) / np.linalg.norm(ainv)
        assert rel < 0.35, rel
        tr_rel = abs(np.trace(cov) - np.trace(ainv)) / np.trace(ainv)
        assert tr_rel < 0.15, tr_rel


class TestCaGmres:
    """gmres_single_reduce / gmres_pipeline parity with plain GMRES
    (Belos_Tpetra_GmresSingleReduce.hpp, Belos_Tpetra_GmresPipeline.hpp)."""

    def _problem(self, nonsym=True):
        from trilinos_tpu.galeri import recirc2d
        a = (recirc2d(16, 16, diff=1e-2) if nonsym else laplace2d(16, 16))
        return make_problem(a)

    @pytest.mark.parametrize("nonsym", [False, True])
    def test_iteration_parity(self, nonsym):
        from trilinos_tpu.solvers import (gmres, gmres_pipeline,
                                          gmres_single_reduce)

        op, b, dense, n = self._problem(nonsym)
        k0 = int(gmres(op, b, rtol=1e-8, restart=40).iters)
        for fn in (gmres_single_reduce, gmres_pipeline):
            res = fn(op, b, rtol=1e-8, restart=40)
            assert bool(res.converged.all()), fn.__name__
            x = np.asarray(res.x)[:n]
            rel = (np.linalg.norm(np.asarray(b)[:n] - dense @ x)
                   / np.linalg.norm(np.asarray(b)[:n]))
            assert rel <= 2e-8, (fn.__name__, rel)
            assert abs(int(res.iters) - k0) <= 3, (fn.__name__,
                                                   int(res.iters), k0)

    def test_preconditioned_and_multivector(self):
        from trilinos_tpu.solvers import gmres_single_reduce

        a = laplace2d(12, 12)
        op, b, dense, n = make_problem(a, nrhs=2)
        dinv = np.ones(b.shape[0])
        dinv[:n] = 1.0 / np.diag(dense)
        prec = lambda v: jnp.asarray(dinv)[:, None] * v \
            if v.ndim == 2 else jnp.asarray(dinv) * v
        res = gmres_single_reduce(op, b, prec=lambda v: (
            jnp.asarray(dinv)[:, None] if v.ndim == 2
            else jnp.asarray(dinv)) * v, rtol=1e-9, restart=40)
        assert bool(res.converged.all())
        x = np.asarray(res.x)[:n]
        r = np.asarray(b)[:n] - dense @ x
        rel = np.linalg.norm(r, axis=0) / np.linalg.norm(
            np.asarray(b)[:n], axis=0)
        assert (rel <= 2e-9).all()

    def test_factory_names(self):
        from trilinos_tpu.solvers import SolverManager, LinearProblem

        a = laplace2d(10, 10)
        op, b, dense, n = make_problem(a)
        for name in ("Single Reduce GMRES", "Pipelined GMRES"):
            mgr = SolverManager(name, {"Convergence Tolerance": 1e-8})
            res = mgr.solve(LinearProblem(op, b))
            assert bool(res.converged.all()), name


class TestBlockGmresEarlyExit:
    def test_iters_counts_block_steps(self):
        """Cycle must exit at convergence, not run all num_blocks steps
        (honest iteration count, Belos per-step status tests)."""
        a = laplace2d(8, 8)  # n=64; converges well inside one m=40 cycle
        op, b, dense, n = make_problem(a, nrhs=2)
        res = block_gmres(op, b, num_blocks=40, rtol=1e-8)
        assert bool(res.converged.all())
        assert int(res.iters) < 40, "no early exit inside the cycle"
        x = np.asarray(res.x)[:n]
        r = np.asarray(b)[:n] - dense @ x
        rel = np.linalg.norm(r, axis=0) / np.linalg.norm(
            np.asarray(b)[:n], axis=0)
        assert (rel <= 2e-8).all()

    def test_matches_restarted_solution(self):
        a = laplace2d(12, 12)
        op, b, dense, n = make_problem(a, nrhs=3)
        res = block_gmres(op, b, num_blocks=25, max_restarts=30, rtol=1e-9)
        assert bool(res.converged.all())
        x = np.asarray(res.x)[:n]
        r = np.asarray(b)[:n] - dense @ x
        rel = np.linalg.norm(r, axis=0) / np.linalg.norm(
            np.asarray(b)[:n], axis=0)
        assert (rel <= 2e-9).all()


class TestBlockGmresBf16Basis:
    """Narrow (bf16) shared block-Krylov basis: the true-residual-gated
    restart loop refines past eps(bf16); default path unchanged."""

    def test_bf16_block_basis_refines(self):
        import jax.numpy as jnp

        a = laplace2d(12, 12)
        op, b, dense, n = make_problem(a, nrhs=3)
        res = block_gmres(op, b, num_blocks=25, max_restarts=60,
                          rtol=1e-6, basis_dtype=jnp.bfloat16)
        assert bool(res.converged.all())
        x = np.asarray(res.x)[:n]
        r = np.asarray(b)[:n] - dense @ x
        rel = np.linalg.norm(r, axis=0) / np.linalg.norm(
            np.asarray(b)[:n], axis=0)
        assert (rel <= 1e-6).all()

    def test_default_unchanged(self):
        a = laplace2d(8, 8)
        op, b, dense, n = make_problem(a, nrhs=2)
        r1 = block_gmres(op, b, num_blocks=20, rtol=1e-8)
        r2 = block_gmres(op, b, num_blocks=20, rtol=1e-8,
                         basis_dtype=b.dtype)
        assert int(r1.iters) == int(r2.iters)
        np.testing.assert_array_equal(np.asarray(r1.x), np.asarray(r2.x))
