"""Hiptmair two-space preconditioner on the 2-D curl-curl problem
(reference: ifpack2/src/Ifpack2_Hiptmair_decl.hpp)."""
import numpy as np
import pytest

import jax.numpy as jnp

from trilinos_tpu import precond as PC
from trilinos_tpu.galeri.stencils import maxwell2d
from trilinos_tpu.ops import formats as F
from trilinos_tpu.ops import matvec as S
from trilinos_tpu.solvers import cg


def edge_problem(nx=10, ny=8, sigma=None, seed=0):
    if sigma is None:
        # log-spread conductivity: spreads the gradient-mode cluster so
        # point smoothers genuinely struggle (realistic eddy-current)
        n_e = nx * (ny + 1) + (nx + 1) * ny
        sigma = 10.0 ** np.random.default_rng(9).uniform(-3, 0, n_e)
    a, g = maxwell2d(nx, ny, sigma=sigma)
    dev = F.choose_format(a)
    n, npad = a.shape[0], dev.n_rows_pad
    b = np.zeros(npad)
    b[:n] = np.random.default_rng(seed).standard_normal(n)
    op = lambda v: S.spmv(dev, v)
    return a, g, op, jnp.asarray(b), n


class TestHiptmair:
    def test_beats_jacobi_on_curlcurl(self):
        """Point Jacobi stalls on the gradient near-null space of
        C'C + sigma*M; Hiptmair's auxiliary node-space correction fixes
        it — assert a large iteration-count gap."""
        a, g, op, b, n = edge_problem()
        hip = PC.create(
            "HIPTMAIR", a,
            {"hiptmair: aux preconditioner": "SA-AMG"},
            aux_op=g).compute()
        jac = PC.create("JACOBI", a).compute()
        r_h = cg(op, b, prec=hip.apply, rtol=1e-8, maxiter=600)
        r_j = cg(op, b, prec=jac.apply, rtol=1e-8, maxiter=600)
        assert bool(r_h.converged.all())
        assert int(r_h.iters) < 0.6 * int(r_j.iters), \
            (int(r_h.iters), int(r_j.iters))
        x = np.asarray(r_h.x)[:n]
        rel = (np.linalg.norm(np.asarray(b)[:n] - a.to_dense() @ x)
               / np.linalg.norm(np.asarray(b)[:n]))
        assert rel <= 2e-8

    def test_requires_gradient(self):
        a, g, op, b, n = edge_problem(4, 4, sigma=0.1)
        with pytest.raises(ValueError):
            PC.create("HIPTMAIR", a).compute()

    def test_symmetric_apply(self):
        """Pre+post smoothing symmetrizes the apply (CG-safe):
        <M r1, r2> == <r1, M r2>."""
        a, g, op, b, n = edge_problem(6, 5, sigma=0.1)
        hip = PC.create("HIPTMAIR", a, aux_op=g).compute()
        rng = np.random.default_rng(3)
        r1 = jnp.asarray(np.concatenate(
            [rng.standard_normal(n), np.zeros(b.shape[0] - n)]))
        r2 = jnp.asarray(np.concatenate(
            [rng.standard_normal(n), np.zeros(b.shape[0] - n)]))
        lhs = float(jnp.dot(hip.apply(r1), r2))
        rhs = float(jnp.dot(r1, hip.apply(r2)))
        np.testing.assert_allclose(lhs, rhs, rtol=1e-10)
