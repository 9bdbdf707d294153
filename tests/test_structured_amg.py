"""Structured-aggregation SA-AMG (StencilOp hierarchy, reshape transfers).

The accelerator-first fast path of precond/amg.py: aggregates are 2x2x2 grid
blocks, transfers are block-sum/broadcast + one stencil apply, coarse
levels are StencilOps with probe-extracted interior Galerkin
coefficients (sparsified with diagonal lumping). Reference analogue:
MueLu structured aggregation + Hierarchy::Iterate
(packages/muelu/src/MueCentral/MueLu_Hierarchy_decl.hpp:103,238).
"""
import numpy as np
import pytest

import jax.numpy as jnp

from trilinos_tpu import precond
from trilinos_tpu.galeri import laplace2d, laplace3d
from trilinos_tpu.ops import matvec as S
from trilinos_tpu.ops.formats import DiaMatrix
from trilinos_tpu.ops.stencil import StencilOp
from trilinos_tpu.solvers import cg


def _rand_padded(npad, n, seed, k=None):
    rng = np.random.default_rng(seed)
    shape = (npad,) if k is None else (npad, k)
    v = np.zeros(shape)
    v[:n] = rng.standard_normal((n,) if k is None else (n, k))
    return jnp.asarray(v)


class TestStructuredHierarchy:
    def test_auto_picks_structured_for_stencil(self):
        op = laplace3d(16, 16, 16, fmt="stencil")
        m = precond.SaAmg(op).compute()
        assert m._structured
        # level 0 is the matrix-free StencilOp; coarse levels are exact
        # Galerkin operators stored as DIA (gather-free applies)
        assert isinstance(m.levels[0]["a"], StencilOp)
        assert all(isinstance(lvl["a"], DiaMatrix)
                   for lvl in m.levels[1:])
        # dims halve level to level
        dims = [lvl["dims"] for lvl in m.levels]
        assert dims[0] == (16, 16, 16) and dims[1] == (8, 8, 8)

    def test_sparsified_galerkin_bounds_stencil_growth(self):
        op = laplace3d(32, 32, 32, fmt="stencil")
        m = precond.SaAmg(op).compute()
        # without dropping, level 1 is 33-pt and level 2 is 179-pt
        assert all(len(lvl["a"].offsets) <= 64 for lvl in m.levels)

    def test_exact_galerkin_coarse_level(self):
        """The DIA level-1 operator equals the true PtAP of the fine
        plane-masked stencil (boundary rows included) entry for entry."""
        from trilinos_tpu.precond.structured import (ClassifiedStencil,
                                                     _galerkin_on_grid)

        op = laplace3d(12, 12, 12, fmt="stencil")
        m = precond.SaAmg(op, {"aggregation: drop tol": 0.0}).compute()
        rep0 = ClassifiedStencil.from_constant(op.offsets, op.coeffs)
        lvl = m.levels[0]
        # recover omega from the builder by rebuilding the exact PtAP
        omega = 4.0 / 3.0 / rep0.gershgorin()
        a_true = _galerkin_on_grid(rep0, (12, 12, 12), (2, 2, 2),
                                   omega).to_dense()
        a1 = m.levels[1]["a"]
        n1 = a1.n_rows
        d = np.asarray(a1.data, dtype=np.float64)
        dense = np.zeros((a1.n_rows_pad, a1.n_rows_pad))
        for k, off in enumerate(a1.offsets):
            idx = np.arange(a1.n_rows_pad)
            j = idx + off
            ok = (j >= 0) & (j < a1.n_rows_pad)
            dense[idx[ok], j[ok]] = d[k, idx[ok]]
        np.testing.assert_allclose(dense[:n1, :n1], a_true, rtol=1e-6,
                                   atol=1e-9)

    def test_stencil_as_matrix_requires_structured(self):
        op = laplace3d(16, 16, 16, fmt="stencil")
        with pytest.raises(TypeError):
            precond.SaAmg(op, {"aggregation: type": "uncoupled"}).compute()

    def test_structured_requires_even_dims(self):
        op = laplace2d(9, 9, fmt="stencil")
        with pytest.raises(ValueError):
            precond.SaAmg(op, {"aggregation: type": "structured"}).compute()

    def test_uncoupled_still_default_for_csr(self):
        a = laplace2d(16, 16)
        m = precond.SaAmg(a).compute()
        assert not m._structured


class TestStructuredVcycle:
    def test_spd(self):
        """CG requires an SPD preconditioner: the V-cycle must be
        EXACTLY symmetric (transfers are exact adjoints, coarse stencils
        symmetrized) and positive."""
        op = laplace3d(16, 16, 16, fmt="stencil")
        m = precond.SaAmg(op).compute()
        n, npad = op.n_rows, op.n_rows_pad
        v = _rand_padded(npad, n, 1)
        w = _rand_padded(npad, n, 2)
        s1 = float(jnp.vdot(v, m.apply(w)))
        s2 = float(jnp.vdot(w, m.apply(v)))
        assert abs(s1 - s2) <= 1e-12 * abs(s1)
        assert float(jnp.vdot(v, m.apply(v))) > 0

    def test_transfer_adjointness(self):
        op = laplace3d(8, 8, 8, fmt="stencil")
        m = precond.SaAmg(op, {"coarse: max size": 8}).compute()
        lvl = m.levels[0]
        op_c = m.levels[1]["a"] if len(m.levels) > 1 else None
        nc_pad = lvl["n_c"]
        nc = op_c.n_rows if op_c is not None else op.n_rows // 8
        w = _rand_padded(op.n_rows_pad, op.n_rows, 3)
        vc = _rand_padded(nc_pad, nc, 4)
        s1 = float(jnp.vdot(vc, lvl["restrict"](w)))
        s2 = float(jnp.vdot(w, lvl["prolong"](vc)))
        assert abs(s1 - s2) <= 1e-12 * abs(s1)

    def test_cg_iteration_parity_with_uncoupled(self):
        a = laplace3d(16, 16, 16)
        op = laplace3d(16, 16, 16, fmt="stencil")
        n, npad = op.n_rows, op.n_rows_pad
        b = _rand_padded(npad, n, 5)
        m_s = precond.SaAmg(op).compute()
        r_s = cg(lambda v: S.spmv(op, v), b, prec=m_s, rtol=1e-8,
                 maxiter=100)
        m_u = precond.SaAmg(a, {"aggregation: type": "uncoupled"}).compute()
        b_u = jnp.asarray(np.asarray(b)[:m_u.levels[0]["n_f"]])
        r_u = cg(lambda v: S.spmv(m_u.levels[0]["a"], v), b_u, prec=m_u,
                 rtol=1e-8, maxiter=100)
        assert bool(r_s.converged) and bool(r_u.converged)
        # structured 2x2x2 aggregates are smaller than uncoupled's
        # ~distance-2 aggregates, so a few extra iterations at this tiny
        # size (measured 15 vs 9 at 16^3; 13 vs 12 at 32^3)
        assert int(r_s.iters) <= max(2 * int(r_u.iters), 16)
        x = np.asarray(r_s.x)[:n]
        rel = (np.linalg.norm(np.asarray(b)[:n] - a.to_dense() @ x)
               / np.linalg.norm(np.asarray(b)[:n]))
        assert rel <= 1.1e-8

    def test_chebyshev_smoother_every_level_f32(self):
        op = laplace3d(16, 16, 16, dtype=np.float32, fmt="stencil")
        m = precond.SaAmg(op, {"smoother: type": "chebyshev",
                               "dtype": np.float32}).compute()
        # the fused polynomial smoother runs on the fine StencilOp;
        # coarse DIA levels smooth with damped Jacobi
        assert "cheb" in m.levels[0]
        n, npad = op.n_rows, op.n_rows_pad
        b = jnp.asarray(np.asarray(_rand_padded(npad, n, 6),
                                   dtype=np.float32))
        r = cg(lambda v: S.spmv(op, v), b, prec=m, rtol=1e-5, maxiter=60)
        assert bool(r.converged) and int(r.iters) <= 20

    def test_multivector_apply(self):
        op = laplace2d(16, 16, fmt="stencil")
        m = precond.SaAmg(op).compute()
        n, npad = op.n_rows, op.n_rows_pad
        B = _rand_padded(npad, n, 7, k=3)
        Y = m.apply(B)
        assert Y.shape == (npad, 3)
        # column k of the multivector apply == single-vector apply
        y0 = m.apply(B[:, 0])
        np.testing.assert_allclose(np.asarray(Y[:, 0]), np.asarray(y0),
                                   rtol=1e-12, atol=1e-14)

    def test_2d_grid(self):
        a = laplace2d(32, 32)
        op = laplace2d(32, 32, fmt="stencil")
        m = precond.SaAmg(op).compute()
        assert m._structured
        n, npad = op.n_rows, op.n_rows_pad
        b = _rand_padded(npad, n, 8)
        r = cg(lambda v: S.spmv(op, v), b, prec=m, rtol=1e-8, maxiter=60)
        assert bool(r.converged)
        x = np.asarray(r.x)[:n]
        rel = (np.linalg.norm(np.asarray(b)[:n] - a.to_dense() @ x)
               / np.linalg.norm(np.asarray(b)[:n]))
        assert rel <= 1.1e-8

    def test_w_cycle(self):
        op = laplace3d(16, 16, 16, fmt="stencil")
        m = precond.SaAmg(op, {"cycle type": "W"}).compute()
        n, npad = op.n_rows, op.n_rows_pad
        b = _rand_padded(npad, n, 9)
        r = cg(lambda v: S.spmv(op, v), b, prec=m, rtol=1e-8, maxiter=60)
        assert bool(r.converged)


class TestFunctionalState:
    """state()/apply_state(): the hierarchy as a jit-argument pytree
    (closure constants serialize into remote-compile requests — the
    256^3 level-1 DIA is ~260 MB)."""

    def test_apply_state_matches_apply_structured(self):
        import jax

        op = laplace3d(16, 16, 16, fmt="stencil")
        m = precond.SaAmg(op).compute()
        n, npad = op.n_rows, op.n_rows_pad
        r = _rand_padded(npad, n, 11)
        y1 = m.apply(r)
        y2 = jax.jit(lambda st, v: m.apply_state(st, v))(m.state(), r)
        np.testing.assert_allclose(np.asarray(y1), np.asarray(y2),
                                   rtol=1e-13, atol=1e-15)
        # multivector through the functional form
        R = _rand_padded(npad, n, 12, k=2)
        Y1 = m.apply(R)
        Y2 = m.apply_state(m.state(), R)
        np.testing.assert_allclose(np.asarray(Y1), np.asarray(Y2),
                                   rtol=1e-13, atol=1e-15)

    def test_apply_state_matches_apply_uncoupled(self):
        import jax

        a = laplace2d(16, 16)
        m = precond.SaAmg(a, {"aggregation: type": "uncoupled"}).compute()
        npad = m.levels[0]["n_f"]
        r = _rand_padded(npad, a.shape[0], 13)
        y1 = m.apply(r)
        y2 = jax.jit(lambda st, v: m.apply_state(st, v))(m.state(), r)
        np.testing.assert_allclose(np.asarray(y1), np.asarray(y2),
                                   rtol=1e-13, atol=1e-15)
