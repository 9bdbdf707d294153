"""Block-structured null-space AMG (gather-free elasticity multigrid).

precond/block_amg.py: structured node aggregation + batched-QR tentative
blocks applied by strided interleave + BDIA Galerkin levels. Reference
analogue: MueLu SA on elasticity (TentativePFactory + AmalgamationFactory
+ TpetraExt TripleMatrixMultiply).
"""
import numpy as np
import pytest

import jax.numpy as jnp

from trilinos_tpu import precond
from trilinos_tpu.galeri.fem import (elasticity2d, elasticity3d,
                                     rigid_body_modes)
from trilinos_tpu.ops import matvec as S
from trilinos_tpu.precond.block_amg import BlockStructuredAmg
from trilinos_tpu.solvers import cg


def _dense(p):
    d = np.zeros(p.shape)
    for i in range(p.shape[0]):
        lo, hi = p.row_ptr[i], p.row_ptr[i + 1]
        d[i, p.cols[lo:hi]] = p.vals[lo:hi]
    return d


class TestBlockStructuredAmg:
    def test_prolong_matches_host_smoothed_p(self):
        """The device transfer IS the host Galerkin prolongator —
        exactness of the hierarchy hinges on sharing one omega."""
        from trilinos_tpu.precond.amg import (
            smooth_prolongator, tentative_prolongator_nullspace)
        from trilinos_tpu.precond.block_amg import (
            _gershgorin_dinv_a, _node_block, _structured_node_agg)

        nx = ny = 8
        a = elasticity2d(nx, ny, e_mod=1.0)
        ns = rigid_body_modes(nx, ny)
        m = BlockStructuredAmg(a, node_dims=(nx, ny), nullspace=ns,
                               n_equations=2,
                               params={"coarse: max size": 8}).compute()
        agg = _structured_node_agg((nx, ny, 1), _node_block((nx, ny, 1)))
        p_t, _ = tentative_prolongator_nullspace(agg, 2, ns)
        om = 4.0 / 3.0 / _gershgorin_dinv_a(a)
        p_s = smooth_prolongator(a, p_t, 4.0 / 3.0, omega=om)
        lvl = m.levels[0]
        rng = np.random.default_rng(1)
        ec = np.zeros(lvl["n_c"])
        ec[: p_s.shape[1]] = rng.standard_normal(p_s.shape[1])
        dev_p = np.asarray(lvl["prolong"](jnp.asarray(ec)))[: p_s.shape[0]]
        host_p = _dense(p_s) @ ec[: p_s.shape[1]]
        np.testing.assert_allclose(dev_p, host_p, rtol=1e-12, atol=1e-14)
        # restrict is the exact adjoint
        rf = np.zeros(lvl["n_f"])
        rf[: p_s.shape[0]] = rng.standard_normal(p_s.shape[0])
        dev_r = np.asarray(lvl["restrict"](jnp.asarray(rf)))[: p_s.shape[1]]
        np.testing.assert_allclose(dev_r, _dense(p_s).T @ rf[: p_s.shape[0]],
                                   rtol=1e-12, atol=1e-14)

    def test_elasticity2d_converges_fast(self):
        nx = ny = 24
        a = elasticity2d(nx, ny, e_mod=1.0)
        ns = rigid_body_modes(nx, ny)
        m = BlockStructuredAmg(a, node_dims=(nx, ny), nullspace=ns,
                               n_equations=2).compute()
        dev = m.levels[0]["a"]
        n, npad = a.shape[0], m.levels[0]["n_f"]
        rng = np.random.default_rng(0)
        b = np.zeros(npad)
        b[:n] = rng.standard_normal(n)
        r = cg(lambda v: S.spmv(dev, v), jnp.asarray(b), prec=m,
               rtol=1e-8, maxiter=100)
        assert bool(r.converged) and int(r.iters) <= 15
        x = np.asarray(r.x)[:n]
        rel = (np.linalg.norm(b[:n] - _dense(a) @ x)
               / np.linalg.norm(b[:n]))
        assert rel <= 2e-8

    def test_elasticity3d_k6(self):
        nx = ny = nz = 8
        a = elasticity3d(nx, ny, nz, e_mod=1.0)
        ns = rigid_body_modes(nx, ny, nz)
        m = BlockStructuredAmg(a, node_dims=(nx, ny, nz), nullspace=ns,
                               n_equations=3).compute()
        dev = m.levels[0]["a"]
        n, npad = a.shape[0], m.levels[0]["n_f"]
        rng = np.random.default_rng(1)
        b = np.zeros(npad)
        b[:n] = rng.standard_normal(n)
        r = cg(lambda v: S.spmv(dev, v), jnp.asarray(b), prec=m,
               rtol=1e-8, maxiter=100)
        assert bool(r.converged) and int(r.iters) <= 30

    def test_spd(self):
        nx = ny = 16
        a = elasticity2d(nx, ny, e_mod=1.0)
        ns = rigid_body_modes(nx, ny)
        m = BlockStructuredAmg(a, node_dims=(nx, ny), nullspace=ns,
                               n_equations=2,
                               params={"coarse: max size": 64}).compute()
        n, npad = a.shape[0], m.levels[0]["n_f"]
        rng = np.random.default_rng(2)
        v = np.zeros(npad)
        w = np.zeros(npad)
        v[:n] = rng.standard_normal(n)
        w[:n] = rng.standard_normal(n)
        s1 = float(jnp.vdot(jnp.asarray(v), m.apply(jnp.asarray(w))))
        s2 = float(jnp.vdot(jnp.asarray(w), m.apply(jnp.asarray(v))))
        assert abs(s1 - s2) <= 1e-11 * abs(s1)
        assert float(jnp.vdot(jnp.asarray(v), m.apply(jnp.asarray(v)))) > 0

    def test_factory_name(self):
        nx = ny = 8
        a = elasticity2d(nx, ny, e_mod=1.0)
        ns = rigid_body_modes(nx, ny)
        m = precond.create("BLOCK SA-AMG", a, node_dims=(nx, ny),
                           nullspace=ns, n_equations=2).compute()
        assert isinstance(m, BlockStructuredAmg)

    def test_size_validation(self):
        a = elasticity2d(8, 8, e_mod=1.0)
        ns = rigid_body_modes(8, 8)
        with pytest.raises(ValueError):
            BlockStructuredAmg(a, node_dims=(8, 4), nullspace=ns,
                               n_equations=2).compute()

    def test_apply_state_matches_apply(self):
        import jax

        nx = ny = 16
        a = elasticity2d(nx, ny, e_mod=1.0)
        ns = rigid_body_modes(nx, ny)
        m = BlockStructuredAmg(a, node_dims=(nx, ny), nullspace=ns,
                               n_equations=2,
                               params={"coarse: max size": 64}).compute()
        n, npad = a.shape[0], m.levels[0]["n_f"]
        rng = np.random.default_rng(5)
        r = np.zeros(npad)
        r[:n] = rng.standard_normal(n)
        y1 = m.apply(jnp.asarray(r))
        y2 = jax.jit(lambda st, v: m.apply_state(st, v))(
            m.state(), jnp.asarray(r))
        np.testing.assert_allclose(np.asarray(y1), np.asarray(y2),
                                   rtol=1e-13, atol=1e-15)


class TestBf16Hierarchy:
    def test_bf16_levels_same_iteration_count(self):
        """A bf16-stored hierarchy (params={'dtype': bfloat16}) is a
        preconditioner — its 3e-3 storage quantization must not degrade
        CG iteration counts. The f32 CG operator stays exact."""
        import jax.numpy as jnp

        nx = ny = 24
        a = elasticity2d(nx, ny, e_mod=1.0)
        ns = rigid_body_modes(nx, ny)
        mf = BlockStructuredAmg(a, node_dims=(nx, ny), nullspace=ns,
                                n_equations=2).compute()
        mb = BlockStructuredAmg(a, node_dims=(nx, ny), nullspace=ns,
                                n_equations=2,
                                params={"dtype": jnp.bfloat16}).compute()
        dev = mf.levels[0]["a"]
        n, npad = a.shape[0], mf.levels[0]["n_f"]
        rng = np.random.default_rng(0)
        b = np.zeros(npad, np.asarray(a.vals).dtype)
        b[:n] = rng.standard_normal(n)
        rf = cg(lambda v: S.spmv(dev, v), jnp.asarray(b), prec=mf,
                rtol=1e-5, maxiter=100)
        rb = cg(lambda v: S.spmv(dev, v), jnp.asarray(b), prec=mb,
                rtol=1e-5, maxiter=100)
        assert bool(rf.converged) and bool(rb.converged)
        assert int(rb.iters) <= int(rf.iters) + 2
