"""Distributed matrix-free stencil operator (DistStencil): VERDICT
round-1 missing #2 — the framework's fastest operator usable in
distributed solves (z-slab halo planes; SURVEY §3.3 overlap structure)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from trilinos_tpu.galeri import laplace3d
from trilinos_tpu.ops import matvec as S
from trilinos_tpu.parallel import distmatrix as D
from trilinos_tpu.parallel import driver as drv
from trilinos_tpu.solvers import cg

pytestmark = pytest.mark.slow


@pytest.mark.parametrize("n_shards", [2, 4, 8])
class TestDistStencil:
    def test_apply_matches_serial(self, n_shards, rng):
        op = laplace3d(16, 8, 8 * n_shards // 2 if n_shards > 2 else 8,
                       dtype=np.float64, fmt="stencil")
        ds = D.distribute_stencil(op, n_shards)
        mesh = drv.make_mesh(n_shards)
        n = op.n_rows
        x = rng.standard_normal(n)
        xg = jnp.asarray(ds.row_map.to_padded(x))
        y = drv.dist_spmv(ds, xg, mesh)
        got = ds.row_map.from_padded(np.asarray(y))
        xp = np.zeros(op.n_rows_pad)
        xp[:n] = x
        want = np.asarray(S.spmv(op, jnp.asarray(xp)))[:n]
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)

    def test_cg_solve(self, n_shards, rng):
        op = laplace3d(8, 8, 8 * n_shards, dtype=np.float64, fmt="stencil")
        a = laplace3d(8, 8, 8 * n_shards)  # stored twin for the check
        ds = D.distribute_stencil(op, n_shards)
        mesh = drv.make_mesh(n_shards)
        n = op.n_rows
        b = rng.standard_normal(n)
        bg = jnp.asarray(ds.row_map.to_padded(b))
        res = drv.dist_solve(cg, ds, bg, mesh=mesh, rtol=1e-10,
                             maxiter=2000)
        assert bool(res.converged.all())
        x = ds.row_map.from_padded(np.asarray(res.x))
        rel = np.linalg.norm(b - a.to_dense() @ x) / np.linalg.norm(b)
        assert rel <= 2e-10


def test_diststencil_rejects_bad_split():
    op = laplace3d(8, 8, 6, dtype=np.float32, fmt="stencil")
    with pytest.raises(ValueError):
        D.distribute_stencil(op, 4)


class TestDistChebFused:
    """Communication-avoiding fused Chebyshev smoother: one depth-s
    exchange + one fused local polynomial per apply."""

    def test_matches_global_fused_apply(self, rng):
        from trilinos_tpu.ops.stencil import (
            chebyshev_stages, stencil_poly_xla)

        n_shards, degree = 4, 3
        op = laplace3d(16, 8, 8 * n_shards, dtype=np.float64,
                       fmt="stencil")
        prec = drv.dist_cheb_fused(op, n_shards, degree=degree,
                                   lmax=1.9, lmin=0.06)
        mesh = drv.make_mesh(n_shards)
        ds = D.distribute_stencil(op, n_shards)
        n = op.n_rows
        r = rng.standard_normal(n)
        rg = jnp.asarray(ds.row_map.to_padded(r))
        # drive the closure under shard_map, sharding the prec arrays
        # by the leading shard axis exactly as dist_solve does
        import functools

        from trilinos_tpu.parallel.comm import AxisComm

        spec = jax.sharding.PartitionSpec(drv.AXIS)

        @jax.jit
        @functools.partial(jax.shard_map, mesh=mesh,
                           in_specs=(spec, spec), out_specs=spec)
        def apply_prec(arrays, rv):
            local = drv.DistPrecond(arrays=arrays, kind=prec.kind,
                                    consts=prec.consts)
            comm = AxisComm(drv.AXIS, n_shards)
            return local.make(comm, None)(rv)

        got = np.asarray(apply_prec(prec.arrays, rg))
        got = ds.row_map.from_padded(np.asarray(got))
        # global reference: fused chebyshev on the full operator
        rp = np.zeros(op.n_rows_pad)
        rp[:n] = r
        stages = chebyshev_stages(1.9, 0.06, degree, 1 / 6.0)
        want = np.asarray(stencil_poly_xla(op, stages,
                                           jnp.asarray(rp)))[:n]
        np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-12)

    def test_preconditioned_dist_cg(self, rng):
        """Distributed CG + CA fused Chebyshev converges faster than
        plain distributed CG and reaches the right solution."""
        n_shards = 4
        op = laplace3d(8, 8, 8 * n_shards, dtype=np.float64,
                       fmt="stencil")
        a = laplace3d(8, 8, 8 * n_shards)
        ds = D.distribute_stencil(op, n_shards)
        mesh = drv.make_mesh(n_shards)
        prec = drv.dist_cheb_fused(op, n_shards, degree=4)
        n = op.n_rows
        b = rng.standard_normal(n)
        bg = jnp.asarray(ds.row_map.to_padded(b))
        res_p = drv.dist_solve(cg, ds, bg, mesh=mesh, prec=prec,
                               rtol=1e-10, maxiter=500)
        res_0 = drv.dist_solve(cg, ds, bg, mesh=mesh, rtol=1e-10,
                               maxiter=500)
        assert bool(res_p.converged.all())
        assert int(res_p.iters) < int(res_0.iters)
        x = ds.row_map.from_padded(np.asarray(res_p.x))
        rel = np.linalg.norm(b - a.to_dense() @ x) / np.linalg.norm(b)
        assert rel <= 5e-10


class TestDistSstepGmres:
    """CA-GMRES: one depth-(s*reach) exchange per matrix-powers block
    (drv.dist_sstep_gmres). Parity across single-chip / dist-fused /
    dist-loop bases, and true-residual correctness."""

    def test_parity_and_convergence(self, rng):
        n_shards = 4
        op = laplace3d(16, 16, 4 * n_shards, dtype=np.float32,
                       fmt="stencil")
        a = laplace3d(16, 16, 4 * n_shards)
        n = op.n_rows
        b = np.zeros(op.n_rows_pad, np.float32)
        b[:n] = rng.standard_normal(n)
        bj = jnp.asarray(b)
        mesh = drv.make_mesh(n_shards)
        from trilinos_tpu.solvers.sstep_gmres import sstep_gmres

        kw = dict(s=3, t_blocks=5, max_restarts=25, rtol=1e-5)
        r_single = sstep_gmres(op, bj, **kw)
        r_fused = drv.dist_sstep_gmres(op, bj, mesh=mesh,
                                       basis="fused", **kw)
        r_loop = drv.dist_sstep_gmres(op, bj, mesh=mesh, basis="loop",
                                      **kw)
        # loop and fused distributed bases are the same math -> same
        # trajectory; single-chip agrees to f32 roundoff
        assert int(r_fused.iters) == int(r_loop.iters)
        np.testing.assert_allclose(float(r_fused.resnorm),
                                   float(r_loop.resnorm), rtol=1e-4)
        assert int(r_fused.iters) == int(r_single.iters)
        assert bool(r_fused.converged)
        x = np.asarray(r_fused.x)[:n]
        rel = np.linalg.norm(b[:n] - a.to_dense() @ x) / np.linalg.norm(
            b[:n])
        assert rel <= 2e-5, rel

    def test_rejects_stored_matrix(self):
        a = laplace3d(8, 8, 8)
        mesh = drv.make_mesh(2)
        with pytest.raises(TypeError, match="StencilOp"):
            drv.dist_sstep_gmres(a, jnp.zeros(512, jnp.float32),
                                 mesh=mesh)
