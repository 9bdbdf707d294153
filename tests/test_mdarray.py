"""Domi analogue: structured N-D distributed arrays with halo exchange.

Reference behaviors: packages/domi/src/Domi_MDMap.hpp (axis
decomposition + comm padding + periodic flags), Domi_MDVector.hpp
(updateCommPad ghost exchange)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from trilinos_tpu.parallel.mdarray import (MDMap, halo_pad, md_dot,
                                           md_map_apply)


def _mesh2d(px=2, py=4):
    devs = np.array(jax.devices()[:px * py]).reshape(px, py)
    return Mesh(devs, ("x", "y"))


def _laplace5(u):
    """5-point Laplacian on a 1-cell-padded block."""
    c = u[1:-1, 1:-1]
    return (4.0 * c - u[:-2, 1:-1] - u[2:, 1:-1]
            - u[1:-1, :-2] - u[1:-1, 2:])


class TestMDMap:
    def test_local_shape_and_distribute(self):
        mesh = _mesh2d()
        md = MDMap((16, 32), ("x", "y"), halo=(1, 1))
        assert md.local_shape(mesh) == (8, 8)
        a = np.arange(16 * 32, dtype=np.float64).reshape(16, 32)
        g = md.distribute(a, mesh)
        np.testing.assert_array_equal(np.asarray(g), a)

    def test_indivisible_rejected(self):
        mesh = _mesh2d()
        md = MDMap((15, 32), ("x", "y"))
        with pytest.raises(ValueError, match="not divisible"):
            md.local_shape(mesh)

    def test_mixed_local_axis(self):
        mesh = _mesh2d()
        md = MDMap((16, 32, 3), ("x", "y", None))
        assert md.local_shape(mesh) == (8, 8, 3)


class TestHaloExchange:
    def test_stencil_matches_single_device(self):
        """Distributed 5-point Laplacian (interior) == dense reference."""
        mesh = _mesh2d()
        md = MDMap((16, 32), ("x", "y"), halo=(1, 1))
        rng = np.random.default_rng(0)
        a = rng.standard_normal((16, 32))
        run = md_map_apply(md, mesh, _laplace5)
        got = np.asarray(run(md.distribute(a, mesh)))
        ap = np.pad(a, 1)  # zero (Dirichlet) boundary, like ppermute
        want = (4 * a - ap[:-2, 1:-1] - ap[2:, 1:-1]
                - ap[1:-1, :-2] - ap[1:-1, 2:])
        np.testing.assert_allclose(got, want, atol=1e-13)

    def test_periodic_wraparound(self):
        mesh = _mesh2d()
        md = MDMap((16, 32), ("x", "y"), halo=(1, 1),
                   periodic=(True, True))
        rng = np.random.default_rng(1)
        a = rng.standard_normal((16, 32))
        run = md_map_apply(md, mesh, _laplace5)
        got = np.asarray(run(md.distribute(a, mesh)))
        want = (4 * a - np.roll(a, 1, 0) - np.roll(a, -1, 0)
                - np.roll(a, 1, 1) - np.roll(a, -1, 1))
        np.testing.assert_allclose(got, want, atol=1e-13)

    def test_corner_ghosts(self):
        """Diagonal (9-point) stencil exercises corner ghost cells."""
        mesh = _mesh2d()
        md = MDMap((8, 16), ("x", "y"), halo=(1, 1),
                   periodic=(True, True))
        rng = np.random.default_rng(2)
        a = rng.standard_normal((8, 16))

        def diag9(u):
            return u[:-2, :-2] + u[2:, 2:] + u[:-2, 2:] + u[2:, :-2]

        run = md_map_apply(md, mesh, diag9)
        got = np.asarray(run(md.distribute(a, mesh)))
        want = (np.roll(np.roll(a, 1, 0), 1, 1)
                + np.roll(np.roll(a, -1, 0), -1, 1)
                + np.roll(np.roll(a, 1, 0), -1, 1)
                + np.roll(np.roll(a, -1, 0), 1, 1))
        np.testing.assert_allclose(got, want, atol=1e-13)

    def test_halo_width_two(self):
        mesh = _mesh2d()
        md = MDMap((16, 16), ("x", "y"), halo=(2, 0),
                   periodic=(True, False))
        rng = np.random.default_rng(3)
        a = rng.standard_normal((16, 16))

        def shift2(u):
            return u[:-4, :]  # value from 2 rows above

        run = md_map_apply(md, mesh, shift2)
        got = np.asarray(run(md.distribute(a, mesh)))
        np.testing.assert_allclose(got, np.roll(a, 2, 0), atol=1e-13)

    def test_local_axis_pad(self):
        """Axes not split over the mesh pad locally (wrap/zero)."""
        mesh = _mesh2d()
        md = MDMap((16, 16), ("x", None), halo=(1, 1),
                   periodic=(False, True))
        rng = np.random.default_rng(4)
        a = rng.standard_normal((16, 16))
        run = md_map_apply(md, mesh, _laplace5)
        got = np.asarray(run(md.distribute(a, mesh)))
        ap = np.pad(a, ((1, 1), (0, 0)))           # zero in x
        ap = np.pad(ap, ((0, 0), (1, 1)), "wrap")  # periodic in y
        want = (4 * a - ap[:-2, 1:-1] - ap[2:, 1:-1]
                - ap[1:-1, :-2] - ap[1:-1, 2:])
        np.testing.assert_allclose(got, want, atol=1e-13)

    def test_md_dot(self):
        import functools

        mesh = _mesh2d()
        md = MDMap((16, 32), ("x", "y"))
        rng = np.random.default_rng(5)
        a = rng.standard_normal((16, 32))
        b = rng.standard_normal((16, 32))
        dot = md_dot(mesh)
        f = jax.jit(functools.partial(
            jax.shard_map, mesh=mesh, in_specs=(md.spec(), md.spec()),
            out_specs=jax.sharding.PartitionSpec())(dot))
        got = float(f(md.distribute(a, mesh), md.distribute(b, mesh)))
        assert np.isclose(got, np.vdot(a, b), rtol=1e-12)


class TestMDSolve:
    """Krylov solves over the N-D process grid (md_solve): the 2-D/3-D
    generalization of the 1-D row-sharded dist_solve."""

    def test_cg_2d_process_grid_matches_serial(self):
        from trilinos_tpu.galeri import laplace2d
        from trilinos_tpu.parallel.mdarray import md_solve
        from trilinos_tpu.solvers import cg

        nx, ny = 16, 32
        mesh = _mesh2d(2, 4)
        md = MDMap((nx, ny), ("x", "y"), halo=(1, 1))
        rng = np.random.default_rng(7)
        b = rng.standard_normal((nx, ny))
        res = md_solve(cg, md, mesh, _laplace5, jnp.asarray(b),
                       rtol=1e-12, maxiter=2000)
        assert bool(res.converged)
        x = np.asarray(res.x)
        assert x.shape == (nx, ny)
        # serial check: laplace2d orders gid = ix + nx*iy -> field[ix,iy]
        a = laplace2d(nx, ny)
        rel = np.linalg.norm(
            b.reshape(-1, order="F")
            - a.to_dense() @ x.reshape(-1, order="F")) \
            / np.linalg.norm(b)
        assert rel < 1e-11

    def test_cg_3d_three_axis_mesh(self):
        from trilinos_tpu.galeri import laplace3d
        from trilinos_tpu.parallel.mdarray import md_solve
        from trilinos_tpu.solvers import cg_single_reduce

        nx, ny, nz = 8, 8, 16
        devs = np.array(jax.devices()[:8]).reshape(2, 2, 2)
        mesh = Mesh(devs, ("x", "y", "z"))
        md = MDMap((nx, ny, nz), ("x", "y", "z"), halo=(1, 1, 1))

        def lap7(u):
            c = u[1:-1, 1:-1, 1:-1]
            return (6.0 * c
                    - u[:-2, 1:-1, 1:-1] - u[2:, 1:-1, 1:-1]
                    - u[1:-1, :-2, 1:-1] - u[1:-1, 2:, 1:-1]
                    - u[1:-1, 1:-1, :-2] - u[1:-1, 1:-1, 2:])

        rng = np.random.default_rng(8)
        b = rng.standard_normal((nx, ny, nz))
        res = md_solve(cg_single_reduce, md, mesh, lap7,
                       jnp.asarray(b), rtol=1e-12, maxiter=3000)
        assert bool(res.converged)
        x = np.asarray(res.x)
        a = laplace3d(nx, ny, nz)
        rel = np.linalg.norm(
            b.reshape(-1, order="F")
            - a.to_dense() @ x.reshape(-1, order="F")) \
            / np.linalg.norm(b)
        assert rel < 1e-11


class TestMDPolyApply:
    """CA fused polynomial sweep on the N-D process grid: one s-deep
    exchange == s chained full-exchange applies."""

    @pytest.mark.parametrize("periodic", [False, True])
    def test_matches_chained_applies(self, periodic):
        mesh = _mesh2d()
        nx, ny, s = 16, 32, 3
        stages = ((0.0, 0.0, 0.0, 0.25),
                  (-0.2, 1.0, 0.0, 0.25),
                  (-0.2, 1.05, -0.3, 0.2))  # chebyshev-like chain
        md_deep = MDMap((nx, ny), ("x", "y"), halo=(s, s),
                        periodic=(periodic, periodic))
        md_one = MDMap((nx, ny), ("x", "y"), halo=(1, 1),
                       periodic=(periodic, periodic))
        rng = np.random.default_rng(11)
        b = rng.standard_normal((nx, ny))

        from trilinos_tpu.parallel.mdarray import md_poly_apply

        run = md_poly_apply(md_deep, mesh, _laplace5, stages)
        got = np.asarray(run(md_deep.distribute(b, mesh)))

        # reference: chained single applies with a full exchange each
        apply1 = md_map_apply(md_one, mesh, _laplace5)
        u_prev2 = jnp.zeros((nx, ny))
        u_prev = md_one.distribute(b, mesh)
        x0 = u_prev
        for (a, bt, g, z) in stages:
            u = jnp.zeros((nx, ny))
            if a:
                u = a * apply1(u_prev)
            if bt:
                u = u + bt * u_prev
            if g:
                u = u + g * u_prev2
            if z:
                u = u + z * x0
            u_prev2, u_prev = u_prev, u
        np.testing.assert_allclose(got, np.asarray(u_prev), atol=1e-12)

    def test_halo_mismatch_rejected(self):
        from trilinos_tpu.parallel.mdarray import md_poly_apply

        mesh = _mesh2d()
        md = MDMap((16, 32), ("x", "y"), halo=(1, 1))
        with pytest.raises(ValueError, match="halo"):
            md_poly_apply(md, mesh, _laplace5,
                          ((1.0, 0, 0, 0), (1.0, 0, 0, 0)))

    def test_ca_smoothed_md_cg(self):
        """md_solve + md_poly_local: CA fused Chebyshev preconditioning
        inside the N-D-grid CG (one deep exchange per prec apply)."""
        from trilinos_tpu.galeri import laplace2d
        from trilinos_tpu.ops.stencil import chebyshev_stages
        from trilinos_tpu.parallel.mdarray import md_poly_local, md_solve
        from trilinos_tpu.solvers import cg

        nx, ny, deg = 16, 32, 3
        mesh = _mesh2d()
        md_op = MDMap((nx, ny), ("x", "y"), halo=(1, 1))
        md_deep = MDMap((nx, ny), ("x", "y"), halo=(deg, deg))
        stages = chebyshev_stages(1.9, 0.06, deg, 0.25)
        prec = md_poly_local(md_deep, mesh, _laplace5, stages)
        rng = np.random.default_rng(12)
        b = rng.standard_normal((nx, ny))
        res_p = md_solve(cg, md_op, mesh, _laplace5, jnp.asarray(b),
                         prec_local=prec, rtol=1e-11, maxiter=500)
        res_0 = md_solve(cg, md_op, mesh, _laplace5, jnp.asarray(b),
                         rtol=1e-11, maxiter=500)
        assert bool(res_p.converged) and bool(res_0.converged)
        assert int(res_p.iters) < int(res_0.iters)
        a = laplace2d(nx, ny)
        x = np.asarray(res_p.x)
        rel = np.linalg.norm(
            b.reshape(-1, order="F")
            - a.to_dense() @ x.reshape(-1, order="F")) \
            / np.linalg.norm(b)
        assert rel < 1e-10
