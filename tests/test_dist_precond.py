"""Distributed preconditioning: sharded SA-AMG V-cycle and overlapping
Schwarz inside shard_map (VERDICT round-1 item 1).

References: muelu/src/MueCentral/MueLu_Hierarchy_decl.hpp:103,238
(distributed Setup/Iterate); ifpack2/src/Ifpack2_AdditiveSchwarz_decl.hpp
+ Ifpack2_OverlappingRowMatrix_decl.hpp (overlap via Import).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from trilinos_tpu.galeri import laplace2d, laplace3d
from trilinos_tpu.parallel import distmatrix as D
from trilinos_tpu.parallel import driver as drv
from trilinos_tpu.parallel.map import Map
from trilinos_tpu.solvers import cg


def dist_setup(a, n_shards, seed=0):
    dm = D.distribute(a, n_shards)
    mesh = drv.make_mesh(n_shards)
    n = a.shape[0]
    b = np.random.default_rng(seed).standard_normal(n)
    bg = jnp.asarray(dm.row_map.to_padded(b))
    return dm, mesh, b, bg


class TestDistRect:
    @pytest.mark.parametrize("n_shards", [2, 4])
    def test_rect_apply_matches_serial(self, n_shards, rng):
        """distribute_rect: distributed P apply == serial P apply."""
        from trilinos_tpu.precond.amg import (aggregate,
                                              tentative_prolongator)

        a = laplace2d(12, 10)
        agg = aggregate(a)
        p = tentative_prolongator(agg)
        fmap = Map.uniform(p.shape[0], n_shards)
        cmap = Map.uniform(p.shape[1], n_shards)
        pdm = D.distribute_rect(p, fmap, cmap)
        mesh = drv.make_mesh(n_shards)
        xc = rng.standard_normal(p.shape[1])
        xg = jnp.asarray(cmap.to_padded(xc))

        import functools
        from jax.sharding import PartitionSpec as P_

        @functools.partial(jax.shard_map, mesh=mesh,
                           in_specs=(P_(drv.AXIS), P_(drv.AXIS)),
                           out_specs=P_(drv.AXIS))
        def run(p_sh, x_loc):
            pl_ = D.unstack_local(p_sh)
            return D.apply_local(pl_.interior, pl_.boundary, pl_.plan,
                                 x_loc, drv.AXIS, n_shards)

        y = fmap.from_padded(np.asarray(run(pdm, xg)))
        want = p.to_dense() @ xc
        np.testing.assert_allclose(y, want, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("n_shards", [4, 8])
class TestDistAmg:
    def test_amg_cg_laplace3d(self, n_shards):
        """AMG-preconditioned distributed CG on Laplace3D converges in the
        expected (mesh-independent-ish) iteration count."""
        a = laplace3d(12, 12, 8)
        dm, mesh, b, bg = dist_setup(a, n_shards)
        prec = drv.dist_amg(a, dm.row_map, coarse_max=32)
        res = drv.dist_solve(cg, dm, bg, mesh=mesh, prec=prec,
                             rtol=1e-8, maxiter=100)
        assert bool(res.converged.all())
        x = dm.row_map.from_padded(np.asarray(res.x))
        rel = (np.linalg.norm(b - a.to_dense() @ x)
               / np.linalg.norm(b))
        assert rel <= 2e-8
        # SA-AMG preconditioned CG: O(10) iterations, vs ~60+ unprec
        assert int(res.iters) <= 25, int(res.iters)

    def test_amg_matches_serial_quality(self, n_shards):
        """Distributed AMG-CG iteration count matches the single-device SaAmg
        within a small margin (same hierarchy, same smoothing)."""
        from trilinos_tpu import precond as PC
        from trilinos_tpu.ops import matvec as S
        from trilinos_tpu.ops.formats import choose_format

        a = laplace2d(24, 24)
        dm, mesh, b, bg = dist_setup(a, n_shards)
        prec = drv.dist_amg(a, dm.row_map, coarse_max=32)
        res_d = drv.dist_solve(cg, dm, bg, mesh=mesh, prec=prec,
                               rtol=1e-8, maxiter=100)
        serial = PC.create("SA-AMG", a, {"coarse: max size": 32}).compute()
        dev = choose_format(a)
        npad = dev.n_rows_pad
        bp = np.zeros(npad)
        bp[: a.shape[0]] = b
        res_s = cg(lambda v: S.spmv(dev, v), jnp.asarray(bp),
                   prec=serial.apply, rtol=1e-8, maxiter=100)
        assert bool(res_d.converged.all()) and bool(res_s.converged.all())
        assert abs(int(res_d.iters) - int(res_s.iters)) <= 5


class TestPartitionedDistribute:
    """Partition → renumber → distribute pipeline + noncontiguous-map
    Directory (VERDICT round-1 item 7; Zoltan2_AlgMultiJagged.hpp,
    Tpetra_DirectoryImpl_decl.hpp:311)."""

    def test_rcb_fewer_ghosts_than_uniform(self):
        nx, ny = 64, 8
        a = laplace2d(nx, ny)
        n_shards = 4
        # uniform row split cuts across the LONG axis: wide interfaces
        dm_u = D.distribute(a, n_shards)
        gids = np.arange(a.shape[0])
        coords = np.stack([gids % nx, gids // nx], axis=1)
        dm_p, directory = D.distribute_partitioned(
            a, n_shards, partition="rcb", coords=coords)
        ghosts_u = int(np.asarray(dm_u.plan.ghost_valid).sum())
        ghosts_p = int(np.asarray(dm_p.plan.ghost_valid).sum())
        assert ghosts_p < ghosts_u, (ghosts_p, ghosts_u)

    @pytest.mark.parametrize("method", ["rcb", "greedy"])
    def test_partitioned_solve_matches_serial(self, method, rng):
        nx, ny = 24, 12
        a = laplace2d(nx, ny)
        n_shards = 4
        gids = np.arange(a.shape[0])
        coords = np.stack([gids % nx, gids // nx], axis=1)
        dm, directory = D.distribute_partitioned(
            a, n_shards, partition=method,
            coords=coords if method == "rcb" else None)
        mesh = drv.make_mesh(n_shards)
        b = rng.standard_normal(a.shape[0])
        # reorder RHS into the permuted numbering via the Directory
        b_new = b[np.argsort(directory.new_of_old)]  # = b[perm]
        bg = jnp.asarray(dm.row_map.to_padded(b_new))
        res = drv.dist_solve(cg, dm, bg, mesh=mesh, rtol=1e-10,
                             maxiter=2000)
        assert bool(res.converged.all())
        x_new = dm.row_map.from_padded(np.asarray(res.x))
        x = x_new[directory.new_of_old]  # back to original numbering
        want = np.linalg.solve(a.to_dense(), b)
        np.testing.assert_allclose(x, want, rtol=1e-7, atol=1e-9)

    def test_directory_remote_index_list(self):
        a = laplace2d(10, 10)
        dm, directory = D.distribute_partitioned(a, 4, partition="greedy")
        gids = np.array([0, 17, 55, 99])
        owners, lids = directory.remote_index_list(gids)
        for g, o, l in zip(gids, owners, lids):
            # the (owner, lid) pair must point back at the same global row
            new_id = directory.new_of_old[g]
            assert dm.row_map.shard_lo(int(o)) + l == new_id
            assert 0 <= l < dm.row_map.n_local_pad


@pytest.mark.parametrize("n_shards", [4, 8])
class TestDistSchwarz:
    @pytest.mark.parametrize("combine", ["ZERO", "ADD"])
    def test_schwarz_gmres_laplace3d(self, n_shards, combine):
        # Schwarz with inexact (ILU-sweep) subdomain solves — and RAS in
        # particular — is a NONSYMMETRIC preconditioner: pair it with
        # GMRES, as the reference does (Ifpack2 AdditiveSchwarz examples).
        from trilinos_tpu.solvers import gmres

        a = laplace3d(10, 10, 8)
        dm, mesh, b, bg = dist_setup(a, n_shards)
        prec = drv.dist_schwarz(a, dm.row_map, overlap=1, combine=combine)
        res = drv.dist_solve(gmres, dm, bg, mesh=mesh, prec=prec,
                             rtol=1e-8, maxiter=300, restart=40)
        assert bool(res.converged.all())
        x = dm.row_map.from_padded(np.asarray(res.x))
        rel = np.linalg.norm(b - a.to_dense() @ x) / np.linalg.norm(b)
        assert rel <= 2e-8

    def test_overlap_beats_block_jacobi(self, n_shards):
        """Overlap-1 RAS should need no more iterations than overlap-0
        (pure local ILU0 / block-Jacobi)."""
        from trilinos_tpu.solvers import gmres

        a = laplace2d(24, 24)
        dm, mesh, b, bg = dist_setup(a, n_shards)
        p0 = drv.dist_ilu0(a, dm.row_map)
        p1 = drv.dist_schwarz(a, dm.row_map, overlap=1, combine="ZERO")
        r0 = drv.dist_solve(gmres, dm, bg, mesh=mesh, prec=p0,
                            rtol=1e-8, maxiter=300, restart=40)
        r1 = drv.dist_solve(gmres, dm, bg, mesh=mesh, prec=p1,
                            rtol=1e-8, maxiter=300, restart=40)
        assert bool(r1.converged.all())
        assert int(r1.iters) <= int(r0.iters) + 2, \
            (int(r1.iters), int(r0.iters))


@pytest.mark.parametrize("n_shards", [4])
class TestRebalancedAmg:
    def test_rebalanced_matches_plain_quality(self, n_shards):
        """Rebalanced (re-partitioned coarse levels) AMG must converge
        like the plain hierarchy (muelu/src/Rebalancing/ analogue)."""
        a = laplace3d(10, 10, 8)
        dm, mesh, b, bg = dist_setup(a, n_shards)
        p0 = drv.dist_amg(a, dm.row_map, coarse_max=32)
        p1 = drv.dist_amg(a, dm.row_map, coarse_max=32, rebalance=True)
        r0 = drv.dist_solve(cg, dm, bg, mesh=mesh, prec=p0,
                            rtol=1e-8, maxiter=100)
        r1 = drv.dist_solve(cg, dm, bg, mesh=mesh, prec=p1,
                            rtol=1e-8, maxiter=100)
        assert bool(r1.converged.all())
        x = dm.row_map.from_padded(np.asarray(r1.x))
        rel = np.linalg.norm(b - a.to_dense() @ x) / np.linalg.norm(b)
        assert rel <= 2e-8
        assert abs(int(r1.iters) - int(r0.iters)) <= 3


class TestDistStructuredAmg:
    """Distributed structured-aggregation AMG (gather-free hierarchy over
    z-slab shards; coarse levels replicated after one all_gather)."""

    @pytest.mark.parametrize("n_shards", [2, 8])
    def test_matches_single_chip_iterations(self, n_shards):
        op = laplace3d(16, 16, 16, fmt="stencil")
        n = op.n_rows

        from trilinos_tpu import precond
        from trilinos_tpu.ops import matvec as S

        m = precond.SaAmg(op).compute()
        rng = np.random.default_rng(3)
        b = rng.standard_normal(n)
        b1 = np.zeros(op.n_rows_pad)
        b1[:n] = b
        r_single = cg(lambda v: S.spmv(op, v), jnp.asarray(b1), prec=m,
                      rtol=1e-8, maxiter=60)

        ds = D.distribute_stencil(op, n_shards)
        mesh = drv.make_mesh(n_shards)
        pc = drv.dist_amg_structured(op, n_shards)
        bg = jnp.asarray(ds.row_map.to_padded(b))
        r_dist = drv.dist_solve(cg, ds, bg, mesh=mesh, prec=pc,
                                rtol=1e-8, maxiter=60)
        assert bool(r_dist.converged)
        # same hierarchy, same arithmetic (modulo reduction order)
        assert abs(int(r_dist.iters) - int(r_single.iters)) <= 1
        x_d = ds.row_map.from_padded(np.asarray(r_dist.x))
        x_s = np.asarray(r_single.x)[:n]
        np.testing.assert_allclose(x_d, x_s, rtol=1e-6, atol=1e-8)

    def test_apply_matches_single_chip(self):
        """One distributed V-cycle == the single-chip V-cycle bitwise-ish."""
        import functools

        from jax.sharding import PartitionSpec as P_

        from trilinos_tpu import precond
        from trilinos_tpu.parallel.comm import AxisComm

        op = laplace3d(8, 8, 8, fmt="stencil")
        n = op.n_rows
        n_shards = 2
        m = precond.SaAmg(op).compute()
        pc = drv.dist_amg_structured(op, n_shards)
        ds = D.distribute_stencil(op, n_shards)
        mesh = drv.make_mesh(n_shards)
        rng = np.random.default_rng(4)
        r = rng.standard_normal(n)

        @functools.partial(jax.shard_map, mesh=mesh,
                           in_specs=(P_(drv.AXIS), P_(drv.AXIS)),
                           out_specs=P_(drv.AXIS))
        def run(prec_sh, r_loc):
            comm = AxisComm(drv.AXIS, n_shards)
            pl = drv.DistPrecond(arrays=prec_sh, kind=pc.kind,
                                 consts=pc.consts)
            return pl.make(comm, None)(r_loc)

        y_d = ds.row_map.from_padded(
            np.asarray(run(pc.arrays, jnp.asarray(
                ds.row_map.to_padded(r)))))
        r1 = np.zeros(op.n_rows_pad)
        r1[:n] = r
        y_s = np.asarray(m.apply(jnp.asarray(r1)))[:n]
        np.testing.assert_allclose(y_d, y_s, rtol=1e-11, atol=1e-13)

    def test_multivector_apply_matches_single_chip(self):
        """(n, k) residual blocks ride the same path (block reductions
        become the pseudo-block shape)."""
        import functools

        from jax.sharding import PartitionSpec as P_

        from trilinos_tpu import precond
        from trilinos_tpu.parallel.comm import AxisComm

        op = laplace3d(8, 8, 8, fmt="stencil")
        n, n_shards = op.n_rows, 2
        m = precond.SaAmg(op).compute()
        pc = drv.dist_amg_structured(op, n_shards)
        ds = D.distribute_stencil(op, n_shards)
        mesh = drv.make_mesh(n_shards)
        rng = np.random.default_rng(4)
        R = rng.standard_normal((n, 3))

        @functools.partial(jax.shard_map, mesh=mesh,
                           in_specs=(P_(drv.AXIS), P_(drv.AXIS, None)),
                           out_specs=P_(drv.AXIS, None))
        def run(prec_sh, r_loc):
            comm = AxisComm(drv.AXIS, n_shards)
            pl = drv.DistPrecond(arrays=prec_sh, kind=pc.kind,
                                 consts=pc.consts)
            return pl.make(comm, None)(r_loc)

        Rg = jnp.asarray(np.stack(
            [ds.row_map.to_padded(R[:, j]) for j in range(3)], axis=1))
        Yd = np.stack([ds.row_map.from_padded(
            np.asarray(run(pc.arrays, Rg)[:, j])) for j in range(3)],
            axis=1)
        R1 = np.zeros((op.n_rows_pad, 3))
        R1[:n] = R
        Ys = np.asarray(m.apply(jnp.asarray(R1)))[:n]
        np.testing.assert_allclose(Yd, Ys, rtol=1e-11, atol=1e-13)

    def test_odd_slab_rejected(self):
        op = laplace3d(8, 8, 8, fmt="stencil")
        with pytest.raises(ValueError):
            drv.dist_amg_structured(op, 8)  # nz/p = 1, z coarsens
