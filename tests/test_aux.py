"""Schwarz, Komplex, partitioning, FE-assembly tests."""
import numpy as np
import pytest

import jax.numpy as jnp

from trilinos_tpu.galeri import laplace2d, recirc2d
from trilinos_tpu.ops import fe, formats as F, komplex
import trilinos_tpu.ops.matvec as S
from trilinos_tpu.parallel import partition as P
from trilinos_tpu import precond
from trilinos_tpu.solvers import cg, gmres


class TestAdditiveSchwarz:
    def test_accelerates_gmres(self):
        a = laplace2d(16, 16)
        dev = F.csr_to_dia(a)
        n, npad = 256, dev.n_rows_pad
        b = np.zeros(npad)
        b[:n] = np.random.default_rng(0).standard_normal(n)
        op = lambda x: S.spmv(dev, x)
        plain = gmres(op, jnp.asarray(b), restart=30, rtol=1e-9, maxiter=2000)
        m = precond.AdditiveSchwarz(
            a, {"schwarz: num subdomains": 4,
                "schwarz: overlap level": 1}).compute()
        accel = gmres(op, jnp.asarray(b), prec=m, restart=30, rtol=1e-9,
                      maxiter=2000)
        x = np.asarray(accel.x)[:n]
        rel = np.linalg.norm(b[:n] - a.to_dense() @ x) / np.linalg.norm(b[:n])
        assert rel <= 1.1e-9
        assert int(accel.iters) < int(plain.iters)

    def test_single_subdomain_is_direct(self):
        a = laplace2d(6, 6)
        m = precond.AdditiveSchwarz(a, {"schwarz: num subdomains": 1,
                                        "schwarz: overlap level": 0}).compute()
        r = np.zeros(40)
        r[:36] = np.random.default_rng(1).standard_normal(36)
        x = np.asarray(m(jnp.asarray(r)))[:36]
        np.testing.assert_allclose(x, np.linalg.solve(a.to_dense(), r[:36]),
                                   rtol=1e-10)

    @pytest.mark.parametrize("mode", ["add", "restricted"])
    def test_combine_modes(self, mode):
        a = laplace2d(8, 8)
        m = precond.AdditiveSchwarz(
            a, {"schwarz: num subdomains": 2, "schwarz: overlap level": 1,
                "schwarz: combine mode": mode}).compute()
        r = np.zeros(64)
        r[:64] = np.random.default_rng(2).standard_normal(64)
        y = np.asarray(m(jnp.asarray(r)))
        assert np.isfinite(y).all() and np.abs(y).max() > 0

    def test_factory(self):
        a = laplace2d(4, 4)
        assert isinstance(precond.create("SCHWARZ", a),
                          precond.AdditiveSchwarz)


class TestTwoLevelSchwarz:
    @staticmethod
    def _solve_iters(a, prec):
        dev = F.csr_to_dia(a)
        n, npad = a.shape[0], dev.n_rows_pad
        b = np.zeros(npad)
        b[:n] = np.random.default_rng(0).standard_normal(n)
        res = cg(lambda x: S.spmv(dev, x), jnp.asarray(b),
                 prec=prec, rtol=1e-8, maxiter=2000)
        assert res.converged
        return int(res.iters)

    def test_numerically_scalable(self):
        """FROSch's raison d'etre: one-level Schwarz iterations grow with
        the subdomain count; the GDSW coarse level keeps them ~flat.
        Box subdomains via MultiJagged (contiguous chunks of a row-major
        grid would be thin slabs — a degenerate decomposition)."""
        from trilinos_tpu.parallel import partition as P

        nx = 48
        a = laplace2d(nx, nx)
        coords = np.stack(np.meshgrid(np.arange(nx), np.arange(nx),
                                      indexing="xy"), axis=-1).reshape(-1, 2)
        it1 = {}
        it2 = {}
        for k in (2, 8):
            part = P.partition_multijagged(coords, (k, k))
            # CG needs the symmetric 'add' combine (RAS is nonsymmetric)
            p = {"schwarz: num subdomains": k * k,
                 "schwarz: overlap level": 1,
                 "schwarz: combine mode": "add",
                 "schwarz: subdomain ids": part}
            it1[k] = self._solve_iters(
                a, precond.AdditiveSchwarz(a, dict(p)).compute())
            it2[k] = self._solve_iters(
                a, precond.TwoLevelSchwarz(a, dict(p)).compute())
        # coarse level helps decisively at 64 subdomains and stays flat
        assert it2[8] < it1[8] - 10
        assert it2[8] <= it2[2] + 4

    def test_partition_of_unity_basis(self):
        a = laplace2d(12, 12)
        m = precond.TwoLevelSchwarz(
            a, {"schwarz: num subdomains": 4}).compute()
        phi = np.asarray(m.phi)[:144]
        # interface rows: PoU; interiors: harmonic extension still sums
        # to 1 rowwise because the constant vector is A_II-harmonic for
        # rows with zero Dirichlet-complement coupling; just require
        # every row to have a nonzero coarse footprint and bounded values
        assert (np.abs(phi).max(axis=1) > 1e-8).all()
        assert np.abs(phi).max() <= 1.0 + 1e-8
        # coarse operator was SPD-invertible
        assert np.isfinite(np.asarray(m.a0_inv)).all()

    def test_constant_coarse_space_and_factory(self):
        a = laplace2d(16, 16)
        m = precond.create("FROSCH", a,
                           {"schwarz: num subdomains": 8,
                            "schwarz: combine mode": "add",
                            "coarse space: type": "constant"})
        assert isinstance(m, precond.TwoLevelSchwarz)
        it_const = self._solve_iters(a, m.compute())
        it_one = self._solve_iters(
            a, precond.AdditiveSchwarz(
                a, {"schwarz: num subdomains": 8,
                    "schwarz: combine mode": "add"}).compute())
        assert it_const < it_one

    def test_custom_partition_ids(self):
        from trilinos_tpu.parallel import partition as P

        nx = ny = 16
        a = laplace2d(nx, ny)
        coords = np.stack(np.meshgrid(np.arange(nx), np.arange(ny),
                                      indexing="xy"), axis=-1).reshape(-1, 2)
        part = P.partition_multijagged(coords, (2, 2))
        m = precond.TwoLevelSchwarz(
            a, {"schwarz: num subdomains": 4,
                "schwarz: combine mode": "add",
                "schwarz: subdomain ids": part}).compute()
        assert self._solve_iters(a, m) < 60


class TestKomplex:
    def test_real_form_matches_complex_solve(self):
        rng = np.random.default_rng(0)
        n = 24
        az = (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
              + 8 * np.eye(n))
        bz = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        a_real = komplex.complex_matrix_to_real(az)
        assert a_real.shape == (2 * n, 2 * n)
        dev = F.csr_to_ell(a_real)
        npad = dev.n_rows_pad
        b_real = np.zeros(npad)
        br = np.asarray(komplex.complex_vec_to_real(bz))
        b_real[: 2 * n] = br
        res = gmres(lambda x: S.spmv(dev, x),
                    jnp.asarray(b_real), restart=50, rtol=1e-11,
                    maxiter=4000)
        z = komplex.real_vec_to_complex(np.asarray(res.x), n)
        want = np.linalg.solve(az, bz)
        np.testing.assert_allclose(z, want, rtol=1e-6, atol=1e-8)

    def test_solve_complex_driver(self):
        """One-call Komplex_LinearProblem driver: ERF build + factory
        solver×prec + complex extraction."""
        rng = np.random.default_rng(3)
        n = 40
        az = (rng.standard_normal((n, n))
              + 1j * rng.standard_normal((n, n)) + 10 * np.eye(n))
        bz = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        z, res = komplex.solve_complex(
            az, bz,
            {"Linear Solver Type": "GMRES",
             "Solver Types": {"GMRES": {"Convergence Tolerance": 1e-10,
                                        "Num Blocks": 60}},
             "Preconditioner Type": "RELAXATION"})
        assert bool(res.converged)
        np.testing.assert_allclose(z, np.linalg.solve(az, bz),
                                   rtol=1e-6, atol=1e-8)

    def test_solve_complex_pair_input_and_bad_rhs(self):
        rng = np.random.default_rng(4)
        n = 16
        ar = F.CsrHost.from_dense(rng.standard_normal((n, n))
                                  + 6 * np.eye(n))
        ai = F.CsrHost.from_dense(0.3 * rng.standard_normal((n, n)))
        bz = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        z, res = komplex.solve_complex((ar, ai), bz)
        az = ar.to_dense() + 1j * ai.to_dense()
        np.testing.assert_allclose(z, np.linalg.solve(az, bz),
                                   rtol=1e-5, atol=1e-7)
        with pytest.raises(ValueError, match="rhs length"):
            komplex.solve_complex((ar, ai), bz[:-1])


class TestPartition:
    def test_rcb_balanced(self, rng):
        coords = rng.standard_normal((1000, 2))
        part = P.partition_rcb(coords, 8)
        q = np.bincount(part)
        assert len(q) == 8
        assert q.max() - q.min() <= 2

    def test_rcb_uneven_parts(self, rng):
        coords = rng.standard_normal((100, 3))
        part = P.partition_rcb(coords, 3)
        assert set(np.unique(part)) == {0, 1, 2}

    def test_greedy_graph_covers(self):
        a = laplace2d(12, 12)
        part = P.partition_greedy_graph(a, 4)
        assert (part >= 0).all()
        q = P.partition_quality(a, part)
        assert q["imbalance"] < 1.5

    def test_permute_round_trip(self, rng):
        a = laplace2d(6, 7)
        perm = rng.permutation(42)
        b = P.permute_csr(a, perm)
        # B[inv[i], inv[j]] = A[i, j]
        inv = np.empty(42, dtype=np.int64)
        inv[perm] = np.arange(42)
        np.testing.assert_allclose(b.to_dense()[np.ix_(inv, inv)],
                                   a.to_dense())

    def test_multijagged_balanced_grid(self):
        nx, ny = 16, 12
        coords = np.stack(np.meshgrid(np.arange(nx), np.arange(ny),
                                      indexing="xy"), axis=-1).reshape(-1, 2)
        part = P.partition_multijagged(coords, (4, 3))
        q = np.bincount(part)
        assert len(q) == 12
        assert q.max() - q.min() <= 1
        # axis-0 multisection first: parts 0..2 share the first x-slab
        xs = coords[:, 0]
        for p in range(12):
            assert xs[part == p].max() - xs[part == p].min() <= nx // 4

    def test_multijagged_matches_rcb_quality(self, rng):
        a = laplace2d(16, 16)
        coords = np.stack(np.meshgrid(np.arange(16), np.arange(16),
                                      indexing="xy"), axis=-1).reshape(-1, 2)
        mj = P.partition_quality(a, P.partition_multijagged(coords, (2, 2)))
        rcb = P.partition_quality(a, P.partition_rcb(coords, 4))
        assert mj["imbalance"] <= rcb["imbalance"] + 1e-9
        assert mj["edge_cut"] <= 2 * rcb["edge_cut"]

    def test_rcm_reduces_bandwidth(self, rng):
        # random permutation of Laplace1D has huge bandwidth; RCM restores ~1
        n = 60
        a = laplace2d(n, 1)
        perm0 = rng.permutation(n)
        b = P.permute_csr(a, perm0)
        rcm = P.order_rcm(b)
        c = P.permute_csr(b, rcm)

        def bandwidth(m):
            rows = np.repeat(np.arange(m.shape[0], dtype=np.int64),
                             m.row_lengths())
            return int(np.abs(rows - m.cols.astype(np.int64)).max())

        assert bandwidth(c) == 1
        assert bandwidth(b) > 5
        # permutation is a valid reordering
        inv = np.empty(n, dtype=np.int64)
        inv[rcm] = np.arange(n)
        np.testing.assert_allclose(c.to_dense()[np.ix_(inv, inv)],
                                   b.to_dense())

    def test_distance2_coloring_valid(self):
        a = laplace2d(9, 9)
        color = P.color_distance2(a)
        n = a.shape[0]
        adj = [set(int(c) for c in a.row(i)[0] if c != i) for i in range(n)]
        for i in range(n):
            for j in adj[i]:
                assert color[i] != color[j]
                for k in adj[j]:
                    if k != i:
                        assert color[i] != color[k]
        # 5-point stencil distance-2 chromatic number is small
        assert color.max() + 1 <= 8

    def test_line_partition_tridi_smoother(self):
        """LinePartitioner + reorder + TriDi container: on an anisotropic
        2-D problem, line smoothing along the strong direction beats
        point Jacobi as a CG preconditioner."""
        import jax.numpy as jnp

        from trilinos_tpu.ops import choose_format, spmv
        from trilinos_tpu.precond.containers import BlockRelaxation
        from trilinos_tpu.precond.jacobi import Relaxation
        from trilinos_tpu.solvers import cg
        from trilinos_tpu.galeri import create_matrix

        nx = ny = 16
        # strong coupling in x: eps*dy stencil
        a = create_matrix("Cross2D", dict(nx=nx, ny=ny, a=2.02, b=-1.0,
                                          c=-1.0, d=-0.01, e=-0.01))
        part = P.partition_lines(a, nx)
        # lines follow x-rows of the grid
        counts = np.bincount(part)
        assert counts.max() == nx
        perm = P.partition_to_permutation(part)
        ap = P.permute_csr(a, perm)
        prec = BlockRelaxation(ap, {"relaxation: container": "TriDi",
                                    "partitioner: block size": nx}).compute()
        dev = choose_format(ap)
        rng = np.random.default_rng(3)
        b = np.zeros(dev.n_rows_pad)
        b[: nx * ny] = rng.standard_normal(nx * ny)
        res_line = cg(lambda x: spmv(dev, x), jnp.asarray(b),
                      prec=prec.apply, rtol=1e-8, maxiter=400)
        jac = Relaxation(ap, {}).compute()
        res_jac = cg(lambda x: spmv(dev, x), jnp.asarray(b),
                     prec=jac.apply, rtol=1e-8, maxiter=400)
        assert res_line.converged
        assert res_line.iters < res_jac.iters

    def test_partition_then_distribute(self, rng):
        """Full Zoltan-style pipeline: partition by RCB on grid coords,
        permute, distribute contiguously, check SpMV."""
        import jax.numpy as jnp

        from trilinos_tpu.parallel import distmatrix as D, driver as drv

        nx, ny = 8, 8
        a = laplace2d(nx, ny)
        coords = np.stack(np.meshgrid(np.arange(nx), np.arange(ny),
                                      indexing="xy"), axis=-1).reshape(-1, 2)
        part = P.partition_rcb(coords, 4)
        perm = P.partition_to_permutation(part)
        b = P.permute_csr(a, perm)
        dm = D.distribute(b, 4)
        mesh = drv.make_mesh(4)
        x = rng.standard_normal(64)
        xp = jnp.asarray(dm.row_map.to_padded(x))
        y = drv.dist_spmv(dm, xp, mesh)
        np.testing.assert_allclose(dm.row_map.from_padded(np.asarray(y)),
                                   b.to_dense() @ x, rtol=1e-12)


class TestFeAssembly:
    def test_1d_bar_assembly(self):
        # 1-D bar elements: K_e = [[1,-1],[-1,1]] chain -> Laplace1D Neumann
        ne = 10
        connect = np.stack([np.arange(ne), np.arange(1, ne + 1)], axis=1)
        ke = np.array([[1.0, -1.0], [-1.0, 1.0]])
        mats = np.tile(ke, (ne, 1, 1))
        a = fe.fe_assemble(connect, mats, ne + 1)
        d = a.to_dense()
        assert d[0, 0] == 1 and d[5, 5] == 2 and d[5, 6] == -1

    def test_matrix_free_apply_matches_assembled(self, rng):
        ne, k, n = 30, 4, 25
        connect = rng.integers(0, n, (ne, k))
        mats = rng.standard_normal((ne, k, k))
        a = fe.fe_assemble(connect, mats, n)
        x = rng.standard_normal(n)
        y = fe.fe_apply_local(jnp.asarray(connect), jnp.asarray(mats),
                              jnp.asarray(x))
        np.testing.assert_allclose(np.asarray(y), a.to_dense() @ x,
                                   rtol=1e-10, atol=1e-12)

    def test_vector_assembly(self):
        connect = np.array([[0, 1], [1, 2]])
        vecs = np.array([[1.0, 2.0], [3.0, 4.0]])
        out = fe.fe_assemble_vector(connect, vecs, 3)
        np.testing.assert_allclose(out, [1.0, 5.0, 4.0])


class TestBlock2x2:
    """Teko-style 2x2 block preconditioning on a saddle-ish system."""

    def _blocked_problem(self, rng):
        from trilinos_tpu.precond.block_2x2 import BlockedOperator2x2

        n0, n1 = 48, 32
        a00d = rng.standard_normal((n0, n0)) * 0.1 + 4 * np.eye(n0)
        a11d = rng.standard_normal((n1, n1)) * 0.1 + 3 * np.eye(n1)
        a01d = rng.standard_normal((n0, n1)) * 0.2
        a10d = rng.standard_normal((n1, n0)) * 0.2
        A00, A01 = jnp.asarray(a00d), jnp.asarray(a01d)
        A10, A11 = jnp.asarray(a10d), jnp.asarray(a11d)
        blk = BlockedOperator2x2(
            lambda v: A00 @ v, lambda v: A01 @ v,
            lambda v: A10 @ v, lambda v: A11 @ v, split=n0)
        dense = np.block([[a00d, a01d], [a10d, a11d]])
        return blk, dense, n0, n1

    def test_blocked_apply_matches_dense(self, rng):
        blk, dense, n0, n1 = self._blocked_problem(rng)
        x = rng.standard_normal(n0 + n1)
        np.testing.assert_allclose(np.asarray(blk(jnp.asarray(x))),
                                   dense @ x, rtol=1e-10)

    def test_block_gs_beats_block_jacobi(self, rng):
        from trilinos_tpu.precond import (block_diagonal_prec,
                                          block_lower_triangular_prec)
        from trilinos_tpu.solvers import gmres

        blk, dense, n0, n1 = self._blocked_problem(rng)
        inv00 = jnp.asarray(np.linalg.inv(dense[:n0, :n0]))
        inv11 = jnp.asarray(np.linalg.inv(dense[n0:, n0:]))
        bj = block_diagonal_prec(lambda v: inv00 @ v, lambda v: inv11 @ v,
                                 n0)
        bgs = block_lower_triangular_prec(
            lambda v: inv00 @ v, blk.a10, lambda v: inv11 @ v, n0)
        b = jnp.asarray(rng.standard_normal(n0 + n1))
        r_j = gmres(blk, b, prec=bj, restart=40, rtol=1e-10, maxiter=400)
        r_g = gmres(blk, b, prec=bgs, restart=40, rtol=1e-10, maxiter=400)
        for r in (r_j, r_g):
            x = np.asarray(r.x)
            assert (np.linalg.norm(np.asarray(b) - dense @ x)
                    <= 1e-8 * np.linalg.norm(np.asarray(b)))
        assert int(r_g.iters) <= int(r_j.iters)

    def test_simple_schur(self, rng):
        from trilinos_tpu.precond import simple_schur_2x2
        from trilinos_tpu.solvers import gmres

        blk, dense, n0, n1 = self._blocked_problem(rng)
        inv00 = jnp.asarray(np.linalg.inv(dense[:n0, :n0]))
        schur = dense[n0:, n0:] - dense[n0:, :n0] @ np.linalg.inv(
            dense[:n0, :n0]) @ dense[:n0, n0:]
        inv_s = jnp.asarray(np.linalg.inv(schur))
        prec = simple_schur_2x2(lambda v: inv00 @ v, blk.a01, blk.a10,
                                lambda v: inv_s @ v, n0)
        b = jnp.asarray(rng.standard_normal(n0 + n1))
        res = gmres(blk, b, prec=prec, restart=40, rtol=1e-10, maxiter=200)
        # exact block-LU preconditioner: converges in O(1) iterations
        assert int(res.iters) <= 5

    def test_lsc_schur(self, rng):
        """Teko NS LSC: exact for F = c I (S = -c^-1 B B^T), and an
        effective preconditioner for a Stokes-like saddle system."""
        from trilinos_tpu.precond import (BlockedOperator2x2,
                                          lsc_inv_schur,
                                          simple_schur_2x2)
        from trilinos_tpu.solvers import gmres

        n0, n1, c = 40, 12, 3.0
        bmat = rng.standard_normal((n1, n0))
        f = c * np.eye(n0)
        dense = np.zeros((n0 + n1, n0 + n1))
        dense[:n0, :n0] = f
        dense[:n0, n0:] = bmat.T
        dense[n0:, :n0] = bmat
        bj = jnp.asarray(bmat)
        blk = BlockedOperator2x2(
            a00=lambda v: c * v, a01=lambda v: bj.T @ v,
            a10=lambda v: bj @ v, a11=lambda v: 0.0 * v, split=n0)
        bbt_inv = jnp.asarray(np.linalg.inv(bmat @ bmat.T))
        inv_s = lsc_inv_schur(lambda v: bbt_inv @ v,
                              lambda v: bj @ v, lambda v: c * v,
                              lambda v: bj.T @ v)
        # exactness: S = -c^-1 B B^T, LSC gives exactly S^-1
        r1 = np.asarray(rng.standard_normal(n1))
        got = np.asarray(inv_s(jnp.asarray(r1)))
        want = np.linalg.solve(-(1 / c) * bmat @ bmat.T, r1)
        np.testing.assert_allclose(got, want, rtol=1e-10)
        # end-to-end: block-LU with the LSC Schur solves in O(1) iters
        prec = simple_schur_2x2(lambda v: v / c, blk.a01, blk.a10,
                                inv_s, n0)
        b = jnp.asarray(rng.standard_normal(n0 + n1))
        res = gmres(blk, b, prec=prec, restart=40, rtol=1e-10,
                    maxiter=100)
        x = np.asarray(res.x)
        assert (np.linalg.norm(np.asarray(b) - dense @ x)
                <= 1e-8 * np.linalg.norm(np.asarray(b)))
        assert int(res.iters) <= 5


class TestConformanceHarness:
    """MVOPTester-analogue harness (BelosMVOPTester.hpp:86,1454)."""

    def test_multivector_traits(self):
        from trilinos_tpu.testing import validate_multivector_traits

        assert validate_multivector_traits() == []

    def test_preconditioner_conformance(self):
        from trilinos_tpu import precond as PC
        from trilinos_tpu.galeri import laplace2d
        from trilinos_tpu.testing import validate_preconditioner

        a = laplace2d(8, 8)
        jac = PC.create("JACOBI", a).compute()
        n = 64

        def prec(x):
            shape = (jac_pad,) if x.ndim == 1 else (jac_pad, x.shape[1])
            xp = jnp.zeros(shape, x.dtype).at[:n].set(x)
            return jac.apply(xp)[:n]

        import jax.numpy as jnp
        jac_pad = 64
        assert validate_preconditioner(prec, n, spd=True) == []

    def test_catches_nonlinear_op(self):
        from trilinos_tpu.testing import validate_operator

        bad = lambda x: x * x if x.ndim == 1 else x * x
        assert any("linear" in p for p in validate_operator(bad, 16))
