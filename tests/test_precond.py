"""Preconditioner tests — lifecycle, factory, and convergence acceleration.

Mirrors packages/ifpack2/test/unit_tests/ (each preconditioner checked
against known convergence behavior) and ifpack2/test/belos/ (prec + Krylov
end-to-end).
"""
import numpy as np
import pytest

import jax.numpy as jnp

from trilinos_tpu.galeri import laplace2d, laplace3d, recirc2d
from trilinos_tpu.ops import formats as F
from trilinos_tpu.ops import matvec as S
from trilinos_tpu import precond
from trilinos_tpu import precond as PC
from trilinos_tpu.solvers import cg, gmres


def make_problem(a_csr, seed=11):
    dev = F.csr_to_dia(a_csr)
    n, npad = a_csr.shape[0], dev.n_rows_pad
    rng = np.random.default_rng(seed)
    b = np.zeros(npad)
    b[:n] = rng.standard_normal(n)
    op = lambda x: S.spmv(dev, x)
    return op, jnp.asarray(b), a_csr.to_dense(), n


def rel_res(b, dense, x, n):
    r = np.asarray(b)[:n] - dense @ np.asarray(x)[:n]
    return np.linalg.norm(r) / np.linalg.norm(np.asarray(b)[:n])


class TestLifecycle:
    def test_apply_before_compute_raises(self):
        a = laplace2d(5, 5)
        m = precond.Relaxation(a)
        with pytest.raises(RuntimeError):
            m.apply(jnp.zeros(32))

    def test_factory_names(self):
        a = laplace2d(5, 5)
        for name in ["JACOBI", "RELAXATION", "CHEBYSHEV", "RILUK", "ILU(0)",
                     "GMRESPOLY", "BLOCK RELAXATION"]:
            p = precond.create(name, a)
            assert isinstance(p, precond.Preconditioner)
        with pytest.raises(ValueError):
            precond.create("NOPE", a)

    def test_unknown_param_rejected(self):
        a = laplace2d(5, 5)
        with pytest.raises(ValueError):
            precond.Relaxation(a, {"relaxation: typo": 1}).compute()


class TestRelaxation:
    def test_jacobi_is_dinv(self):
        a = laplace2d(6, 6)
        m = precond.Relaxation(a).compute()
        x = jnp.ones(40)
        np.testing.assert_allclose(np.asarray(m(x))[:36], 0.25 * np.ones(36))

    def test_sweeps_improve(self):
        a = laplace2d(12, 12)
        op, b, dense, n = make_problem(a)
        res1 = cg(op, b, prec=precond.Relaxation(a).compute(), rtol=1e-8)
        m3 = precond.Relaxation(a, {"relaxation: sweeps": 3,
                                    "relaxation: damping factor": 0.8}).compute()
        res3 = cg(op, b, prec=m3, rtol=1e-8)
        assert rel_res(b, dense, res3.x, n) <= 1.1e-8
        assert int(res3.iters) < int(res1.iters)

    def test_l1_jacobi(self):
        a = laplace2d(8, 8)
        m = precond.Relaxation(a, {"relaxation: type": "l1 Jacobi"}).compute()
        # l1 diag ≥ plain diag → smaller inverse
        assert float(m.dinv[:64].max()) < 0.25 + 1e-12


class TestChebyshev:
    def test_accelerates_cg(self):
        a = laplace2d(24, 24)
        op, b, dense, n = make_problem(a)
        plain = cg(op, b, rtol=1e-8, maxiter=2000)
        cheb = precond.Chebyshev(a, {"chebyshev: degree": 4}).compute()
        accel = cg(op, b, prec=cheb, rtol=1e-8, maxiter=2000)
        assert rel_res(b, dense, accel.x, n) <= 1.1e-8
        assert int(accel.iters) < 0.5 * int(plain.iters)

    def test_power_method_estimate(self):
        a = laplace2d(16, 16)
        cheb = precond.Chebyshev(a, {"chebyshev: eigenvalue max iterations": 30,
                                     "chebyshev: boost factor": 1.0}).compute()
        # exact λmax(D⁻¹A) for Laplace2D is < 2; power estimate within 15%
        dense = a.to_dense()
        exact = np.max(np.abs(np.linalg.eigvals(dense / 4.0)))
        assert abs(cheb.lmax - exact) / exact < 0.15

    def test_user_eigenvalue_skips_power(self):
        a = laplace2d(8, 8)
        cheb = precond.Chebyshev(a, {"chebyshev: max eigenvalue": 1.9}).compute()
        assert cheb.lmax == 1.9


class TestIlu0:
    def test_factor_exact_for_triangular_product(self):
        """For a matrix whose ILU(0) has no dropped fill (tridiagonal),
        L@U must reproduce A exactly."""
        from trilinos_tpu.galeri import laplace1d

        a = laplace1d(20)
        L, U = precond.ilu0_factor(a)
        np.testing.assert_allclose(L.to_dense() @ U.to_dense(), a.to_dense(),
                                   atol=1e-12)

    def test_factor_pattern_restricted(self):
        a = laplace2d(6, 6)
        L, U = precond.ilu0_factor(a)
        # L strict-lower+diag and U upper pattern subset of A's + diag
        prod = L.to_dense() @ U.to_dense()
        # residual (fill dropped) nonzero only OUTSIDE A's pattern
        mask = a.to_dense() != 0
        np.testing.assert_allclose(prod[mask], a.to_dense()[mask], atol=1e-10)

    def test_accelerates_gmres(self):
        a = recirc2d(16, 16, diff=1e-2)
        op, b, dense, n = make_problem(a)
        plain = gmres(op, b, restart=30, rtol=1e-8, maxiter=2000)
        ilu = precond.Ilu0(a, {"fact: sweeps": 8}).compute()
        accel = gmres(op, b, prec=ilu, restart=30, rtol=1e-8, maxiter=2000)
        assert rel_res(b, dense, accel.x, n) <= 1e-6
        assert int(accel.iters) < int(plain.iters)

    def test_trisolve_sweeps_converge_to_exact(self):
        """With many sweeps the Jacobi tri-solve approaches the exact
        (scipy) ILU apply."""
        import scipy.sparse as sp
        import scipy.sparse.linalg as spla

        a = laplace2d(8, 8)
        ilu = precond.Ilu0(a, {"fact: sweeps": 40}).compute()
        L, U = precond.ilu0_factor(a)
        r = np.random.default_rng(1).standard_normal(64)
        rp = np.zeros(64)
        rp[:] = r
        got = np.asarray(ilu(jnp.asarray(np.concatenate([r, np.zeros(0)]))))[:64]
        y = spla.spsolve_triangular(sp.csr_matrix(L.to_dense()), r, lower=True)
        want = spla.spsolve_triangular(sp.csr_matrix(U.to_dense()), y,
                                       lower=False)
        np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10)


class TestGmresPoly:
    def test_reduces_outer_iterations(self):
        a = laplace2d(20, 20)
        op, b, dense, n = make_problem(a)
        plain = gmres(op, b, restart=30, rtol=1e-8, maxiter=2000)
        poly = precond.GmresPoly(a, {"poly: degree": 10}).compute()
        accel = gmres(op, b, prec=poly, restart=30, rtol=1e-8, maxiter=2000)
        assert rel_res(b, dense, accel.x, n) <= 1.1e-8
        assert int(accel.iters) < 0.4 * int(plain.iters)


class TestBlockJacobi:
    def test_exact_for_block_diagonal(self, rng):
        bs, nb = 4, 5
        blocks = [rng.standard_normal((bs, bs)) + 4 * np.eye(bs)
                  for _ in range(nb)]
        dense = np.zeros((20, 20))
        for i, blk in enumerate(blocks):
            dense[i * bs:(i + 1) * bs, i * bs:(i + 1) * bs] = blk
        a = F.CsrHost.from_dense(dense)
        m = precond.BlockJacobi(a, {"partitioner: block size": bs}).compute()
        x = rng.standard_normal(24)
        x[20:] = 0
        got = np.asarray(m(jnp.asarray(x)))[:20]
        np.testing.assert_allclose(got, np.linalg.solve(dense, x[:20]),
                                   rtol=1e-10)

    def test_accelerates_cg(self):
        a = laplace3d(6, 6, 6)
        op, b, dense, n = make_problem(a)
        plain = cg(op, b, rtol=1e-8)
        m = precond.BlockJacobi(a, {"partitioner: block size": 6}).compute()
        accel = cg(op, b, prec=m, rtol=1e-8)
        assert rel_res(b, dense, accel.x, n) <= 1.1e-8
        assert int(accel.iters) <= int(plain.iters)


class TestMulticolorGS:
    def test_stencil_is_two_colorable(self):
        from trilinos_tpu.precond import MulticolorGaussSeidel

        a = laplace2d(10, 10)
        m = MulticolorGaussSeidel(a)
        m.initialize()
        assert m.n_colors == 2  # red-black

    def test_color_classes_independent(self):
        from trilinos_tpu.precond.multicolor_gs import greedy_color

        a = laplace2d(8, 8)
        color = greedy_color(a)
        rows = np.repeat(np.arange(64), a.row_lengths())
        off = rows != a.cols
        assert (color[rows[off]] != color[a.cols[off]]).all()

    def test_gs_beats_jacobi_as_smoother(self):
        from trilinos_tpu import precond

        a = laplace2d(16, 16)
        op, b, dense, n = make_problem(a)
        jac = precond.Relaxation(a, {"relaxation: sweeps": 2,
                                     "relaxation: damping factor": 0.8}).compute()
        gs = precond.MulticolorGaussSeidel(
            a, {"relaxation: sweeps": 1,
                "relaxation: symmetric": True}).compute()
        r_j = cg(op, b, prec=jac, rtol=1e-9, maxiter=2000)
        r_g = cg(op, b, prec=gs, rtol=1e-9, maxiter=2000)
        assert rel_res(b, dense, r_g.x, n) <= 1.1e-9
        assert int(r_g.iters) <= int(r_j.iters)

    def test_factory(self):
        from trilinos_tpu import precond

        a = laplace2d(4, 4)
        assert isinstance(precond.create("MT GAUSS-SEIDEL", a),
                          precond.MulticolorGaussSeidel)


class TestBlockRelaxationContainers:
    """Container family (Ifpack2_Container_decl.hpp: Dense/TriDi/Banded)."""

    @pytest.mark.parametrize("container", ["Dense", "TriDi", "Banded",
                                           "SparseILU0"])
    def test_cg_converges(self, container):
        a = laplace2d(16, 12)
        op, b, dense, n = make_problem(a)
        prec = PC.create("BLOCK RELAXATION", a, {
            "relaxation: container": container,
            "partitioner: block size": 16,  # grid lines (nx=16)
            "relaxation: damping factor": 0.9,
        }).compute()
        res = cg(op, b, prec=prec.apply, rtol=1e-8, maxiter=500)
        assert bool(res.converged.all()), container
        x = np.asarray(res.x)[:n]
        rel = (np.linalg.norm(np.asarray(b)[:n] - dense @ x)
               / np.linalg.norm(np.asarray(b)[:n]))
        assert rel <= 2e-8

    def test_tridi_matches_dense_on_tridiagonal_blocks(self):
        """For 1-D line blocks of Laplace2D (x-lines), the in-block
        coupling IS tridiagonal: TriDi and Dense containers must produce
        the same preconditioner action."""
        a = laplace2d(16, 8)
        op, b, dense, n = make_problem(a)
        common = {"partitioner: block size": 16}
        pd = PC.create("BLOCK RELAXATION", a,
                       {**common, "relaxation: container": "Dense"}).compute()
        pt = PC.create("BLOCK RELAXATION", a,
                       {**common, "relaxation: container": "TriDi"}).compute()
        r = jnp.asarray(np.random.default_rng(0).standard_normal(
            b.shape[0]))
        np.testing.assert_allclose(np.asarray(pd.apply(r)),
                                   np.asarray(pt.apply(r)),
                                   rtol=1e-10, atol=1e-12)

    def test_line_blocks_beat_point_jacobi(self):
        """Line (TriDi) smoothing on an ANISOTROPIC problem: strong
        x-coupling -> x-line blocks capture it, point Jacobi doesn't."""
        from trilinos_tpu.galeri.stencils import cross2d_stencil, stencil_csr

        eps = 0.01  # weak y-coupling
        st = cross2d_stencil(2 + 2 * eps, -1.0, -1.0, -eps, -eps)
        a = stencil_csr((32, 16), st)
        op, b, dense, n = make_problem(a)
        lines = PC.create("BLOCK RELAXATION", a, {
            "relaxation: container": "TriDi",
            "partitioner: block size": 32}).compute()
        jac = PC.create("JACOBI", a).compute()
        r_l = cg(op, b, prec=lines.apply, rtol=1e-8, maxiter=900)
        r_j = cg(op, b, prec=jac.apply, rtol=1e-8, maxiter=900)
        assert bool(r_l.converged.all())
        assert int(r_l.iters) < 0.5 * int(r_j.iters), \
            (int(r_l.iters), int(r_j.iters))


class TestDatabaseContainer:
    """Ifpack2::DatabaseSchwarz analogue: identical diagonal patches share
    one inverse (Ifpack2_DatabaseSchwarz_decl.hpp)."""

    def test_matches_dense_container(self):
        a = laplace2d(16, 8)
        op, b, dense, n = make_problem(a)
        common = {"partitioner: block size": 16}
        pd = PC.create("BLOCK RELAXATION", a,
                       {**common, "relaxation: container": "Dense"}).compute()
        pq = PC.create("DATABASE SCHWARZ", a,
                       {**common,
                        "relaxation: container": "Database"}).compute()
        r = jnp.asarray(np.random.default_rng(0).standard_normal(
            b.shape[0]))
        np.testing.assert_allclose(np.asarray(pq.apply(r)),
                                   np.asarray(pd.apply(r)),
                                   rtol=1e-10, atol=1e-12)

    def test_database_is_small(self):
        """Interior line blocks of Laplace2D are identical: far fewer
        unique patches than blocks."""
        a = laplace2d(16, 32)
        pq = PC.create("BLOCK RELAXATION", a, {
            "partitioner: block size": 16,
            "relaxation: container": "Database"}).compute()
        assert pq.n_patches < 32 // 2


class TestHierarchyGold:
    """MueLu gold-file pattern (muelu/test/interface/*/Output/*.gold):
    the committed EXPECTED construction output of a fixed hierarchy.
    Catches silent drift in aggregation / smoothing / Galerkin setup
    that convergence tests absorb (a worse hierarchy that still
    converges passes them)."""

    def test_sa_hierarchy_structure_laplace2d_32(self):
        from trilinos_tpu.precond.amg import build_hierarchy_host

        a = laplace2d(32, 32)
        levels, a_c = build_hierarchy_host(a, 10, 16, 2, 4.0 / 3.0)
        got = [(al.shape[0], al.vals.size, ps.shape[1])
               for al, ps in levels] + [(a_c.shape[0], a_c.vals.size)]
        # gold: (n, nnz, n_coarse) per level + coarsest (n, nnz)
        assert got == [(1024, 4992, 148), (148, 1446, 10), (10, 74)], got

    def test_gold_is_deterministic(self):
        from trilinos_tpu.precond.amg import build_hierarchy_host

        a = laplace2d(32, 32)
        l1, c1 = build_hierarchy_host(a, 10, 16, 2, 4.0 / 3.0)
        l2, c2 = build_hierarchy_host(a, 10, 16, 2, 4.0 / 3.0)
        for (a1, p1), (a2, p2) in zip(l1, l2):
            np.testing.assert_array_equal(a1.vals, a2.vals)
            np.testing.assert_array_equal(p1.vals, p2.vals)
        np.testing.assert_array_equal(c1.vals, c2.vals)


class TestIluK:
    """ILU(k) level-of-fill (Ifpack2::RILUK "fact: iluk level-of-fill"
    via IlukGraph, packages/ifpack2/src/Ifpack2_IlukGraph.hpp)."""

    def test_level0_pattern_is_a(self):
        from trilinos_tpu.precond.ilu import iluk_pattern

        a = laplace2d(8, 8)
        ptr, cols = iluk_pattern(a, 0)
        np.testing.assert_array_equal(ptr, a.row_ptr)
        np.testing.assert_array_equal(cols, a.cols)

    def test_native_matches_python_fallback(self):
        from trilinos_tpu.precond.ilu import iluk_pattern
        import trilinos_tpu.precond.ilu as ilu_mod
        import trilinos_tpu.native as nat

        a = recirc2d(10, 10, diff=1e-2)
        for k in (1, 2, 3):
            ptr_n, cols_n = iluk_pattern(a, k)
            # force the python fallback
            orig = nat.iluk_native
            nat.iluk_native = lambda *args: None
            try:
                ptr_p, cols_p = iluk_pattern(a, k)
            finally:
                nat.iluk_native = orig
            np.testing.assert_array_equal(ptr_n, ptr_p)
            np.testing.assert_array_equal(cols_n, cols_p)

    def test_fill_monotone_in_level(self):
        from trilinos_tpu.precond.ilu import iluk_pattern

        a = laplace2d(10, 10)
        nnz = [iluk_pattern(a, k)[0][-1] for k in (0, 1, 2, 4)]
        assert nnz[0] < nnz[1] < nnz[2] < nnz[3]

    def test_large_level_is_complete_lu(self):
        """kfill >= n: the pattern holds ALL elimination fill, so
        L@U == A exactly (ILU(k) → complete LU)."""
        from trilinos_tpu.precond.ilu import iluk_augment

        a = laplace2d(6, 6)
        n = a.shape[0]
        aug = iluk_augment(a, n)
        L, U = precond.ilu0_factor(aug)
        np.testing.assert_allclose(L.to_dense() @ U.to_dense(),
                                   a.to_dense(), atol=1e-10)

    def test_higher_level_fewer_iterations(self):
        a = recirc2d(16, 16, diff=1e-2)
        op, b, dense, n = make_problem(a)
        its = {}
        for k in (0, 2):
            m = precond.Ilu0(a, {"fact: sweeps": 8,
                                 "fact: iluk level-of-fill": k}).compute()
            r = gmres(op, b, prec=m, restart=30, rtol=1e-8, maxiter=2000)
            assert rel_res(b, dense, r.x, n) <= 1e-6
            its[k] = int(r.iters)
        assert its[2] < its[0]


class TestRBiluk:
    """Block-level ILU (Ifpack2::Experimental::RBILUK via the scalar
    reduction: block LU == scalar LU on the dense-block pattern)."""

    def test_block_tridiag_is_exact(self):
        """For a BLOCK-tridiagonal matrix, RBILUK(0) has no dropped
        block fill → L@U == A exactly (the block analogue of ILU(0)
        being exact on a tridiagonal)."""
        from trilinos_tpu.precond.ilu import ilu0_factor, rbiluk_augment

        rng = np.random.default_rng(5)
        b, nb = 3, 8
        n = b * nb
        dense = np.zeros((n, n))
        for i in range(nb):
            for j in (i - 1, i, i + 1):
                if 0 <= j < nb:
                    blk = rng.standard_normal((b, b))
                    if i == j:
                        blk += 6 * np.eye(b)
                    dense[i*b:(i+1)*b, j*b:(j+1)*b] = blk
        a = F.CsrHost.from_dense(dense)
        aug = rbiluk_augment(a, b, 0)
        L, U = ilu0_factor(aug)
        np.testing.assert_allclose(L.to_dense() @ U.to_dense(), dense,
                                   atol=1e-9)

    def test_rbiluk_beats_scalar_ilu0_on_elasticity(self):
        """On a 2D elasticity system (natural 2x2 blocks), block ILU
        couples the per-node dofs and beats scalar ILU(0) iterations."""
        from trilinos_tpu.galeri import elasticity2d

        a = elasticity2d(10, 10, e_mod=1.0)
        op, b_rhs, dense, n = make_problem(a)
        its = {}
        for name, params in (("scalar", {"fact: sweeps": 10}),
                             ("block", {"fact: sweeps": 10,
                                        "fact: block size": 2})):
            m = precond.create("RBILUK", a, params).compute()
            r = gmres(op, b_rhs, prec=m, restart=40, rtol=1e-8,
                      maxiter=2000)
            assert rel_res(b_rhs, dense, r.x, n) <= 1e-6
            its[name] = int(r.iters)
        assert its["block"] <= its["scalar"]

    def test_bad_block_size_raises(self):
        from trilinos_tpu.precond.ilu import rbiluk_augment
        from trilinos_tpu.galeri import laplace2d

        a = laplace2d(5, 5)  # n = 25, not divisible by 2
        with pytest.raises(ValueError, match="not a multiple"):
            rbiluk_augment(a, 2, 0)
