"""Unit tests for local sparse formats and SpMV/SpMM.

Modeled on the reference's per-class unit-test layout
(packages/tpetra/core/test/CrsMatrix/) and kokkos-kernels spmv tests:
each format is validated against a dense reference product.
"""
import numpy as np
import pytest

from trilinos_tpu.ops import formats as F
from trilinos_tpu.ops import matvec as S


def random_csr(rng, m, n, density=0.1, dtype=np.float64):
    nnz = max(int(m * n * density), 1)
    rows = rng.integers(0, m, nnz)
    cols = rng.integers(0, n, nnz)
    vals = rng.standard_normal(nnz).astype(dtype)
    return F.CsrHost.from_coo(rows, cols, vals, (m, n))


class TestCsrHost:
    def test_from_coo_sums_duplicates(self):
        a = F.CsrHost.from_coo([0, 0, 1], [1, 1, 0], [1.0, 2.0, 5.0], (2, 2))
        d = a.to_dense()
        np.testing.assert_allclose(d, [[0, 3], [5, 0]])

    def test_round_trip_dense(self, rng):
        a = random_csr(rng, 17, 23)
        np.testing.assert_allclose(a.to_dense(),
                                   F.CsrHost.from_dense(a.to_dense()).to_dense())

    def test_transpose(self, rng):
        a = random_csr(rng, 11, 7)
        np.testing.assert_allclose(a.transpose().to_dense(), a.to_dense().T)

    def test_diagonal(self, rng):
        a = random_csr(rng, 9, 9, density=0.4)
        np.testing.assert_allclose(a.diagonal(), np.diag(a.to_dense()))

    def test_scipy_round_trip(self, rng):
        a = random_csr(rng, 12, 12)
        b = F.CsrHost.from_scipy(a.to_scipy())
        np.testing.assert_allclose(a.to_dense(), b.to_dense())


def _check_spmv(a_csr, dev, nrhs, rtol=1e-12):
    rng = np.random.default_rng(7)
    n_pad_cols = {
        F.EllMatrix: lambda d: d.n_rows_pad,
        F.DiaMatrix: lambda d: d.n_rows_pad,
        F.BsrMatrix: lambda d: d.n_brows_pad * d.block_size,
        F.BdiaMatrix: lambda d: d.n_rows_pad,
    }[type(dev)](dev)
    dense = a_csr.to_dense()
    m, n = a_csr.shape
    shape = (n_pad_cols,) if nrhs == 0 else (n_pad_cols, nrhs)
    x = np.zeros(shape)
    xin = rng.standard_normal((n,) if nrhs == 0 else (n, nrhs))
    x[:n] = xin
    y = S.spmv(dev, x)
    expect = dense @ xin
    np.testing.assert_allclose(np.asarray(y)[:m], expect, rtol=rtol, atol=1e-12)
    # padding must stay zero... except identity pad rows map zero->zero anyway
    np.testing.assert_allclose(np.asarray(y)[m:], 0.0, atol=1e-12)
    # transpose apply
    shape_t = (dev.n_rows_pad if not isinstance(dev, F.BsrMatrix)
               else dev.n_brows_pad * dev.block_size,)
    if nrhs:
        shape_t = shape_t + (nrhs,)
    xt = np.zeros(shape_t)
    xt_in = rng.standard_normal((m,) if nrhs == 0 else (m, nrhs))
    xt[:m] = xt_in
    yt = S.spmv(dev, xt, transpose=True)
    expect_t = dense.T @ xt_in
    got = np.asarray(yt)[:n]
    # padded identity rows contribute x_pad (zero) — nothing
    np.testing.assert_allclose(got, expect_t, rtol=rtol, atol=1e-12)


class TestEll:
    @pytest.mark.parametrize("nrhs", [0, 1, 4])
    def test_spmv_random(self, rng, nrhs):
        a = random_csr(rng, 33, 33, density=0.2)
        _check_spmv(a, F.csr_to_ell(a), nrhs)

    def test_rect(self, rng):
        a = random_csr(rng, 16, 24, density=0.2)
        dev = F.csr_to_ell(a, identity_pad_rows=False)
        x = rng.standard_normal(24)
        y = S.spmv(dev, np.asarray(x))
        np.testing.assert_allclose(np.asarray(y)[:16], a.to_dense() @ x,
                                   rtol=1e-12)

    def test_empty_rows(self):
        a = F.CsrHost.from_coo([2], [1], [3.0], (5, 5))
        _check_spmv(a, F.csr_to_ell(a), 0)


class TestDia:
    @pytest.mark.parametrize("nrhs", [0, 2])
    def test_laplace1d(self, nrhs):
        from trilinos_tpu.galeri import laplace1d

        a = laplace1d(37)
        _check_spmv(a, F.csr_to_dia(a), nrhs)

    def test_identity_padding(self):
        from trilinos_tpu.galeri import laplace1d

        a = laplace1d(10)
        d = F.csr_to_dia(a)
        assert d.n_rows_pad == 16
        dense_pad = np.asarray(d.data)
        assert (dense_pad[d.offsets.index(0), 10:] == 1.0).all()


class TestBsr:
    @pytest.mark.parametrize("b,nrhs", [(2, 0), (2, 4), (4, 1)])
    def test_spmv_random(self, rng, b, nrhs):
        a = random_csr(rng, 24, 24, density=0.15)
        _check_spmv(a, F.csr_to_bsr(a, b), nrhs)

    def test_unaligned_dims_padded(self, rng):
        a = random_csr(rng, 10, 10, density=0.3)
        dev = F.csr_to_bsr(a, 4)
        assert dev.n_rows % 4 == 0  # got identity-extended
        dense = F.to_dense(dev)
        np.testing.assert_allclose(dense[:10, :10], a.to_dense())
        np.testing.assert_allclose(dense[10:12, 10:12], np.eye(2))


def block_stencil_csr(rng, nb, b, offsets, dtype=np.float64):
    """Random block-stencil matrix: dense (b, b) blocks at constant block
    offsets (in-range only)."""
    rows, cols, vals = [], [], []
    for o in offsets:
        qs = np.arange(max(0, -o), min(nb, nb - o))
        blocks = rng.standard_normal((len(qs), b, b)).astype(dtype)
        for bi in range(b):
            for bj in range(b):
                rows.append(qs * b + bi)
                cols.append((qs + o) * b + bj)
                vals.append(blocks[:, bi, bj])
    return F.CsrHost.from_coo(np.concatenate(rows), np.concatenate(cols),
                              np.concatenate(vals), (nb * b, nb * b))


class TestBdia:
    @pytest.mark.parametrize("b,nrhs", [(2, 0), (2, 3), (4, 1)])
    def test_spmv_block_stencil(self, rng, b, nrhs):
        a = block_stencil_csr(rng, 13, b, (-3, -1, 0, 1, 3))
        dev = F.csr_to_bdia(a, b)
        assert isinstance(dev, F.BdiaMatrix)
        assert dev.offsets == (-3, -1, 0, 1, 3)
        _check_spmv(a, dev, nrhs)

    def test_to_dense_and_identity_padding(self, rng):
        a = block_stencil_csr(rng, 5, 2, (0, 1))
        dev = F.csr_to_bdia(a, 2)
        assert dev.nbr_pad == 8
        dense = F.to_dense(dev)
        np.testing.assert_allclose(dense, a.to_dense())
        data = np.asarray(dev.data)
        d0 = dev.offsets.index(0)
        for i in range(2):
            np.testing.assert_allclose(data[d0, i, i, 5:], 1.0)

    def test_missing_zero_offset_gets_identity_plane(self, rng):
        a = block_stencil_csr(rng, 6, 2, (-1, 1))
        dev = F.csr_to_bdia(a, 2)
        assert 0 in dev.offsets
        _check_spmv(a, dev, 0)

    def test_unaligned_dims_padded(self, rng):
        a = random_csr(rng, 11, 11, density=0.6)
        dev = F.csr_to_bdia(a, 2)
        assert dev.n_rows % 2 == 0
        dense = F.to_dense(dev)
        np.testing.assert_allclose(dense[:11, :11], a.to_dense())

    def test_elasticity2d_choose_format(self):
        """Q1 elasticity has ≤27 scalar diagonals: choose_format picks
        scalar DIA (fastest for interleaved applies); explicit
        csr_to_bdia still yields the block-stencil format for
        plane-layout solves."""
        from trilinos_tpu.galeri import elasticity2d

        a = elasticity2d(6, 5)
        dev = F.choose_format(a, block_size=2)
        assert isinstance(dev, F.DiaMatrix)
        _check_spmv(a, dev, 2, rtol=1e-9)
        bdev = F.csr_to_bdia(a, 2)
        assert isinstance(bdev, F.BdiaMatrix)
        assert len(bdev.offsets) <= 9
        _check_spmv(a, bdev, 2, rtol=1e-9)


class TestChooseFormat:
    def test_stencil_goes_dia(self):
        from trilinos_tpu.galeri import laplace2d

        a = laplace2d(10, 10)
        assert isinstance(F.choose_format(a), F.DiaMatrix)

    def test_random_goes_ell(self, rng):
        a = random_csr(rng, 64, 64, density=0.2)
        assert isinstance(F.choose_format(a), F.EllMatrix)

    def test_blocked_goes_bsr(self, rng):
        a = random_csr(rng, 24, 24, density=0.2)
        assert isinstance(F.choose_format(a, block_size=2), F.BsrMatrix)


class TestStencilDia:
    def test_matches_csr_assembly(self):
        from trilinos_tpu.galeri import stencils

        a_csr = stencils.laplace2d(7, 9)
        a_dia = stencils.laplace2d(7, 9, fmt="dia")
        np.testing.assert_allclose(F.to_dense(a_dia), a_csr.to_dense())
        assert a_dia.nnz == a_csr.nnz

    def test_recirc2d_matches(self):
        from trilinos_tpu.galeri import stencils

        a_csr = stencils.recirc2d(6, 5)
        a_dia = stencils.recirc2d(6, 5, fmt="dia")
        np.testing.assert_allclose(F.to_dense(a_dia), a_csr.to_dense(),
                                   rtol=1e-12)

    def test_brick3d_27pt(self):
        from trilinos_tpu.galeri import brick3d

        a = brick3d(4, 4, 4)
        # interior point has 27 entries
        assert a.max_row_length() == 27


class TestResidual:
    def test_fused_residual(self, rng):
        from trilinos_tpu.galeri import laplace2d

        a = laplace2d(8, 8)
        d = F.csr_to_dia(a)
        x = np.zeros(d.n_rows_pad)
        b = np.zeros(d.n_rows_pad)
        x[:64] = rng.standard_normal(64)
        b[:64] = rng.standard_normal(64)
        r = S.residual(d, x, b)
        np.testing.assert_allclose(np.asarray(r)[:64],
                                   b[:64] - a.to_dense() @ x[:64], rtol=1e-12)


class TestFemProblems:
    def test_elasticity2d_spd(self):
        from trilinos_tpu.galeri import elasticity2d

        a = elasticity2d(5, 4, e_mod=1.0, nu=0.25)
        assert a.shape == (40, 40)
        d = a.to_dense()
        np.testing.assert_allclose(d, d.T, atol=1e-12)
        w = np.linalg.eigvalsh(d)
        assert w.min() > 0  # SPD after boundary shift

    def test_elasticity2d_solvable(self):
        import jax.numpy as jnp

        from trilinos_tpu.galeri import elasticity2d
        from trilinos_tpu.solvers import cg

        a = elasticity2d(8, 8, e_mod=1.0, nu=0.3)
        dev = F.csr_to_ell(a)
        n = a.shape[0]
        b = np.zeros(dev.n_rows_pad)
        b[:n] = np.random.default_rng(0).standard_normal(n)
        res = cg(lambda x: S.spmv(dev, x), jnp.asarray(b),
                 rtol=1e-8, maxiter=5000)
        x = np.asarray(res.x)[:n]
        rel = (np.linalg.norm(b[:n] - a.to_dense() @ x)
               / np.linalg.norm(b[:n]))
        assert rel <= 1.1e-8

    def test_elasticity3d_spd_and_rigid_body(self):
        """Q1 hex elasticity (Galeri_Elasticity3DProblem analogue):
        element annihilates all 6 rigid-body modes; assembled operator
        is SPD after the boundary shift."""
        from trilinos_tpu.galeri import elasticity3d
        from trilinos_tpu.galeri.fem import _q1_elasticity3d_ke

        ke = _q1_elasticity3d_ke(1.0, 0.25)
        np.testing.assert_allclose(ke, ke.T, atol=1e-14)
        nodes = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                          [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]],
                         dtype=float)
        for d in range(3):
            m = np.zeros((8, 3))
            m[:, d] = 1
            assert np.abs(ke @ m.reshape(-1)).max() < 1e-12
        for ax in range(3):
            om = np.zeros(3)
            om[ax] = 1
            m = np.cross(np.broadcast_to(om, (8, 3)), nodes)
            assert np.abs(ke @ m.reshape(-1)).max() < 1e-12
        w = np.linalg.eigvalsh(ke)
        assert (np.abs(w) < 1e-12).sum() == 6  # exactly the RBMs

        a = elasticity3d(5, 4, 4, e_mod=1.0, nu=0.25)
        assert a.shape == (3 * 5 * 4 * 4,) * 2
        d = a.to_dense()
        np.testing.assert_allclose(d, d.T, atol=1e-12)
        assert np.linalg.eigvalsh(d).min() > 0

    def test_elasticity3d_bdia_packable_and_solvable(self):
        """Interior nodes couple to 27 neighbours -> constant-block-
        offset (BDIA b=3) structure; CG on the BDIA apply reaches the
        tolerance."""
        import jax.numpy as jnp

        from trilinos_tpu.galeri import elasticity3d
        from trilinos_tpu.ops import csr_to_bdia
        from trilinos_tpu.solvers import cg

        a = elasticity3d(8, 7, 6, e_mod=1.0, nu=0.3, dtype=np.float32)
        bd = csr_to_bdia(a, 3, dtype=np.float32)
        assert bd.block_size == 3 and len(bd.offsets) == 27
        n = a.shape[0]
        x = np.random.default_rng(2).standard_normal(n).astype(
            np.float32)
        xp = np.zeros(bd.n_rows_pad, np.float32)
        xp[:n] = x
        y = np.asarray(S.spmv(bd, jnp.asarray(xp)))[:n]
        y_ref = a.to_dense() @ x
        assert (np.abs(y - y_ref).max()
                <= 1e-5 * np.abs(y_ref).max())

        b = np.zeros(bd.n_rows_pad, np.float32)
        b[:n] = np.random.default_rng(3).standard_normal(n)
        res = cg(lambda v: S.spmv(bd, v), jnp.asarray(b), rtol=1e-5,
                 maxiter=3000)
        xs = np.asarray(res.x)[:n]
        rel = (np.linalg.norm(b[:n] - a.to_dense() @ xs)
               / np.linalg.norm(b[:n]))
        assert rel <= 2e-5, rel

    def test_helmholtz_shift(self):
        from trilinos_tpu.galeri import helmholtz2d
        from trilinos_tpu.galeri import laplace2d

        h = helmholtz2d(10, 10, k=2.0, h=0.1)
        l = laplace2d(10, 10)
        diff = l.to_dense() - h.to_dense()
        np.testing.assert_allclose(np.diag(diff), 0.04 * np.ones(100),
                                   rtol=1e-12)

    def test_uniflow_directions(self):
        from trilinos_tpu.galeri import uniflow2d

        a_e = uniflow2d(8, 8, alpha=0.0, conv=1.0, diff=1e-3)  # flow +x
        a_n = uniflow2d(8, 8, alpha=np.pi / 2, conv=1.0, diff=1e-3)
        # different wind -> different matrices, both nonsymmetric
        assert not np.allclose(a_e.to_dense(), a_n.to_dense())
        d = a_e.to_dense()
        assert not np.allclose(d, d.T)


class TestBf16Storage:
    def test_bf16_dia_matches_f32(self, rng):
        """bf16 matrix storage (halves the dominant SpMV stream) with f32
        compute — the mixed-precision option from the roadmap."""
        import ml_dtypes
        import jax.numpy as jnp
        from trilinos_tpu.galeri import laplace3d

        a = laplace3d(8, 8, 8)
        d16 = F.csr_to_dia(a, dtype=ml_dtypes.bfloat16)
        d32 = F.csr_to_dia(a, dtype=np.float32)
        assert str(d16.dtype) == "bfloat16"
        x = rng.standard_normal(d32.n_rows_pad).astype(np.float32)
        y16 = np.asarray(S.spmv(d16, jnp.asarray(x)),
                         dtype=np.float32)
        y32 = np.asarray(S.spmv(d32, jnp.asarray(x)))
        rel = np.abs(y16 - y32).max() / np.abs(y32).max()
        assert rel < 2e-2


def test_from_coo_fuzz_vs_scipy():
    """Round-5 from_coo rewrite (single-sort + reduceat dedup): random
    COO with duplicates, unsorted/sorted/empty, must match
    scipy.coo_matrix's canonical CSR exactly."""
    import scipy.sparse as sp

    rng = np.random.default_rng(42)
    for trial in range(25):
        m = int(rng.integers(1, 40))
        n = int(rng.integers(1, 40))
        nnz = int(rng.integers(0, 4 * m))
        rows = rng.integers(0, m, nnz)
        cols = rng.integers(0, n, nnz)
        vals = rng.standard_normal(nnz)
        if trial % 3 == 0 and nnz:  # sorted-input fast path
            order = np.lexsort((cols, rows))
            rows, cols, vals = rows[order], cols[order], vals[order]
        a = F.CsrHost.from_coo(rows, cols, vals, (m, n))
        ref = sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsr()
        ref.sum_duplicates()
        np.testing.assert_array_equal(a.row_ptr, ref.indptr)
        np.testing.assert_array_equal(a.cols, ref.indices)
        np.testing.assert_allclose(a.vals, ref.data, rtol=1e-14)


def test_from_coo_complex_and_nodedup():
    import scipy.sparse as sp

    rng = np.random.default_rng(7)
    rows = rng.integers(0, 10, 30)
    cols = rng.integers(0, 10, 30)
    vals = rng.standard_normal(30) + 1j * rng.standard_normal(30)
    a = F.CsrHost.from_coo(rows, cols, vals, (10, 10))
    ref = sp.coo_matrix((vals, (rows, cols)), shape=(10, 10)).tocsr()
    ref.sum_duplicates()
    np.testing.assert_allclose(a.to_dense(), ref.toarray(), rtol=1e-14)
    # sum_duplicates=False keeps every entry, stably ordered
    b = F.CsrHost.from_coo(np.array([1, 0, 1]), np.array([2, 1, 2]),
                           np.array([1.0, 2.0, 3.0]), (3, 3),
                           sum_duplicates=False)
    assert b.nnz == 3
    np.testing.assert_allclose(b.row(1)[1], [1.0, 3.0])
