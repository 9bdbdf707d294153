"""Every SpMV path against scipy.sparse: forward and transpose, nrhs 1/2/4,
f32 and f64, on the formats the dispatch serves (matrix-free StencilOp,
DIA incl. bf16 data, ELL, BSR, BDIA). The geometry cases (2-D, Star2D
diagonal offsets, 27-point, padded and odd planes, non-power-of-two
dims, negative block offsets) pin the boundary handling of the
shifted-multiply-add paths."""
import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp

from trilinos_tpu.galeri import elasticity2d, laplace2d, laplace3d, \
    recirc2d, stencils
from trilinos_tpu.galeri.fem import elasticity3d
from trilinos_tpu.ops import CsrHost, csr_to_bdia, csr_to_bsr, csr_to_dia, \
    csr_to_ell, spmv
from trilinos_tpu.ops.stencil import StencilOp

ST7 = stencils.cross3d_stencil(6.0, *([-1.0] * 6))
ST5 = stencils.cross2d_stencil(4.0, -1.0, -1.0, -1.0, -1.0)
# a nonsymmetric 5-point stencil makes the transpose meaningful
ST5_NS = stencils.cross2d_stencil(4.0, -1.5, -0.5, -1.25, -0.75)
STAR = stencils.star2d_stencil(8.0, *([-1.0] * 8))
BRICK = stencils.brick3d_stencil(26.0, -1.0, -0.5, -0.25)


def _stencil(dims, st, n_rows_pad=None):
    return (lambda dt: StencilOp.create(dims, st, n_rows_pad=n_rows_pad,
                                        dtype=np.dtype(dt).name),
            lambda: stencils.stencil_csr(dims, st))


def _stored(make_csr, convert):
    return (lambda dt: convert(make_csr(), dt), make_csr)


def _random_csr():
    rng = np.random.default_rng(11)
    a = sp.random(300, 300, density=0.02, random_state=rng,
                  format="csr") + sp.eye(300) * 4.0
    return CsrHost.from_scipy(a.tocsr())


CASES = {
    "stencil7_3d": _stencil((12, 10, 6), ST7),
    "stencil27_brick": _stencil((8, 6, 5), BRICK),
    "stencil5_2d_nonsym": _stencil((30, 20), ST5_NS),
    "stencil_star2d": _stencil((16, 12), STAR),
    "stencil_padded_planes": _stencil((8, 8, 5), ST7, 8 * 8 * 7),
    "stencil_odd_planes": _stencil((7, 5, 3), ST7),
    "stencil_non_pow2": _stencil((24, 18, 6), ST7),
    "dia_laplace3d": _stored(lambda: laplace3d(10, 8, 6),
                             lambda a, dt: csr_to_dia(a, dtype=dt)),
    "dia_recirc2d": _stored(lambda: recirc2d(20, 16),
                            lambda a, dt: csr_to_dia(a, dtype=dt)),
    "ell_recirc2d": _stored(lambda: recirc2d(20, 16),
                            lambda a, dt: csr_to_ell(a, dtype=dt)),
    "ell_random": _stored(_random_csr,
                          lambda a, dt: csr_to_ell(a, dtype=dt)),
    "bsr_elasticity2d_b2": _stored(lambda: elasticity2d(10, 8, e_mod=1.0),
                                   lambda a, dt: csr_to_bsr(a, 2, dtype=dt)),
    "bdia_elasticity2d_b2": _stored(
        lambda: elasticity2d(10, 8, e_mod=1.0),
        lambda a, dt: csr_to_bdia(a, 2, dtype=dt)),
    "bdia_elasticity3d_b3": _stored(
        lambda: elasticity3d(5, 4, 3, e_mod=1.0),
        lambda a, dt: csr_to_bdia(a, 3, dtype=dt)),
    "bdia_elasticity3d_b6": _stored(
        lambda: elasticity3d(4, 3, 2, e_mod=1.0),
        lambda a, dt: csr_to_bdia(a, 6, dtype=dt)),
}
TOL = {np.float32: 1e-5, np.float64: 1e-12}


def _check(dev, a_sp, x_full, transpose, tol):
    n = a_sp.shape[0]
    y = np.asarray(spmv(dev, jnp.asarray(x_full), transpose=transpose),
                   np.float64)
    x = np.asarray(x_full, np.float64)[:n]
    want = (a_sp.T if transpose else a_sp) @ x
    scale = np.abs(want).max()
    np.testing.assert_allclose(y[:n], want, rtol=0, atol=tol * scale)
    return y


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("nrhs", [1, 2, 4])
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_spmv_matches_scipy(case, transpose, nrhs, dtype):
    build, make_csr = CASES[case]
    a_sp = make_csr().to_scipy()
    dev = build(dtype)
    n = a_sp.shape[0]
    shape = (dev.n_rows_pad,) if nrhs == 1 else (dev.n_rows_pad, nrhs)
    x = np.zeros(shape, dtype)
    x[:n] = np.random.default_rng(nrhs).standard_normal(
        (n,) + shape[1:])
    y = _check(dev, a_sp, x, transpose, TOL[dtype])
    # zero padding maps to zero padding
    np.testing.assert_array_equal(y[n:], 0.0)


@pytest.mark.parametrize("case", ["dia_laplace3d", "dia_recirc2d"])
def test_dia_bf16_data_f32_accumulate(case):
    """bf16 diagonal storage with f32 vectors: within bf16 rounding of
    the matrix values (exact for the integer Laplacian)."""
    _, make_csr = CASES[case]
    a = make_csr()
    dev = csr_to_dia(a, dtype=jnp.bfloat16)
    assert dev.dtype == jnp.bfloat16
    x = np.zeros(dev.n_rows_pad, np.float32)
    x[:a.shape[0]] = np.random.default_rng(0).standard_normal(a.shape[0])
    y = spmv(dev, jnp.asarray(x))
    assert y.dtype == jnp.float32
    _check(dev, a.to_scipy(), x, False, 1e-2)


def test_stencil_padding_rows_are_identity():
    """Extra whole z-planes past the grid are identity rows."""
    build, make_csr = CASES["stencil_padded_planes"]
    op = build(np.float64)
    x = np.random.default_rng(5).standard_normal(op.n_rows_pad)
    y = _check(op, make_csr().to_scipy(), x, False, 1e-12)
    np.testing.assert_array_equal(y[op.n_rows:], x[op.n_rows:])


def test_stencil_nnz_counts_boundary_truncation():
    op = laplace2d(10, 10, dtype=np.float32, fmt="stencil")
    assert op.nnz == laplace2d(10, 10).nnz


def test_cg_with_stencil_op():
    from trilinos_tpu.solvers import cg

    op = laplace2d(20, 20, dtype=np.float64, fmt="stencil")
    a = laplace2d(20, 20)
    x_true = np.random.default_rng(3).standard_normal(400)
    b = np.zeros(op.n_rows_pad)
    b[:400] = a.to_dense() @ x_true
    res = cg(lambda v: spmv(op, v), jnp.asarray(b), rtol=1e-10,
             maxiter=2000)
    np.testing.assert_allclose(np.asarray(res.x)[:400], x_true,
                               rtol=1e-6, atol=1e-8)


def test_cg_converges_with_bf16_matrix():
    from trilinos_tpu.solvers import cg

    a16 = laplace2d(24, 24, dtype=jnp.bfloat16, fmt="dia")
    a = laplace2d(24, 24)
    n, npad = a.shape[0], a16.n_rows_pad
    b = np.zeros(npad, np.float32)
    b[:n] = np.random.default_rng(2).standard_normal(n)
    res = cg(lambda v: spmv(a16, v), jnp.asarray(b), rtol=1e-5,
             maxiter=2000)
    assert bool(res.converged.all())
    x = np.asarray(res.x, dtype=np.float64)[:n]
    rel = (np.linalg.norm(b[:n] - a.to_dense() @ x)
           / np.linalg.norm(b[:n]))
    assert rel <= 5e-5
