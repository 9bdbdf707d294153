"""Stencil polynomial applies (matrix powers / Chebyshev / Richardson as
one recurrence chain) against the same recurrence evaluated with a
scipy.sparse CSR of the stencil, and the Chebyshev stages against the
Chebyshev preconditioner class. Reference anchors:
Ifpack2_Details_ChebyshevKernel_decl.hpp (smoother sweep),
Belos_Tpetra_GmresSstep.hpp:305 (matrix-powers basis)."""
import numpy as np
import pytest

import jax.numpy as jnp

from trilinos_tpu.galeri import stencils
from trilinos_tpu.ops.stencil import (
    StencilOp, chebyshev_stages, monomial_stages, power_stages,
    richardson_stages, stencil_poly_xla, stencil_powers_xla)

ST7 = [((0, 0, 0), 6.0), ((1, 0, 0), -1.0), ((-1, 0, 0), -1.0),
       ((0, 1, 0), -1.0), ((0, -1, 0), -1.0), ((0, 0, 1), -1.0),
       ((0, 0, -1), -1.0)]
ST5 = [((0, 0), 4.0), ((1, 0), -1.0), ((-1, 0), -1.0),
       ((0, 1), -1.0), ((0, -1), -1.0)]


def _newton4():
    """Newton-basis stage tuples (via the canonical builder in
    solvers.sstep_gmres) with zeta=0 appended."""
    from trilinos_tpu.solvers.sstep_gmres import newton_basis_stages

    return tuple((a, bt, g, 0.0) for a, bt, g in
                 newton_basis_stages([5.9, 3.1, 0.4, 2.2], 6.0))


def _reference(dims, st, n_pad, stages, x):
    """u_1..u_s of the recurrence with scipy CSR applies in f64; padding
    rows carry u_{j-1} unchanged."""
    a = stencils.stencil_csr(dims, st).to_scipy()
    n = a.shape[0]
    x = np.asarray(x, np.float64)
    u_prev2, u_prev = np.zeros_like(x), x
    outs = []
    for (al, bt, g, z) in stages:
        au = np.concatenate([a @ u_prev[:n], u_prev[n:]])
        u = al * au + bt * u_prev + g * u_prev2 + z * x
        u[n:] = u_prev[n:]
        u_prev2, u_prev = u_prev, u
        outs.append(u)
    return np.stack(outs)


CASES = {
    "powers1": power_stages(1),
    "powers2": power_stages(2),
    "powers4": power_stages(4),
    "monomial4": monomial_stages(4, sigma=6.0),
    "newton4": _newton4(),
    "chebyshev4": chebyshev_stages(1.9, 0.06, 4, 1 / 6.0),
    "richardson3": richardson_stages(0.8, 3, 1 / 6.0),
}
GRIDS = {
    "3d": ((16, 12, 6), ST7, None),
    "2d": ((20, 14), ST5, None),
    "non_pow2": ((24, 18, 5), ST7, None),
    "padded_planes": ((8, 8, 5), ST7, 8 * 8 * 7),
}


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("name", sorted(CASES))
def test_powers_match_scipy_recurrence(grid, name):
    dims, st, n_pad = GRIDS[grid]
    op = StencilOp.create(dims, st, n_rows_pad=n_pad, dtype="float64")
    # nonzero padding rows: they must pass through every stage unchanged
    x = np.random.default_rng(len(name)).standard_normal(op.n_rows_pad)
    stages = CASES[name]
    got = np.asarray(stencil_powers_xla(op, stages, jnp.asarray(x)))
    want = _reference(dims, st, op.n_rows_pad, stages, x)
    assert got.shape == (len(stages), op.n_rows_pad)
    np.testing.assert_allclose(got, want, rtol=1e-11,
                               atol=1e-11 * np.abs(want).max())
    last = np.asarray(stencil_poly_xla(op, stages, jnp.asarray(x)))
    np.testing.assert_array_equal(last, got[-1])
    np.testing.assert_array_equal(got[:, op.n_rows:],
                                  np.broadcast_to(x[op.n_rows:],
                                                  got[:, op.n_rows:].shape))


def test_multivector_poly_matches_columns():
    op = StencilOp.create((16, 12, 6), ST7, dtype="float64")
    x = np.random.default_rng(3).standard_normal((op.n_rows_pad, 3))
    stages = chebyshev_stages(1.9, 0.06, 3, 1 / 6.0)
    got = np.asarray(stencil_poly_xla(op, stages, jnp.asarray(x)))
    for j in range(3):
        col = np.asarray(stencil_poly_xla(op, stages, jnp.asarray(x[:, j])))
        np.testing.assert_allclose(got[:, j], col, rtol=1e-13, atol=1e-13)


def test_z_bounds_default_is_full_grid():
    """Explicit z-bounds (0, nz) equal the default masks."""
    op = StencilOp.create((16, 12, 6), ST7, dtype="float64")
    x = jnp.asarray(np.random.default_rng(4).standard_normal(op.n_rows_pad))
    stages = power_stages(3)
    got = stencil_poly_xla(op, stages, x,
                           z_bounds=jnp.asarray([0, 6], jnp.int32))
    np.testing.assert_array_equal(np.asarray(got),
                                  np.asarray(stencil_poly_xla(op, stages, x)))


def test_chebyshev_stages_match_preconditioner():
    """chebyshev_stages reproduces the Chebyshev preconditioner class
    exactly (constant-diagonal stencil, explicit eigen bounds)."""
    from trilinos_tpu.galeri import laplace3d
    from trilinos_tpu.precond import create as make_prec

    nx, ny, nz = 16, 16, 4
    a = laplace3d(nx, ny, nz)          # CsrHost, diag = 6
    lmax, lmin = 1.9 * 6, 0.06 * 6
    degree = 4
    prec = make_prec("CHEBYSHEV", a, {
        "chebyshev: degree": degree,
        "chebyshev: max eigenvalue": lmax / 6.0,
        "chebyshev: min eigenvalue": lmin / 6.0,
    }).compute()
    # NOTE the class runs on the Jacobi-scaled system: its
    # lmax/lmin are eigenvalue bounds of D^-1 A.
    op = StencilOp.create((nx, ny, nz), ST7)
    b = np.zeros(op.n_rows_pad, np.float32)
    b[:op.n_rows] = np.random.default_rng(9).standard_normal(op.n_rows)
    bj = jnp.asarray(b)
    stages = chebyshev_stages(lmax / 6.0, lmin / 6.0, degree, 1 / 6.0)
    got = np.asarray(stencil_poly_xla(op, stages, bj))
    want = np.asarray(prec.apply(bj[:op.n_rows_pad]))
    np.testing.assert_allclose(got[:op.n_rows], want[:op.n_rows],
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("degree", [2, 3, 5])
def test_fused_stencil_chebyshev_equals_class(degree):
    """fused_stencil_chebyshev on the StencilOp ≡ the Chebyshev class on
    the stored matrix, given the same eigenvalue bounds."""
    from trilinos_tpu.galeri import laplace3d
    from trilinos_tpu.precond import create as make_prec
    from trilinos_tpu.precond import fused_stencil_chebyshev

    op = laplace3d(16, 16, 8, fmt="stencil")
    lmax = 2.0
    fused = fused_stencil_chebyshev(op, degree=degree, lmax=lmax)
    cls = make_prec("CHEBYSHEV", laplace3d(16, 16, 8), {
        "chebyshev: degree": degree, "chebyshev: max eigenvalue": lmax,
        "chebyshev: min eigenvalue": lmax / 30.0}).compute()
    b = np.zeros(op.n_rows_pad)
    b[:op.n_rows] = np.random.default_rng(degree).standard_normal(op.n_rows)
    got = np.asarray(fused(jnp.asarray(b)))[:op.n_rows]
    want = np.asarray(cls.apply(jnp.asarray(b)))[:op.n_rows]
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_fused_chebyshev_preconditions_cg():
    """CG + degree-3 Chebyshev polynomial on the stencil operator:
    converges, matches the unpreconditioned solution, and cuts the
    iteration count (the AMG-smoother/preconditioner use case)."""
    from trilinos_tpu.galeri import laplace3d
    from trilinos_tpu.ops import matvec as mv
    from trilinos_tpu.precond import fused_stencil_chebyshev
    from trilinos_tpu.solvers import cg

    op = laplace3d(32, 32, 8, dtype=np.float32, fmt="stencil")
    n, npad = op.n_rows, op.n_rows_pad
    b = np.zeros(npad, np.float32)
    b[:n] = np.random.default_rng(3).standard_normal(n)
    bj = jnp.asarray(b)
    prec = fused_stencil_chebyshev(op, degree=3)
    res_p = cg(lambda v: mv.spmv(op, v), bj, prec=prec, rtol=1e-5,
               maxiter=300)
    res_0 = cg(lambda v: mv.spmv(op, v), bj, rtol=1e-5, maxiter=300)
    assert bool(res_p.converged) and bool(res_0.converged)
    assert int(res_p.iters) < int(res_0.iters)
    np.testing.assert_allclose(np.asarray(res_p.x)[:n],
                               np.asarray(res_0.x)[:n],
                               rtol=2e-3, atol=2e-4)
