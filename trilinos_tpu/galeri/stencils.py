"""Galeri-equivalent test-problem generators.

Named stencil operators matching the reference's Galeri package
(packages/galeri/src-epetra/Galeri_CrsMatrices.cpp:157-303 string factory;
stencil headers packages/galeri/src-epetra/CrsMatrices/Galeri_Cross2D.h:77-95,
Galeri_Star2D.h, Galeri_Cross3D.h, Galeri_Recirc2D.h; Xpetra-side Brick3D in
packages/galeri/src-xpetra/Galeri_StencilProblems.hpp).

Accelerator-first difference: instead of a per-row InsertGlobalValues assembly loop,
generators emit the operator in **closed form** — vectorized COO → CsrHost,
or directly as DiaMatrix (offset/value arrays with boundary masks), which is
the zero-assembly fast path for large problems.

Grid numbering matches the reference: lexicographic, gid = ix + nx*(iy + ny*iz)
(Galeri_Utils GetNeighboursCartesian2d/3d). Boundaries are Dirichlet-truncated
(out-of-range neighbors simply absent).
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from ..ops.formats import CsrHost, DiaMatrix, round_up, ROW_ALIGN

import jax.numpy as jnp

# A stencil is a list of (grid_offset, coefficient) pairs; the coefficient is
# a scalar or a callable mapping coordinate arrays (ix, iy, ...) -> values.
Stencil = Sequence[tuple[tuple[int, ...], float | Callable]]


def _grid_coords(dims: tuple[int, ...]):
    """Coordinate arrays of shape (n_total,) per dimension, lexicographic
    with the FIRST dim fastest (matches Galeri's ix = gid % nx)."""
    idx = np.arange(int(np.prod(dims)), dtype=np.int64)
    coords = []
    for d in dims:
        coords.append(idx % d)
        idx = idx // d
    return coords


def _gid(coords, dims) -> np.ndarray:
    g = np.zeros_like(coords[0])
    stride = 1
    for c, d in zip(coords, dims):
        g = g + c * stride
        stride *= d
    return g


def _coeff_values(coeff, coords) -> np.ndarray:
    if callable(coeff):
        return np.asarray(coeff(*coords), dtype=np.float64)
    return np.full(coords[0].shape, float(coeff))


def stencil_csr(dims: tuple[int, ...], stencil: Stencil,
                dtype=np.float64) -> CsrHost:
    """Assemble a stencil operator as host CSR (vectorized, no insert loop)."""
    n = int(np.prod(dims))
    coords = _grid_coords(dims)
    # row gid is just the linear index, and a stencil offset's neighbor
    # gid is gid + Σ o_k·stride_k (a CONSTANT shift) — no per-offset
    # gid recomputation (profiled 8s of a 24s 128³ assembly)
    idx = np.arange(n, dtype=np.int64)
    strides = []
    s = 1
    for d in dims:
        strides.append(s)
        s *= d
    rows_all, cols_all, vals_all = [], [], []
    for off, coeff in stencil:
        valid = np.ones(n, dtype=bool)
        lin = 0
        for c, o, d, st in zip(coords, off, dims, strides):
            if o:
                cn = c + o
                valid &= (cn >= 0) & (cn < d)
            lin += o * st
        vals = _coeff_values(coeff, coords).astype(dtype)
        rows_all.append(idx[valid])
        cols_all.append(idx[valid] + lin)
        vals_all.append(vals[valid])
    return CsrHost.from_coo(np.concatenate(rows_all), np.concatenate(cols_all),
                            np.concatenate(vals_all), (n, n),
                            sum_duplicates=True)


def stencil_dia(dims: tuple[int, ...], stencil: Stencil, dtype=np.float64,
                n_rows_pad: int | None = None,
                identity_pad: bool = True) -> DiaMatrix:
    """Assemble a stencil operator directly as DiaMatrix (no COO/CSR pass).

    Each stencil offset maps to one linear diagonal offset; boundary-invalid
    positions are zeroed in the data array, which is exactly the invariant
    ``dia_spmm`` relies on for its cyclic shifts.
    """
    n = int(np.prod(dims))
    if n_rows_pad is None:
        n_rows_pad = round_up(n, ROW_ALIGN)
    coords = _grid_coords(dims)
    # merge stencil entries landing on the same linear offset
    by_off: dict[int, np.ndarray] = {}
    nnz = 0
    for off, coeff in stencil:
        lin = 0
        stride = 1
        for o, d in zip(off, dims):
            lin += o * stride
            stride *= d
        valid = np.ones(n, dtype=bool)
        for c, o, d in zip(coords, off, dims):
            cn = c + o
            valid &= (cn >= 0) & (cn < d)
        vals = np.where(valid, _coeff_values(coeff, coords), 0.0).astype(dtype)
        nnz += int(valid.sum())
        if lin in by_off:
            by_off[lin] = by_off[lin] + vals
        else:
            by_off[lin] = vals
    offsets = tuple(sorted(by_off))
    data = np.zeros((len(offsets), n_rows_pad), dtype=dtype)
    for i, o in enumerate(offsets):
        data[i, :n] = by_off[o]
    if identity_pad and 0 in by_off and n_rows_pad > n:
        data[offsets.index(0), n:] = 1.0
    return DiaMatrix(data=jnp.asarray(data), offsets=offsets, n_rows=n,
                     n_cols=n, nnz=nnz)


# ---------------------------------------------------------------------------
# Named problems (reference parameter conventions)
# ---------------------------------------------------------------------------


def cross2d_stencil(a, b, c, d, e) -> Stencil:
    #     e            (Galeri_Cross2D.h:72-75: b left, c right, d lower, e upper)
    #   b a c
    #     d
    return [((0, 0), a), ((-1, 0), b), ((1, 0), c), ((0, -1), d), ((0, 1), e)]


def star2d_stencil(a, b, c, d, e, z1, z2, z3, z4) -> Stencil:
    # Galeri_Star2D.h:84-127: corners z1..z4 = (lower-1, lower+1, upper-1, upper+1)
    return cross2d_stencil(a, b, c, d, e) + [
        ((-1, -1), z1), ((1, -1), z2), ((-1, 1), z3), ((1, 1), z4)]


def big_star2d_stencil(a, b, c, d, e, z1, z2, z3, z4, bb, cc, dd, ee) -> Stencil:
    # Galeri_BigStar2D.h: 13-point (star + distance-2 cross)
    return star2d_stencil(a, b, c, d, e, z1, z2, z3, z4) + [
        ((-2, 0), bb), ((2, 0), cc), ((0, -2), dd), ((0, 2), ee)]


def cross3d_stencil(a, b, c, d, e, f, g) -> Stencil:
    # Galeri_Cross3D.h:59-61: b/c left-right, d/e lower-upper, f/g below-above
    return [((0, 0, 0), a), ((-1, 0, 0), b), ((1, 0, 0), c),
            ((0, -1, 0), d), ((0, 1, 0), e), ((0, 0, -1), f), ((0, 0, 1), g)]


def brick3d_stencil(a, b, c, d) -> Stencil:
    """27-point stencil: center a, faces b, edges c, corners d
    (packages/galeri/src-xpetra/Galeri_StencilProblems.hpp Brick3D)."""
    st = []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                r = abs(dx) + abs(dy) + abs(dz)
                coeff = (a, b, c, d)[r]
                st.append(((dx, dy, dz), coeff))
    return st


def laplace1d(n: int, dtype=np.float64, fmt: str = "csr"):
    st = [((0,), 2.0), ((-1,), -1.0), ((1,), -1.0)]
    return _emit((n,), st, dtype, fmt)


def laplace2d(nx: int, ny: int, dtype=np.float64, fmt: str = "csr"):
    """Laplace2D = Cross2D(4, -1, -1, -1, -1)
    (Galeri_CrsMatrices.cpp:287)."""
    return _emit((nx, ny), cross2d_stencil(4.0, -1.0, -1.0, -1.0, -1.0),
                 dtype, fmt)


def laplace3d(nx: int, ny: int, nz: int, dtype=np.float64, fmt: str = "csr"):
    """Laplace3D = Cross3D(6, -1 ×6) (Galeri_CrsMatrices.cpp:398ff)."""
    return _emit((nx, ny, nz), cross3d_stencil(6.0, *([-1.0] * 6)), dtype, fmt)


def star2d(nx: int, ny: int, a=5.0, b=-1.0, c=-1.0, d=-1.0, e=-1.0,
           z1=-0.25, z2=-0.25, z3=-0.25, z4=-0.25, dtype=np.float64,
           fmt: str = "csr"):
    return _emit((nx, ny), star2d_stencil(a, b, c, d, e, z1, z2, z3, z4),
                 dtype, fmt)


def big_star2d(nx: int, ny: int, dtype=np.float64, fmt: str = "csr"):
    """Default coefficients from Galeri_CrsMatrices.cpp:228:
    BigStar2D(20, -8, -8, -8, -8, 2, 2, 2, 2, 1, 1, 1, 1)."""
    st = big_star2d_stencil(20.0, -8.0, -8.0, -8.0, -8.0,
                            2.0, 2.0, 2.0, 2.0, 1.0, 1.0, 1.0, 1.0)
    return _emit((nx, ny), st, dtype, fmt)


def brick3d(nx: int, ny: int, nz: int, dtype=np.float64, fmt: str = "csr"):
    """27-point Brick3D with the standard (26, -1) fill."""
    return _emit((nx, ny, nz), brick3d_stencil(26.0, -1.0, -1.0, -1.0),
                 dtype, fmt)


def recirc2d(nx: int, ny: int, lx=1.0, ly=1.0, conv=1.0, diff=1e-5,
             dtype=np.float64, fmt: str = "csr"):
    """Recirculating convection-diffusion (upwinded), coefficients exactly
    per Galeri_Recirc2D.h:78-120."""
    hx = lx / (nx + 1)
    hy = ly / (ny + 1)

    def fields(ix, iy):
        x = hx * (ix + 1)
        y = hy * (iy + 1)
        conv_x = conv * 4 * x * (x - 1.0) * (1.0 - 2 * y) / hx
        conv_y = -conv * 4 * y * (y - 1.0) * (1.0 - 2 * x) / hy
        a = np.zeros_like(x)
        b = np.zeros_like(x)
        c = np.zeros_like(x)
        d = np.zeros_like(x)
        e = np.zeros_like(x)
        neg_x = conv_x < 0
        c += np.where(neg_x, conv_x, 0.0)
        a -= np.where(neg_x, conv_x, 0.0)
        b -= np.where(~neg_x, conv_x, 0.0)
        a += np.where(~neg_x, conv_x, 0.0)
        neg_y = conv_y < 0
        e += np.where(neg_y, conv_y, 0.0)
        a -= np.where(neg_y, conv_y, 0.0)
        d -= np.where(~neg_y, conv_y, 0.0)
        a += np.where(~neg_y, conv_y, 0.0)
        a += diff * 2.0 / (hx * hx) + diff * 2.0 / (hy * hy)
        b -= diff / (hx * hx)
        c -= diff / (hx * hx)
        d -= diff / (hy * hy)
        e -= diff / (hy * hy)
        return a, b, c, d, e

    def pick(i):
        return lambda ix, iy: fields(ix.astype(float), iy.astype(float))[i]

    st = [((0, 0), pick(0)), ((-1, 0), pick(1)), ((1, 0), pick(2)),
          ((0, -1), pick(3)), ((0, 1), pick(4))]
    return _emit((nx, ny), st, dtype, fmt)


def _emit(dims, st, dtype, fmt):
    if fmt == "csr":
        return stencil_csr(dims, st, dtype)
    if fmt == "dia":
        return stencil_dia(dims, st, dtype)
    if fmt == "stencil":
        # matrix-free constant-coefficient operator (the stencil fast path); only
        # valid when every coefficient is a constant scalar
        from ..ops.stencil import StencilOp

        if any(callable(c) for _, c in st):
            raise ValueError("fmt='stencil' requires constant coefficients")
        dt = np.dtype(dtype).name
        return StencilOp.create(dims, st, dtype=dt)
    raise ValueError(f"unknown fmt {fmt!r}")


# String factory, mirroring Galeri::CreateCrsMatrix's name dispatch
# (Galeri_CrsMatrices.cpp:157ff).
def create_matrix(name: str, params: dict, dtype=np.float64, fmt: str = "csr"):
    p = dict(params)
    nx, ny, nz = p.get("nx"), p.get("ny"), p.get("nz")
    name_lower = name.lower()
    if name_lower == "laplace1d":
        return laplace1d(nx, dtype, fmt)
    if name_lower == "laplace2d":
        return laplace2d(nx, ny, dtype, fmt)
    if name_lower == "laplace3d":
        return laplace3d(nx, ny, nz, dtype, fmt)
    if name_lower == "star2d":
        return star2d(nx, ny, dtype=dtype, fmt=fmt)
    if name_lower == "bigstar2d":
        return big_star2d(nx, ny, dtype, fmt)
    if name_lower == "brick3d":
        return brick3d(nx, ny, nz, dtype, fmt)
    if name_lower == "recirc2d":
        return recirc2d(nx, ny, conv=p.get("conv", 1.0),
                        diff=p.get("diff", 1e-5), dtype=dtype, fmt=fmt)
    if name_lower == "cross2d":
        st = cross2d_stencil(p["a"], p["b"], p["c"], p["d"], p["e"])
        return _emit((nx, ny), st, dtype, fmt)
    if name_lower in ("elasticity2d", "helmholtz2d", "uniflow2d"):
        from . import fem

        if name_lower == "elasticity2d":
            return fem.elasticity2d(nx, ny, e_mod=p.get("E", 1e9),
                                    nu=p.get("nu", 0.25))
        if name_lower == "helmholtz2d":
            return fem.helmholtz2d(nx, ny, k=p.get("k", 1.0),
                                   fmt=fmt) if "fmt" in                 fem.helmholtz2d.__code__.co_varnames else                 fem.helmholtz2d(nx, ny, k=p.get("k", 1.0))
        return fem.uniflow2d(nx, ny, conv=p.get("conv", 1.0),
                             diff=p.get("diff", 1e-5),
                             alpha=p.get("alpha", 0.0))
    if name_lower == "maxwell2d":
        return maxwell2d(nx, ny, sigma=p.get("sigma", 1.0))
    raise ValueError(f"unknown Galeri matrix type {name!r}")


def maxwell2d(nx: int, ny: int, sigma=1.0, dtype=np.float64):
    """2-D eddy-current (curl-curl) test problem on a structured grid:
    A = CᵀC + σ·M on EDGE unknowns, with M = I, plus the discrete
    gradient G (edges × nodes) whose range spans curl-curl's null space.
    The Galeri-style generator for Hiptmair smoother testing (reference:
    ifpack2/src/Ifpack2_Hiptmair_decl.hpp's target problem class).

    Edge numbering: x-edges (nx·(ny+1)) first, then y-edges ((nx+1)·ny).
    Returns (A: CsrHost, G: CsrHost).
    """
    n_nodes = (nx + 1) * (ny + 1)
    n_ex = nx * (ny + 1)
    n_ey = (nx + 1) * ny
    n_e = n_ex + n_ey

    def node(i, j):
        return i + (nx + 1) * j

    def ex(i, j):  # x-edge from (i,j) to (i+1,j)
        return i + nx * j

    def ey(i, j):  # y-edge from (i,j) to (i,j+1)
        return n_ex + i + (nx + 1) * j

    rows_g, cols_g, vals_g = [], [], []
    for j in range(ny + 1):
        for i in range(nx):
            rows_g += [ex(i, j), ex(i, j)]
            cols_g += [node(i + 1, j), node(i, j)]
            vals_g += [1.0, -1.0]
    for j in range(ny):
        for i in range(nx + 1):
            rows_g += [ey(i, j), ey(i, j)]
            cols_g += [node(i, j + 1), node(i, j)]
            vals_g += [1.0, -1.0]
    g = CsrHost.from_coo(np.array(rows_g), np.array(cols_g),
                         np.array(vals_g, dtype=dtype), (n_e, n_nodes))

    rows_c, cols_c, vals_c = [], [], []
    for j in range(ny):
        for i in range(nx):
            f = i + nx * j
            rows_c += [f, f, f, f]
            cols_c += [ex(i, j), ey(i + 1, j), ex(i, j + 1), ey(i, j)]
            vals_c += [1.0, 1.0, -1.0, -1.0]
    c = CsrHost.from_coo(np.array(rows_c), np.array(cols_c),
                         np.array(vals_c, dtype=dtype), (nx * ny, n_e))

    from ..ops.matrix_ops import diag_matrix, spadd, spgemm

    ctc = spgemm(c.transpose(), c)
    sig = (np.full(n_e, float(sigma)) if np.isscalar(sigma)
           else np.asarray(sigma, dtype=np.float64))
    a = spadd(ctc, diag_matrix(sig), 1.0, 1.0)
    return a, g
