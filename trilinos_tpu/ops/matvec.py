"""Local SpMV / SpMM dispatch over the device formats.

JAX replacement for ``KokkosSparse::spmv``
(reference: packages/kokkos-kernels/src/sparse/KokkosSparse_spmv.hpp:65 and
impl/KokkosSparse_spmv_impl.hpp). Where the reference picks team/vector
launch parameters per call, here the *format* was chosen at pack time
(formats.choose_format) and each format has one XLA-fusable compute shape:

  * ELL — gather rows of x + multiply + row-sum (one bandwidth-bound pass);
  * DIA — unrolled shifted multiply-adds (no gather; stencil fast path);
  * BSR — gathered block panels through batched b×b products;
  * BDIA — block-stencil multiply-adds on residue planes;
  * StencilOp — matrix-free masked shifted multiply-adds (ops/stencil.py).

All functions accept x of shape (n_pad,) or (n_pad, nrhs) and return y with
the same leading padding; identity padding rows map zero padding to zero.
Every path is plain jax.numpy that XLA compiles for the device.
"""
from __future__ import annotations


import jax
import jax.numpy as jnp

from .blas import HI
from .formats import (BdiaMatrix, BsrMatrix, DiaMatrix, EllMatrix,
                      SparseMatrix)
from .stencil import StencilOp, stencil_spmv_xla


def _ensure_2d(x):
    if x.ndim == 1:
        return x[:, None], True
    return x, False


def _restore(y, was_1d):
    return y[:, 0] if was_1d else y


# ---------------------------------------------------------------------------
# format kernels (XLA)
# ---------------------------------------------------------------------------


def ell_spmm(a: EllMatrix, x: jax.Array) -> jax.Array:
    """y[i] = sum_k vals[i,k] * x[cols[i,k]]  (padding entries have val 0)."""
    x2, was_1d = _ensure_2d(x)
    gathered = x2.at[a.cols].get(mode="promise_in_bounds")
    # precision pinned: this is an OPERATOR apply (ILU factors, AMG
    # transfers, general ELL matrices) — a reduced-precision default
    # (TF32 on the GPU) would be a silent perturbation of A itself
    y = jnp.einsum("rk,rkn->rn", a.vals, gathered.astype(a.vals.dtype),
                   precision=HI)
    return _restore(y, was_1d)


def dia_spmm(a: DiaMatrix, x: jax.Array) -> jax.Array:
    """y[i] = sum_d data[d,i] * x[i + offsets[d]]; rolls are exact because
    out-of-range diagonal positions store zeros."""
    x2, was_1d = _ensure_2d(x)
    n = a.n_rows_pad
    if x2.shape[0] != n:
        raise ValueError(f"DIA spmv: x length {x2.shape[0]} != padded rows {n}")
    data = a.data
    y = jnp.zeros((n, x2.shape[1]), dtype=jnp.result_type(a.dtype, x2.dtype))
    for d, off in enumerate(a.offsets):
        shifted = jnp.roll(x2, -off, axis=0) if off != 0 else x2
        y = y + data[d][:, None] * shifted
    return _restore(y, was_1d)


def bsr_spmm(a: BsrMatrix, x: jax.Array) -> jax.Array:
    """Block SpMM: gather x block panels, batched b×b matmul."""
    x2, was_1d = _ensure_2d(x)
    b = a.block_size
    nrhs = x2.shape[1]
    xb = x2.reshape(-1, b, nrhs)  # (n_x_blocks, b, nrhs)
    panels = xb.at[a.bcols].get(mode="promise_in_bounds")
    # (nbr, kb, b, b) @ (nbr, kb, b, nrhs) -> (nbr, b, nrhs)
    y = jnp.einsum("rkij,rkjn->rin", a.bvals, panels.astype(a.bvals.dtype),
                   preferred_element_type=a.bvals.dtype, precision=HI)
    y = y.reshape(-1, nrhs)
    return _restore(y, was_1d)


def _bdia_planes(a: BdiaMatrix, x2: jax.Array) -> jax.Array:
    """De-interleave (n, k) into residue planes (b, NBR, k)."""
    b = a.block_size
    return x2.reshape(a.nbr_pad, b, -1).transpose(1, 0, 2)


def _bdia_unplanes(yp: jax.Array) -> jax.Array:
    b, nbr, k = yp.shape
    return yp.transpose(1, 0, 2).reshape(nbr * b, k)


def bdia_spmm(a: BdiaMatrix, x: jax.Array) -> jax.Array:
    """Block-stencil SpMM on residue planes:
    yp[i, q] += data[d, i, j, q] * xp[j, q + off_d].

    The (i, j) nest is UNROLLED into elementwise FMAs (b ≤ 4 makes the
    contraction dims tiny): plain f32 multiply-adds that XLA fuses into
    one loop, with no matrix-unit precision question at all. Larger
    blocks (b > 4, e.g. the k=6 coarse levels of the elasticity AMG)
    switch to ONE HIGHEST-precision einsum per offset: the nd·b² unroll
    explodes XLA compile time inside solver loops (b=6, nd=27), and
    precision=HIGHEST keeps the einsum in full f32 (no TF32)."""
    x2, was_1d = _ensure_2d(x)
    if x2.shape[0] != a.n_rows_pad:
        raise ValueError(
            f"BDIA spmv: x length {x2.shape[0]} != padded rows {a.n_rows_pad}")
    b = a.block_size
    xp = _bdia_planes(a, x2)  # (b, NBR, k)
    data = a.data  # (nd, b, b, NBR)
    rt = jnp.result_type(a.dtype, x2.dtype)
    if b > 4:
        acc = jnp.zeros(xp.shape, dtype=rt)
        for d, off in enumerate(a.offsets):
            shifted = jnp.roll(xp, -off, axis=1) if off else xp
            acc = acc + jnp.einsum(
                "ijq,jqk->iqk", data[d].astype(rt), shifted.astype(rt),
                precision=jax.lax.Precision.HIGHEST)
        return _restore(_bdia_unplanes(acc), was_1d)
    accs = [jnp.zeros(xp.shape[1:], dtype=rt) for _ in range(b)]
    for d, off in enumerate(a.offsets):
        shifted = jnp.roll(xp, -off, axis=1) if off else xp
        for i in range(b):
            for j in range(b):
                accs[i] = accs[i] + (data[d, i, j][:, None]
                                     * shifted[j].astype(rt))
    return _restore(_bdia_unplanes(jnp.stack(accs)), was_1d)


def bdia_spmm_t(a: BdiaMatrix, x: jax.Array) -> jax.Array:
    """Transpose apply: yp[j, q + off] += data[d, i, j, q] * xp[i, q].
    Unrolled elementwise form below b=5, one HIGHEST-precision einsum
    per offset above — the same compile-time/precision split as the
    forward apply."""
    x2, was_1d = _ensure_2d(x)
    b = a.block_size
    xp = _bdia_planes(a, x2)
    data = a.data
    rt = jnp.result_type(a.dtype, x2.dtype)
    if b > 4:
        acc = jnp.zeros(xp.shape, dtype=rt)
        for d, off in enumerate(a.offsets):
            term = jnp.einsum("ijq,iqk->jqk", data[d].astype(rt),
                              xp.astype(rt),
                              precision=jax.lax.Precision.HIGHEST)
            acc = acc + (jnp.roll(term, off, axis=1) if off else term)
        return _restore(_bdia_unplanes(acc), was_1d)
    accs = [jnp.zeros(xp.shape[1:], dtype=rt) for _ in range(b)]
    for d, off in enumerate(a.offsets):
        for j in range(b):
            term = jnp.zeros(xp.shape[1:], dtype=rt)
            for i in range(b):
                term = term + data[d, i, j][:, None] * xp[i].astype(rt)
            accs[j] = accs[j] + (jnp.roll(term, off, axis=0) if off
                                 else term)
    return _restore(_bdia_unplanes(jnp.stack(accs)), was_1d)


# transpose applies ------------------------------------------------------


def ell_spmm_t(a: EllMatrix, x: jax.Array, n_out: int | None = None) -> jax.Array:
    """yᵀ apply: y[cols[i,k]] += vals[i,k] * x[i] (scatter-add)."""
    x2, was_1d = _ensure_2d(x)
    n_out = n_out or a.vals.shape[0]  # padded col space assumed == row pad
    contrib = a.vals[:, :, None] * x2[:, None, :]
    y = jnp.zeros((n_out, x2.shape[1]), dtype=contrib.dtype)
    y = y.at[a.cols.reshape(-1)].add(contrib.reshape(-1, x2.shape[1]),
                                     mode="promise_in_bounds")
    return _restore(y, was_1d)


def dia_spmm_t(a: DiaMatrix, x: jax.Array) -> jax.Array:
    """Transpose of DIA: diagonal at offset o becomes offset -o with data
    shifted; yᵀ[j] = sum_d data[d, j - o_d] * x[j - o_d]."""
    x2, was_1d = _ensure_2d(x)
    n = a.n_rows_pad
    data = a.data
    y = jnp.zeros((n, x2.shape[1]), dtype=jnp.result_type(a.dtype, x2.dtype))
    for d, off in enumerate(a.offsets):
        term = data[d][:, None] * x2
        y = y + (jnp.roll(term, off, axis=0) if off != 0 else term)
    return _restore(y, was_1d)


def bsr_spmm_t(a: BsrMatrix, x: jax.Array) -> jax.Array:
    x2, was_1d = _ensure_2d(x)
    b = a.block_size
    nrhs = x2.shape[1]
    xb = x2.reshape(-1, b, nrhs)[: a.n_brows_pad]
    # contribution of block (r,k): bvals[r,k]^T @ xb[r] into block bcols[r,k]
    contrib = jnp.einsum("rkij,rin->rkjn", a.bvals, xb.astype(a.bvals.dtype),
                         preferred_element_type=a.bvals.dtype, precision=HI)
    n_bout = max(a.n_brows_pad, -(-a.n_cols // b))
    y = jnp.zeros((n_bout, b, nrhs), dtype=contrib.dtype)
    y = y.at[a.bcols.reshape(-1)].add(contrib.reshape(-1, b, nrhs),
                                      mode="promise_in_bounds")
    y = y.reshape(-1, nrhs)
    return _restore(y, was_1d)


# ---------------------------------------------------------------------------
# public dispatch
# ---------------------------------------------------------------------------

_XLA_FWD = {EllMatrix: ell_spmm, DiaMatrix: dia_spmm, BsrMatrix: bsr_spmm,
            BdiaMatrix: bdia_spmm}
_XLA_TRANS = {EllMatrix: ell_spmm_t, DiaMatrix: dia_spmm_t,
              BsrMatrix: bsr_spmm_t, BdiaMatrix: bdia_spmm_t}


def spmv(a: SparseMatrix, x: jax.Array,
         transpose: bool = False) -> jax.Array:
    """Local sparse matrix–(multi)vector product."""
    x = jnp.asarray(x)
    if isinstance(a, StencilOp):
        return stencil_spmv_xla(a.transposed() if transpose else a, x)
    table = _XLA_TRANS if transpose else _XLA_FWD
    return table[type(a)](a, x)


spmm = spmv  # multivector RHS is handled uniformly


def residual(a: SparseMatrix, x: jax.Array, b: jax.Array) -> jax.Array:
    """Fused r = b - A x (analogue of Tpetra::Details::localResidual,
    packages/tpetra/core/src/Tpetra_Details_residual.hpp:53). XLA fuses the
    subtraction into the SpMV epilogue."""
    return b - spmv(a, x)
