"""Sparse matrix-matrix algebra on host CSR.

JAX analogue of TpetraExt's MatrixMatrix module
(packages/tpetra/core/ext/TpetraExt_MatrixMatrix_decl.hpp — distributed
SpGEMM C = A·B, spadd, and the triple product R·A·P of
TpetraExt_TripleMatrixMultiply_decl.hpp; node-local kernels in
kokkos-kernels/src/sparse/KokkosSparse_spgemm.hpp).

These products run at *setup* time (AMG hierarchy construction, graph
coarsening) — host-side vectorized numpy is the right tool; the resulting
operators are packed to device formats once. A C++ native kernel can slot
under the same API later.
"""
from __future__ import annotations

import numpy as np

from .formats import CsrHost


def spgemm(a: CsrHost, b: CsrHost) -> CsrHost:
    """C = A @ B (duplicate products summed)."""
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"shape mismatch {a.shape} @ {b.shape}")
    from ..native import spgemm_native

    c = spgemm_native(a, b)
    if c is not None:
        return c
    a_rows = np.repeat(np.arange(a.shape[0], dtype=np.int64),
                       a.row_lengths())
    b_row_len = np.diff(b.row_ptr)
    counts = b_row_len[a.cols]
    total = int(counts.sum())
    if total == 0:
        return CsrHost.from_coo(np.zeros(0, np.int64), np.zeros(0, np.int64),
                                np.zeros(0, a.vals.dtype),
                                (a.shape[0], b.shape[1]))
    starts = b.row_ptr[a.cols]
    ends = np.cumsum(counts)
    inner = np.arange(total, dtype=np.int64) - np.repeat(ends - counts,
                                                         counts)
    b_idx = np.repeat(starts, counts) + inner
    rows = np.repeat(a_rows, counts)
    cols = b.cols[b_idx].astype(np.int64)
    vals = np.repeat(a.vals, counts) * b.vals[b_idx]
    return CsrHost.from_coo(rows, cols, vals, (a.shape[0], b.shape[1]),
                            sum_duplicates=True)


def spadd(a: CsrHost, b: CsrHost, alpha: float = 1.0,
          beta: float = 1.0) -> CsrHost:
    """C = alpha·A + beta·B (KokkosSparse_spadd analogue)."""
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} + {b.shape}")
    ra = np.repeat(np.arange(a.shape[0], dtype=np.int64), a.row_lengths())
    rb = np.repeat(np.arange(b.shape[0], dtype=np.int64), b.row_lengths())
    rows = np.concatenate([ra, rb])
    cols = np.concatenate([a.cols.astype(np.int64), b.cols.astype(np.int64)])
    vals = np.concatenate([alpha * a.vals, beta * b.vals])
    return CsrHost.from_coo(rows, cols, vals, a.shape, sum_duplicates=True)


def ptap(a: CsrHost, p: CsrHost) -> CsrHost:
    """Galerkin triple product Pᵀ A P (the AMG coarse operator;
    TpetraExt_TripleMatrixMultiply R=Pᵀ case)."""
    return spgemm(spgemm(p.transpose(), a), p)


def rap(r: CsrHost, a: CsrHost, p: CsrHost) -> CsrHost:
    """General triple product R A P."""
    return spgemm(spgemm(r, a), p)


def diag_matrix(d: np.ndarray) -> CsrHost:
    n = len(d)
    idx = np.arange(n, dtype=np.int64)
    return CsrHost.from_coo(idx, idx, np.asarray(d), (n, n),
                            sum_duplicates=False)
