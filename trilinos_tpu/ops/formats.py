"""Local (single-device) sparse-matrix storage.

This is the accelerator-first answer to the reference's node-level CSR container
(``KokkosSparse::CrsMatrix``, packages/kokkos-kernels/src/sparse/
KokkosSparse_CrsMatrix.hpp) and BSR container. XLA needs **static shapes**,
so instead of one dynamic CSR we keep:

  * ``CsrHost``  — numpy CSR on host: the assembly / factorization substrate
    (plays the role of Tpetra's host-side fill state before fillComplete,
    packages/tpetra/core/src/Tpetra_CrsMatrix_def.hpp:4437).
  * ``EllMatrix`` — padded ELLPACK on device: ``cols/vals`` of shape
    ``(n_rows_pad, k)``; SpMV is one gather + multiply + row reduction,
    which XLA fuses into a single bandwidth-bound pass.
  * ``DiaMatrix`` — diagonal-offset (stencil) storage: for Galeri-style
    banded operators SpMV becomes a handful of vector shifts — no gather
    at all, the speed-of-light format.
  * ``BsrMatrix`` — block-ELL (constant block size): gathered block panels
    feed batched ``b×b`` matmuls. Analogue of
    ``Tpetra::BlockCrsMatrix`` (src/Tpetra_BlockCrsMatrix_decl.hpp:53).

Padding convention (load-bearing, used framework-wide):
  rows added to reach the padded row count are **identity rows**, and the
  matching vector entries are **zero**. Then SpMV maps zero padding to zero
  padding, residuals vanish on the padding, and Jacobi/ILU diagonals stay
  invertible.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

import jax
import jax.numpy as jnp

ROW_ALIGN = 8  # f32 sublane count; all padded row counts are multiples


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------------------
# Host CSR (assembly substrate)
# ---------------------------------------------------------------------------


class CsrHost:
    """Numpy CSR with duplicate-summing construction from COO.

    Construction mirrors the reference's insert → sortAndMerge →
    fillComplete pipeline (Tpetra_CrsMatrix_def.hpp:4573) collapsed into
    one host-side step: stencil/IO produce COO, we sort, merge duplicates
    (ADD combine, cf. Tpetra_CombineMode.hpp:59), and build row_ptr.
    """

    def __init__(self, row_ptr: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                 shape: tuple[int, int]):
        self.row_ptr = np.asarray(row_ptr, dtype=np.int64)
        self.cols = np.asarray(cols, dtype=np.int32)
        self.vals = np.asarray(vals)
        self.shape = shape
        assert self.row_ptr.shape == (shape[0] + 1,)

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_coo(cls, rows, cols, vals, shape, sum_duplicates=True) -> "CsrHost":
        # ONE stable sort on the fused (row, col) key; duplicates are then
        # ADJACENT, so dedup is a linear not-equal scan + add.reduceat —
        # the profiled round-5 hot path of ALL host setup (the old
        # lexsort + np.unique sorted twice and np.add.at scattered
        # element-at-a-time: 2.4x slower on the 64³ AMG hierarchy build)
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals)
        key = rows * np.int64(shape[1]) + cols
        if len(key) and np.all(key[1:] >= key[:-1]):
            pass  # already row-major sorted (from_dense, pattern scans)
        else:
            order = np.argsort(key, kind="stable")
            key, vals = key[order], vals[order]
        if sum_duplicates and len(key):
            newseg = np.empty(len(key), dtype=bool)
            newseg[0] = True
            np.not_equal(key[1:], key[:-1], out=newseg[1:])
            starts = np.flatnonzero(newseg)
            key = key[starts]
            vals = np.add.reduceat(vals, starts)
        rows = key // shape[1]
        cols = key % shape[1]
        counts = np.bincount(rows, minlength=shape[0])
        row_ptr = np.zeros(shape[0] + 1, dtype=np.int64)
        np.cumsum(counts, out=row_ptr[1:])
        return cls(row_ptr, cols.astype(np.int32), vals, shape)

    @classmethod
    def from_dense(cls, a: np.ndarray, tol: float = 0.0) -> "CsrHost":
        a = np.asarray(a)
        rows, cols = np.nonzero(np.abs(a) > tol)
        return cls.from_coo(rows, cols, a[rows, cols], a.shape)

    @classmethod
    def from_scipy(cls, a) -> "CsrHost":
        a = a.tocsr()
        a.sum_duplicates()
        return cls(a.indptr.astype(np.int64), a.indices.astype(np.int32),
                   a.data, a.shape)

    @classmethod
    def eye(cls, n: int, dtype=np.float64) -> "CsrHost":
        idx = np.arange(n)
        return cls(np.arange(n + 1), idx.astype(np.int32),
                   np.ones(n, dtype=dtype), (n, n))

    # -- basic queries -----------------------------------------------------
    @property
    def nnz(self) -> int:
        return len(self.cols)

    @property
    def dtype(self):
        return self.vals.dtype

    def row_lengths(self) -> np.ndarray:
        return np.diff(self.row_ptr)

    def max_row_length(self) -> int:
        return int(self.row_lengths().max(initial=0))

    def row(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        s, e = self.row_ptr[i], self.row_ptr[i + 1]
        return self.cols[s:e], self.vals[s:e]

    def diagonal(self) -> np.ndarray:
        d = np.zeros(min(self.shape), dtype=self.vals.dtype)
        rows = np.repeat(np.arange(self.shape[0], dtype=np.int64),
                         self.row_lengths())
        hit = (self.cols == rows) & (rows < min(self.shape))
        # first matching entry per row wins (rows are col-sorted, so a
        # duplicate-free matrix has at most one); reversed write order
        # keeps "first wins" under np-style last-write semantics
        idx = np.flatnonzero(hit)[::-1]
        d[rows[idx]] = self.vals[idx]
        return d

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=self.vals.dtype)
        for i in range(self.shape[0]):
            c, v = self.row(i)
            out[i, c] += v
        return out

    def matvec_host(self, x: np.ndarray) -> np.ndarray:
        """Host-side y = A x (setup/verification paths, not the hot op)."""
        rows = np.repeat(np.arange(self.shape[0]), self.row_lengths())
        y = np.zeros(self.shape[0],
                     dtype=np.result_type(self.vals, np.asarray(x)))
        np.add.at(y, rows, self.vals * np.asarray(x)[self.cols])
        return y

    def submatrix(self, row_ids: np.ndarray,
                  col_ids: np.ndarray) -> "CsrHost":
        """A[row_ids][:, col_ids] (host setup op, e.g. boundary-dof
        condensation)."""
        row_ids = np.asarray(row_ids)
        col_ids = np.asarray(col_ids)
        col_pos = np.full(self.shape[1], -1, dtype=np.int64)
        col_pos[col_ids] = np.arange(len(col_ids))
        rows_full = np.repeat(np.arange(self.shape[0]), self.row_lengths())
        row_pos = np.full(self.shape[0], -1, dtype=np.int64)
        row_pos[row_ids] = np.arange(len(row_ids))
        keep = (row_pos[rows_full] >= 0) & (col_pos[self.cols] >= 0)
        return CsrHost.from_coo(row_pos[rows_full[keep]],
                                col_pos[self.cols[keep]],
                                self.vals[keep],
                                (len(row_ids), len(col_ids)))

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.csr_matrix((self.vals, self.cols, self.row_ptr), shape=self.shape)

    def transpose(self) -> "CsrHost":
        """Explicit host transpose (analogue of Tpetra RowMatrixTransposer,
        src/Tpetra_RowMatrixTransposer_decl.hpp; local part only)."""
        m, n = self.shape
        rows = np.repeat(np.arange(m), self.row_lengths())
        return CsrHost.from_coo(self.cols.astype(np.int64), rows, self.vals, (n, m))

    def extract(self, row_sel: np.ndarray, col_renumber: np.ndarray | None = None):
        """Rows subset as COO triplets (used by overlap/Schwarz filters)."""
        rows_out, cols_out, vals_out = [], [], []
        for new_i, i in enumerate(row_sel):
            c, v = self.row(int(i))
            rows_out.append(np.full(len(c), new_i, dtype=np.int64))
            cols_out.append(c.astype(np.int64))
            vals_out.append(v)
        if rows_out:
            return (np.concatenate(rows_out), np.concatenate(cols_out),
                    np.concatenate(vals_out))
        return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                np.zeros(0, self.vals.dtype))


# ---------------------------------------------------------------------------
# Device formats (pytrees)
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class EllMatrix:
    """Padded ELLPACK: cols/vals (n_rows_pad, k); short rows padded with
    (col=0, val=0) entries. ``n_rows``/``n_cols`` are the logical sizes."""

    cols: jax.Array  # (n_rows_pad, k) int32
    vals: jax.Array  # (n_rows_pad, k) dtype
    n_rows: int = dataclasses.field(metadata=dict(static=True))
    n_cols: int = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))

    @property
    def n_rows_pad(self) -> int:
        return self.cols.shape[0]

    @property
    def k(self) -> int:
        return self.cols.shape[1]

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DiaMatrix:
    """Diagonal-offset storage: diagonal d at row i multiplies
    ``x[i + offsets[d]]``.

    Out-of-range positions hold zeros, so a cyclic shift (jnp.roll) of x is
    exact. Offsets are static → the SpMV unrolls to ``len(offsets)`` fused
    multiply-adds over shifted vectors: zero gathers.

    Layout: ``data`` is ``(n_diags, n_rows_pad)``.
    """

    data: jax.Array  # (nd, n_pad)
    offsets: tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    n_rows: int = dataclasses.field(metadata=dict(static=True))
    n_cols: int = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))

    @property
    def n_rows_pad(self) -> int:
        return self.data.shape[1]

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BsrMatrix:
    """Block-ELL (constant block size b): ``bcols`` (nbr, kb) indexes block
    columns; ``bvals`` (nbr, kb, b, b) holds dense blocks. SpMM gathers x
    block panels and runs batched b×b matmuls."""

    bcols: jax.Array  # (n_brows_pad, kb) int32
    bvals: jax.Array  # (n_brows_pad, kb, b, b) dtype
    block_size: int = dataclasses.field(metadata=dict(static=True))
    n_rows: int = dataclasses.field(metadata=dict(static=True))  # scalar rows
    n_cols: int = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))  # scalar nnz

    @property
    def n_brows_pad(self) -> int:
        return self.bcols.shape[0]

    @property
    def n_rows_pad(self) -> int:
        return self.n_brows_pad * self.block_size

    @property
    def kb(self) -> int:
        return self.bcols.shape[1]

    @property
    def dtype(self):
        return self.bvals.dtype

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BdiaMatrix:
    """Block-diagonal (block-stencil) storage — the JAX-native BSR fast
    path for FEM/elasticity operators whose *block* sparsity pattern is a
    stencil (constant block-column offsets, e.g. the 9 node-neighbours of
    a Q1 quad with ``b`` dofs per node).

    Rather than gathering (b, b) blocks and running tiny matmuls, the
    scalar vector is de-interleaved into
    ``b`` residue planes ``xp[j, q] = x[q·b + j]`` and the apply becomes

        yp[i, q] += data[d, i, j, q] * xp[j, q + offsets[d]]

    — ``nd·b²`` shifted elementwise FMAs over dense planes: zero gathers,
    exact-nnz data traffic, i.e. the DiaMatrix compute shape with
    a (b × b) plane nest. Analogue of ``Tpetra::BlockCrsMatrix`` applies
    (src/Tpetra_BlockCrsMatrix_decl.hpp:53) and the block spmv of
    kokkos-kernels (sparse/impl/KokkosSparse_spmv_bsrmatrix_impl.hpp).

    ``data`` is ``(nd, b, b, NBR)``. ``offsets`` are BLOCK offsets
    (block col − block row). Out-of-range plane positions hold zeros so cyclic shifts
    are exact; padding block rows are identity blocks.
    """

    data: jax.Array  # (nd, b, b, NBR)
    offsets: tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    block_size: int = dataclasses.field(metadata=dict(static=True))
    n_rows: int = dataclasses.field(metadata=dict(static=True))
    n_cols: int = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))

    @property
    def nbr_pad(self) -> int:
        """Padded block-row count."""
        return self.data.shape[3]

    @property
    def n_rows_pad(self) -> int:
        return self.nbr_pad * self.block_size

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)


SparseMatrix = EllMatrix | DiaMatrix | BsrMatrix | BdiaMatrix


# ---------------------------------------------------------------------------
# Conversions host CSR -> device formats
# ---------------------------------------------------------------------------


def csr_to_ell(a: CsrHost, dtype=None, k: int | None = None,
               n_rows_pad: int | None = None, identity_pad_rows: bool = True,
               n_cols: int | None = None) -> EllMatrix:
    """Pack host CSR into padded ELL arrays (device).

    ``k`` defaults to max row length; rows beyond ``a.shape[0]`` (up to the
    aligned ``n_rows_pad``) become identity rows when the matrix is square.
    """
    m, n = a.shape
    if n_cols is not None:
        n = n_cols
    if k is None:
        k = max(a.max_row_length(), 1)
    if n_rows_pad is None:
        n_rows_pad = round_up(m, ROW_ALIGN)
    dtype = dtype or a.vals.dtype
    cols = np.zeros((n_rows_pad, k), dtype=np.int32)
    vals = np.zeros((n_rows_pad, k), dtype=dtype)
    lens = a.row_lengths()
    if lens.max(initial=0) > k:
        raise ValueError(f"row length {lens.max()} exceeds ELL width {k}")
    # vectorized scatter of CSR entries into the ELL grid
    rows_rep = np.repeat(np.arange(m), lens)
    pos = np.arange(a.nnz) - np.repeat(a.row_ptr[:-1], lens)
    cols[rows_rep, pos] = a.cols
    vals[rows_rep, pos] = a.vals.astype(dtype)
    if identity_pad_rows and m == n and n_rows_pad > m:
        # identity rows on the padding; entries past n_cols stay zero rows
        pad = np.arange(m, n_rows_pad)
        inb = pad < n
        cols[pad, 0] = np.where(inb, np.minimum(pad, n - 1), 0)
        vals[pad, 0] = inb.astype(dtype)
    return EllMatrix(cols=jnp.asarray(cols), vals=jnp.asarray(vals),
                     n_rows=m, n_cols=n, nnz=a.nnz)


def csr_to_dia(a: CsrHost, dtype=None, n_rows_pad: int | None = None,
               max_diags: int | None = None) -> DiaMatrix:
    """Pack host CSR into diagonal-offset storage.

    Only efficient when the number of distinct (col - row) offsets is small
    (stencil operators — the Galeri analogue emits exactly these). Raises if
    the diagonal count exceeds ``max_diags``.
    """
    m, n = a.shape
    if n_rows_pad is None:
        n_rows_pad = round_up(m, ROW_ALIGN)
    dtype = dtype or a.vals.dtype
    rows_rep = np.repeat(np.arange(m), a.row_lengths())
    offs = a.cols.astype(np.int64) - rows_rep
    uniq = np.unique(offs)
    if max_diags is not None and len(uniq) > max_diags:
        raise ValueError(f"{len(uniq)} diagonals exceeds limit {max_diags}")
    data = np.zeros((len(uniq), n_rows_pad), dtype=dtype)
    d_idx = np.searchsorted(uniq, offs)  # uniq is sorted
    data[d_idx, rows_rep] = a.vals.astype(dtype)
    offsets = tuple(int(o) for o in uniq)
    off_index = {o: i for i, o in enumerate(offsets)}
    if m == n and 0 in off_index:
        # identity padding rows (keeps Jacobi diag invertible on the pad)
        data[off_index[0], m:n_rows_pad] = 1.0
    return DiaMatrix(data=jnp.asarray(data), offsets=offsets, n_rows=m,
                     n_cols=n, nnz=a.nnz)


def pad_csr_square(a: CsrHost, multiple: int) -> CsrHost:
    """Extend a square host CSR with identity rows/cols so both dims are a
    multiple of ``multiple`` (pre-step for BSR packing)."""
    m, n = a.shape
    assert m == n, "pad_csr_square requires a square matrix"
    mp = round_up(m, multiple)
    if mp == m:
        return a
    extra = np.arange(m, mp)
    rows = np.concatenate([np.repeat(np.arange(m), a.row_lengths()), extra])
    cols = np.concatenate([a.cols.astype(np.int64), extra])
    vals = np.concatenate([a.vals, np.ones(mp - m, dtype=a.vals.dtype)])
    return CsrHost.from_coo(rows, cols, vals, (mp, mp), sum_duplicates=False)


def csr_to_bsr(a: CsrHost, block_size: int, dtype=None,
               n_brows_pad: int | None = None,
               kb: int | None = None) -> BsrMatrix:
    """Pack host CSR into block-ELL with constant block size.

    Rows/cols are grouped into ``block_size`` chunks; any scalar nonzero
    makes its whole block present (standard BSR fill-in). A square matrix
    whose dimension is not a multiple of ``block_size`` is first extended
    with identity rows/cols (``pad_csr_square``). ``kb`` forces the
    blocks-per-row width (>= the natural width) so per-shard packs stack
    into one uniform pytree (the distributed interior case).
    """
    b = block_size
    m, n = a.shape
    if m == n and m % b != 0:
        a = pad_csr_square(a, b)
        m, n = a.shape
    if m % b != 0 or n % b != 0:
        raise ValueError(f"BSR needs dims divisible by b={b}, got {a.shape}")
    mb, nb = m // b, n // b
    if n_brows_pad is None:
        n_brows_pad = round_up(mb, max(ROW_ALIGN // min(b, ROW_ALIGN), 1))
    dtype = dtype or a.vals.dtype
    rows_rep = np.repeat(np.arange(m), a.row_lengths())
    brow = rows_rep // b
    bcol = a.cols.astype(np.int64) // b
    # unique block coordinates, per block-row
    key = brow * nb + bcol
    uniq_key, inv = np.unique(key, return_inverse=True)
    ub_row = uniq_key // nb
    ub_col = uniq_key % nb
    blens = np.bincount(ub_row, minlength=mb)
    kb_nat = max(int(blens.max(initial=0)), 1)
    if kb is None:
        kb = kb_nat
    elif kb < kb_nat:
        raise ValueError(f"kb={kb} < natural block-row width {kb_nat}")
    bcols = np.zeros((n_brows_pad, kb), dtype=np.int32)
    bvals = np.zeros((n_brows_pad, kb, b, b), dtype=dtype)
    # slot of each unique block within its row
    bptr = np.zeros(mb + 1, dtype=np.int64)
    np.cumsum(blens, out=bptr[1:])
    slot_of_block = np.arange(len(uniq_key)) - bptr[ub_row]
    bcols[ub_row, slot_of_block] = ub_col
    # scatter scalar entries into their block slot
    ent_slot = slot_of_block[inv]
    bvals[brow, ent_slot, rows_rep % b, a.cols % b] = a.vals.astype(dtype)
    if m == n:
        # fully padded block rows: identity blocks (zero block if past n_cols)
        for ib in range(mb, n_brows_pad):
            bcols[ib, 0] = min(ib, nb - 1)
            if ib < nb:
                bvals[ib, 0] = np.eye(b, dtype=dtype)
    return BsrMatrix(bcols=jnp.asarray(bcols), bvals=jnp.asarray(bvals),
                     block_size=b, n_rows=m, n_cols=n, nnz=a.nnz)


def csr_to_bdia(a: CsrHost, block_size: int, dtype=None,
                nbr_pad: int | None = None,
                max_diags: int | None = None) -> BdiaMatrix:
    """Pack host CSR into block-diagonal (block-stencil) storage.

    Scalar entry (r, c) lands in plane (d, r%b, c%b) at block row r//b,
    where d indexes the block offset c//b − r//b. Efficient only when the
    number of distinct block offsets is small; raises past ``max_diags``.
    A square matrix whose dimension is not a multiple of ``block_size`` is
    first extended with identity rows/cols.
    """
    b = block_size
    m, n = a.shape
    if m == n and m % b != 0:
        a = pad_csr_square(a, b)
        m, n = a.shape
    if m % b != 0 or n % b != 0:
        raise ValueError(f"BDIA needs dims divisible by b={b}, got {a.shape}")
    mb = m // b
    if nbr_pad is None:
        nbr_pad = round_up(mb, ROW_ALIGN)
    dtype = dtype or a.vals.dtype
    rows_rep = np.repeat(np.arange(m), a.row_lengths())
    brow = rows_rep // b
    bcol = a.cols.astype(np.int64) // b
    offs = bcol - brow
    uniq = np.unique(offs)
    if max_diags is not None and len(uniq) > max_diags:
        raise ValueError(f"{len(uniq)} block offsets exceeds limit {max_diags}")
    off_index = {int(o): i for i, o in enumerate(uniq)}
    need_zero = m == n and 0 not in off_index
    nd = len(uniq) + (1 if need_zero else 0)
    if need_zero:
        uniq = np.sort(np.append(uniq, 0))
        off_index = {int(o): i for i, o in enumerate(uniq)}
    data = np.zeros((nd, b, b, nbr_pad), dtype=dtype)
    d_idx = np.searchsorted(uniq, offs)  # uniq is sorted
    data[d_idx, rows_rep % b, a.cols % b, brow] = a.vals.astype(dtype)
    if m == n:
        # identity blocks on padding block rows
        d0 = off_index[0]
        for i in range(b):
            data[d0, i, i, mb:nbr_pad] = 1.0
    return BdiaMatrix(data=jnp.asarray(data), offsets=tuple(int(o) for o in uniq),
                      block_size=b, n_rows=m, n_cols=n, nnz=a.nnz)


def choose_format(a: CsrHost, nrhs: int = 1, block_size: int | None = None,
                  dtype=None) -> SparseMatrix:
    """fillComplete-style format selection heuristic.

    * explicit ``block_size``: few distinct SCALAR diagonals → DIA
      (interleaved-vector applies need no de-interleave transpose);
      else few BLOCK offsets and dense fill → BDIA; else BSR
    * few distinct diagonals       → DIA (stencil fast path)
    * modest ELL padding blowup    → ELL
    Analogue of the reference's spmv launch-parameter heuristic
    (kokkos-kernels/src/sparse/impl/KokkosSparse_spmv_impl.hpp:221-230),
    except our decision happens once at pack time, not per launch.
    """
    from ..utils import behavior

    if block_size is not None and block_size > 1:
        b = block_size
        rows_rep = np.repeat(np.arange(a.shape[0]), a.row_lengths())
        n_sdiags = len(np.unique(a.cols.astype(np.int64) - rows_rep))
        if n_sdiags <= 32:
            return csr_to_dia(a, dtype=dtype)
        boffs = np.unique(a.cols.astype(np.int64) // b - rows_rep // b)
        stored = len(boffs) * b * b * (a.shape[0] // b + 1)
        if len(boffs) <= 32 and a.nnz >= 0.35 * stored:
            return csr_to_bdia(a, b, dtype=dtype)
        return csr_to_bsr(a, block_size, dtype=dtype)
    rows_rep = np.repeat(np.arange(a.shape[0]), a.row_lengths())
    n_diags = len(np.unique(a.cols.astype(np.int64) - rows_rep))
    avg_len = a.nnz / max(a.shape[0], 1)
    if n_diags <= max(32, 2 * avg_len):
        return csr_to_dia(a, dtype=dtype)
    k = a.max_row_length()
    pad_ratio = k * a.shape[0] / max(a.nnz, 1)
    if pad_ratio <= behavior.ell_pad_limit():
        return csr_to_ell(a, dtype=dtype)
    # fallback: ELL anyway (row-binned CSR lands in a later milestone)
    return csr_to_ell(a, dtype=dtype)


def to_dense(m: SparseMatrix) -> np.ndarray:
    """Debug helper: materialize the logical (unpadded) dense matrix."""
    if isinstance(m, EllMatrix):
        out = np.zeros((m.n_rows, m.n_cols), dtype=m.dtype)
        cols = np.asarray(m.cols)[: m.n_rows]
        vals = np.asarray(m.vals)[: m.n_rows]
        for i in range(m.n_rows):
            np.add.at(out[i], cols[i], vals[i])
        return out
    if isinstance(m, DiaMatrix):
        out = np.zeros((m.n_rows, m.n_cols), dtype=m.dtype)
        data = np.asarray(m.data)
        for d, off in enumerate(m.offsets):
            for i in range(m.n_rows):
                j = i + off
                if 0 <= j < m.n_cols:
                    out[i, j] += data[d, i]
        return out
    if isinstance(m, BsrMatrix):
        b = m.block_size
        nb = -(-m.n_cols // b)
        out = np.zeros((m.n_brows_pad * b, nb * b), dtype=m.dtype)
        bcols = np.asarray(m.bcols)
        bvals = np.asarray(m.bvals)
        for ib in range(m.n_brows_pad):
            for s in range(m.kb):
                jb = bcols[ib, s]
                out[ib * b:(ib + 1) * b, jb * b:(jb + 1) * b] += bvals[ib, s]
        return out[: m.n_rows, : m.n_cols]
    if isinstance(m, BdiaMatrix):
        b = m.block_size
        out = np.zeros((m.n_rows, m.n_cols), dtype=m.dtype)
        data = np.asarray(m.data)
        for d, off in enumerate(m.offsets):
            for i in range(b):
                for j in range(b):
                    for q in range(m.n_rows // b):
                        r, c = q * b + i, (q + off) * b + j
                        if 0 <= r < m.n_rows and 0 <= c < m.n_cols:
                            out[r, c] += data[d, i, j, q]
        return out
    raise TypeError(type(m))
