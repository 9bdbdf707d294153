"""ILU(k) with accelerator-friendly iterative triangular solves.

JAX analogue of Ifpack2::RILUK
(packages/ifpack2/src/Ifpack2_RILUK_decl.hpp:243 — initialize builds the
level-of-fill graph via IlukGraph (Ifpack2_IlukGraph.hpp; here
``iluk_pattern``, native C++ tt_iluk), compute does the numeric factor,
apply is two triangular solves via LocalSparseTriangularSolver,
Ifpack2_LocalSparseTriangularSolver_decl.hpp:77). Fill level k > 0 uses
the classical reduction: ILU(0) numerics on the level-k-augmented
pattern ("fact: iluk level-of-fill", the reference's parameter name).

Hard-part decision (SURVEY.md §7 hard-parts #4): level-scheduled sparse
tri-solve is an accelerator anti-pattern (many tiny sequential levels), so the
apply uses **fixed-sweep Jacobi richardson iterations on the triangular
factors** — the strategy of the reference's own fine-grained-parallel
FastILU family (packages/ifpack2/src/Ifpack2_Details_FastILU_Base_decl.hpp,
backend shylu/shylu_node/fastilu). A fixed sweep count keeps the apply a
LINEAR operator (safe for CG/GMRES); sweeps ≥ nilpotency index would make
it exact.

The numeric factorization itself is the classic IKJ ILU(0) restricted to
the sparsity pattern, done on host at compute() (numpy); the factors are
packed to device formats once.
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..ops.formats import CsrHost, choose_format, round_up, ROW_ALIGN
from ..ops.matvec import spmv
from ..utils.params import Param
from .base import Preconditioner

_SPECS = {
    "fact: sweeps": Param("fact: sweeps", 6,
                          doc="Jacobi sweeps per triangular solve"),
    "fact: iluk level-of-fill": Param(
        "fact: iluk level-of-fill", 0,
        doc="ILU(k) fill level (Ifpack2::RILUK parameter): the numeric "
            "factor runs on the level-k-augmented pattern"),
    "fact: block size": Param(
        "fact: block size", 1,
        doc="b > 1 → RBILUK: block-level ILU(k) on the BSR block graph "
            "(Ifpack2::Experimental::RBILUK)"),
    "dtype": Param("dtype", None),
}


def iluk_pattern(a: CsrHost, kfill: int):
    """ILU(k) symbolic level-of-fill pattern (Ifpack2::IlukGraph,
    packages/ifpack2/src/Ifpack2_IlukGraph.hpp). Returns (row_ptr, cols)
    of the augmented pattern. Native C++ fast path (tt_iluk); the Python
    fallback is the same row-merge algorithm with a heap standing in for
    the ordered working set."""
    from ..native import iluk_native

    n = a.shape[0]
    out = iluk_native(n, a.row_ptr, a.cols, int(kfill))
    if out is not None:
        return out
    import heapq

    ABSENT = -1
    lev = np.full(n, ABSENT, dtype=np.int64)
    u_cols: list[np.ndarray] = []
    u_levs: list[np.ndarray] = []
    out_ptr = np.zeros(n + 1, np.int64)
    out_cols: list[np.ndarray] = []
    for i in range(n):
        ci = a.cols[a.row_ptr[i]:a.row_ptr[i + 1]].astype(np.int64)
        heap = list(ci)
        heapq.heapify(heap)
        lev[ci] = 0
        seen = []
        while heap:
            k = heapq.heappop(heap)
            if seen and k == seen[-1]:
                continue  # duplicate push
            seen.append(k)
            if k >= i:
                continue
            lk = lev[k]
            for j, lj in zip(u_cols[k], u_levs[k]):
                nl = lk + lj + 1
                if nl <= kfill:
                    if lev[j] == ABSENT:
                        lev[j] = nl
                        heapq.heappush(heap, int(j))
                    elif nl < lev[j]:
                        lev[j] = nl
        row = np.asarray(seen, dtype=np.int64)
        out_cols.append(row)
        out_ptr[i + 1] = out_ptr[i] + len(row)
        up = row[row > i]
        u_cols.append(up)
        u_levs.append(lev[up].copy())
        lev[row] = ABSENT
    return out_ptr, np.concatenate(out_cols) if out_cols else np.zeros(
        0, np.int64)


def _scatter_positions(rows_pat, cols_pat, a: CsrHost) -> np.ndarray:
    """Positions of A's entries inside a superset pattern (both
    row-major sorted): ONE vectorized searchsorted over the combined
    (row, col) keys — replaces a per-row Python loop on the setup
    path."""
    ncp1 = a.shape[1] + 1
    keys_pat = rows_pat * ncp1 + cols_pat.astype(np.int64)
    rows_a = np.repeat(np.arange(a.shape[0], dtype=np.int64),
                       a.row_lengths())
    keys_a = rows_a * ncp1 + a.cols.astype(np.int64)
    return np.searchsorted(keys_pat, keys_a)


def iluk_augment(a: CsrHost, kfill: int) -> CsrHost:
    """A with EXPLICIT ZEROS at the ILU(k) fill positions: ILU(0) numeric
    factorization on this pattern IS ILU(k) — the classical reduction."""
    if kfill <= 0:
        return a
    ptr, cols = iluk_pattern(a, kfill)
    n = a.shape[0]
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ptr))
    vals = np.zeros(len(cols), dtype=a.vals.dtype)
    vals[_scatter_positions(rows, cols, a)] = a.vals
    return CsrHost.from_coo(rows, cols.astype(np.int64), vals, a.shape,
                            sum_duplicates=False)


def rbiluk_augment(a: CsrHost, block_size: int, kfill: int = 0) -> CsrHost:
    """RBILUK pattern (Ifpack2::Experimental::RBILUK,
    packages/ifpack2/src/Ifpack2_Experimental_RBILUK_decl.hpp): block-
    level ILU(k) on the BSR block graph. Reduction used here: block LU
    without pivoting equals SCALAR LU on the dense-block pattern, so the
    factorization is (1) block graph of A, (2) level-k fill on the BLOCK
    graph (``iluk_pattern``), (3) expand every kept block to a dense
    b×b scalar patch (A's values where present, explicit zeros at fill),
    (4) scalar ILU(0) numerics on that pattern."""
    b = int(block_size)
    n = a.shape[0]
    if b <= 1:
        return iluk_augment(a, kfill)
    if n % b:
        raise ValueError(f"matrix order {n} not a multiple of block "
                         f"size {b}")
    nb = n // b
    rows_rep = np.repeat(np.arange(n, dtype=np.int64), a.row_lengths())
    bkey = (rows_rep // b) * nb + a.cols.astype(np.int64) // b
    bkey = np.unique(bkey)
    brows, bcols_ = bkey // nb, bkey % nb
    bptr = np.zeros(nb + 1, np.int64)
    np.add.at(bptr, brows + 1, 1)
    bptr = np.cumsum(bptr)
    bgraph = CsrHost(bptr, bcols_.astype(np.int32),
                     np.ones(len(bcols_)), (nb, nb))
    if kfill > 0:
        bptr, bcols_ = iluk_pattern(bgraph, kfill)
        bcols_ = bcols_.astype(np.int64)
    # expand each block to a dense b×b scalar patch
    nblk = len(bcols_)
    blk_rows = np.repeat(np.repeat(np.arange(nb), np.diff(bptr)), b * b)
    blk_cols = np.repeat(bcols_, b * b)
    ii = np.tile(np.repeat(np.arange(b), b), nblk)
    jj = np.tile(np.tile(np.arange(b), b), nblk)
    rows_s = blk_rows * b + ii
    cols_s = blk_cols * b + jj
    pattern = CsrHost.from_coo(rows_s, cols_s,
                               np.zeros(len(rows_s), dtype=a.vals.dtype),
                               a.shape, sum_duplicates=False)
    vals = pattern.vals.copy()
    rows_pat = np.repeat(np.arange(n, dtype=np.int64),
                         np.diff(pattern.row_ptr))
    vals[_scatter_positions(rows_pat, pattern.cols, a)] = a.vals
    return CsrHost(pattern.row_ptr, pattern.cols, vals, a.shape)


def ilu0_factor(a: CsrHost) -> tuple[CsrHost, CsrHost]:
    """Classic IKJ ILU(0): returns (L unit-lower incl. diag=1, U upper).

    Fast path: the native C++ kernel (trilinos_tpu.native.ilu0_native);
    pure-Python fallback below."""
    from ..native import ilu0_native

    n = a.shape[0]
    # the native kernel requires column-sorted rows (CsrHost.from_coo
    # guarantees this; verify cheaply before trusting it)
    rows_rep_chk = np.repeat(np.arange(n), a.row_lengths())
    keys = rows_rep_chk.astype(np.int64) * (a.shape[1] + 1) + a.cols
    sorted_ok = bool(np.all(np.diff(keys) > 0)) if len(keys) else True
    fv = ilu0_native(n, a.row_ptr, a.cols, a.vals) if sorted_ok else None
    if fv is not None:
        rows_rep = np.repeat(np.arange(n), a.row_lengths())
        lower = a.cols < rows_rep
        upper = ~lower
        diag_rows = np.arange(n)
        l_m = CsrHost.from_coo(
            np.concatenate([rows_rep[lower], diag_rows]),
            np.concatenate([a.cols[lower].astype(np.int64), diag_rows]),
            np.concatenate([fv[lower], np.ones(n)]), a.shape,
            sum_duplicates=False)
        u_m = CsrHost.from_coo(rows_rep[upper],
                               a.cols[upper].astype(np.int64), fv[upper],
                               a.shape, sum_duplicates=False)
        return l_m, u_m
    # copy values into a row-indexed dict-of-rows for the sequential sweep
    row_cols = []
    row_vals = []
    for i in range(n):
        c, v = a.row(i)
        order = np.argsort(c)
        row_cols.append(c[order].astype(np.int64))
        row_vals.append(v[order].astype(np.float64).copy())
    col_pos = [dict(zip(rc.tolist(), range(len(rc)))) for rc in row_cols]
    for i in range(n):
        ci, vi = row_cols[i], row_vals[i]
        for kk in range(len(ci)):
            k = ci[kk]
            if k >= i:
                break
            ukk_pos = col_pos[k].get(k)
            if ukk_pos is None:
                continue
            ukk = row_vals[k][ukk_pos]
            if ukk == 0:
                continue
            vi[kk] = lik = vi[kk] / ukk
            # update row i against row k's upper part, pattern-restricted
            ck, vk = row_cols[k], row_vals[k]
            for jj in range(ukk_pos + 1, len(ck)):
                pos = col_pos[i].get(ck[jj])
                if pos is not None:
                    vi[pos] -= lik * vk[jj]
    # split into L (strict lower + unit diag) and U (diag + upper)
    lr, lc, lv, ur, uc, uv = [], [], [], [], [], []
    for i in range(n):
        ci, vi = row_cols[i], row_vals[i]
        lower = ci < i
        upper = ci >= i
        lr.append(np.full(lower.sum() + 1, i))
        lc.append(np.concatenate([ci[lower], [i]]))
        lv.append(np.concatenate([vi[lower], [1.0]]))
        ur.append(np.full(upper.sum(), i))
        uc.append(ci[upper])
        uv.append(vi[upper])
    l_m = CsrHost.from_coo(np.concatenate(lr), np.concatenate(lc),
                           np.concatenate(lv), a.shape, sum_duplicates=False)
    u_m = CsrHost.from_coo(np.concatenate(ur), np.concatenate(uc),
                           np.concatenate(uv), a.shape, sum_duplicates=False)
    return l_m, u_m


class Ilu0(Preconditioner):
    def _do_initialize(self) -> None:
        self.params.validate(_SPECS)
        if not isinstance(self.a, CsrHost):
            raise TypeError("Ilu0 expects a CsrHost matrix")

    def _do_compute(self) -> None:
        dtype = self.params["dtype"] or self.a.vals.dtype
        sweeps = int(self.params["fact: sweeps"])
        lof = int(self.params["fact: iluk level-of-fill"])
        bs = int(self.params["fact: block size"])
        aug = (rbiluk_augment(self.a, bs, lof) if bs > 1
               else iluk_augment(self.a, lof))
        l_m, u_m = ilu0_factor(aug)
        n = self.a.shape[0]
        npad = round_up(n, ROW_ALIGN)
        self._l = choose_format(l_m, dtype=dtype)
        self._u = choose_format(u_m, dtype=dtype)
        du = u_m.diagonal().astype(np.float64)
        dinv = np.ones(npad)
        dinv[:n] = 1.0 / np.where(du != 0, du, 1.0)
        self._udinv = jnp.asarray(dinv, dtype=dtype)
        self.sweeps = sweeps

    def _apply(self, r: jax.Array) -> jax.Array:
        """x = U⁻¹ L⁻¹ r via fixed-sweep Jacobi on each factor."""
        udinv = self._udinv if r.ndim == 1 else self._udinv[:, None]
        # L y = r, L unit-diagonal: y ← r − (L − I) y
        y = r
        for _ in range(self.sweeps):
            y = r - (spmv(self._l, y) - y)
        # U x = y: x ← D_U⁻¹ (y − (U − D_U) x)
        x = udinv * y
        for _ in range(self.sweeps):
            x = x + udinv * (y - spmv(self._u, x))
        return x
