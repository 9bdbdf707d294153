"""Distributed sparse setup algebra: SpGEMM, transpose, RAP, AMG setup
over row-sharded blocks — never assembling a global matrix.

JAX counterpart of the reference's distributed matrix-matrix layer:
  * ``spgemm_blocks``    ≈ TpetraExt::MatrixMatrix::Multiply
    (packages/tpetra/core/ext/TpetraExt_MatrixMatrix_decl.hpp:1) — import
    the B rows matching A's ghost columns, then a purely local SpGEMM;
  * ``transpose_blocks`` ≈ Tpetra::RowMatrixTransposer
    (src/Tpetra_RowMatrixTransposer_decl.hpp) — local transpose then an
    Export-ADD of rows to their owners;
  * ``rap_blocks``       ≈ TpetraExt::TripleMatrixMultiply
    (core/ext/TpetraExt_TripleMatrixMultiply_decl.hpp:1);
  * ``build_dist_hierarchy`` ≈ MueLu::Hierarchy::Setup run DISTRIBUTED
    (muelu/src/MueCentral/MueLu_Hierarchy_decl.hpp:103): per-shard
    UNCOUPLED aggregation (MueLu's default UncoupledAggregationFactory —
    aggregates never cross rank boundaries), smoothed P via distributed
    SpGEMM, Galerkin A_c via local PᵀAP contributions + row Export-ADD.

Representation: a distributed host matrix is ``(blocks, rmap)`` where
``blocks[s]`` is a CsrHost of shard s's owned rows with GLOBAL column
indices — the host-side mirror of Tpetra's row-distributed CrsMatrix
(each rank holds only its rows). Per-shard memory is O(nnz/P + ghosts);
the only cross-shard data movement is explicit in ``import_rows`` /
``export_add_rows``, exactly where the reference's Import/Export plans
sit, so the same code maps to a real multi-host exchange.
"""
from __future__ import annotations

import numpy as np

from ..ops.formats import CsrHost
from ..ops.matrix_ops import spgemm
from .map import Map


def split_rows(a: CsrHost, rmap: Map) -> list[CsrHost]:
    """Global CSR → per-shard row blocks (global columns). Test/bootstrap
    helper — the distributed flow receives blocks already sharded."""
    blocks = []
    for s in range(rmap.n_shards):
        lo, hi = rmap.shard_lo(s), rmap.shard_hi(s)
        blocks.append(CsrHost(a.row_ptr[lo:hi + 1] - a.row_ptr[lo],
                              a.cols[a.row_ptr[lo]:a.row_ptr[hi]],
                              a.vals[a.row_ptr[lo]:a.row_ptr[hi]],
                              (hi - lo, a.shape[1])))
    return blocks


def concat_rows(blocks: list[CsrHost], n_cols: int | None = None) -> CsrHost:
    """Per-shard row blocks → one global CSR (test oracle only)."""
    n_cols = n_cols if n_cols is not None else blocks[0].shape[1]
    row_ptr = [np.zeros(1, np.int64)]
    off = 0
    for b in blocks:
        row_ptr.append(b.row_ptr[1:] + off)
        off += b.row_ptr[-1]
    return CsrHost(np.concatenate(row_ptr),
                   np.concatenate([b.cols for b in blocks]),
                   np.concatenate([b.vals for b in blocks]),
                   (sum(b.shape[0] for b in blocks), n_cols))


def import_rows(blocks: list[CsrHost], rmap: Map,
                gids: np.ndarray) -> CsrHost:
    """Gather the rows ``gids`` (global, any order) from their owning
    shards into one CsrHost (global columns) — the Import of matrix rows
    (DistObject doImport with the packCrsMatrix row wire format,
    src/Tpetra_Details_packCrsMatrix_decl.hpp:59-66). Host-side the
    "message" is a row slice; the grouping by owner below is the exact
    send/recv partition a Distributor plan would carry."""
    gids = np.asarray(gids, dtype=np.int64)
    owners = rmap.owner_of(gids)
    out_lens = np.zeros(len(gids), dtype=np.int64)
    chunks = {}
    for s in np.unique(owners):
        sel = np.nonzero(owners == s)[0]
        blk = blocks[int(s)]
        lids = gids[sel] - rmap.shard_lo(int(s))
        lens = blk.row_ptr[lids + 1] - blk.row_ptr[lids]
        out_lens[sel] = lens
        # slice each requested row (vectorized gather of CSR segments)
        starts = blk.row_ptr[lids]
        total = int(lens.sum())
        idx = (np.repeat(starts, lens)
               + np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens))
        chunks[int(s)] = (sel, blk.cols[idx].astype(np.int64),
                          blk.vals[idx], lens)
    # reassemble in request order
    row_ptr = np.zeros(len(gids) + 1, dtype=np.int64)
    row_ptr[1:] = np.cumsum(out_lens)
    cols = np.zeros(int(out_lens.sum()), dtype=np.int64)
    vals = np.zeros(int(out_lens.sum()),
                    dtype=blocks[0].vals.dtype)
    for s, (sel, ccols, cvals, lens) in chunks.items():
        pos = (np.repeat(row_ptr[sel], lens)
               + np.arange(int(lens.sum()))
               - np.repeat(np.cumsum(lens) - lens, lens))
        cols[pos] = ccols
        vals[pos] = cvals
    ncols = blocks[0].shape[1]
    return CsrHost(row_ptr, cols, vals, (len(gids), ncols))


def spgemm_blocks(a_blocks: list[CsrHost], a_rmap: Map,
                  b_blocks: list[CsrHost], b_rmap: Map) -> list[CsrHost]:
    """Distributed C = A·B over row-sharded blocks (A rows sharded by
    ``a_rmap``; B rows sharded by ``b_rmap`` over A's column space).

    Per shard: ONE ghost-row import of B (the rows matching A_s's
    non-owned columns — the Import TpetraExt::MatrixMatrix builds from
    A's column map), then a local SpGEMM on the compacted
    [owned B rows | ghost B rows] stack. Returns C row-sharded by
    ``a_rmap`` with B's global columns."""
    n_cols_b = b_blocks[0].shape[1]
    out = []
    for s in range(a_rmap.n_shards):
        a_s = a_blocks[s]
        lo, hi = b_rmap.shard_lo(s), b_rmap.shard_hi(s)
        needed = np.unique(a_s.cols.astype(np.int64))
        ghost = needed[(needed < lo) | (needed >= hi)]
        b_own = b_blocks[s]
        if len(ghost):
            b_ghost = import_rows(b_blocks, b_rmap, ghost)
            stack_ptr = np.concatenate(
                [b_own.row_ptr, b_ghost.row_ptr[1:] + b_own.row_ptr[-1]])
            stack = CsrHost(stack_ptr,
                            np.concatenate([b_own.cols, b_ghost.cols]),
                            np.concatenate([b_own.vals, b_ghost.vals]),
                            (b_own.shape[0] + len(ghost), n_cols_b))
        else:
            stack = CsrHost(b_own.row_ptr, b_own.cols, b_own.vals,
                            (b_own.shape[0], n_cols_b))
        # remap A_s columns onto the compact stack: owned -> local row,
        # ghost gid -> n_owned + position in the sorted ghost list
        a_cols = a_s.cols.astype(np.int64)
        owned = (a_cols >= lo) & (a_cols < hi)
        new_cols = np.empty_like(a_cols)
        new_cols[owned] = a_cols[owned] - lo
        if len(ghost):
            new_cols[~owned] = (b_own.shape[0]
                                + np.searchsorted(ghost, a_cols[~owned]))
        a_local = CsrHost(a_s.row_ptr, new_cols, a_s.vals,
                          (a_s.shape[0], stack.shape[0]))
        out.append(spgemm(a_local, stack))
    return out


def export_add_rows(contrib_blocks: list[CsrHost],
                    target_rmap: Map) -> list[CsrHost]:
    """Export-ADD: each shard holds CONTRIBUTION rows in the full global
    row space (``contrib_blocks[s]`` shape (n_global_target, n_cols));
    rows are shipped to their owners and summed — the CombineMode::ADD
    doExport of overlapping assembly (src/Tpetra_CombineMode.hpp:59,
    DistObject::doExport). Returns owner-sharded blocks (local rows)."""
    out = []
    for t in range(target_rmap.n_shards):
        lo, hi = target_rmap.shard_lo(t), target_rmap.shard_hi(t)
        rows_parts, cols_parts, vals_parts = [], [], []
        for s in range(target_rmap.n_shards):
            c = contrib_blocks[s]
            r0, r1 = c.row_ptr[lo], c.row_ptr[hi]
            if r1 == r0:
                continue
            rows = (np.repeat(np.arange(lo, hi, dtype=np.int64),
                              np.diff(c.row_ptr[lo:hi + 1])) - lo)
            rows_parts.append(rows)
            cols_parts.append(c.cols[r0:r1].astype(np.int64))
            vals_parts.append(c.vals[r0:r1])
        if rows_parts:
            out.append(CsrHost.from_coo(
                np.concatenate(rows_parts), np.concatenate(cols_parts),
                np.concatenate(vals_parts),
                (hi - lo, contrib_blocks[0].shape[1]),
                sum_duplicates=True))
        else:
            out.append(CsrHost.from_coo(
                np.zeros(0, np.int64), np.zeros(0, np.int64),
                np.zeros(0, contrib_blocks[0].vals.dtype),
                (hi - lo, contrib_blocks[0].shape[1])))
    return out


def transpose_blocks(blocks: list[CsrHost], rmap: Map,
                     col_map: Map) -> list[CsrHost]:
    """Distributed transpose: per-shard local transpose into the global
    transposed row space, then Export-ADD to the owners of the
    transposed rows (= original columns) — RowMatrixTransposer
    (src/Tpetra_RowMatrixTransposer_decl.hpp). Result is row-sharded by
    ``col_map`` with columns in ``rmap``'s global space."""
    contribs = []
    for s in range(rmap.n_shards):
        blk = blocks[s]
        lo = rmap.shard_lo(s)
        rows = np.repeat(np.arange(blk.shape[0], dtype=np.int64),
                         blk.row_lengths()) + lo
        contribs.append(CsrHost.from_coo(
            blk.cols.astype(np.int64), rows, blk.vals,
            (col_map.n_global, rmap.n_global), sum_duplicates=False))
    return export_add_rows(contribs, col_map)


def rap_blocks(a_blocks: list[CsrHost], rmap: Map,
               p_blocks: list[CsrHost], cmap: Map) -> list[CsrHost]:
    """Distributed Galerkin product A_c = Pᵀ A P
    (TpetraExt::TripleMatrixMultiply, core/ext/
    TpetraExt_TripleMatrixMultiply_decl.hpp:1). One distributed SpGEMM
    (A·P — P is row-sharded by the FINE map, ghost-row import over it),
    then each shard forms its LOCAL contribution Pᵀ_s·(AP)_s and
    Export-ADDs coarse rows to their owners. Returns A_c row-sharded by
    ``cmap``."""
    ap = spgemm_blocks(a_blocks, rmap, p_blocks, rmap)
    contribs = []
    for s in range(rmap.n_shards):
        p_s, ap_s = p_blocks[s], ap[s]
        # local Pᵀ_s: (n_coarse_global, n_fine_local)
        rows_l = np.repeat(np.arange(p_s.shape[0], dtype=np.int64),
                           p_s.row_lengths())
        p_t = CsrHost.from_coo(p_s.cols.astype(np.int64), rows_l, p_s.vals,
                               (cmap.n_global, p_s.shape[0]),
                               sum_duplicates=False)
        contribs.append(spgemm(p_t, ap_s))
    return export_add_rows(contribs, cmap)


# ---------------------------------------------------------------------------
# distributed SA-AMG setup
# ---------------------------------------------------------------------------


def _diag_blocks(blocks: list[CsrHost], rmap: Map) -> list[np.ndarray]:
    out = []
    for s in range(rmap.n_shards):
        blk = blocks[s]
        lo = rmap.shard_lo(s)
        n = blk.shape[0]
        rows = np.repeat(np.arange(n, dtype=np.int64), blk.row_lengths())
        d = np.zeros(n, dtype=np.float64)
        on_diag = blk.cols.astype(np.int64) - lo == rows
        np.add.at(d, rows[on_diag], blk.vals[on_diag])
        out.append(d)
    return out


def _dist_matvec(blocks, rmap, x):
    """Host distributed y = A x (for the λmax power estimate): per-shard
    ghost gather of x then local product — one halo exchange per apply."""
    y = np.zeros(rmap.n_global, dtype=np.float64)
    for s in range(rmap.n_shards):
        blk = blocks[s]
        lo, hi = rmap.shard_lo(s), rmap.shard_hi(s)
        rows = np.repeat(np.arange(blk.shape[0], dtype=np.int64),
                         blk.row_lengths())
        np.add.at(y, rows + lo, blk.vals * x[blk.cols.astype(np.int64)])
    return y


def _local_diag_block(blk: CsrHost, lo: int, hi: int) -> CsrHost:
    """Shard's diagonal block (owned rows × owned cols, local indices) —
    the LocalFilter view (Ifpack2_LocalFilter_decl.hpp) the uncoupled
    aggregation runs on."""
    rows = np.repeat(np.arange(blk.shape[0], dtype=np.int64),
                     blk.row_lengths())
    cols = blk.cols.astype(np.int64)
    keep = (cols >= lo) & (cols < hi)
    return CsrHost.from_coo(rows[keep], cols[keep] - lo, blk.vals[keep],
                            (blk.shape[0], blk.shape[0]),
                            sum_duplicates=False)


def build_dist_hierarchy(blocks: list[CsrHost], rmap: Map, *,
                         max_levels: int = 10, coarse_max: int = 64,
                         min_agg: int = 2, damping: float = 4.0 / 3.0):
    """Distributed SA-AMG setup over row-sharded blocks: returns
    (levels, coarse_blocks, coarse_map) where each level is
    (a_blocks, a_map, p_blocks, c_map, dinv_blocks).

    Per level:
      1. UNCOUPLED aggregation: each shard aggregates its own diagonal
         block (MueLu's default — aggregates never cross ranks), so the
         coarse map is the concatenation of per-shard aggregate counts;
      2. tentative P (column-normalized piecewise constants) is purely
         local;
      3. smoothed P = P_t − ω D⁻¹A·P_t: ONE distributed SpGEMM
         (ghost-row import of P_t) + local row-scaled subtraction; ω from
         a distributed power estimate of λmax(D⁻¹A) (one halo exchange
         per power step);
      4. A_c = PᵀAP via ``rap_blocks`` (one more distributed SpGEMM +
         Export-ADD of coarse rows).
    Per-shard peak memory is O(nnz/P + ghost rows) at every step — no
    global matrix is ever formed."""
    from ..ops.matrix_ops import spadd

    levels = []
    a_blocks, a_map = blocks, rmap
    for _ in range(max_levels - 1):
        if a_map.n_global <= coarse_max:
            break
        # 1. per-shard uncoupled aggregation on the diagonal block
        from ..precond.amg import aggregate

        aggs, counts = [], []
        for s in range(a_map.n_shards):
            lo, hi = a_map.shard_lo(s), a_map.shard_hi(s)
            if hi == lo:
                aggs.append(np.zeros(0, np.int64))
                counts.append(0)
                continue
            local = _local_diag_block(a_blocks[s], lo, hi)
            agg = aggregate(local, min_agg)
            aggs.append(agg)
            counts.append(int(agg.max()) + 1 if len(agg) else 0)
        n_coarse = int(sum(counts))
        if n_coarse >= a_map.n_global:  # no coarsening progress
            break
        c_map = Map.contiguous(counts)

        # 2. tentative prolongator: local rows -> shard-owned coarse cols
        p_t_blocks = []
        for s in range(a_map.n_shards):
            agg = aggs[s]
            clo = c_map.shard_lo(s)
            if len(agg) == 0:
                p_t_blocks.append(CsrHost.from_coo(
                    np.zeros(0, np.int64), np.zeros(0, np.int64),
                    np.zeros(0, a_blocks[s].vals.dtype),
                    (0, c_map.n_global)))
                continue
            sizes = np.bincount(agg)
            vals = 1.0 / np.sqrt(sizes[agg].astype(np.float64))
            p_t_blocks.append(CsrHost.from_coo(
                np.arange(len(agg), dtype=np.int64), agg + clo, vals,
                (len(agg), c_map.n_global), sum_duplicates=False))

        # 3. smoothed P = (I − ω D⁻¹A) P_t
        d_blocks = _diag_blocks(a_blocks, a_map)
        dinv_g = np.concatenate(
            [1.0 / np.where(d != 0, d, 1.0) for d in d_blocks]) \
            if a_map.n_global else np.zeros(0)
        # distributed power estimate of λmax(D⁻¹A)
        rng = np.random.default_rng(0)
        v = rng.standard_normal(a_map.n_global)
        lam = 1.0
        for _ in range(10):
            w = dinv_g * _dist_matvec(a_blocks, a_map, v)
            lam = np.linalg.norm(w)
            v = w / max(lam, 1e-30)
        omega = damping / max(lam, 1e-12)
        ap_t = spgemm_blocks(a_blocks, a_map, p_t_blocks, a_map)
        p_blocks = []
        for s in range(a_map.n_shards):
            lo = a_map.shard_lo(s)
            dinv_s = 1.0 / np.where(d_blocks[s] != 0, d_blocks[s], 1.0)
            scaled = CsrHost(
                ap_t[s].row_ptr, ap_t[s].cols,
                ap_t[s].vals * np.repeat(omega * dinv_s,
                                         ap_t[s].row_lengths()),
                ap_t[s].shape)
            p_blocks.append(spadd(p_t_blocks[s], scaled, 1.0, -1.0))

        # 4. Galerkin coarse operator (distributed RAP)
        a_c_blocks = rap_blocks(a_blocks, a_map, p_blocks, c_map)
        levels.append((a_blocks, a_map, p_blocks, c_map, d_blocks))
        a_blocks, a_map = a_c_blocks, c_map
    return levels, a_blocks, a_map
