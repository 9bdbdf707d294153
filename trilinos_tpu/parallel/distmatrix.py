"""Distributed sparse matrices: row-sharded storage + compiled halo exchange.

This module is the JAX-native fusion of the reference's
Import/Export + Distributor + CrsMatrix::apply machinery:

  * plan construction  ≈ ``Tpetra::Import`` setupSamePermuteRemote/
    setupExport (src/Tpetra_Import_decl.hpp:468,499) and
    ``Distributor::createFromRecvs`` (src/Tpetra_Distributor.hpp:349) —
    done ONCE on host at ``distribute()`` (the fillComplete moment,
    src/Tpetra_CrsMatrix_def.hpp:4437), then frozen into the jitted step;
  * the ghost/column ordering rule follows the reference
    (src/Tpetra_Details_makeColMap_def.hpp:136-198): owned columns first in
    domain order, then remote GIDs grouped by owning shard, sorted within —
    this is what makes recv buffers contiguous per neighbor;
  * the exchange itself lowers to ``lax.all_to_all`` (general neighbor
    sets) or a short sequence of ``lax.ppermute`` steps (banded neighbor
    sets — the common stencil case), the compiled-collective form of the
    Distributor's "fast path: contiguous per-neighbor slices"
    (src/Tpetra_Distributor.hpp:2302-2380);
  * apply splits the local matrix into an **interior** part (owned columns
    only — the big bandwidth-bound SpMV) and a compact **boundary** part
    (rows touching ghosts). The exchange and the interior SpMV are
    data-independent, so XLA's latency-hiding scheduler overlaps them —
    the overlap the reference structurally supports via split
    doPosts/doWaits but does not exploit inside apply
    (SURVEY.md §3.3; Tpetra_CrsMatrix_def.hpp:4887-4903).

SPMD packaging: per-shard plan/matrix arrays are stacked with a leading
shard axis; ``shard_map`` with in_spec P('rows') hands each shard its own
slice, which ``unstack_local`` squeezes back into ordinary pytrees.
"""
from __future__ import annotations

import dataclasses

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.blas import HI
from ..ops.formats import (BsrMatrix, CsrHost, DiaMatrix, EllMatrix,
                           ROW_ALIGN, csr_to_dia, csr_to_ell, round_up)
from ..ops.matvec import spmv
from .map import Map


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """Frozen exchange schedule (per-shard arrays; stacked across shards).

    send_idx:  (P, seg) — local padded indices to ship to each peer
               (destination-major, gid-sorted within a destination)
    send_valid:(P, seg) bool — False on pad slots of send_idx
    recv_sel:  (g_pad,) — for each ghost slot, its position in the flat
               receive buffer (mode-dependent layout)
    ghost_valid:(g_pad,) bool — False on pad ghost slots
    mode: 'a2a' (all_to_all over the full peer axis) or 'ppermute'
          (one permute per static shard offset in ``offsets``)
    """

    send_idx: jax.Array
    send_valid: jax.Array
    recv_sel: jax.Array
    ghost_valid: jax.Array
    n_ghost_pad: int = dataclasses.field(metadata=dict(static=True))
    seg: int = dataclasses.field(metadata=dict(static=True))
    mode: str = dataclasses.field(metadata=dict(static=True))
    offsets: tuple[int, ...] = dataclasses.field(metadata=dict(static=True))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BoundaryPart:
    """Compact ELL over only the rows that reference ghosts; ``cols``
    index into the extended vector [x_local | ghosts]."""

    rows_idx: jax.Array  # (nb_pad,) int32 (pad rows -> 0, vals are 0)
    cols: jax.Array  # (nb_pad, kb) int32
    vals: jax.Array  # (nb_pad, kb)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DistMatrix:
    interior: DiaMatrix | EllMatrix | BsrMatrix
    boundary: BoundaryPart
    plan: HaloPlan
    row_map: Map = dataclasses.field(metadata=dict(static=True))
    # rectangular operators (P/R in AMG hierarchies): domain space map
    col_map: Map | None = dataclasses.field(metadata=dict(static=True),
                                            default=None)

    @property
    def domain_map(self) -> Map:
        return self.col_map or self.row_map


def stack_shards(trees):
    """Stack a list of per-shard pytrees along a new leading shard axis."""
    return jax.tree_util.tree_map(lambda *ls: jnp.stack(ls), *trees)


def unstack_local(tree):
    """Inside shard_map: squeeze the (length-1) leading shard axis."""
    return jax.tree_util.tree_map(lambda l: l[0], tree)


# ---------------------------------------------------------------------------
# plan + matrix construction (host, fillComplete-time)
# ---------------------------------------------------------------------------


def distribute_partitioned(a: CsrHost, n_shards: int, *,
                           partition="greedy", coords=None,
                           fmt: str = "auto", dtype=None):
    """Partition → renumber → distribute pipeline (the Zoltan2 +
    Import composition the reference applies before a solve,
    zoltan2/src/algorithms/partition/Zoltan2_AlgMultiJagged.hpp;
    Tpetra_DirectoryImpl_decl.hpp:311 for the resulting GID lookup).

    ``partition``: 'rcb' (needs coords (n, d)), 'greedy' (graph BFS), or a
    precomputed (n,) part array. Returns (DistMatrix, Directory): the
    matrix is distributed in the PERMUTED numbering; the Directory maps
    original row ids to (owner, lid), and its ``new_of_old`` permutation
    reorders RHS/solution vectors (x_new = x_old[perm]).
    """
    from .map import Directory
    from .partition import (partition_greedy_graph, partition_rcb,
                            partition_to_permutation, permute_csr)

    if isinstance(partition, str):
        if partition == "rcb":
            if coords is None:
                raise ValueError("rcb partitioning needs coords (n, d)")
            part = partition_rcb(coords, n_shards)
        elif partition == "greedy":
            part = partition_greedy_graph(a, n_shards)
        else:
            raise ValueError(f"unknown partition {partition!r}")
    else:
        part = np.asarray(partition, dtype=np.int64)
    perm = partition_to_permutation(part)  # perm[new] = old
    a_p = permute_csr(a, perm)
    sizes = np.bincount(part, minlength=n_shards)
    rmap = Map.contiguous(sizes)
    dm = distribute(a_p, n_shards, fmt=fmt, dtype=dtype, rmap=rmap)
    new_of_old = np.empty(a.shape[0], dtype=np.int64)
    new_of_old[perm] = np.arange(a.shape[0])
    return dm, Directory(map=rmap, new_of_old=new_of_old)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DistStencil:
    """Matrix-free distributed stencil operator: z-slab row partition.

    The framework's fastest operator (ops.stencil.StencilOp) as a
    DistMatrix-class citizen (VERDICT round-1 missing #2): each shard owns
    nz/P whole z-planes; the halo plan ships the neighboring ``depth``
    planes; the local apply runs the single-chip stencil kernel on the
    EXTENDED slab (ghost planes at global edges stay zero, which
    reproduces the Dirichlet truncation exactly) and slices out the owned
    planes. Reference analogue: the interior/boundary overlap structure of
    Tpetra_Distributor.hpp:561,1079 (SURVEY §3.3), realized as whole-plane
    halo exchange + the matrix-free fast path.
    """

    plan: HaloPlan
    sel: jax.Array  # (n_ext,) int32 into [x_local | ghosts]
    valid: jax.Array  # (n_ext,) bool; False -> 0 (off-grid plane)
    op_local: "object" = dataclasses.field(metadata=dict(static=True))
    row_map: Map = dataclasses.field(metadata=dict(static=True))
    depth: int = dataclasses.field(metadata=dict(static=True), default=1)


def distribute_stencil(op, n_shards: int,
                       depth: int | None = None) -> DistStencil:
    """Split a global StencilOp into a DistStencil over z-slabs.

    ``depth`` (in z-planes) defaults to the stencil's z-reach; the
    communication-avoiding smoother path passes degree*reach so ONE
    exchange feeds a whole fused polynomial sweep."""
    from ..ops.stencil import StencilOp

    nx, ny, nz = op.dims
    pxy = nx * ny
    if nz % n_shards != 0:
        raise ValueError(
            f"distribute_stencil needs nz ({nz}) divisible by n_shards "
            f"({n_shards}); pad the grid or use distribute() on the "
            f"stored form")
    nzl = nz // n_shards
    npl = nzl * pxy
    if npl % ROW_ALIGN != 0:
        raise ValueError("plane size must be ROW_ALIGN-aligned")
    n = op.n_rows
    rmap = Map.uniform(n, n_shards)
    assert rmap.n_local_pad == npl
    if depth is None:
        depth = max((abs(o[2]) for o in op.offsets), default=0)
        depth = max(depth, 1)

    ghosts_of = []
    for s in range(n_shards):
        lo, hi = s * npl, (s + 1) * npl
        g_lo = np.arange(max(lo - depth * pxy, 0), lo)
        g_hi = np.arange(hi, min(hi + depth * pxy, n))
        ghosts_of.append(np.concatenate([g_lo, g_hi]))
    plans, _ = build_halo_plans(ghosts_of, rmap, n_shards)
    g_pad = plans[0].n_ghost_pad

    op_loc = StencilOp(dims=(nx, ny, nzl + 2 * depth), offsets=op.offsets,
                       coeffs=op.coeffs,
                       n_rows_pad=(nzl + 2 * depth) * pxy, dtype=op.dtype)
    n_ext = op_loc.n_rows_pad
    sels, valids = [], []
    for s in range(n_shards):
        lo, hi = s * npl, (s + 1) * npl
        g = ghosts_of[s]
        gid = np.arange(lo - depth * pxy, hi + depth * pxy)
        sel = np.zeros(n_ext, dtype=np.int32)
        valid = np.zeros(n_ext, dtype=bool)
        owned = (gid >= lo) & (gid < hi)
        sel[owned] = (gid[owned] - lo).astype(np.int32)
        ghost = (~owned) & (gid >= 0) & (gid < n)
        # ghosts_of[s] is gid-sorted (owner-major == gid order for slabs)
        sel[ghost] = (npl + np.searchsorted(g, gid[ghost])).astype(np.int32)
        valid[owned | ghost] = True
        sels.append(jnp.asarray(sel))
        valids.append(jnp.asarray(valid))

    return DistStencil(
        plan=stack_shards(plans), sel=jnp.stack(sels),
        valid=jnp.stack(valids), op_local=op_loc, row_map=rmap,
        depth=depth)


def gather_extended(ds_sel, ds_valid, plan: HaloPlan, x: jax.Array,
                    axis_name: str, n_shards: int) -> jax.Array:
    """Per-shard (inside shard_map): exchange ghosts and assemble the
    EXTENDED-slab vector — owned rows + halo planes in extended-row
    order, off-grid rows zeroed. Shared by the DistStencil apply and
    the CA paths (fused Chebyshev smoother, matrix-powers basis)."""
    ghosts = exchange(x, plan, axis_name, n_shards)
    was_1d = x.ndim == 1
    x2 = x[:, None] if was_1d else x
    g2 = ghosts[:, None] if was_1d else ghosts
    allv = jnp.concatenate([x2, g2.astype(x2.dtype)], axis=0)
    ext = jnp.where(ds_valid[:, None],
                    allv.at[ds_sel].get(mode="promise_in_bounds"), 0)
    return ext[:, 0] if was_1d else ext


def zslab_bounds(op, n_shards: int, depth: int) -> np.ndarray:
    """Per-shard valid-z-plane range [lo, hi) in EXTENDED-slab plane
    coordinates: beyond-global-boundary ghost planes must stay masked
    at every polynomial stage, while interior shard cuts read real halo
    data (the invariant shared by dist_cheb_fused and
    dist_sstep_gmres). Shape (n_shards, 2) int32."""
    nz = op.dims[2]
    nzl = nz // n_shards
    nz_ext = nzl + 2 * depth
    return np.stack([
        [max(0, depth - s * nzl),
         min(nz_ext, nz - s * nzl + depth)]
        for s in range(n_shards)]).astype(np.int32)


def apply_local_stencil(ds_sel, ds_valid, op_loc, depth, plan: HaloPlan,
                        x: jax.Array, axis_name: str,
                        n_shards: int) -> jax.Array:
    """Per-shard DistStencil apply (inside shard_map)."""
    from ..ops.matvec import spmv

    nx, ny, _ = op_loc.dims
    pxy = nx * ny
    npl = x.shape[0]
    ext = gather_extended(ds_sel, ds_valid, plan, x, axis_name, n_shards)
    y = spmv(op_loc, ext)
    y_own = y[depth * pxy: depth * pxy + npl]
    return y_own


#: cumulative count of halo-plan constructions (a cheap observability
#: hook: values-only refill paths must NOT bump this — tested)
PLAN_BUILD_COUNT = 0


def build_halo_plans(ghosts_of, omap: Map, n_shards: int):
    """Build per-shard HaloPlans for arbitrary ghost sets.

    ghosts_of[s]: owner-major gid-sorted ghost gids shard s needs; ``omap``
    owns the ghosted index space. This is the Import-construction /
    createFromRecvs handshake (src/Tpetra_Import_decl.hpp:468,499;
    src/Tpetra_Distributor.hpp:349) run once on host. Returns
    (plans, sends) — sends[s][t] = lids of shard s that shard t needs.
    """
    global PLAN_BUILD_COUNT
    PLAN_BUILD_COUNT += 1
    sends = [[np.zeros(0, np.int64) for _ in range(n_shards)]
             for _ in range(n_shards)]
    for t in range(n_shards):
        g = ghosts_of[t]
        if len(g) == 0:
            continue
        owners = omap.owner_of(g)
        for o in np.unique(owners):
            sends[int(o)][t] = omap.gid_to_lid(g[owners == o], int(o))

    seg = max((len(sends[s][t]) for s in range(n_shards)
               for t in range(n_shards)), default=0)
    seg = max(seg, 1)
    g_pad = round_up(max((len(g) for g in ghosts_of), default=0) or 1,
                     ROW_ALIGN)

    # neighbor structure: use ppermute when few static shard offsets
    all_offs = sorted({(t - s) % n_shards
                       for s in range(n_shards) for t in range(n_shards)
                       if len(sends[s][t])})
    mode = "ppermute" if 0 < len(all_offs) <= 4 else "a2a"
    if not all_offs:
        mode = "a2a"  # no communication at all; trivial plan

    plans = []
    for s in range(n_shards):
        send_idx = np.zeros((n_shards, seg), dtype=np.int32)
        send_valid = np.zeros((n_shards, seg), dtype=bool)
        for t in range(n_shards):
            send_idx[t, : len(sends[s][t])] = sends[s][t]
            send_valid[t, : len(sends[s][t])] = True
        g = ghosts_of[s]
        recv_sel = np.zeros(g_pad, dtype=np.int32)
        ghost_valid = np.zeros(g_pad, dtype=bool)
        ghost_valid[: len(g)] = True
        if len(g):
            owners = omap.owner_of(g).astype(np.int64)
            # ghosts are owner-major gid-sorted, so each ghost's position
            # in its owner's send segment is its offset within the
            # owner's run — closed form, no per-ghost lookup
            uniq, starts = np.unique(owners, return_index=True)
            counts = np.diff(np.append(starts, len(g)))
            pos = np.arange(len(g)) - np.repeat(starts, counts)
            if mode == "a2a":
                lane = owners
            else:
                lut = np.zeros(n_shards, dtype=np.int64)
                for i, off in enumerate(all_offs):
                    lut[off] = i
                lane = lut[(s - owners) % n_shards]
            recv_sel[: len(g)] = (lane * seg + pos).astype(np.int32)
        plans.append(HaloPlan(
            send_idx=jnp.asarray(send_idx),
            send_valid=jnp.asarray(send_valid),
            recv_sel=jnp.asarray(recv_sel),
            ghost_valid=jnp.asarray(ghost_valid),
            n_ghost_pad=g_pad, seg=seg, mode=mode, offsets=tuple(all_offs)))
    return plans, sends


def _boundary_stats(trips):
    rows = trips[0]
    if len(rows) == 0:
        return 0, 0
    _, counts = np.unique(rows, return_counts=True)
    return len(counts), int(counts.max())


def _pack_boundary(trips, nb_pad, kb, npl_c, dtype):
    """Vectorized packing of boundary COO triples (local row, ghost slot,
    value) into the compact BoundaryPart ELL (no Python per-entry loop)."""
    rows, slots, vals = trips
    rows_idx = np.zeros(nb_pad, dtype=np.int32)
    bcols = np.zeros((nb_pad, kb), dtype=np.int32)
    bvals = np.zeros((nb_pad, kb), dtype=dtype)
    if len(rows):
        order = np.lexsort((slots, rows))
        r_s, sl_s, v_s = rows[order], slots[order], vals[order]
        ur, starts = np.unique(r_s, return_index=True)
        counts = np.diff(np.append(starts, len(r_s)))
        j_idx = np.repeat(np.arange(len(ur)), counts)
        q_idx = np.arange(len(r_s)) - np.repeat(starts, counts)
        rows_idx[: len(ur)] = ur
        bcols[j_idx, q_idx] = npl_c + sl_s
        bvals[j_idx, q_idx] = v_s
    return BoundaryPart(rows_idx=jnp.asarray(rows_idx),
                        cols=jnp.asarray(bcols), vals=jnp.asarray(bvals))


def distribute_rect(a: CsrHost, row_map: Map, col_map: Map,
                    dtype=None) -> DistMatrix:
    """Row-partition a RECTANGULAR host CSR: rows by ``row_map``, column
    (domain) space owned by ``col_map``. The interior holds locally-owned
    columns; ghost columns get a halo plan over the column map — the
    general Import the reference builds at fillComplete for non-square
    operators (prolongators/restrictions in MueLu hierarchies,
    muelu/src/Transfers/).

    The interior format is ELL without identity padding (rectangular
    operators have no identity-row convention).
    """
    assert a.shape[0] <= row_map.n_global and a.shape[1] <= col_map.n_global
    all_rows = np.repeat(np.arange(a.shape[0], dtype=np.int64),
                         a.row_lengths())
    all_cols = a.cols.astype(np.int64)
    all_vals = a.vals

    def shard_coo(s):
        lo, hi = row_map.shard_lo(s), row_map.shard_hi(s)
        lo_r, hi_r = min(lo, a.shape[0]), min(hi, a.shape[0])
        sl = slice(a.row_ptr[lo_r], a.row_ptr[hi_r])
        return all_rows[sl] - lo, all_cols[sl], all_vals[sl]

    return _distribute_rect(shard_coo, row_map, col_map,
                            dtype or a.vals.dtype)


def distribute_rect_blocks(blocks, row_map: Map, col_map: Map,
                           dtype=None) -> DistMatrix:
    """``distribute_rect()`` from per-shard row blocks (``blocks[s]`` =
    shard s's owned rows, GLOBAL columns in ``col_map``'s space) — no
    global assembly; see ``distribute_blocks``."""
    assert row_map.n_shards == len(blocks)

    def shard_coo(s):
        blk = blocks[s]
        rows = np.repeat(np.arange(blk.shape[0], dtype=np.int64),
                         blk.row_lengths())
        return rows, blk.cols.astype(np.int64), blk.vals

    dtype = dtype or blocks[0].vals.dtype
    return _distribute_rect(shard_coo, row_map, col_map, dtype)


def _distribute_rect(shard_coo, row_map: Map, col_map: Map,
                     dtype) -> DistMatrix:
    n_shards = row_map.n_shards
    npl_r, npl_c = row_map.n_local_pad, col_map.n_local_pad

    ghosts_of, interior_csr, boundary_coo = [], [], []
    for s in range(n_shards):
        lo, hi = row_map.shard_lo(s), row_map.shard_hi(s)
        rs_g, cs_g, vs_g = shard_coo(s)
        clo, chi = col_map.shard_lo(s), col_map.shard_hi(s)
        owned = (cs_g >= clo) & (cs_g < chi)
        interior_csr.append(CsrHost.from_coo(
            rs_g[owned], cs_g[owned] - clo, vs_g[owned],
            (hi - lo, npl_c), sum_duplicates=False))
        bc_rows = rs_g[~owned]
        bc_cols = cs_g[~owned]
        bc_vals = vs_g[~owned]
        ghost_gids = np.unique(bc_cols)
        owners = col_map.owner_of(ghost_gids)
        order = np.lexsort((ghost_gids, owners))
        ghost_gids = ghost_gids[order]
        ghosts_of.append(ghost_gids)
        sort_perm = np.argsort(ghost_gids, kind="stable")
        lookup = np.searchsorted(ghost_gids[sort_perm], bc_cols)
        bc_slots = sort_perm[lookup]
        boundary_coo.append((bc_rows, bc_slots, bc_vals))

    plans, _ = build_halo_plans(ghosts_of, col_map, n_shards)

    stats = [_boundary_stats(t) for t in boundary_coo]
    kb = max(max((c for _, c in stats), default=0), 1)
    nb_pad = round_up(max((r for r, _ in stats), default=0) or 1,
                      ROW_ALIGN)
    k_union = max(max(ic.max_row_length() for ic in interior_csr), 1)
    interiors, boundaries = [], []
    for s in range(n_shards):
        e = csr_to_ell(interior_csr[s], dtype=dtype, k=k_union,
                       n_rows_pad=npl_r, identity_pad_rows=False)
        interiors.append(EllMatrix(cols=e.cols, vals=e.vals, n_rows=npl_r,
                                   n_cols=npl_c, nnz=0))
        boundaries.append(_pack_boundary(boundary_coo[s], nb_pad, kb,
                                         npl_c, dtype))
    return DistMatrix(
        interior=stack_shards(interiors), boundary=stack_shards(boundaries),
        plan=stack_shards(plans), row_map=row_map, col_map=col_map)


def distribute(a: CsrHost, n_shards: int, fmt: str = "auto",
               dtype=None, rmap: Map | None = None,
               block_size: int = 1) -> DistMatrix:
    """Partition a square host CSR by rows over ``n_shards`` and build the
    frozen halo plan (the fillComplete + Import-construction step).

    ``rmap`` overrides the default contiguous-uniform map (e.g. the
    nonuniform contiguous map of a partitioned renumbering — see
    ``distribute_partitioned``). ``fmt="bsr"`` stores each shard's
    interior as block-ELL with ``block_size`` (the distributed
    BlockCrsMatrix, src/Tpetra_BlockCrsMatrix_decl.hpp:53 — there the
    block structure extends into the comm layer via BlockMultiVector;
    here only the interior apply is blocked and the halo stays scalar,
    which keeps one plan for every format); requires every shard
    boundary and the local padding to be block-aligned."""
    n = a.shape[0]
    assert a.shape[0] == a.shape[1], "distribute() requires square A"
    rmap = rmap or Map.uniform(n, n_shards)
    assert rmap.n_shards == n_shards and rmap.n_global == n

    all_rows = np.repeat(np.arange(a.shape[0], dtype=np.int64),
                         a.row_lengths())
    all_cols = a.cols.astype(np.int64)
    all_vals = a.vals

    def shard_coo(s):
        lo, hi = rmap.shard_lo(s), rmap.shard_hi(s)
        sl = slice(a.row_ptr[lo], a.row_ptr[hi])
        return all_rows[sl] - lo, all_cols[sl], all_vals[sl]

    return _distribute_square(shard_coo, rmap, fmt, dtype or a.vals.dtype,
                              block_size, debug_a=a)


def distribute_blocks(blocks, rmap: Map | None = None, fmt: str = "auto",
                      dtype=None, block_size: int = 1) -> DistMatrix:
    """``distribute()`` from ALREADY-SHARDED per-shard row blocks —
    ``blocks[s]`` is a CsrHost of shard s's owned rows with GLOBAL column
    indices. No global matrix is ever assembled: this is the entry the
    distributed AMG setup (parallel/dist_setup.py) uses so per-shard
    memory stays O(n/P), matching the reference's distributed
    fillComplete (Tpetra_CrsMatrix_def.hpp:4437 — each rank holds only
    its own rows)."""
    rmap = rmap or Map.contiguous([b.shape[0] for b in blocks])
    assert rmap.n_shards == len(blocks)
    assert rmap.n_global == sum(b.shape[0] for b in blocks)

    def shard_coo(s):
        blk = blocks[s]
        rows = np.repeat(np.arange(blk.shape[0], dtype=np.int64),
                         blk.row_lengths())
        return rows, blk.cols.astype(np.int64), blk.vals

    dtype = dtype or blocks[0].vals.dtype
    return _distribute_square(shard_coo, rmap, fmt, dtype, block_size)


def _distribute_square(shard_coo, rmap: Map, fmt: str, dtype,
                       block_size: int, debug_a: CsrHost | None = None
                       ) -> DistMatrix:
    """Shared fillComplete body: per-shard COO → interior/boundary split,
    ghost ordering, frozen halo plans, format packing. ``shard_coo(s)``
    yields (local row idx, GLOBAL col idx, vals) for shard s's rows."""
    n_shards = rmap.n_shards
    npl = rmap.n_local_pad

    # -- per-shard analysis (vectorized; must scale to 10M+ rows) ----------
    ghosts_of = []  # shard -> ghost gid array (owner-major, gid-sorted)
    interior_csr = []
    boundary_coo = []  # shard -> dict local row -> [(ghost_slot, val), ...]
    for s in range(n_shards):
        lo, hi = rmap.shard_lo(s), rmap.shard_hi(s)
        rs_g, cs_g, vs_g = shard_coo(s)
        owned = (cs_g >= lo) & (cs_g < hi)
        interior_csr.append(CsrHost.from_coo(
            rs_g[owned], cs_g[owned] - lo, vs_g[owned],
            (hi - lo, hi - lo), sum_duplicates=False))
        bc_rows = rs_g[~owned]
        bc_cols = cs_g[~owned]
        bc_vals = vs_g[~owned]
        # makeColMap ordering: remotes grouped by owner, sorted by gid.
        # Maps are contiguous, so owner-major order == gid order; the
        # native one-sort kernel (tt_ghost_slots) replaces the numpy
        # unique/lexsort/searchsorted chain on the 10M+-row setup path.
        from ..native import ghost_slots_native

        nat = ghost_slots_native(bc_cols)
        if nat is not None:
            ghost_gids, bc_slots = nat
        else:
            ghost_gids = np.unique(bc_cols)
            owners = rmap.owner_of(ghost_gids)
            order = np.lexsort((ghost_gids, owners))
            ghost_gids = ghost_gids[order]
            sort_perm = np.argsort(ghost_gids, kind="stable")
            lookup = np.searchsorted(ghost_gids[sort_perm], bc_cols)
            bc_slots = sort_perm[lookup]
        ghosts_of.append(ghost_gids)
        boundary_coo.append((bc_rows, bc_slots, bc_vals))

    plans, sends = build_halo_plans(ghosts_of, rmap, n_shards)

    # -- freeze per-shard matrix arrays ------------------------------------
    g_pad = plans[0].n_ghost_pad
    boundaries = []
    interiors = []
    stats = [_boundary_stats(t) for t in boundary_coo]
    kb = max(max((c for _, c in stats), default=0), 1)
    nb_pad = round_up(max((r for r, _ in stats), default=0) or 1,
                      ROW_ALIGN)
    # uniform interior format across shards
    if fmt == "auto":
        probe = interior_csr[0]
        rows_rep = np.repeat(np.arange(probe.shape[0]), probe.row_lengths())
        ndiag = len(np.unique(probe.cols.astype(np.int64) - rows_rep))
        fmt = "dia" if ndiag <= 32 else "ell"
    if fmt == "dia":
        off_union = sorted({o for ic in interior_csr
                            for o in _diag_offsets(ic)})
    elif fmt == "bsr":
        b = block_size
        if b < 2:
            raise ValueError("fmt='bsr' needs block_size >= 2")
        for s in range(n_shards):
            if (rmap.shard_hi(s) - rmap.shard_lo(s)) % b:
                raise ValueError(
                    f"shard {s} size not divisible by block_size={b}")
        if npl % b:
            raise ValueError(f"local padding {npl} not divisible by {b}")
        from ..ops.formats import csr_to_bsr

        kb_union = max(csr_to_bsr(ic, b).kb for ic in interior_csr)
    else:
        k_union = max(max(ic.max_row_length() for ic in interior_csr), 1)

    for s in range(n_shards):
        # NOTE: static fields (n_rows/n_cols/nnz) must be IDENTICAL across
        # shards so the pytrees stack; use map-level uniform values.
        if fmt == "dia":
            interiors.append(_csr_to_dia_fixed(interior_csr[s], off_union,
                                               npl, dtype))
        elif fmt == "bsr":
            m = csr_to_bsr(interior_csr[s], b, dtype=dtype,
                           n_brows_pad=npl // b, kb=kb_union)
            interiors.append(dataclasses.replace(
                m, n_rows=npl, n_cols=npl, nnz=0))
        else:
            e = csr_to_ell(interior_csr[s], dtype=dtype, k=k_union,
                           n_rows_pad=npl)
            interiors.append(EllMatrix(cols=e.cols, vals=e.vals, n_rows=npl,
                                       n_cols=npl, nnz=0))
        boundaries.append(_pack_boundary(boundary_coo[s], nb_pad, kb,
                                         npl, dtype))

    dm = DistMatrix(
        interior=stack_shards(interiors), boundary=stack_shards(boundaries),
        plan=stack_shards(plans), row_map=rmap)
    from ..utils import behavior

    if behavior.debug() and debug_a is not None:
        _debug_validate(dm, debug_a, ghosts_of, sends)
    return dm


def _debug_validate(dm: DistMatrix, a: CsrHost, ghosts_of, sends) -> None:
    """TT_DEBUG invariant checks (the analogue of the reference's
    debug-mode cross-process consistency checks,
    Tpetra_Details_Behavior debug() gating e.g.
    Tpetra_CrsMatrix_def.hpp:5117-5167): validates plan reciprocity,
    recv-buffer indexing, and boundary column ranges at fillComplete."""
    rmap = dm.row_map
    p = rmap.n_shards
    plan0 = jax.tree_util.tree_map(np.asarray, dm.plan)
    seg = dm.plan.seg
    g_pad = dm.plan.n_ghost_pad
    for s in range(p):
        g = ghosts_of[s]
        # reciprocity: every ghost of s is sent by its owner
        owners = rmap.owner_of(g)
        for gid, o in zip(g, owners):
            lid = gid - rmap.shard_lo(int(o))
            assert lid in set(sends[int(o)][s].tolist()), \
                f"ghost gid {gid} of shard {s} missing from owner {o}'s send"
        # recv_sel in range
        flat_len = (p if dm.plan.mode == "a2a"
                    else len(dm.plan.offsets)) * seg
        sel = plan0.recv_sel[s]
        assert (sel[: len(g)] < flat_len).all(), "recv_sel out of range"
        # boundary columns within [0, npl + g_pad)
        bc = np.asarray(dm.boundary.cols)[s]
        assert (bc < rmap.n_local_pad + g_pad).all(), \
            "boundary column index beyond ghost space"


def _diag_offsets(c: CsrHost):
    rows_rep = np.repeat(np.arange(c.shape[0]), c.row_lengths())
    return {int(o) for o in np.unique(c.cols.astype(np.int64) - rows_rep)}


def _csr_to_dia_fixed(c: CsrHost, offsets, n_rows_pad, dtype):
    """DIA with a prescribed offset set (union across shards)."""
    d = csr_to_dia(c, dtype=dtype, n_rows_pad=n_rows_pad)
    data = np.zeros((len(offsets), n_rows_pad), dtype=dtype)
    src = np.asarray(d.data)
    for i, o in enumerate(offsets):
        if o in d.offsets:
            data[i] = src[d.offsets.index(o)]
    return DiaMatrix(data=jnp.asarray(data), offsets=tuple(offsets),
                     n_rows=n_rows_pad, n_cols=n_rows_pad, nnz=0)


# ---------------------------------------------------------------------------
# runtime (inside shard_map)
# ---------------------------------------------------------------------------


def exchange(x: jax.Array, plan: HaloPlan, axis_name: str,
             n_shards: int) -> jax.Array:
    """Ghost gather: returns (g_pad,) or (g_pad, k) ghost values."""
    was_1d = x.ndim == 1
    x2 = x[:, None] if was_1d else x
    if plan.mode == "a2a":
        sbuf = x2[plan.send_idx]  # (P, seg, k)
        rbuf = lax.all_to_all(sbuf, axis_name, 0, 0)
        flat = rbuf.reshape(-1, x2.shape[1])
    else:
        me = lax.axis_index(axis_name)
        parts = []
        for off in plan.offsets:
            dest = (me + off) % n_shards
            sb = jnp.take(x2[plan.send_idx], dest, axis=0)  # (seg, k)
            perm = [(s, (s + off) % n_shards) for s in range(n_shards)]
            parts.append(lax.ppermute(sb, axis_name, perm))
        flat = jnp.concatenate(parts, axis=0)
    ghosts = flat[plan.recv_sel]
    return ghosts[:, 0] if was_1d else ghosts


def exchange_reverse(ghosts: jax.Array, plan: HaloPlan, axis_name: str,
                     n_shards: int):
    """Reverse (Export-direction) transfer: each shard's per-ghost
    contributions travel back to the ghost's OWNER.

    Returns (contrib, idx, valid): flat received contributions, the local
    row index each lands on (plan.send_idx order), and a validity mask.
    The reference analogue is Export/doExport's reversal of an Import plan
    (src/Tpetra_Export_decl.hpp; Distributor::createReverseDistributor).
    """
    was_1d = ghosts.ndim == 1
    g2 = ghosts[:, None] if was_1d else ghosts
    k = g2.shape[1]
    g2 = jnp.where(plan.ghost_valid[:, None], g2, 0)
    n_lanes = (n_shards if plan.mode == "a2a" else len(plan.offsets))
    flat = jnp.zeros((n_lanes * plan.seg, k), g2.dtype)
    # pad ghost slots point at position 0 but carry zeros -> add is safe
    flat = flat.at[plan.recv_sel].add(g2, mode="promise_in_bounds")
    me = lax.axis_index(axis_name)
    if plan.mode == "a2a":
        rbuf = lax.all_to_all(flat.reshape(n_shards, plan.seg, k),
                              axis_name, 0, 0)
        contrib = rbuf.reshape(-1, k)
        idx = plan.send_idx.reshape(-1)
        valid = plan.send_valid.reshape(-1)
    else:
        parts, idxs, valids = [], [], []
        for i, off in enumerate(plan.offsets):
            part = flat[i * plan.seg:(i + 1) * plan.seg]
            perm = [(s, (s - off) % n_shards) for s in range(n_shards)]
            parts.append(lax.ppermute(part, axis_name, perm))
            t = (me + off) % n_shards
            idxs.append(jnp.take(plan.send_idx, t, axis=0))
            valids.append(jnp.take(plan.send_valid, t, axis=0))
        contrib = jnp.concatenate(parts, axis=0)
        idx = jnp.concatenate(idxs, axis=0)
        valid = jnp.concatenate(valids, axis=0)
    if was_1d:
        contrib = contrib[:, 0]
    return contrib, idx, valid


def export_combine(x: jax.Array, ghosts: jax.Array, plan: HaloPlan,
                   axis_name: str, n_shards: int,
                   mode: str = "ADD") -> jax.Array:
    """doExport: combine each shard's ghost contributions into the owned
    vector under a CombineMode (src/Tpetra_CombineMode.hpp:59-88).

    ADD     sum contributions into existing values
    INSERT / REPLACE   overwrite with the incoming value (with multiple
            contributors the scatter order is unspecified, as in the
            reference's unpack)
    ABSMAX  replace with max(|old|, |incoming|)
    ZERO    bypass communication entirely — x is returned unchanged (the
            restricted-Schwarz combine; see Ifpack2::AdditiveSchwarz)
    """
    mode = mode.upper()
    if mode == "ZERO":
        return x
    contrib, idx, valid = exchange_reverse(ghosts, plan, axis_name, n_shards)
    was_1d = x.ndim == 1
    x2 = x[:, None] if was_1d else x
    c2 = contrib[:, None] if was_1d else contrib
    v2 = valid[:, None]
    c2 = c2.astype(x2.dtype)
    sel = jnp.where(valid, idx, x2.shape[0])  # invalid -> dropped
    if mode == "ADD":
        y = x2.at[idx].add(jnp.where(v2, c2, 0), mode="promise_in_bounds")
    elif mode in ("INSERT", "REPLACE"):
        y = x2.at[sel].set(c2, mode="drop")
    elif mode == "ABSMAX":
        m = jnp.zeros_like(x2).at[sel].max(jnp.abs(c2), mode="drop")
        touched = jnp.zeros(x2.shape, bool).at[sel].set(True, mode="drop")
        y = jnp.where(touched, jnp.maximum(jnp.abs(x2), m), x2)
    else:
        raise ValueError(f"unknown CombineMode {mode!r}")
    return y[:, 0] if was_1d else y


def apply_local_transpose(mat_interior, mat_boundary: BoundaryPart,
                          plan: HaloPlan, x: jax.Array, axis_name: str,
                          n_shards: int) -> jax.Array:
    """Distributed transpose SpMV y = Aᵀx, per-shard view (the
    ``apply(..., Teuchos::TRANS)`` mode of the reference's CrsMatrix,
    Tpetra_CrsMatrix_def.hpp localApply CONJ_TRANS + Export-ADD of the
    off-process column contributions).

    The local rows scatter Aᵀ contributions into the extended
    [owned-columns | ghost-columns] space; ghost contributions then ride
    the EXISTING Import plan in reverse (``export_combine`` ADD), so no
    second comm plan is built. Square row-distributed matrices only
    (row_map == domain map) — rectangular transposes (AMG restriction)
    store R explicitly instead.
    """
    was_1d = x.ndim == 1
    x2 = x[:, None] if was_1d else x
    n_loc = x2.shape[0]
    k = x2.shape[1]
    y = spmv(mat_interior, x, transpose=True)  # interior cols are owned
    y2 = y[:, None] if was_1d else y
    # boundary rows: y_ext[cols[r, j]] += vals[r, j] * x[rows_idx[r]]
    xb = x2.at[mat_boundary.rows_idx].get(mode="promise_in_bounds")
    contrib = (mat_boundary.vals[:, :, None]
               * xb[:, None, :].astype(mat_boundary.vals.dtype))
    ext = jnp.zeros((n_loc + plan.n_ghost_pad, k), contrib.dtype)
    ext = ext.at[mat_boundary.cols.reshape(-1)].add(
        contrib.reshape(-1, k), mode="promise_in_bounds")
    y2 = y2 + ext[:n_loc].astype(y2.dtype)
    y2 = export_combine(y2, ext[n_loc:].astype(y2.dtype), plan, axis_name,
                        n_shards, "ADD")
    return y2[:, 0] if was_1d else y2


def apply_local(mat_interior, mat_boundary: BoundaryPart, plan: HaloPlan,
                x: jax.Array, axis_name: str, n_shards: int) -> jax.Array:
    """Distributed SpMV, per-shard view: overlap-friendly split apply."""
    ghosts = exchange(x, plan, axis_name, n_shards)  # collective
    y = spmv(mat_interior, x)  # independent of the collective -> overlaps
    was_1d = x.ndim == 1
    x2 = x[:, None] if was_1d else x
    g2 = ghosts[:, None] if was_1d else ghosts
    ext = jnp.concatenate([x2, g2.astype(x2.dtype)], axis=0)
    gathered = ext.at[mat_boundary.cols].get(mode="promise_in_bounds")
    contrib = jnp.einsum("rk,rkn->rn", mat_boundary.vals,
                         gathered.astype(mat_boundary.vals.dtype),
                         precision=HI)
    y2 = y[:, None] if was_1d else y
    y2 = y2.at[mat_boundary.rows_idx].add(contrib, mode="promise_in_bounds")
    return y2[:, 0] if was_1d else y2


# ---------------------------------------------------------------------------
# values-only refill (graph/plan reuse)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RefillPlan:
    """Frozen values-only refill recipe — the graph-reuse contract of
    ``Tpetra::CrsMatrix::resumeFill``/``fillComplete``
    (src/Tpetra_CrsMatrix_decl.hpp:2897): when a matrix's VALUES change
    but its sparsity (row_ptr/cols) does not, the halo plan, column
    maps, boundary structure, and packed integer arrays are all reused;
    only the float value arrays are regenerated by one vectorized
    gather per leaf.

    Built once by :func:`build_refill` (which re-runs the symbolic
    distribute on a position-marker matrix); ``leaf_idx`` holds, for
    every float leaf of (interior, boundary), an int64 array with
    entries >= 0 (gather from the CSR nnz array), -1 (structural zero /
    padding) or -2 (identity-padding one)."""

    leaf_idx: tuple
    nnz: int = dataclasses.field(metadata=dict(static=True))


def _infer_fmt(dm: DistMatrix):
    it = dm.interior
    if isinstance(it, DiaMatrix):
        return "dia", 1
    if isinstance(it, BsrMatrix):
        return "bsr", it.block_size
    return "ell", 1


def _float_leaves(dm: DistMatrix):
    leaves = jax.tree_util.tree_leaves((dm.interior, dm.boundary))
    return [l for l in leaves if jnp.issubdtype(jnp.asarray(l).dtype,
                                                jnp.floating)]


def build_refill(a: CsrHost, dm: DistMatrix) -> RefillPlan:
    """Capture the value-position mapping of ``dm`` relative to ``a``'s
    nnz ordering. One-time symbolic cost (same as a distribute); every
    subsequent :func:`refill_values` is a pure gather."""
    nnz = len(a.vals)
    marker = CsrHost(a.row_ptr, a.cols,
                     np.arange(2, nnz + 2, dtype=np.float64), a.shape)
    fmt, bs = _infer_fmt(dm)
    if dm.col_map is not None:
        raise NotImplementedError(
            "build_refill supports square DistMatrix (rect transfers are "
            "rebuilt by the AMG setup that owns them)")
    dm_idx = distribute(marker, dm.row_map.n_shards, fmt=fmt,
                        dtype=np.float64, rmap=dm.row_map, block_size=bs)
    idx = []
    for leaf in _float_leaves(dm_idx):
        v = np.asarray(leaf)
        out = np.full(v.shape, -1, dtype=np.int64)
        out[v == 1.0] = -2
        sel = v >= 2.0
        out[sel] = np.round(v[sel]).astype(np.int64) - 2
        idx.append(out)
    return RefillPlan(leaf_idx=tuple(idx), nnz=nnz)


def refill_values(dm: DistMatrix, plan: RefillPlan,
                  new_vals: np.ndarray) -> DistMatrix:
    """New DistMatrix with ``new_vals`` (the nnz array of a matrix with
    UNCHANGED sparsity) scattered into ``dm``'s frozen layout. No plan
    build, no ghost analysis — the resumeFill hot path for nonlinear /
    transient outer loops."""
    if len(new_vals) != plan.nnz:
        raise ValueError(
            f"value count {len(new_vals)} != pattern nnz {plan.nnz}")
    new_vals = np.asarray(new_vals, dtype=np.float64)
    it = 0
    flat, treedef = jax.tree_util.tree_flatten((dm.interior, dm.boundary))
    out = []
    for leaf in flat:
        arr = jnp.asarray(leaf)
        if not jnp.issubdtype(arr.dtype, jnp.floating):
            out.append(leaf)
            continue
        ix = plan.leaf_idx[it]
        it += 1
        vals = np.where(ix >= 0, new_vals[np.maximum(ix, 0)],
                        np.where(ix == -2, 1.0, 0.0))
        out.append(jnp.asarray(vals, dtype=arr.dtype))
    interior, boundary = jax.tree_util.tree_unflatten(treedef, out)
    return DistMatrix(interior=interior, boundary=boundary, plan=dm.plan,
                      row_map=dm.row_map, col_map=dm.col_map)
