"""Mesh drivers: shard_map wrappers turning per-shard kernels into global
jitted programs.

The JAX replacement for the reference's solve-side MPI plumbing:
where Trilinos runs one OS process per rank with an MpiComm, here ONE
program is jitted over a ``jax.sharding.Mesh`` axis ('rows'); per-shard
code (halo exchange, local SpMV, local dots) runs under ``jax.shard_map``
and reductions lower to psum over ICI (SURVEY.md §2.3 mapping).

Distributed preconditioning follows the Ifpack2 split (§3.5): the
preconditioner's *state* is row-sharded arrays (diagonals, factors); its
apply is a per-shard closure built inside shard_map via ``DistPrecond.make``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.formats import CsrHost
from ..solvers.base import SolveResult
from .comm import AxisComm, Comm
from .distmatrix import (DistMatrix, DistStencil, apply_local,
                         apply_local_stencil, apply_local_transpose,
                         unstack_local)
from .map import Map


def _local_op(al, n_shards, axes=None):
    """Per-shard operator closure for either DistMatrix or DistStencil."""
    axes = axes or AXIS
    if isinstance(al, DistStencil):
        return lambda v: apply_local_stencil(
            al.sel, al.valid, al.op_local, al.depth, al.plan, v, axes,
            n_shards)
    return lambda v: apply_local(al.interior, al.boundary, al.plan, v,
                                 axes, n_shards)


def _local_op_t(al, n_shards, axes=None):
    """Per-shard TRANSPOSE operator closure (square DistMatrix only)."""
    axes = axes or AXIS
    if isinstance(al, DistStencil):
        raise NotImplementedError(
            "transpose apply on DistStencil: symmetric stencils satisfy "
            "Aᵀ = A; for general stencils distribute the stored format")
    if al.col_map is not None:
        raise NotImplementedError(
            "transpose of a rectangular DistMatrix — AMG stores R "
            "explicitly (distribute_rect) instead")
    return lambda v: apply_local_transpose(al.interior, al.boundary,
                                           al.plan, v, axes, n_shards)

AXIS = "rows"


def solve_axes(mesh: Mesh):
    """Row-dimension axis name(s) of a solve mesh: the single 'rows'
    axis, or ALL axes flattened outer-major for a multi-level mesh.

    A 2-axis ('dcn', 'rows') mesh is the BASELINE #4-5 multi-host
    topology (SURVEY §2.3): rows are sharded over the flattened
    (dcn-major) device order, so with a contiguous row Map the banded
    halo ppermutes connect NEIGHBORING inner-axis devices (ICI) and only
    the slab cuts at dcn-group boundaries cross the slow outer links.
    All collectives (psum / ppermute / all_to_all) take the axis tuple
    directly — XLA lowers them over the flattened product axis."""
    ax = tuple(mesh.axis_names)
    return ax[0] if len(ax) == 1 else ax


def make_mesh2(p_outer: int, p_inner: int,
               axes: tuple[str, str] = ("dcn", AXIS)) -> Mesh:
    """Two-level solve mesh: ``p_outer`` DCN groups x ``p_inner`` chips.
    Pass to any dist_* driver; the row dimension is sharded over BOTH
    axes (outer-major), matching Map.uniform's contiguous order."""
    devs = jax.devices()
    n = p_outer * p_inner
    if n > len(devs):
        raise ValueError(
            f"requested {n} mesh devices but only {len(devs)} available")
    return Mesh(np.array(devs[:n]).reshape(p_outer, p_inner), axes)


def make_mesh(n_devices: int | None = None, axis: str = AXIS) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(
            f"requested {n} mesh devices but only {len(devs)} available "
            f"(set XLA_FLAGS=--xla_force_host_platform_device_count=N "
            f"before importing jax for a virtual CPU mesh)")
    return Mesh(np.array(devs[:n]), (axis,))


# ---------------------------------------------------------------------------
# distributed preconditioners
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DistPrecond:
    """Sharded preconditioner state + a static builder for the per-shard
    apply closure. ``arrays`` leaves carry a leading shard axis."""

    arrays: dict
    kind: str = dataclasses.field(metadata=dict(static=True))
    consts: tuple = dataclasses.field(metadata=dict(static=True), default=())

    def make(self, comm: Comm, op: Callable) -> Callable:
        local = unstack_local(self.arrays)
        if self.kind == "identity":
            return lambda x: x
        if self.kind == "jacobi":
            dinv = local["dinv"]
            return lambda x: (dinv if jnp.ndim(x) == 1 else dinv[:, None]) * x
        if self.kind == "ilu0":
            from ..ops.formats import EllMatrix
            from ..ops.matvec import spmv

            (sweeps,) = self.consts

            def mk(cols, vals):
                n = cols.shape[0]
                return EllMatrix(cols=cols, vals=vals, n_rows=n, n_cols=n,
                                 nnz=0)

            l_m = mk(local["l_cols"], local["l_vals"])
            u_m = mk(local["u_cols"], local["u_vals"])
            udinv_v = local["udinv"]

            def ilu_apply(r):
                udinv = udinv_v if r.ndim == 1 else udinv_v[:, None]
                y = r
                for _ in range(sweeps):
                    y = r - (spmv(l_m, y) - y)
                x = udinv * y
                for _ in range(sweeps):
                    x = x + udinv * (y - spmv(u_m, x))
                return x

            return ilu_apply
        if self.kind == "amg":
            from .distmatrix import apply_local as _apply_local

            sweeps, omega, gamma, npl_c = self.consts
            levels = local["levels"]
            coarse_inv = local["coarse_inv"]
            coarse_pos = local["coarse_pos"]
            axis, p_shards = comm.axis_name, comm.size

            def apply_dm(dm, v):
                return _apply_local(dm.interior, dm.boundary, dm.plan, v,
                                    axis, p_shards)

            def smooth(lvl, x, b):
                dinv = (lvl["dinv"] if b.ndim == 1
                        else lvl["dinv"][:, None])
                for _ in range(sweeps):
                    x = x + omega * dinv * (b - apply_dm(lvl["a"], x))
                return x

            def vcycle(k, b):
                if k == len(levels):
                    # replicated dense coarse solve in LOGICAL (unpadded)
                    # space: gather the padded chunks, compress through
                    # coarse_pos, one (n_c, n_c) matmul, scatter back.
                    # Memory is n_c² instead of (P·n_local_pad)² — the
                    # round-3 P² scaling cliff removed (the reference
                    # agglomerates the coarse problem to one rank; this
                    # is the replicated-compute equivalent)
                    r_all = jax.lax.all_gather(b, axis, tiled=True)
                    r_log = r_all[coarse_pos]
                    e_log = coarse_inv @ r_log
                    e_all = jnp.zeros_like(r_all).at[coarse_pos].set(
                        e_log.astype(r_all.dtype))
                    me = jax.lax.axis_index(axis)
                    if b.ndim == 1:
                        return jax.lax.dynamic_slice(
                            e_all, (me * npl_c,), (npl_c,))
                    return jax.lax.dynamic_slice(
                        e_all, (me * npl_c, 0), (npl_c, b.shape[1]))
                lvl = levels[k]
                x = smooth(lvl, jnp.zeros_like(b), b)
                for _ in range(gamma):  # gamma=2 -> W-cycle
                    r = b - apply_dm(lvl["a"], x)
                    r_c = apply_dm(lvl["r"], r)
                    e_c = vcycle(k + 1, r_c)
                    x = x + apply_dm(lvl["p"], e_c)
                x = smooth(lvl, x, b)
                return x

            return lambda r: vcycle(0, r)
        if self.kind == "amg_structured":
            from ..ops.matvec import spmv
            from ..precond.amg import (_structured_transfers,
                                       block_pair_dup, block_pair_sum)
            from .distmatrix import apply_local_stencil

            (sweeps, omg, gamma, op_loc, depth, fine_meta,
             inner_meta) = self.consts
            (dims, block, om_t, dinv_f, nzl, n_c1_pad,
             n_c1_log) = fine_meta
            nx, ny, _ = dims
            bx, by, bz = block
            slab = (nx, ny, nzl)
            cslab = (nx // bx, ny // by, nzl // bz)
            n_lc = cslab[0] * cslab[1] * cslab[2]
            nrm = float(1.0 / np.sqrt(bx * by * bz))
            w_f = om_t * dinv_f
            axis, p_shards = comm.axis_name, comm.size
            plan = local["plan"]
            sel, valid = local["sel"], local["valid"]
            inner = local["inner"]
            coarse_inv = local["coarse_inv"]

            def a_fine(v):
                return apply_local_stencil(sel, valid, op_loc, depth,
                                           plan, v, axis, p_shards)

            def dmul(dv, v):
                return v * (dv if v.ndim == 1 else dv[:, None])

            def inner_vcycle(k, b):
                # replicated: every shard runs the identical coarse
                # correction — zero collectives below this point
                if k == len(inner):
                    return coarse_inv @ b
                arrs = inner[k]
                cdims, cblock, c_om, c_npad, c_nlog = inner_meta[k]
                restrict, prolong = _structured_transfers(
                    arrs["a"], cdims, c_npad, c_nlog, cblock, c_om,
                    arrs["dinv"])
                dv = arrs["dinv"]
                x = omg * dmul(dv, b)
                for _ in range(sweeps - 1):
                    x = x + omg * dmul(dv, b - spmv(arrs["a"], x))
                for _ in range(gamma):
                    r = b - spmv(arrs["a"], x)
                    x = x + prolong(inner_vcycle(k + 1, restrict(r)))
                for _ in range(sweeps):
                    x = x + omg * dmul(dv, b - spmv(arrs["a"], x))
                return x

            def apply(r):
                tail_pad = ((0, 0),) * (r.ndim - 1)
                # pre-smooth from zero guess (first sweep is apply-free)
                x = (omg * dinv_f) * r
                for _ in range(sweeps - 1):
                    x = x + (omg * dinv_f) * (r - a_fine(x))
                for _ in range(gamma):
                    res = r - a_fine(x)
                    # restrict: P_tᵀ(res − w·A res), block-sum LOCAL
                    rc = block_pair_sum(res - w_f * a_fine(res), slab,
                                        block) * nrm
                    rc_g = jax.lax.all_gather(rc, axis, tiled=True)
                    e_g = inner_vcycle(
                        0, jnp.pad(rc_g,
                                   ((0, n_c1_pad - n_c1_log),) + tail_pad))
                    me = jax.lax.axis_index(axis)
                    zeros = (jnp.zeros((), me.dtype),) * (r.ndim - 1)
                    e_loc = jax.lax.dynamic_slice(
                        e_g, (me * n_lc,) + zeros,
                        (n_lc,) + r.shape[1:])
                    t = block_pair_dup(e_loc, cslab, block) * nrm
                    x = x + (t - w_f * a_fine(t))
                for _ in range(sweeps):
                    x = x + (omg * dinv_f) * (r - a_fine(x))
                return x

            return apply
        if self.kind == "schwarz":
            from ..ops.formats import EllMatrix
            from ..ops.matvec import spmv
            from .distmatrix import exchange, export_combine

            (sweeps, combine, npl) = self.consts
            axis, p_shards = comm.axis_name, comm.size
            plan = local["plan"]
            udinv_v = local["udinv"]

            def mk(cols, vals):
                n = cols.shape[0]
                return EllMatrix(cols=cols, vals=vals, n_rows=n, n_cols=n,
                                 nnz=0)

            l_m = mk(local["l_cols"], local["l_vals"])
            u_m = mk(local["u_cols"], local["u_vals"])

            def schwarz_apply(r):
                # widen to the overlapped subdomain [owned | overlap]
                ghosts = exchange(r, plan, axis, p_shards)
                rt = jnp.concatenate([r, ghosts.astype(r.dtype)], axis=0)
                udinv = udinv_v if r.ndim == 1 else udinv_v[:, None]
                y = rt
                for _ in range(sweeps):
                    y = rt - (spmv(l_m, y) - y)
                z = udinv * y
                for _ in range(sweeps):
                    z = z + udinv * (y - spmv(u_m, z))
                z_own, z_ovl = z[:npl], z[npl:]
                # RAS (ZERO) drops overlap contributions; classical AS
                # (ADD) exports them back to their owners
                return export_combine(z_own, z_ovl, plan, axis, p_shards,
                                      mode=combine)

            return schwarz_apply
        if self.kind == "chebyshev":
            dinv = local["dinv"]
            lmax, lmin, degree = self.consts

            def cheb(b):
                di = dinv if b.ndim == 1 else dinv[:, None]
                theta = (lmax + lmin) / 2
                delta = (lmax - lmin) / 2
                sigma1 = theta / delta
                rho = 1.0 / sigma1
                z = di * b
                d_vec = z / theta
                x = d_vec
                r = b
                for _ in range(degree - 1):
                    r = r - op(d_vec)
                    z = di * r
                    rho_new = 1.0 / (2 * sigma1 - rho)
                    d_vec = (rho_new * rho) * d_vec + (2 * rho_new / delta) * z
                    x = x + d_vec
                    rho = rho_new
                return x

            return cheb
        if self.kind == "cheb_fused":
            from ..ops.stencil import stencil_poly_xla
            from .distmatrix import gather_extended

            stages, op_loc, npl, off = self.consts
            axis, p_shards = comm.axis_name, comm.size
            plan = local["plan"]
            sel, valid, zb = local["sel"], local["valid"], local["zb"]

            def cheb_fused(r):
                # ONE depth-s exchange feeds the whole polynomial sweep
                # (the communication-avoiding smoother: s-deep ghosts once
                # instead of 1-deep ghosts s times)
                if r.ndim != 1:
                    raise NotImplementedError(
                        "cheb_fused: single-vector apply only")
                ext = gather_extended(sel, valid, plan, r, axis,
                                      p_shards)
                y = stencil_poly_xla(op_loc, stages, ext, z_bounds=zb)
                return jax.lax.dynamic_slice(y, (off,), (npl,))

            return cheb_fused
        raise ValueError(f"unknown DistPrecond kind {self.kind!r}")


def dist_jacobi(a: CsrHost, rmap: Map, dtype=None) -> DistPrecond:
    """Row-sharded inverse-diagonal (the distributed Ifpack2 RELAXATION)."""
    dtype = dtype or a.vals.dtype
    d = a.diagonal().astype(np.float64)
    dinv_g = 1.0 / np.where(d != 0, d, 1.0)
    stacked = rmap.to_padded(dinv_g)
    # identity on padding rows
    for s in range(rmap.n_shards):
        lo = s * rmap.n_local_pad + rmap.n_owned(s)
        stacked[lo:(s + 1) * rmap.n_local_pad] = 1.0
    arr = jnp.asarray(stacked.reshape(rmap.n_shards, rmap.n_local_pad),
                      dtype=dtype)
    return DistPrecond(arrays={"dinv": arr}, kind="jacobi")


def dist_chebyshev(a: CsrHost, rmap: Map, lmax: float, lmin: float | None = None,
                   degree: int = 4, ratio: float = 30.0,
                   dtype=None) -> DistPrecond:
    base = dist_jacobi(a, rmap, dtype)
    lmin = lmin if lmin is not None else lmax / ratio
    return DistPrecond(arrays=base.arrays, kind="chebyshev",
                       consts=(float(lmax), float(lmin), int(degree)))


def dist_cheb_fused(op, n_shards: int, degree: int = 4,
                    lmax: float | None = None,
                    lmin: float | None = None, ratio: float = 30.0,
                    boost: float = 1.1,
                    eig_iters: int = 10) -> DistPrecond:
    """Communication-avoiding fused Chebyshev smoother for a global
    matrix-free StencilOp distributed over z-slabs: ONE depth-
    (degree*reach) ghost exchange feeds the whole degree-d polynomial
    sweep (ops/stencil.py ``stencil_poly_xla``) — d-1 fewer exchanges
    per apply.
    The per-shard z-bounds keep beyond-global-boundary ghost planes
    masked at every stage while interior shard cuts read real halo
    data (validated against the global fused apply)."""
    from ..ops.stencil import StencilOp, stencil_chebyshev_setup
    from .distmatrix import distribute_stencil, zslab_bounds

    if not isinstance(op, StencilOp):
        raise TypeError("dist_cheb_fused expects a global StencilOp")
    stages = stencil_chebyshev_setup(op, degree, lmax, lmin, ratio,
                                     boost, eig_iters)

    z_reach = max(max((abs(o[2]) for o in op.offsets), default=0), 1)
    depth = degree * z_reach
    ds = distribute_stencil(op, n_shards, depth=depth)
    pxy = op.dims[0] * op.dims[1]
    zb = zslab_bounds(op, n_shards, depth)
    return DistPrecond(
        arrays={"plan": ds.plan, "sel": ds.sel, "valid": ds.valid,
                "zb": jnp.asarray(zb)},
        kind="cheb_fused",
        consts=(stages, ds.op_local, ds.row_map.n_local_pad,
                depth * pxy))


def dist_ilu0(a: CsrHost, rmap: Map, sweeps: int = 6,
              dtype=None, fill_level: int = 0) -> DistPrecond:
    """Per-shard local ILU(k) (block-Jacobi ILU): each shard factors its
    LocalFilter (off-shard couplings dropped) — exactly the reference's
    parallel ILU composition (Ifpack2 LocalFilter + RILUK, SURVEY §3.5);
    the apply is the fixed-sweep Jacobi triangular solve. ``fill_level``
    > 0 augments each local pattern with ILU(k) level-fill
    (precond.ilu.iluk_pattern, the IlukGraph analogue)."""
    import jax.numpy as jnp
    import numpy as np

    from ..ops.formats import csr_to_ell
    from ..precond.ilu import ilu0_factor, iluk_augment

    dtype = dtype or a.vals.dtype
    npl = rmap.n_local_pad
    rows_all = np.repeat(np.arange(a.shape[0], dtype=np.int64),
                         a.row_lengths())
    shards = []
    for s in range(rmap.n_shards):
        lo, hi = rmap.shard_lo(s), rmap.shard_hi(s)
        sl = slice(a.row_ptr[lo], a.row_ptr[hi])
        rs, cs, vs = rows_all[sl], a.cols[sl].astype(np.int64), a.vals[sl]
        keep = (cs >= lo) & (cs < hi)
        local = CsrHost.from_coo(rs[keep] - lo, cs[keep] - lo, vs[keep],
                                 (hi - lo, hi - lo))
        l_m, u_m = ilu0_factor(iluk_augment(local, fill_level))
        shards.append((l_m, u_m))
    kl = max(max(l.max_row_length() for l, _ in shards), 1)
    ku = max(max(u.max_row_length() for _, u in shards), 1)
    l_cols, l_vals, u_cols, u_vals, udinvs = [], [], [], [], []
    for s, (l_m, u_m) in enumerate(shards):
        le = csr_to_ell(l_m, dtype=dtype, k=kl, n_rows_pad=npl)
        ue = csr_to_ell(u_m, dtype=dtype, k=ku, n_rows_pad=npl)
        l_cols.append(le.cols)
        l_vals.append(le.vals)
        u_cols.append(ue.cols)
        u_vals.append(ue.vals)
        du = u_m.diagonal().astype(np.float64)
        dv = np.ones(npl)
        dv[: len(du)] = 1.0 / np.where(du != 0, du, 1.0)
        udinvs.append(jnp.asarray(dv, dtype=dtype))
    arrays = {
        "l_cols": jnp.stack(l_cols), "l_vals": jnp.stack(l_vals),
        "u_cols": jnp.stack(u_cols), "u_vals": jnp.stack(u_vals),
        "udinv": jnp.stack(udinvs),
    }
    return DistPrecond(arrays=arrays, kind="ilu0", consts=(int(sweeps),))


def identity_precond() -> DistPrecond:
    return DistPrecond(arrays={}, kind="identity")


def _permute_rows(m: CsrHost, new_of_old: np.ndarray) -> CsrHost:
    rows = np.repeat(np.arange(m.shape[0], dtype=np.int64),
                     m.row_lengths())
    return CsrHost.from_coo(new_of_old[rows], m.cols.astype(np.int64),
                            m.vals, m.shape, sum_duplicates=False)


def _permute_cols(m: CsrHost, new_of_old: np.ndarray) -> CsrHost:
    rows = np.repeat(np.arange(m.shape[0], dtype=np.int64),
                     m.row_lengths())
    return CsrHost.from_coo(rows, new_of_old[m.cols.astype(np.int64)],
                            m.vals, m.shape, sum_duplicates=False)


def dist_amg(a: CsrHost, rmap: Map, *, max_levels: int = 10,
             coarse_max: int = 64, min_agg: int = 2,
             sa_damping: float = 4.0 / 3.0, sweeps: int = 2,
             omega: float = 0.8, cycle: str = "V",
             rebalance: bool = False, nullspace=None,
             n_equations: int = 1, dtype=None) -> DistPrecond:
    """Distributed smoothed-aggregation AMG.

    Setup runs on host (MueLu Hierarchy::Setup,
    muelu/src/MueCentral/MueLu_Hierarchy_decl.hpp:103): aggregation,
    smoothed P, Galerkin coarse operators. Every level's A is row-sharded
    (DistMatrix with halo plan); P and R are RECTANGULAR DistMatrices whose
    halo plans live on the coarse/fine column maps. The V/W-cycle
    (Hierarchy::Iterate, :238) then runs entirely inside shard_map —
    smoothing, restriction and prolongation are halo-exchange applies, and
    the coarsest level is a replicated dense solve after one all_gather.
    """
    from ..precond.amg import build_hierarchy_host
    from .distmatrix import distribute, distribute_rect
    from .partition import (partition_greedy_graph,
                            partition_to_permutation, permute_csr)

    dtype = dtype or a.vals.dtype
    n_shards = rmap.n_shards
    assert rmap.n_global == a.shape[0]
    host_levels, a_coarse = build_hierarchy_host(
        a, max_levels, coarse_max, min_agg, sa_damping,
        nullspace=nullspace, n_equations=n_equations)

    if rebalance:
        # MueLu-style rebalanced hierarchy (muelu/src/Rebalancing/):
        # re-partition each COARSE level's operator with graph growing so
        # its halo plans cut fewer edges, and carry the renumbering
        # through P's columns / R's rows. The finest level keeps the
        # caller's map (the solve vector layout must not change).
        relabeled = []
        for i, (a_l, p_l) in enumerate(host_levels):
            if i == 0:
                relabeled.append([a_l, p_l])
                continue
            part = partition_greedy_graph(a_l, n_shards)
            perm = partition_to_permutation(part)  # perm[new] = old
            inv = np.empty(a_l.shape[0], dtype=np.int64)
            inv[perm] = np.arange(a_l.shape[0])
            relabeled[i - 1][1] = _permute_cols(relabeled[i - 1][1], inv)
            relabeled.append([permute_csr(a_l, perm),
                              _permute_rows(p_l, inv)])
        if len(host_levels) > 1:
            # coarsest operator's rows follow the last P's columns
            part = partition_greedy_graph(a_coarse, n_shards)
            perm = partition_to_permutation(part)
            inv = np.empty(a_coarse.shape[0], dtype=np.int64)
            inv[perm] = np.arange(a_coarse.shape[0])
            relabeled[-1][1] = _permute_cols(relabeled[-1][1], inv)
            a_coarse = permute_csr(a_coarse, perm)
        host_levels = [tuple(lv) for lv in relabeled]

    maps = [rmap]
    for (_, p_l) in host_levels:
        maps.append(Map.uniform(p_l.shape[1], n_shards))

    levels = []
    for i, (a_l, p_l) in enumerate(host_levels):
        fmap, cmap = maps[i], maps[i + 1]
        a_dm = distribute(a_l, n_shards, dtype=dtype)
        p_dm = distribute_rect(p_l, fmap, cmap, dtype=dtype)
        r_dm = distribute_rect(p_l.transpose(), cmap, fmap, dtype=dtype)
        d = a_l.diagonal().astype(np.float64)
        dinv_g = 1.0 / np.where(d != 0, d, 1.0)
        stacked = fmap.to_padded(dinv_g)
        for s in range(n_shards):
            lo = s * fmap.n_local_pad + fmap.n_owned(s)
            stacked[lo:(s + 1) * fmap.n_local_pad] = 1.0
        dinv = jnp.asarray(
            stacked.reshape(n_shards, fmap.n_local_pad), dtype=dtype)
        levels.append(dict(a=a_dm, p=p_dm, r=r_dm, dinv=dinv))

    # coarsest: dense pinv in LOGICAL (unpadded) space, replicated;
    # coarse_pos maps logical coarse dofs into the padded all_gather
    # layout at apply time (n_c² memory, not (P·n_local_pad)²)
    cmap = maps[-1]
    coarse_inv, coarse_pos = _coarse_inv_from_dense(
        a_coarse.to_dense(), cmap, n_shards, dtype)

    gamma = 2 if cycle == "W" else 1
    return DistPrecond(
        arrays={"levels": levels, "coarse_inv": coarse_inv,
                "coarse_pos": coarse_pos},
        kind="amg",
        consts=(int(sweeps), float(omega), gamma, cmap.n_local_pad))


def _coarse_inv_from_dense(acc: np.ndarray, cmap: Map, n_shards: int,
                           dtype):
    """Replicated dense pinv of the coarsest operator in LOGICAL space,
    plus the logical→padded position map used at apply time — the ONE
    home of the coarse-solve layout convention (pinv rcond, pad
    placement) shared by dist_amg and dist_amg_blocks."""
    pos = np.zeros(cmap.n_global, np.int64)
    for s in range(n_shards):
        lo, hi = cmap.shard_lo(s), cmap.shard_hi(s)
        pos[lo:hi] = s * cmap.n_local_pad + np.arange(hi - lo)
    cinv = np.linalg.pinv(acc, rcond=1e-12)  # semidefinite-safe
    nc = cmap.n_global
    coarse_inv = jnp.asarray(
        np.broadcast_to(cinv, (n_shards, nc, nc)).copy(), dtype=dtype)
    coarse_pos = jnp.asarray(
        np.broadcast_to(pos, (n_shards, nc)).copy().astype(np.int32))
    return coarse_inv, coarse_pos


def _coarse_dense_inv(a_c_blocks, cmap: Map, n_shards: int, dtype):
    """Coarse inverse from row-sharded blocks (the only all-gather of
    the distributed setup): assemble the dense accumulator, then the
    shared logical-space construction."""
    acc = np.zeros((cmap.n_global, cmap.n_global))
    for s in range(n_shards):
        blk = a_c_blocks[s]
        lo = cmap.shard_lo(s)
        rows = np.repeat(np.arange(blk.shape[0], dtype=np.int64),
                         blk.row_lengths()) + lo
        np.add.at(acc, (rows, blk.cols.astype(np.int64)), blk.vals)
    return _coarse_inv_from_dense(acc, cmap, n_shards, dtype)


def dist_amg_blocks(blocks, rmap: Map, *, max_levels: int = 10,
                    coarse_max: int = 64, min_agg: int = 2,
                    sa_damping: float = 4.0 / 3.0, sweeps: int = 2,
                    omega: float = 0.8, cycle: str = "V",
                    dtype=None) -> DistPrecond:
    """Distributed smoothed-aggregation AMG with a DISTRIBUTED setup.

    Unlike :func:`dist_amg` (whose setup assembles the global matrix on
    one host), every setup step here runs over row-sharded per-shard
    blocks — uncoupled aggregation, distributed SpGEMM for the smoothed
    P, distributed RAP for every Galerkin coarse level
    (parallel/dist_setup.py ≈ TpetraExt::TripleMatrixMultiply +
    MueLu::Hierarchy::Setup,
    core/ext/TpetraExt_TripleMatrixMultiply_decl.hpp:1,
    muelu/src/MueCentral/MueLu_Hierarchy_decl.hpp:103). Per-shard setup
    memory is O(nnz/P + ghosts); only the ≤``coarse_max``-row coarsest
    operator is replicated (dense pinv). The V/W-cycle apply is the same
    compiled shard_map program as :func:`dist_amg`."""
    from .dist_setup import build_dist_hierarchy, transpose_blocks
    from .distmatrix import distribute_blocks, distribute_rect_blocks

    dtype = dtype or blocks[0].vals.dtype
    n_shards = rmap.n_shards
    host_levels, a_c_blocks, cmap = build_dist_hierarchy(
        blocks, rmap, max_levels=max_levels, coarse_max=coarse_max,
        min_agg=min_agg, damping=sa_damping)

    levels = []
    for (a_bl, a_map, p_bl, c_map, d_bl) in host_levels:
        a_dm = distribute_blocks(a_bl, a_map, dtype=dtype)
        p_dm = distribute_rect_blocks(p_bl, a_map, c_map, dtype=dtype)
        r_bl = transpose_blocks(p_bl, a_map, c_map)
        r_dm = distribute_rect_blocks(r_bl, c_map, a_map, dtype=dtype)
        stacked = np.ones(a_map.n_global_pad)
        for s in range(n_shards):
            dinv_s = 1.0 / np.where(d_bl[s] != 0, d_bl[s], 1.0)
            lo = s * a_map.n_local_pad
            stacked[lo:lo + len(dinv_s)] = dinv_s
        dinv = jnp.asarray(
            stacked.reshape(n_shards, a_map.n_local_pad), dtype=dtype)
        levels.append(dict(a=a_dm, p=p_dm, r=r_dm, dinv=dinv))

    coarse_inv, coarse_pos = _coarse_dense_inv(a_c_blocks, cmap,
                                               n_shards, dtype)
    gamma = 2 if cycle == "W" else 1
    return DistPrecond(
        arrays={"levels": levels, "coarse_inv": coarse_inv,
                "coarse_pos": coarse_pos},
        kind="amg",
        consts=(int(sweeps), float(omega), gamma, cmap.n_local_pad))


def dist_amg_structured(op, n_shards: int, *, sweeps: int = 2,
                        omega: float = 0.8, cycle: str = "V",
                        dtype=None, **amg_params) -> DistPrecond:
    """Distributed STRUCTURED-aggregation AMG for a global StencilOp
    over z-slab shards — the gather-free hierarchy of precond/amg.py
    made multi-chip:

      * level 0 is distributed: the DistStencil apply (whole-plane halo
        exchange + local stencil kernel) carries smoothing, residual and
        the smoothed-transfer A-applies; the tentative block-sum /
        broadcast is LOCAL per shard (z aggregation pairs whole planes,
        so a slab with an even plane count never crosses a shard cut);
      * levels 1+ are REPLICATED: after the local restrict, one tiled
        all_gather assembles the (already small) coarse residual and
        every shard runs the same exact-classified inner V-cycle
        redundantly — the standard coarse-agglomeration trade (MueLu's
        repartitioning onto fewer ranks, muelu/src/Rebalancing/, taken
        to its limit: zero further collectives).

    Comm per V-cycle: 2·sweeps + 3 plane exchanges + 1 all_gather.
    Requires nz divisible by n_shards with nz/n_shards even (when the
    z axis coarsens). The hierarchy itself is the single-chip SaAmg's
    (same iteration counts as the single-device preconditioner).
    """
    from ..ops.stencil import StencilOp
    from ..precond.amg import SaAmg
    from .distmatrix import distribute_stencil

    if not isinstance(op, StencilOp):
        raise TypeError("dist_amg_structured expects a global StencilOp")
    dtype = dtype or np.dtype(op.dtype)
    m = SaAmg(op, dict({"smoother: sweeps": sweeps,
                        "smoother: damping factor": omega,
                        "cycle type": cycle, "dtype": dtype},
                       **amg_params)).compute()
    if not m.levels:
        raise ValueError(
            "dist_amg_structured: the hierarchy has no levels (problem "
            "size <= 'coarse: max size') — a distributed V-cycle is "
            "meaningless; solve directly or lower coarse: max size")
    fine = m.levels[0]
    nx, ny, nz = fine["dims"]
    bx, by, bz = fine["block"]
    nzl = nz // n_shards
    if bz == 2 and nzl % 2:
        raise ValueError(
            f"dist_amg_structured: nz/n_shards = {nzl} must be even so "
            "z-plane aggregation stays shard-local")
    ds = distribute_stencil(op, n_shards)
    d0 = dict(zip(map(tuple, op.offsets), op.coeffs))[(0, 0, 0)]

    # inner (replicated) levels: broadcast each coarse level's arrays
    # across the shard axis (they are small — the fine level is the one
    # that matters and it is matrix-free)
    def bcast(t):
        return jax.tree_util.tree_map(
            lambda l: jnp.broadcast_to(
                l, (n_shards,) + l.shape).copy(), t)

    inner_arrays = [dict(a=bcast(lvl["a"]), dinv=bcast(lvl["dinv"]))
                    for lvl in m.levels[1:]]
    inner_meta = tuple(
        (lvl["dims"], lvl["block"], float(lvl["omega"]),
         int(lvl["n_c"]), int(lvl["n_c_log"]))
        for lvl in m.levels[1:])
    n_c1_pad = fine["n_c"]          # padded global coarse length
    n_c1_log = fine["n_c_log"]
    gamma = 2 if cycle == "W" else 1
    fine_meta = (fine["dims"], fine["block"], float(fine["omega"]),
                 float(1.0 / d0), int(nzl), int(n_c1_pad),
                 int(n_c1_log))
    return DistPrecond(
        arrays={"plan": ds.plan, "sel": ds.sel, "valid": ds.valid,
                "inner": inner_arrays, "coarse_inv": bcast(m.coarse_inv)},
        kind="amg_structured",
        consts=(int(sweeps), float(omega), gamma, ds.op_local,
                int(ds.depth), fine_meta, inner_meta))


def dist_schwarz(a: CsrHost, rmap: Map, *, overlap: int = 1,
                 sweeps: int = 6, combine: str = "ZERO",
                 dtype=None) -> DistPrecond:
    """Distributed (restricted) additive Schwarz with ILU(0) subdomain
    solves.

    Each shard's subdomain = its owned rows plus ``overlap`` layers of
    graph neighbors (the reference's OverlappingRowMatrix built via
    Import, ifpack2/src/Ifpack2_OverlappingRowMatrix_decl.hpp;
    Ifpack2_AdditiveSchwarz_decl.hpp). A second halo plan gathers the
    residual on the overlap rows; the subdomain ILU(0) applies with fixed
    Jacobi sweeps (FastILU strategy); combine='ZERO' is restricted AS
    (discard overlap contributions), 'ADD' is classical AS via
    export_combine.
    """
    from ..ops.formats import csr_to_ell
    from ..precond.ilu import ilu0_factor
    from .distmatrix import build_halo_plans, stack_shards

    dtype = dtype or a.vals.dtype
    n_shards = rmap.n_shards
    npl = rmap.n_local_pad
    n = a.shape[0]
    rows_all = np.repeat(np.arange(n, dtype=np.int64), a.row_lengths())

    # --- overlap rows per shard: BFS `overlap` layers out ---------------
    ghosts_of = []
    for s in range(n_shards):
        lo, hi = rmap.shard_lo(s), rmap.shard_hi(s)
        in_sub = np.zeros(n, dtype=bool)
        in_sub[lo:hi] = True
        frontier = np.arange(lo, hi)
        for _ in range(overlap):
            if not len(frontier):
                break
            sel = np.zeros(n, dtype=bool)
            sel[frontier] = True
            cols = a.cols[sel[rows_all]]
            new = np.unique(cols.astype(np.int64))
            new = new[~in_sub[new]]
            in_sub[new] = True
            frontier = new
        ovl = np.where(in_sub)[0]
        ovl = ovl[(ovl < lo) | (ovl >= hi)]
        owners = rmap.owner_of(ovl)
        order = np.lexsort((ovl, owners))
        ghosts_of.append(ovl[order])

    plans, _ = build_halo_plans(ghosts_of, rmap, n_shards)
    g_pad = plans[0].n_ghost_pad
    ntot = npl + g_pad

    # --- per-shard overlapped subdomain matrix + ILU(0) -----------------
    shards = []
    for s in range(n_shards):
        lo, hi = rmap.shard_lo(s), rmap.shard_hi(s)
        ovl = ghosts_of[s]
        # local index of each global id inside the subdomain (-1 = out)
        lidx = np.full(n, -1, dtype=np.int64)
        lidx[lo:hi] = np.arange(hi - lo)
        lidx[ovl] = npl + np.arange(len(ovl))
        sub_rows = np.concatenate([np.arange(lo, hi), ovl])
        sel = np.zeros(n, dtype=bool)
        sel[sub_rows] = True
        mask = sel[rows_all]
        rs_g = rows_all[mask]
        cs_g = a.cols[mask].astype(np.int64)
        vs_g = a.vals[mask]
        keep = lidx[cs_g] >= 0
        rs2 = lidx[rs_g[keep]]
        cs2 = lidx[cs_g[keep]]
        vs2 = vs_g[keep]
        # identity rows on padding slots keep the factorization regular
        present = np.zeros(ntot, dtype=bool)
        present[rs2] = True
        pad_rows = np.where(~present)[0]
        sub = CsrHost.from_coo(
            np.concatenate([rs2, pad_rows]),
            np.concatenate([cs2, pad_rows]),
            np.concatenate([vs2, np.ones(len(pad_rows),
                                         dtype=a.vals.dtype)]),
            (ntot, ntot))
        shards.append(ilu0_factor(sub))

    kl = max(max(l.max_row_length() for l, _ in shards), 1)
    ku = max(max(u.max_row_length() for _, u in shards), 1)
    l_cols, l_vals, u_cols, u_vals, udinvs = [], [], [], [], []
    for l_m, u_m in shards:
        le = csr_to_ell(l_m, dtype=dtype, k=kl, n_rows_pad=ntot)
        ue = csr_to_ell(u_m, dtype=dtype, k=ku, n_rows_pad=ntot)
        l_cols.append(le.cols)
        l_vals.append(le.vals)
        u_cols.append(ue.cols)
        u_vals.append(ue.vals)
        du = u_m.diagonal().astype(np.float64)
        dv = np.ones(ntot)
        dv[: len(du)] = 1.0 / np.where(du != 0, du, 1.0)
        udinvs.append(jnp.asarray(dv, dtype=dtype))
    arrays = {
        "l_cols": jnp.stack(l_cols), "l_vals": jnp.stack(l_vals),
        "u_cols": jnp.stack(u_cols), "u_vals": jnp.stack(u_vals),
        "udinv": jnp.stack(udinvs), "plan": stack_shards(plans),
    }
    return DistPrecond(arrays=arrays, kind="schwarz",
                       consts=(int(sweeps), combine.upper(), npl))


# ---------------------------------------------------------------------------
# global entry points
# ---------------------------------------------------------------------------


def dist_spmv(a: DistMatrix, x: jax.Array, mesh: Mesh) -> jax.Array:
    """Global distributed SpMV on a padded sharded vector. Accepts a
    1-axis ('rows',) or multi-level ('dcn','rows') mesh."""
    n_shards = a.row_map.n_shards
    axes = solve_axes(mesh)
    vec_spec = P(axes) if x.ndim == 1 else P(axes, None)

    @functools.partial(jax.shard_map, mesh=mesh,
                       in_specs=(P(axes), vec_spec), out_specs=vec_spec)
    def run(a_sh, x_loc):
        al = unstack_local(a_sh)
        return _local_op(al, n_shards, axes)(x_loc)

    return run(a, x)


def dist_spmv_t(a: DistMatrix, x: jax.Array, mesh: Mesh) -> jax.Array:
    """Global distributed TRANSPOSE SpMV y = Aᵀx (Tpetra's
    ``apply(X, Y, Teuchos::TRANS)``): local Aᵀ scatter into the extended
    column space + Export-ADD of ghost-column contributions over the
    reversed Import plan."""
    n_shards = a.row_map.n_shards
    axes = solve_axes(mesh)
    vec_spec = P(axes) if x.ndim == 1 else P(axes, None)

    @functools.partial(jax.shard_map, mesh=mesh,
                       in_specs=(P(axes), vec_spec), out_specs=vec_spec)
    def run(a_sh, x_loc):
        al = unstack_local(a_sh)
        return _local_op_t(al, n_shards, axes)(x_loc)

    return run(a, x)


def dist_lsqr(a: DistMatrix, b: jax.Array, x0: jax.Array | None = None, *,
              mesh: Mesh, **solver_kw) -> SolveResult:
    """Distributed LSQR (Golub–Kahan bidiagonalization needs BOTH A and
    Aᵀ applies — the reference's Belos::LSQRSolMgr over a Tpetra operator
    with transpose support). One jitted program: forward halo-exchange
    apply + reverse Export-ADD transpose apply + psum reductions."""
    from ..solvers.lsqr import lsqr

    n_shards = a.row_map.n_shards
    axes = solve_axes(mesh)
    vec_spec = P(axes) if b.ndim == 1 else P(axes, None)
    x0 = jnp.zeros_like(b) if x0 is None else x0
    scal_spec = P()

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(axes), vec_spec, vec_spec),
        out_specs=SolveResult(x=vec_spec, iters=scal_spec,
                              resnorm=scal_spec, converged=scal_spec))
    def run(a_sh, b_loc, x0_loc):
        al = unstack_local(a_sh)
        comm = AxisComm(axes, n_shards)
        return lsqr(_local_op(al, n_shards, axes),
                    _local_op_t(al, n_shards, axes),
                    b_loc, x0=x0_loc, comm=comm, **solver_kw)

    return run(a, b, x0)


def dist_solve(solver: Callable, a: DistMatrix, b: jax.Array,
               x0: jax.Array | None = None, *, mesh: Mesh,
               prec: DistPrecond | None = None, **solver_kw) -> SolveResult:
    """Run any Krylov driver from ``trilinos_tpu.solvers`` over the mesh.

    ``b`` (and optional ``x0``) are padded sharded vectors
    (row_map.n_global_pad long). The whole solve — operator applies, halo
    exchanges, reductions — is ONE jitted program over the mesh.
    """
    n_shards = a.row_map.n_shards
    prec = prec or identity_precond()
    axes = solve_axes(mesh)
    vec_spec = P(axes) if b.ndim == 1 else P(axes, None)
    x0 = jnp.zeros_like(b) if x0 is None else x0
    scal_spec = P()
    # cg(condest_window=N) / gmres(condest=True) add a replicated
    # condest leaf to the result pytree (computed from psum'd
    # coefficients — identical per shard)
    ce_spec = (scal_spec if solver_kw.get("condest_window")
               or solver_kw.get("condest") else None)
    hist_spec = P() if solver_kw.get("history") else None

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(axes), vec_spec, vec_spec, P(axes)),
        out_specs=SolveResult(x=vec_spec, iters=scal_spec,
                              resnorm=scal_spec, converged=scal_spec,
                              condest=ce_spec, history=hist_spec))
    def run(a_sh, b_loc, x0_loc, prec_sh):
        al = unstack_local(a_sh)
        comm = AxisComm(axes, n_shards)
        op = _local_op(al, n_shards, axes)
        prec_local = DistPrecond(arrays=prec_sh, kind=prec.kind,
                                 consts=prec.consts)
        m = prec_local.make(comm, op)
        return solver(op, b_loc, x0=x0_loc, prec=m, comm=comm, **solver_kw)

    return run(a, b, x0, prec.arrays)


def dist_sstep_gmres(op, b: jax.Array, *, mesh: Mesh, s: int = 4,
                     t_blocks: int = 8, max_restarts: int = 20,
                     rtol: float = 1e-8, atol: float = 0.0,
                     sigma: float | None = None,
                     basis: str = "fused",
                     shifts=None, basis_dtype=None) -> SolveResult:
    """Communication-avoiding distributed s-step GMRES on a global
    matrix-free StencilOp over z-slabs — the full CA-GMRES kernel
    (Hoemmen/Demmel): the matrix-powers block W = [Aq/σ … A^s q/σ^s] is
    generated from ONE depth-(s·z_reach) halo exchange feeding the
    all-output polynomial apply (stencil_powers_xla), so a block step
    costs ONE exchange + 4 reductions (block CGS2 + CholQR2) versus s
    exchanges + ~3s reductions for standard Arnoldi.

    The per-shard traced z-bounds keep beyond-global-boundary ghost
    planes masked at EVERY stage while interior shard cuts read real
    halo data (the same invariant as ``dist_cheb_fused``). Reference
    anchor: Belos_Tpetra_GmresSstep.hpp:305, whose matrix-powers loop
    pays a full import (exchange) per apply.

    basis='fused' is the one-exchange basis above; basis='loop' is the
    baseline with one exchange per apply.
    """
    from ..ops.matvec import spmv as _spmv
    from ..ops.stencil import (StencilOp, monomial_stages,
                               stencil_powers_xla)
    from ..solvers.sstep_gmres import (estimate_opnorm,
                                       newton_basis_stages, sstep_gmres)
    from .distmatrix import (distribute_stencil, gather_extended,
                             zslab_bounds)

    if not isinstance(op, StencilOp):
        raise TypeError("dist_sstep_gmres expects a global StencilOp")
    n_shards = int(mesh.devices.size)

    if sigma is None:
        # host-side ‖A‖ estimate on the global operator — the SAME
        # estimator sstep_gmres uses, so iteration counts are
        # comparable across drivers
        sigma = estimate_opnorm(lambda v: _spmv(op, v), op.n_rows_pad,
                                b.dtype)

    z_reach = max(max((abs(o[2]) for o in op.offsets), default=0), 1)
    # the loop baseline exchanges once PER APPLY, so it only needs
    # single-apply halo depth — a depth-(s·reach) plan would inflate its
    # per-exchange bytes s-fold and overstate the fused path's advantage
    depth = (s * z_reach) if basis != "loop" else z_reach
    ds = distribute_stencil(op, n_shards, depth=depth)
    pxy = op.dims[0] * op.dims[1]
    zb = jnp.asarray(zslab_bounds(op, n_shards, depth))
    if shifts is not None:
        stages = tuple((a, bt, g, 0.0)
                       for a, bt, g in newton_basis_stages(shifts, sigma))
    else:
        stages = monomial_stages(s, sigma)
    off = depth * pxy
    npl = ds.row_map.n_local_pad
    vec_spec = P(AXIS)
    scal_spec = P()

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), vec_spec),
        out_specs=SolveResult(x=vec_spec, iters=scal_spec,
                              resnorm=scal_spec, converged=scal_spec,
                              condest=None))
    def run(ds_sh, zb_sh, b_loc):
        al = unstack_local(ds_sh)
        zbl = zb_sh[0]
        comm = AxisComm(AXIS, n_shards)
        op_loc = _local_op(al, n_shards)

        def powers_fn(q, sig):
            ext = gather_extended(al.sel, al.valid, al.plan, q, AXIS,
                                  n_shards)
            u = stencil_powers_xla(al.op_local, stages, ext,
                                   z_bounds=zbl)
            return u[:, off:off + npl].T          # (npl, s)

        return sstep_gmres(
            op_loc, b_loc, s=s, t_blocks=t_blocks,
            max_restarts=max_restarts, rtol=rtol, atol=atol,
            sigma=sigma, comm=comm, shifts=shifts,
            powers_fn=None if basis == "loop" else powers_fn,
            basis_dtype=basis_dtype)

    return run(ds, zb, b)


# ---------------------------------------------------------------------------
# Global-view distributed operators + eigen (the Anasazi-over-Tpetra role)
# ---------------------------------------------------------------------------

def global_operator(a, mesh: Mesh) -> Callable:
    """Global-view distributed apply: returns ``op(x) -> Ax`` where x is a
    GLOBAL padded array (``row_map.n_global_pad`` rows, 1-D or (n, k)).

    This is the Tpetra ``Operator::apply`` seen from the caller's side
    (Tpetra_Operator.hpp): one jitted shard_map program (halo exchange +
    interior/boundary split SpMV) per call; XLA/GSPMD keeps the result
    row-sharded, so chains of applies and reductions on the returned
    arrays stay distributed. Works for DistMatrix and DistStencil.
    The matrix rides as a jit ARGUMENT (never a closure — large closures
    break remote compile)."""
    n_shards = a.row_map.n_shards if not isinstance(a, DistStencil) else \
        int(mesh.devices.size)

    @jax.jit
    def apply(a_, x):
        vec_spec = P(AXIS) if x.ndim == 1 else P(AXIS, None)

        @functools.partial(jax.shard_map, mesh=mesh,
                           in_specs=(P(AXIS), vec_spec), out_specs=vec_spec)
        def run(a_sh, x_loc):
            al = unstack_local(a_sh)
            return _local_op(al, n_shards)(x_loc)

        return run(a_, x)

    return lambda x: apply(a, x)


def global_precond(prec: DistPrecond, a, mesh: Mesh) -> Callable:
    """Global-view apply of a DistPrecond (see ``global_operator``):
    ``m(r)`` takes/returns global padded arrays, computed as one jitted
    shard_map program."""
    n_shards = a.row_map.n_shards

    @jax.jit
    def apply(a_, parrs, x):
        vec_spec = P(AXIS) if x.ndim == 1 else P(AXIS, None)

        @functools.partial(
            jax.shard_map, mesh=mesh,
            in_specs=(P(AXIS), P(AXIS), vec_spec), out_specs=vec_spec)
        def run(a_sh, p_sh, x_loc):
            al = unstack_local(a_sh)
            comm = AxisComm(AXIS, n_shards)
            op = _local_op(al, n_shards)
            m = DistPrecond(arrays=p_sh, kind=prec.kind,
                            consts=prec.consts).make(comm, op)
            return m(x_loc)

        return run(a_, parrs, x)

    return lambda x: apply(a, prec.arrays, x)


_EIG_V0_WIDTH = {
    # solver name -> start-block width (0 = single 1-D start vector)
    "lobpcg": lambda nev, kw: nev,
    "tracemin": lambda nev, kw: kw.get("block") or nev + 2,
    "rtr": lambda nev, kw: kw.get("block") or nev,
    "block_davidson": lambda nev, kw: kw.get("nb") or nev,
    "generalized_davidson": lambda nev, kw: kw.get("nb") or nev,
    "block_krylov_schur": lambda nev, kw: kw.get("nb") or 1,
    "lanczos_eigs": lambda nev, kw: 0,
    "arnoldi": lambda nev, kw: 0,
    "power_method": lambda nev, kw: 0,
}


def dist_eigsolve(eigsolver: Callable, a: DistMatrix, nev: int, *,
                  mesh: Mesh, v0: np.ndarray | None = None,
                  prec: DistPrecond | None = None, seed: int = 7,
                  mass_matrix: DistMatrix | None = None, **kw):
    """Run any eigensolver from ``trilinos_tpu.eigen`` on a DistMatrix —
    the reference's Anasazi-over-Tpetra stack (every Anasazi SolMgr is
    MPI-distributed through MultiVecTraits; AnasaziTpetraAdapter.hpp).

    JAX-native form: GLOBAL-VIEW rather than per-shard. Multivectors are
    row-sharded global arrays; the operator apply is one jitted shard_map
    program (``global_operator``); every solver-side einsum/norm on those
    arrays is partitioned by GSPMD. This covers both fully-jitted solvers
    (lobpcg's while_loop compiles to ONE sharded program) and solvers
    with host-orchestrated restarts (block_krylov_schur's ordschur on the
    projected Hessenberg — small replicated host work between sharded
    device steps, exactly the reference's rank-replicated LAPACK calls).

    Padding: pad rows/cols of a distributed matrix are zero (decoupled),
    so the zero-pad subspace is A-invariant; v0 is built (or padded) with
    ZERO pad rows, hence no iterate ever leaves the true-matrix subspace
    and the computed spectrum is exactly the unpadded matrix's.

    ``v0`` is an UNPADDED host array ((n,) or (n, w)); returns the
    solver's result with eigenvectors in the padded global layout
    (recover host order via ``a.row_map.from_padded``).
    """
    import inspect

    from jax.sharding import NamedSharding

    rmap = a.row_map
    dtype = kw.get("dtype", jnp.float64)
    params = list(inspect.signature(eigsolver).parameters)
    if "dtype" not in params:  # lobpcg/lanczos infer dtype from v0
        kw.pop("dtype", None)
    name = getattr(eigsolver, "__name__", "")
    width = _EIG_V0_WIDTH.get(name, lambda nev, kw: nev)(nev, kw)
    if v0 is None:
        rng = np.random.default_rng(seed)
        shape = (rmap.n_global,) if width == 0 else (rmap.n_global, width)
        v0 = rng.standard_normal(shape)
    v0p = rmap.to_padded(np.asarray(v0, dtype=np.dtype(jnp.dtype(dtype))))
    spec = P(AXIS) if v0p.ndim == 1 else P(AXIS, None)
    v0j = jax.device_put(v0p, NamedSharding(mesh, spec))

    op = global_operator(a, mesh)
    if prec is not None:
        kw["prec"] = global_precond(prec, a, mesh)
    if mass_matrix is not None:
        # GENERALIZED pencil A x = λ M x over the mesh: the mass apply is
        # its own jitted shard_map program (AnasaziBasicEigenproblem
        # setM, AnasaziBasicEigenproblem.hpp:60). Solvers spell the
        # operator 'mass' (krylov_schur, where m is the basis size) or
        # 'm' (lobpcg/tracemin, matching scipy.eigsh's M) — binding by
        # name alone would hand the operator to e.g. lanczos_eigs's
        # integer basis-length 'm', so the 'm'-means-mass solvers are
        # an explicit whitelist and everything else raises.
        mop = global_operator(mass_matrix, mesh)
        if "mass" in params:
            kw["mass"] = mop
        elif name in ("lobpcg", "tracemin", "block_davidson",
                      "generalized_davidson", "rtr"):
            kw["m"] = mop
        else:
            raise ValueError(
                f"{name or eigsolver!r} does not support a mass matrix; "
                "use lobpcg, tracemin, block_davidson, "
                "generalized_davidson, rtr, or block_krylov_schur for "
                "generalized pencils")

    if len(params) > 1 and params[1] == "n":
        # (op, n, nev, ..., v0=) family: davidson/krylov_schur/tracemin/rtr
        return eigsolver(op, rmap.n_global_pad, nev, v0=v0j, **kw)
    if "nev" in params:  # lanczos_eigs(op, v0, nev, ...)
        return eigsolver(op, v0j, nev, **kw)
    return eigsolver(op, v0j, **kw)  # lobpcg / power_method / arnoldi
