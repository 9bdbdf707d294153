"""Structured multi-dimensional distributed arrays (the Domi analogue).

Reference: packages/domi/src — Domi_MDComm.hpp (d-dimensional process
grid), Domi_MDMap.hpp (global dims split per axis, communication
padding = halo widths, periodic flags), Domi_MDVector.hpp (field data
on an MDMap; ``updateCommPad()`` performs the ghost exchange per axis;
``getLowerPad/getUpperPad``), Domi_Slice.hpp.

Accelerator-first design: an MDMap is a declarative layout — global shape, the
jax mesh axis each array axis is split over (None = local), halo width
and periodicity per axis. The MDComm is the ``jax.sharding.Mesh``
itself. ``updateCommPad`` becomes ``halo_pad``: a pure function used
INSIDE ``jax.shard_map`` that grows each local block by its ghost
slabs with one ``lax.ppermute`` pair per split axis (axis-by-axis
padding makes corner ghosts correct, the standard dimension-sweep
halo); non-periodic edges receive zeros (ppermute's no-source fill),
matching Dirichlet-style padding. ``md_map_apply`` wraps a user
stencil kernel into a jitted global function over the mesh — the
N-dimensional generalization of the framework's 1-D row-sharded
DistStencil interior.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec


@dataclasses.dataclass(frozen=True)
class MDMap:
    """Layout descriptor for a structured distributed array.

    global_shape: global extents per axis.
    mesh_axes:    jax mesh axis name the array axis is split over, or
                  None for a local (replicated-extent) axis.
    halo:         ghost width per axis (used by ``halo_pad``).
    periodic:     per-axis periodic wraparound of the ghost exchange.
    """
    global_shape: tuple
    mesh_axes: tuple
    halo: tuple = ()
    periodic: tuple = ()

    def __post_init__(self):
        nd = len(self.global_shape)
        if len(self.mesh_axes) != nd:
            raise ValueError("mesh_axes length != ndim")
        object.__setattr__(self, "halo",
                           tuple(self.halo) or (0,) * nd)
        object.__setattr__(self, "periodic",
                           tuple(self.periodic) or (False,) * nd)
        if len(self.halo) != nd or len(self.periodic) != nd:
            raise ValueError("halo/periodic length != ndim")

    def spec(self) -> PartitionSpec:
        return PartitionSpec(*self.mesh_axes)

    def sharding(self, mesh: Mesh) -> NamedSharding:
        return NamedSharding(mesh, self.spec())

    def local_shape(self, mesh: Mesh) -> tuple:
        out = []
        for dim, ax in zip(self.global_shape, self.mesh_axes):
            if ax is None:
                out.append(dim)
            else:
                n = mesh.shape[ax]
                if dim % n:
                    raise ValueError(
                        f"global extent {dim} not divisible by mesh "
                        f"axis {ax!r} size {n}")
                out.append(dim // n)
        return tuple(out)

    def distribute(self, arr, mesh: Mesh):
        """Place a host/global array onto the mesh with this layout
        (the MDVector constructor)."""
        arr = jnp.asarray(arr)
        if arr.shape != tuple(self.global_shape):
            raise ValueError(
                f"array shape {arr.shape} != global_shape "
                f"{tuple(self.global_shape)}")
        self.local_shape(mesh)  # validates divisibility
        return jax.device_put(arr, self.sharding(mesh))


def _pad_axis(u, axis, w, mesh_axis, periodic, axis_size):
    """Grow ``u`` (a local block inside shard_map) by w ghost cells on
    both ends of ``axis`` via one ppermute pair (or local wrap/zero pad
    for unsplit axes)."""
    if w == 0:
        return u
    if mesh_axis is None:
        mode = "wrap" if periodic else "constant"
        cfg = [(0, 0)] * u.ndim
        cfg[axis] = (w, w)
        return jnp.pad(u, cfg, mode=mode)

    lo_slab = lax.slice_in_dim(u, 0, w, axis=axis)
    hi_slab = lax.slice_in_dim(u, u.shape[axis] - w, u.shape[axis],
                               axis=axis)
    if periodic:
        fwd = [(i, (i + 1) % axis_size) for i in range(axis_size)]
        bwd = [(i, (i - 1) % axis_size) for i in range(axis_size)]
    else:
        fwd = [(i, i + 1) for i in range(axis_size - 1)]
        bwd = [(i + 1, i) for i in range(axis_size - 1)]
    # neighbor below sends its top slab -> our lower ghosts; ranks with
    # no source receive zeros (the non-periodic boundary fill)
    lo_ghost = lax.ppermute(hi_slab, mesh_axis, fwd)
    hi_ghost = lax.ppermute(lo_slab, mesh_axis, bwd)
    return jnp.concatenate([lo_ghost, u, hi_ghost], axis=axis)


def halo_pad(u, mdmap: MDMap, mesh: Mesh):
    """updateCommPad(): pad a LOCAL block (inside shard_map) with ghost
    slabs on every axis with halo > 0. Axis-by-axis sweep (already-
    padded slabs are exchanged by later axes, so corner ghosts are
    populated correctly)."""
    for axis in range(u.ndim):
        ax = mdmap.mesh_axes[axis]
        size = mesh.shape[ax] if ax is not None else 1
        u = _pad_axis(u, axis, mdmap.halo[axis], ax,
                      mdmap.periodic[axis], size)
    return u


def md_map_apply(mdmap: MDMap, mesh: Mesh, local_fn):
    """Build a jitted global function: shard by ``mdmap``, halo-pad
    each block, apply ``local_fn(padded_block) -> block`` (which must
    shrink the pad back, e.g. a stencil valid-region apply), reassemble
    the global array. The Domi MDVector compute idiom."""
    spec = mdmap.spec()

    @jax.jit
    @functools.partial(jax.shard_map, mesh=mesh, in_specs=(spec,),
                       out_specs=spec)
    def run(u):
        return local_fn(halo_pad(u, mdmap, mesh))

    return run


def md_solve(solver, mdmap: MDMap, mesh: Mesh, local_fn, b,
             prec_local=None, **solver_kw):
    """Run any Krylov driver from ``trilinos_tpu.solvers`` on a field
    sharded over the N-D process grid: the operator is
    ``local_fn(halo_padded_block) -> block`` (a stencil valid-region
    apply), reductions are one psum over ALL mesh axes (lax.psum takes
    the axis-name tuple), and the whole solve is ONE jitted shard_map
    program — the N-dimensional generalization of the 1-D row-sharded
    ``driver.dist_solve``. ``prec_local`` optionally preconditions with
    a per-shard block->block function (e.g. ``md_poly_local`` — the CA
    fused Chebyshev smoother). Returns a SolveResult whose ``x`` is the
    global (mdmap.global_shape) array."""
    import dataclasses as _dc
    import functools as _ft

    from .comm import AxisComm

    spec = mdmap.spec()
    axes = tuple(mesh.axis_names)
    n_total = int(np.prod([mesh.shape[a] for a in axes]))
    b_sh = mdmap.distribute(b, mesh)
    scal = PartitionSpec()

    @jax.jit
    @_ft.partial(jax.shard_map, mesh=mesh, in_specs=(spec,),
                 out_specs=_result_specs(spec, scal))
    def run(b_loc):
        comm = AxisComm(axes, n_total)
        shape = b_loc.shape

        def op(v):
            return local_fn(halo_pad(v.reshape(shape), mdmap,
                                     mesh)).reshape(-1)

        kw = dict(solver_kw)
        if prec_local is not None:
            if "prec" in kw:
                raise ValueError(
                    "pass either prec_local (block form) or prec "
                    "(flat form), not both")
            kw["prec"] = lambda v: prec_local(
                v.reshape(shape)).reshape(-1)
        res = solver(op, b_loc.reshape(-1), comm=comm, **kw)
        return _dc.replace(res, x=res.x.reshape(shape))

    return run(b_sh)


def _result_specs(vec_spec, scal_spec):
    from ..solvers.base import SolveResult

    return SolveResult(x=vec_spec, iters=scal_spec, resnorm=scal_spec,
                       converged=scal_spec)


def _center_crop(u, widths):
    sl = tuple(slice(w, d - w) for w, d in zip(widths, u.shape))
    return u[sl]


def md_poly_apply(mdmap: MDMap, mesh: Mesh, stage_apply, stages,
                  reach: int = 1):
    """Communication-avoiding polynomial sweep on an MD-sharded field:
    ONE halo exchange of depth s*reach feeds the whole three-term
    recurrence

        u_0 = x;  u_j = a_j*(A u_{j-1}) + b_j*u_{j-1} + g_j*u_{j-2}
                        + z_j*x

    computed locally on progressively shrinking pads (the N-D
    process-grid analogue of driver.dist_cheb_fused). ``stage_apply``
    maps a padded block to one shrunk by ``reach`` cells per side
    (a stencil valid-region apply); ``mdmap.halo`` must be
    len(stages)*reach on every axis with halo.

    Boundary treatment: a halo-padded ones-mask zeroes every
    beyond-global-boundary cell after each stage, so ghost regions
    beyond a non-periodic edge behave exactly like the truncated
    operator (interior shard cuts hold real neighbor data and pass
    through unmasked). Returns the jitted global function."""
    local = md_poly_local(mdmap, mesh, stage_apply, stages, reach)
    spec = mdmap.spec()

    @jax.jit
    @functools.partial(jax.shard_map, mesh=mesh, in_specs=(spec,),
                       out_specs=spec)
    def run(x):
        return local(x)

    return run


def md_poly_local(mdmap: MDMap, mesh: Mesh, stage_apply, stages,
                  reach: int = 1):
    """The per-shard body of ``md_poly_apply``: a pure function on
    LOCAL blocks for use INSIDE an enclosing shard_map (e.g. as a
    preconditioner in ``md_solve`` — the CA fused smoother composed
    with a distributed Krylov solve)."""
    s = len(stages)
    for ax, h in enumerate(mdmap.halo):
        if h and h != s * reach:
            raise ValueError(
                f"axis {ax}: halo {h} != len(stages)*reach "
                f"{s * reach}")
    local_shape = mdmap.local_shape(mesh)

    def _in_domain_mask():
        """Ones on in-domain cells of the padded ext block, zeros on
        ghost cells beyond a non-periodic global edge — pure index
        arithmetic from axis_index, NO communication (the data halo is
        the sweep's single exchange)."""
        m = None
        for ax in range(len(local_shape)):
            h, per = mdmap.halo[ax], mdmap.periodic[ax]
            dim = local_shape[ax] + 2 * h
            if h == 0 or per:
                continue
            name = mdmap.mesh_axes[ax]
            if name is None:
                gpos = jnp.arange(dim) - h
                gdim = mdmap.global_shape[ax]
            else:
                gpos = (lax.axis_index(name) * local_shape[ax]
                        + jnp.arange(dim) - h)
                gdim = mdmap.global_shape[ax]
            ok = jnp.logical_and(gpos >= 0, gpos < gdim)
            shape = [1] * len(local_shape)
            shape[ax] = dim
            ok = ok.reshape(shape)
            m = ok if m is None else jnp.logical_and(m, ok)
        return m

    def run(x):
        ext = halo_pad(x, mdmap, mesh)
        dm = _in_domain_mask()
        mask = (None if dm is None
                else jnp.broadcast_to(dm, ext.shape).astype(x.dtype))
        crop = tuple(reach if h else 0 for h in mdmap.halo)

        def shrink(u, j):
            return _center_crop(u, tuple(j * c for c in crop))

        u_prev2 = jnp.zeros_like(ext)
        u_prev = ext
        for j, (a, b, g, z) in enumerate(stages, start=1):
            u = jnp.zeros_like(shrink(ext, j))
            if a:
                u = a * stage_apply(u_prev)
            if b:
                u = u + b * shrink(u_prev, 1)
            if g:
                u = u + g * shrink(u_prev2, 2 if j > 1 else 1)
            if z:
                u = u + z * shrink(ext, j)
            if mask is not None:     # fully periodic: nothing to mask
                u = u * shrink(mask, j)
            # keep each u_k at its natural pad (s-k)*reach: the g-term
            # two stages later crops by exactly 2
            u_prev2, u_prev = u_prev, u
        return u_prev

    return run


def md_dot(mesh: Mesh):
    """Global dot over MD-distributed fields (inside shard_map use
    lax.psum; at the jit level jnp.vdot on sharded arrays already
    inserts the collective — provided for the explicit per-shard
    path)."""
    axes = tuple(mesh.axis_names)

    def dot(a_local, b_local):
        return lax.psum(jnp.sum(a_local * b_local), axes)
    return dot
