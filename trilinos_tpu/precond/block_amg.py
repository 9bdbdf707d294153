"""Block-structured null-space AMG: fast elasticity multigrid on the accelerator.

The null-space-aware SA hierarchy (MueLu TentativePFactory with
rigid-body modes) with every gather removed — for PDE systems whose
NODES live on a structured grid (galeri.fem elasticity2d/3d):

  * node aggregation is structured 2×2×2 blocks, so the tentative
    prolongator's per-aggregate QR blocks form ONE batched (n_agg,
    8·b, k) tensor and its apply is 8 strided-slice/interleave passes
    + unrolled (b × k) multiply-adds — zero gathers, exact arithmetic
    (no reduced-precision matmul rounding on tiny contractions);
  * smoothed transfers cost one operator apply each
    (P = (I−ωD⁻¹A)P_t ⇒ Pᵀr = P_tᵀ(r − ωA(D⁻¹r)), A symmetric);
  * every level is EXACT host Galerkin (PᵀAP with the true smoothed P)
    packed as a BDIA block-stencil matrix — the block 27-neighbour
    pattern of a structured node grid keeps block offsets constant, so
    applies are the gather-free residue-plane multiply-adds
    (ops/matvec.py bdia_spmm);
  * coarse levels carry k dofs per aggregate-node (k = null-space
    dimension: 3 in 2-D, 6 in 3-D) and recurse with the coarse null
    space, stopping at a dense pseudo-inverse.

Reference analogue: MueLu SA on elasticity (TentativePFactory +
AmalgamationFactory + TripleMatrixMultiply), with the hierarchy's data
layout built from shifted dense planes instead of CRS gathers.
"""
from __future__ import annotations

import itertools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.blas import HI
from ..ops.formats import CsrHost, csr_to_bdia, round_up, ROW_ALIGN
from ..ops.matrix_ops import ptap
from ..ops.matvec import spmv
from ..utils.params import Param
from .amg import smooth_prolongator, tentative_prolongator_nullspace
from .base import Preconditioner

_SPECS = {
    "max levels": Param("max levels", 10),
    "coarse: max size": Param("coarse: max size", 512),
    "sa: damping factor": Param("sa: damping factor", 4.0 / 3.0),
    "smoother: sweeps": Param("smoother: sweeps", 2),
    "smoother: damping factor": Param("smoother: damping factor", 0.8),
    "cycle type": Param("cycle type", "V", choices=("V", "W")),
    "dtype": Param("dtype", None),
}


def _node_block(dims) -> tuple[int, int, int]:
    return tuple(2 if (d % 2 == 0 and d >= 4) else 1 for d in dims)


def _structured_node_agg(dims, block) -> np.ndarray:
    """Aggregate id per node, x-fastest like node gids."""
    n = int(np.prod(dims))
    idx = np.arange(n, dtype=np.int64)
    agg = np.zeros(n, dtype=np.int64)
    stride = 1
    rest = idx
    for d, bb in zip(dims, block):
        agg = agg + (rest % d) // bb * stride
        stride *= d // bb
        rest = rest // d
    return agg


def _positions(block):
    """Aggregate-local node positions, x-fastest."""
    return [p[::-1] for p in itertools.product(
        range(block[2]), range(block[1]), range(block[0]))]


def _extract_q(p_t: CsrHost, dims, block, b: int, k: int) -> np.ndarray:
    """Per-position tentative blocks Q[(pz,py,px)] as one
    (n_pos, n_agg, b, k) tensor, read off the CSR P_t (every dof row
    holds exactly its aggregate's k sorted columns)."""
    n_dofs = p_t.shape[0]
    assert int(p_t.row_ptr[-1]) == n_dofs * k
    qflat = np.asarray(p_t.vals, dtype=np.float64).reshape(n_dofs, k)
    nx, ny, nz = dims
    cdims = tuple(d // bb for d, bb in zip(dims, block))
    n_agg = int(np.prod(cdims))
    pos = _positions(block)
    q = np.zeros((len(pos), n_agg, b, k))
    cidx = np.arange(n_agg, dtype=np.int64)
    cx = cidx % cdims[0]
    cy = (cidx // cdims[0]) % cdims[1]
    cz = cidx // (cdims[0] * cdims[1])
    for pi, (px, py, pz) in enumerate(pos):
        node = ((block[0] * cx + px)
                + nx * ((block[1] * cy + py) + ny * (block[2] * cz + pz)))
        for i in range(b):
            q[pi, :, i, :] = qflat[b * node + i]
    return q


def _block_ns_transfers(a_dev, dims, block, b: int, k: int, q_dev,
                        omega: float, dinv, npad_f: int, npad_c: int):
    """Gather-free smoothed transfers for one block-structured level.

    q_dev: (n_pos, n_agg, b, k) tentative blocks (orthonormal columns
    per aggregate). The tentative apply interleaves per-position block
    products with strided slices / interior-dilation pads; the (b, k)
    contraction is UNROLLED into elementwise multiply-adds (an einsum
    would lower tiny contractions to reduced-precision dots).
    """
    nx, ny, nz = dims
    cdims = tuple(d // bb for d, bb in zip(dims, block))
    n_f = nx * ny * nz * b
    n_c = int(np.prod(cdims)) * k
    pos = _positions(block)

    def _pad(v, npad, nlog):
        return jnp.pad(v, ((0, npad - nlog),))

    def tentative(e):
        e4 = e[:n_c].reshape(cdims[2], cdims[1], cdims[0], k)
        out = None
        for pi, (px, py, pz) in enumerate(pos):
            qb = q_dev[pi].reshape(cdims[2], cdims[1], cdims[0], b, k)
            blk = jnp.stack(
                [sum(qb[..., i, j] * e4[..., j] for j in range(k))
                 for i in range(b)], axis=-1)      # (cz, cy, cx, b)
            for ax, (bb, pp) in enumerate(
                    zip(block[::-1], (pz, py, px))):
                if bb == 2:
                    cfg = [(0, 0, 0)] * blk.ndim
                    cfg[ax] = (0, 1, 1)
                    blk = lax.pad(blk, jnp.zeros((), blk.dtype), cfg)
                    if pp:
                        blk = jnp.roll(blk, pp, axis=ax)
            out = blk if out is None else out + blk
        return _pad(out.reshape(-1), npad_f, n_f)

    def tentative_t(r):
        r4 = r[:n_f].reshape(nz, ny, nx, b)
        acc = None
        for pi, (px, py, pz) in enumerate(pos):
            sl = [slice(pz, None, block[2]) if block[2] == 2 else
                  slice(None),
                  slice(py, None, block[1]) if block[1] == 2 else
                  slice(None),
                  slice(px, None, block[0]) if block[0] == 2 else
                  slice(None)]
            rp = r4[tuple(sl)]                      # (cz, cy, cx, b)
            qb = q_dev[pi].reshape(cdims[2], cdims[1], cdims[0], b, k)
            e = jnp.stack(
                [sum(qb[..., i, j] * rp[..., i] for i in range(b))
                 for j in range(k)], axis=-1)       # (cz, cy, cx, k)
            acc = e if acc is None else acc + e
        return _pad(acc.reshape(-1), npad_c, n_c)

    def dmul(v):
        return dinv * v

    def restrict(r):
        return tentative_t(r - omega * spmv(a_dev, dmul(r)))

    def prolong(e):
        t = tentative(e)
        return t - omega * dmul(spmv(a_dev, t))

    return restrict, prolong


def _gershgorin_dinv_a(a: CsrHost) -> float:
    d = np.abs(a.diagonal())
    rows = np.repeat(np.arange(a.shape[0]), a.row_lengths())
    s = np.zeros(a.shape[0])
    np.add.at(s, rows, np.abs(a.vals))
    with np.errstate(divide="ignore"):
        return float(np.max(s / np.maximum(d, 1e-300)))


class BlockStructuredAmg(Preconditioner):
    """Null-space SA with structured node aggregation + BDIA levels.

    ``BlockStructuredAmg(a, {...}, node_dims=(nx, ny, nz),
    nullspace=ns, n_equations=b)`` — a is the interleaved-dof CsrHost
    (galeri.fem elasticity2d/3d layout), ns the (n_dofs, k) modes
    (galeri.fem.rigid_body_modes)."""

    def __init__(self, a, params=None, *, node_dims, nullspace,
                 n_equations: int):
        super().__init__(a, params)
        self.node_dims = tuple(node_dims) + (1,) * (3 - len(node_dims))
        self.nullspace = np.asarray(nullspace, dtype=np.float64)
        self.b = int(n_equations)

    def _do_initialize(self) -> None:
        self.params.validate(_SPECS)
        if not isinstance(self.a, CsrHost):
            raise TypeError("BlockStructuredAmg expects a CsrHost matrix")
        if self.a.shape[0] != int(np.prod(self.node_dims)) * self.b:
            raise ValueError("node_dims × n_equations != matrix size")
        if self.nullspace.shape[0] != self.a.shape[0]:
            raise ValueError("nullspace rows != matrix size")
        if all(bb == 1 for bb in _node_block(self.node_dims)):
            raise ValueError("node grid has no even axis >= 4 to "
                             "aggregate (use SaAmg's uncoupled path)")

    def _do_compute(self) -> None:
        p = self.params
        dtype = p["dtype"] or self.a.vals.dtype
        damping = float(p["sa: damping factor"])
        self.sweeps = int(p["smoother: sweeps"])
        self.omega = float(p["smoother: damping factor"])
        self.gamma = 2 if p["cycle type"] == "W" else 1
        coarse_max = int(p["coarse: max size"])

        a, ns, dims, b = self.a, self.nullspace, self.node_dims, self.b
        k = ns.shape[1]
        self.levels = []
        for _ in range(int(p["max levels"]) - 1):
            block = _node_block(dims)
            if a.shape[0] <= coarse_max or all(bb == 1 for bb in block):
                break
            agg = _structured_node_agg(dims, block)
            p_t, ns_c = tentative_prolongator_nullspace(agg, b, ns)
            q = _extract_q(p_t, dims, block, b, k)
            # ONE omega shared by the host Galerkin P and the device
            # transfer applies, so the coarse operator is the exact
            # PtAP of the prolongator the V-cycle actually applies
            gersh = _gershgorin_dinv_a(a)
            omega_t = damping / gersh
            p_s = smooth_prolongator(a, p_t, damping, omega=omega_t)
            a_c = ptap(a, p_s)

            cdims = tuple(d // bb for d, bb in zip(dims, block))
            a_dev = csr_to_bdia(a, b, dtype=dtype)
            npad_f = a_dev.n_rows_pad
            # match the NEXT level's BDIA padding convention
            # (nbr_pad = round_up(block rows, ROW_ALIGN), rows = nbr*k)
            npad_c = round_up(int(np.prod(cdims)), ROW_ALIGN) * k
            d = a.diagonal()
            dv = np.ones(npad_f)
            dv[: a.shape[0]] = 1.0 / np.where(d != 0, d, 1.0)
            dinv = jnp.asarray(dv, dtype=dtype)
            q_dev = jnp.asarray(q, dtype=dtype)
            restrict, prolong = _block_ns_transfers(
                a_dev, dims, block, b, k, q_dev, omega_t, dinv,
                npad_f, npad_c)
            self.levels.append(dict(
                a=a_dev, dinv=dinv, restrict=restrict, prolong=prolong,
                q=q_dev, bk=(b, k), omega_t=omega_t,
                # damped-Jacobi weight scaled to the level's spectrum:
                # the user damping (default 0.8) is calibrated for
                # lmax(D^-1 A)=2 (Laplacians); elasticity reaches ~2.6+
                # and an overshooting smoother (omega*lmax > 2) makes
                # the V-cycle INDEFINITE (measured: f32 73k-dof CG with
                # the unscaled weight stalls while plain CG converges)
                omega_s=self.omega * 2.0 / gersh,
                n_f=npad_f, n_c=npad_c, dims=dims, block=block))
            a, ns, dims, b = a_c, ns_c, cdims, k
        # coarsest: dense pseudo-inverse (identity-padded)
        nc = a.shape[0]
        npad = (self.levels[-1]["n_c"] if self.levels
                else round_up(nc, ROW_ALIGN))
        dense = np.eye(npad)
        dense[:nc, :nc] = a.to_dense()
        self.coarse_inv = jnp.asarray(np.linalg.pinv(dense, rcond=1e-12),
                                      dtype=dtype)

    def n_levels(self) -> int:
        return len(self.levels) + 1

    # -- functional (jit-argument) form ---------------------------------
    def state(self):
        """Device arrays of the hierarchy as a pytree — pass as a jit
        ARGUMENT and apply with :meth:`apply_state` when the hierarchy
        is too large to bake as jit constants (same escape hatch as
        SaAmg.state; see docs/structured_amg.md Limits)."""
        return {"levels": [{"a": l["a"], "dinv": l["dinv"], "q": l["q"]}
                           for l in self.levels],
                "coarse_inv": self.coarse_inv}

    def apply_state(self, st, r: jax.Array) -> jax.Array:
        levels = []
        for lvl, s in zip(self.levels, st["levels"]):
            bb, kk = lvl["bk"]
            restrict, prolong = _block_ns_transfers(
                s["a"], lvl["dims"], lvl["block"], bb, kk, s["q"],
                lvl["omega_t"], s["dinv"], lvl["n_f"], lvl["n_c"])
            levels.append(dict(lvl, a=s["a"], dinv=s["dinv"],
                               restrict=restrict, prolong=prolong))
        return self._vcycle_impl(levels, st["coarse_inv"], 0, r)

    def _smooth(self, lvl, x, r):
        for _ in range(self.sweeps):
            x = x + lvl["omega_s"] * lvl["dinv"] * (r - spmv(lvl["a"], x))
        return x

    def _vcycle_impl(self, levels, coarse_inv, k: int,
                     r: jax.Array) -> jax.Array:
        if k == len(levels):
            return jnp.matmul(coarse_inv, r, precision=HI)
        lvl = levels[k]
        x = self._smooth(lvl, jnp.zeros_like(r), r)
        for _ in range(self.gamma):
            res = r - spmv(lvl["a"], x)
            x = x + lvl["prolong"](self._vcycle_impl(
                levels, coarse_inv, k + 1, lvl["restrict"](res)))
        return self._smooth(lvl, x, r)

    def _apply(self, r: jax.Array) -> jax.Array:
        if r.ndim != 1:
            raise NotImplementedError(
                "BlockStructuredAmg: single-vector apply only")
        return self._vcycle_impl(self.levels, self.coarse_inv, 0, r)
