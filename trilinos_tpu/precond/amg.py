"""Smoothed-aggregation algebraic multigrid preconditioner.

JAX analogue of MueLu's SA-AMG
(packages/muelu/src/MueCentral/MueLu_Hierarchy_decl.hpp:103,238 —
``Setup`` builds P/R/Ac per level, ``Iterate`` runs the V-cycle with
recursive coarse solve, MueLu_Hierarchy_def.hpp:655,1081; aggregation and
prolongator smoothing under muelu/src/Transfers/; smoothers via Ifpack2).

Setup (host, at compute()):
  1. greedy distance-1 aggregation of the matrix graph
     (MueLu UncoupledAggregation analogue)
  2. tentative prolongator P_t (piecewise-constant, column-normalized)
  3. smoothed P = (I − ω D⁻¹A) P_t with ω = damping/λmax(D⁻¹A)
  4. coarse operator A_c = Pᵀ A P  (Galerkin, ops.matrix_ops.ptap)
  repeated until the coarse problem is small; coarsest level inverts
  densely.

Apply (device, jitted): a fixed V-cycle — damped-Jacobi pre/post smoothing,
residual restriction, recursive coarse correction, dense coarse solve —
unrolled over the (static) level list, so the whole preconditioner is one
fused XLA computation usable inside any Krylov driver.

Structured aggregation (accelerator-first fast path, the analogue of MueLu's
``aggregation: type = structured`` / region-hierarchy work): when the fine
operator is a constant-coefficient :class:`StencilOp` on a grid with even
dims, aggregates are 2×2×2 grid blocks, so

  * the tentative transfers are RESHAPES (block-sum / broadcast — zero
    gathers, zero stored P),
  * the smoothed transfers cost one stencil apply each
    (P = (I−ωD⁻¹A)P_t ⇒ Pᵀr = P_tᵀ(r−ωAD⁻¹r)),
  * every coarse level is the EXACT Galerkin operator in boundary-
    classified form (precond/structured.py: coefficients depend only on
    per-axis clamped distance to the faces, extracted from one small
    probe PᵀAP and verified on a second), stored as a DIA matrix —
    gather-free DIA applies,
  * setup is all-host and O(probe³) per level, independent of the real
    grid size (ω uses the Gershgorin λmax bound, exact for these
    operators' purposes — no on-device power method).

The unstructured V-cycle's ELL-gather P/Pᵀ applies and coarse ELL SpMVs
are replaced by reshapes + stencil/DIA applies.
"""
from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.blas import HI
from ..ops.formats import CsrHost, choose_format, round_up, ROW_ALIGN
from ..ops.matrix_ops import ptap
from ..ops.matvec import spmv
from ..utils.params import Param
from .base import Preconditioner

_SPECS = {
    "max levels": Param("max levels", 10),
    "coarse: max size": Param("coarse: max size", 64),
    "aggregation: min agg size": Param("aggregation: min agg size", 2),
    "sa: damping factor": Param("sa: damping factor", 4.0 / 3.0),
    "smoother: sweeps": Param("smoother: sweeps", 2),
    "smoother: damping factor": Param("smoother: damping factor", 0.8),
    "smoother: type": Param("smoother: type", "jacobi",
                            choices=("jacobi", "chebyshev")),
    "cycle type": Param("cycle type", "V", choices=("V", "W")),
    "fine: matrix-free operator": Param("fine: matrix-free operator",
                                        None),
    "aggregation: type": Param("aggregation: type", "auto",
                               choices=("auto", "uncoupled", "structured")),
    # sparsified Galerkin: coarse-stencil entries below drop_tol·|diag|
    # are lumped into the diagonal (preserves symmetry + row sums),
    # bounding SA stencil growth (levels converge to ~81 offsets at
    # 0.005 instead of 33→179→…). 0.005 keeps size-independent AMG
    # convergence (measured 5 iters at 64³ and 6 at 256³ vs 9/21 at
    # 0.02 — the dropped reach-2 entries carry real coupling)
    "aggregation: drop tol": Param("aggregation: drop tol", 0.005),
    # null-space-aware SA (MueLu "Nullspace" + "number of equations"):
    # (n, k) modes the tentative prolongator must interpolate exactly —
    # rigid-body modes for elasticity (galeri.fem.rigid_body_modes)
    "nullspace: vectors": Param("nullspace: vectors", None),
    "number of equations": Param("number of equations", 1),
    "dtype": Param("dtype", None),
}


def aggregate(a: CsrHost, min_size: int = 2) -> np.ndarray:
    """Greedy distance-1 aggregation: agg id per node (MueLu
    UncoupledAggregation phase 1 + leftover attachment).

    Vectorized as rounds of a distance-2 maximal independent set
    (random priorities; a node roots an aggregate iff its priority is
    the max within graph distance 2, computed by two sparse
    max-propagations with ``np.maximum.at``) — no per-row Python loop,
    so setup scales to multi-million-row fine levels. Round count is
    O(log n) w.h.p.; each round assigns the winners' whole (fully
    unaggregated) neighborhoods."""
    n = a.shape[0]
    rows = np.repeat(np.arange(n, dtype=np.int64), a.row_lengths())
    cols = a.cols.astype(np.int64)
    keep = (cols != rows) & (cols < n)
    rows, cols = rows[keep], cols[keep]

    agg = np.full(n, -1, dtype=np.int64)
    prio = np.random.default_rng(0).permutation(n).astype(np.float64) + 1
    next_id = 0

    def edge_max(x):
        out = np.zeros(n, dtype=x.dtype)
        np.maximum.at(out, rows, x[cols])
        return np.maximum(out, x)

    while True:
        unagg = agg == -1
        # candidates: unaggregated nodes with a fully unaggregated
        # neighborhood (phase-1 root condition)
        nbr_agg = np.zeros(n, dtype=bool)
        np.maximum.at(nbr_agg, rows, ~unagg[cols])
        cand = unagg & ~nbr_agg
        if not cand.any():
            break
        pr = np.where(cand, prio, 0.0)
        winners = cand & (pr == edge_max(edge_max(pr))) & (pr > 0)
        w_ids = np.nonzero(winners)[0]
        if not len(w_ids):
            break
        agg[w_ids] = next_id + np.arange(len(w_ids))
        # winners are distance->2 independent: neighborhoods are
        # disjoint, so direct scatter is race-free
        sel = winners[rows]
        agg[cols[sel]] = agg[rows[sel]]
        next_id += len(w_ids)

    # phase 2: attach leftovers to an adjacent aggregate (a few rounds
    # pull in chains of leftovers)
    for _ in range(3):
        left = agg == -1
        if not left.any():
            break
        best = np.full(n, -1, dtype=np.int64)
        sel = left[rows] & (agg[cols] >= 0)
        np.maximum.at(best, rows[sel], agg[cols[sel]])
        take = left & (best >= 0)
        agg[take] = best[take]
    # isolated leftovers become singletons
    left = np.nonzero(agg == -1)[0]
    if len(left):
        agg[left] = next_id + np.arange(len(left))
    # renumber consecutively (some ids may be empty after attachment)
    uniq, agg = np.unique(agg, return_inverse=True)
    return agg.astype(np.int64)


def tentative_prolongator(agg: np.ndarray) -> CsrHost:
    n = len(agg)
    nagg = int(agg.max()) + 1
    counts = np.bincount(agg, minlength=nagg).astype(np.float64)
    vals = 1.0 / np.sqrt(counts[agg])
    return CsrHost.from_coo(np.arange(n), agg, vals, (n, nagg),
                            sum_duplicates=False)


def amalgamate_graph(a: CsrHost, b: int) -> CsrHost:
    """Node (amalgamated) connectivity graph of a matrix with ``b`` dofs
    per node — what MueLu aggregates for PDE systems
    (muelu/src/Graph/MueLu_AmalgamationFactory_decl.hpp)."""
    if b == 1:
        return a
    n_nodes = a.shape[0] // b
    rows = np.repeat(np.arange(a.shape[0], dtype=np.int64),
                     a.row_lengths()) // b
    cols = a.cols.astype(np.int64) // b
    key = np.unique(rows * n_nodes + cols)
    return CsrHost.from_coo(key // n_nodes, key % n_nodes,
                            np.ones(len(key)), (n_nodes, n_nodes),
                            sum_duplicates=False)


def tentative_prolongator_nullspace(node_agg: np.ndarray, b: int,
                                    ns: np.ndarray):
    """Null-space-preserving tentative prolongator (MueLu
    TentativePFactory with a user "Nullspace", e.g. rigid-body modes):
    per aggregate, the restriction of the null space to the aggregate's
    dofs is QR-factored — Q becomes the aggregate's P_t block (columns
    orthonormal) and R the aggregate's rows of the COARSE null space,
    so ``P_t @ ns_coarse == ns`` exactly and every level interpolates
    the modes the smoother cannot damp.

    Returns ``(P_t, ns_coarse)``. Aggregates whose dof count is below
    the null-space dimension get zero-padded Q columns (rank handled by
    the coarsest pseudo-inverse)."""
    k = ns.shape[1]
    nagg = int(node_agg.max()) + 1
    dof_agg = np.repeat(node_agg, b)
    n = len(dof_agg)
    order = np.argsort(dof_agg, kind="stable")
    counts = np.bincount(dof_agg, minlength=nagg)
    starts = np.concatenate([[0], np.cumsum(counts)])
    rows_all, cols_all, vals_all = [], [], []
    ns_c = np.zeros((nagg * k, k))
    # batch the per-aggregate QRs by aggregate size
    for m in np.unique(counts):
        sel = np.nonzero(counts == m)[0]
        if m == 0 or not len(sel):
            continue
        dofs = np.stack([order[starts[a]:starts[a] + m] for a in sel])
        blocks = ns[dofs]                      # (n_sel, m, k)
        q, r = np.linalg.qr(blocks)            # q (n_sel, m, kk)
        kk = q.shape[2]
        if kk < k:
            q = np.pad(q, ((0, 0), (0, 0), (0, k - kk)))
            r = np.pad(r, ((0, 0), (0, k - kk), (0, 0)))
        rows_all.append(np.repeat(dofs, k, axis=1).reshape(-1))
        cols_all.append(
            (sel[:, None, None] * k
             + np.arange(k)[None, None, :]
             + np.zeros((1, m, 1), np.int64)).reshape(-1))
        vals_all.append(q.reshape(-1))
        ns_c[(sel[:, None] * k + np.arange(k)).reshape(-1)] = (
            r.reshape(-1, k))
    p_t = CsrHost.from_coo(np.concatenate(rows_all),
                           np.concatenate(cols_all),
                           np.concatenate(vals_all), (n, nagg * k),
                           sum_duplicates=False)
    return p_t, ns_c


def smooth_prolongator(a: CsrHost, p_t: CsrHost, damping: float,
                       omega: float | None = None) -> CsrHost:
    """P = (I − ω D⁻¹ A) P_t with ω = damping / λmax(D⁻¹A) (power est.),
    or an explicit ``omega`` when the caller must share the weight with
    matrix-free transfer applies (block_amg)."""
    from ..ops.matrix_ops import diag_matrix, spadd, spgemm

    d = a.diagonal()
    dinv = 1.0 / np.where(d != 0, d, 1.0)
    if omega is None:
        # cheap λmax estimate of D⁻¹A by a few host power iterations
        rng = np.random.default_rng(0)
        v = rng.standard_normal(a.shape[0])
        rows_rep = np.repeat(np.arange(a.shape[0]), a.row_lengths())
        lam = 1.0
        for _ in range(10):
            w = np.zeros(a.shape[0])
            np.add.at(w, rows_rep, a.vals * v[a.cols])
            w *= dinv
            lam = np.linalg.norm(w)
            v = w / max(lam, 1e-30)
        omega = damping / max(lam, 1e-12)
    da = spgemm(diag_matrix(omega * dinv), a)
    dap = spgemm(da, p_t)
    return spadd(p_t, dap, 1.0, -1.0)


def build_hierarchy_host(a: CsrHost, max_levels: int, coarse_max: int,
                         min_agg: int, damping: float,
                         nullspace: np.ndarray | None = None,
                         n_equations: int = 1):
    """Host-side SA-AMG setup shared by the single-device and distributed
    preconditioners: returns ([(A_l, P_l), ...], A_coarsest) — the
    Hierarchy::Setup phase (MueLu_Hierarchy_decl.hpp:103).

    With ``nullspace`` (n, k) — e.g. galeri.fem.rigid_body_modes for
    elasticity — aggregation runs on the amalgamated node graph
    (``n_equations`` dofs per node) and the tentative prolongator
    interpolates the null space exactly at every level (MueLu
    TentativePFactory semantics); coarse levels carry k dofs per
    aggregate."""
    levels = []
    b = int(n_equations)
    ns = nullspace
    for _ in range(max_levels - 1):
        if a.shape[0] <= coarse_max:
            break
        if ns is None:
            agg = aggregate(a, min_agg)
            if int(agg.max()) + 1 >= a.shape[0]:  # no coarsening progress
                break
            p_t = tentative_prolongator(agg)
        else:
            agg = aggregate(amalgamate_graph(a, b), min_agg)
            if (int(agg.max()) + 1) * ns.shape[1] >= a.shape[0]:
                break
            p_t, ns = tentative_prolongator_nullspace(agg, b, ns)
            b = ns.shape[1]  # coarse: k dofs per aggregate-node
        p_s = smooth_prolongator(a, p_t, damping)
        a_c = ptap(a, p_s)
        levels.append((a, p_s))
        a = a_c
    return levels, a


# ---------------------------------------------------------------------------
# structured aggregation (StencilOp hierarchy, zero gathers)
# ---------------------------------------------------------------------------


def _structured_block(dims) -> tuple[int, ...]:
    """Per-axis aggregation factor: 2 where the axis is coarsenable."""
    return tuple(2 if (d % 2 == 0 and d >= 4) else 1 for d in dims)


def _is_symmetric_stencil(offsets, coeffs, tol=1e-12) -> bool:
    table = {tuple(o): float(c) for o, c in zip(offsets, coeffs)}
    return all(
        abs(table.get(tuple(-x for x in o), np.inf) - c) <= tol * max(
            1.0, abs(c))
        for o, c in table.items())


# Pair sums via even/odd STRIDED SLICES and duplication via lax.pad
# interior dilation + roll keep every intermediate in the natural grid
# layout (no 6-D (…,2) reshapes) and stay exact adjoints of each other.
# Shared by the single-device and distributed (per-shard slab)
# structured transfers.


def block_pair_sum(r, dims, block):
    """Σ over 2-blocks per coarsened axis: (n_f[,k]) → (n_c[,k]) flat.
    ``dims`` = (nx, ny, nz) of the (slab-)grid r covers."""
    nx, ny, nz = dims
    n_f = nx * ny * nz
    tail = r.shape[1:]
    t = r[:n_f].reshape((nz, ny, nx) + tail)
    for ax, bb in ((2, block[0]), (1, block[1]), (0, block[2])):
        if bb == 2:
            sl0 = [slice(None)] * t.ndim
            sl1 = [slice(None)] * t.ndim
            sl0[ax] = slice(0, None, 2)
            sl1[ax] = slice(1, None, 2)
            t = t[tuple(sl0)] + t[tuple(sl1)]
    return t.reshape((-1,) + tail)


def block_pair_dup(e, cdims, block):
    """Duplicate into 2-blocks per coarsened axis: (n_c[,k]) → (n_f[,k])
    flat. ``cdims`` = coarse (cx, cy, cz) of the (slab-)grid."""
    cx, cy, cz = cdims
    n_c = cx * cy * cz
    tail = e.shape[1:]
    t = e[:n_c].reshape((cz, cy, cx) + tail)
    for ax, bb in ((0, block[2]), (1, block[1]), (2, block[0])):
        if bb == 2:
            cfg = [(0, 0, 0)] * t.ndim
            cfg[ax] = (0, 1, 1)   # interior dilation: [e0,0,e1,0,…]
            p = lax.pad(t, jnp.zeros((), t.dtype), cfg)
            t = p + jnp.roll(p, 1, axis=ax)
    return t.reshape((-1,) + tail)


def _structured_transfers(op_f, dims, npad_c, n_c, block, omega, dinv):
    """Matrix-free smoothed transfers for one structured level.

    restrict(r) = P_tᵀ (r − ω·A(D⁻¹r))    (A symmetric)
    prolong(e)  = t − ω·D⁻¹(A t),  t = P_t e
    with P_t block-broadcast / P_tᵀ block-sum as pure reshapes — zero
    gathers, zero stored P. ``dinv`` is a jnp array of shape (1,)
    (constant diagonal) or (npad_f,). Handles (n,) and (n, k) operands.
    """
    from ..ops.matvec import spmv

    nx, ny, nz = dims
    bx, by, bz = block
    cdims = (nx // bx, ny // by, nz // bz)
    n_f, npad_f = nx * ny * nz, op_f.n_rows_pad
    # Python float, not np.float64: a strong f64 scalar would promote
    # f32 operands under x64 mode
    nrm = float(1.0 / np.sqrt(bx * by * bz))

    def _pad(v, npad, nlog):
        return jnp.pad(v, ((0, npad - nlog),) + ((0, 0),) * (v.ndim - 1))

    def dmul(r):
        return r * (dinv if r.ndim == 1 else dinv[:, None])

    def block_sum(r):
        return _pad(block_pair_sum(r, dims, block) * nrm, npad_c, n_c)

    def block_bcast(e):
        return _pad(block_pair_dup(e, cdims, block) * nrm, npad_f, n_f)

    def restrict(r):
        return block_sum(r - omega * spmv(op_f, dmul(r)))

    def prolong(e):
        t = block_bcast(e)
        return t - omega * dmul(spmv(op_f, t))

    return restrict, prolong


def build_classified_hierarchy(op, max_levels: int, coarse_max: int,
                               damping: float, drop_tol: float, dtype):
    """Exact structured hierarchy: level 0 is the StencilOp itself;
    every coarse level is the TRUE Galerkin operator in boundary-
    classified form (precond/structured.py), materialized as a stored
    DIA matrix (gather-free applies). Returns
    ``(levels_meta, coarsest_csr, coarsest_npad)`` where each meta is
    ``dict(dev, rep, dims, block, omega)``."""
    from .structured import (ClassifiedStencil, _galerkin_on_grid,
                             galerkin_classified)

    rep = ClassifiedStencil.from_constant(op.offsets, op.coeffs)
    dims = tuple(op.dims)
    dev = op
    levels = []
    for _ in range(max_levels - 1):
        if int(np.prod(dims)) <= coarse_max:
            break
        block = _structured_block(dims)
        if all(b == 1 for b in block):
            break
        rep_c, omega = galerkin_classified(rep, block, damping, drop_tol)
        cdims = tuple(d // b for d, b in zip(dims, block))
        levels.append(dict(dev=dev, rep=rep, dims=dims, block=block,
                           omega=omega))
        if any(c < m for c, m in zip(cdims, rep_c.min_dims())):
            # the coarse grid is smaller than the classified boundary
            # layers: close out with an exact PtAP on the (by now tiny)
            # real grid instead of materializing the classified form
            coarsest = _galerkin_on_grid(rep, dims, block, omega)
            return levels, coarsest, round_up(coarsest.shape[0],
                                              ROW_ALIGN)
        rep, dims = rep_c, cdims
        n_c = int(np.prod(cdims))
        dev = rep.materialize_dia(cdims, dtype=dtype,
                                  n_rows_pad=round_up(n_c, 1024))
    coarsest = rep.materialize_csr(dims)
    return levels, coarsest, dev.n_rows_pad


class SaAmg(Preconditioner):
    """Smoothed-aggregation AMG V-cycle (fixed, linear → Krylov-safe)."""

    def _do_initialize(self) -> None:
        self.params.validate(_SPECS)
        from ..ops.stencil import StencilOp

        agg_t = self.params["aggregation: type"]
        cand = (self.a if isinstance(self.a, StencilOp)
                else self.params["fine: matrix-free operator"])
        can_structured = (
            isinstance(cand, StencilOp)
            and _is_symmetric_stencil(cand.offsets, cand.coeffs)
            and any(b == 2 for b in _structured_block(cand.dims)))
        if agg_t == "structured" and not can_structured:
            raise ValueError(
                "aggregation: type 'structured' needs a symmetric "
                "StencilOp (as the matrix or 'fine: matrix-free "
                "operator') on a grid with at least one even dim >= 4")
        # auto: prefer the structured hierarchy whenever a symmetric
        # StencilOp is available (matrix or fine-op) — its coarse levels
        # are the EXACT Galerkin operators (boundary-classified
        # extraction, precond/structured.py) and its transfers are
        # gather-free, so it is both faster and as accurate as the
        # uncoupled path on structured problems
        self._structured = (agg_t == "structured"
                            or (agg_t == "auto" and can_structured
                                and self.params["nullspace: vectors"]
                                is None))
        if self._structured and \
                self.params["nullspace: vectors"] is not None:
            raise ValueError("'nullspace: vectors' needs the uncoupled "
                             "hierarchy (structured aggregation carries "
                             "the constant mode only)")
        fine_op = self.params["fine: matrix-free operator"]
        if (fine_op is not None and not isinstance(self.a, StencilOp)
                and fine_op.shape != self.a.shape):
            raise ValueError("fine operator shape != matrix shape")
        self._stencil = cand if self._structured else None
        if not self._structured and not isinstance(self.a, CsrHost):
            raise TypeError(
                "SaAmg expects a CsrHost matrix (a bare StencilOp is "
                "only usable with structured aggregation)")

    def _do_compute(self) -> None:
        p = self.params
        self.sweeps = int(p["smoother: sweeps"])
        self.omega = float(p["smoother: damping factor"])
        self.gamma = 2 if p["cycle type"] == "W" else 1
        if self._structured:
            self._compute_structured(p)
            return
        dtype = p["dtype"] or self.a.vals.dtype
        self.levels = []
        host_levels, a = build_hierarchy_host(
            self.a, int(p["max levels"]), int(p["coarse: max size"]),
            int(p["aggregation: min agg size"]),
            float(p["sa: damping factor"]),
            nullspace=p["nullspace: vectors"],
            n_equations=int(p["number of equations"]))
        # matrix-free fine level: the framework's fastest operator (and
        # the fused-polynomial Chebyshev smoother) carries the dominant
        # level-0 cost; coarser levels stay stored (they are built by
        # Galerkin products anyway). The stored fine matrix self.a is
        # still used for aggregation/PtAP setup.
        self.fine_op = p["fine: matrix-free operator"]
        for k, (a_l, p_s) in enumerate(host_levels):
            d = a_l.diagonal()
            if k == 0 and self.fine_op is not None:
                npad = self.fine_op.n_rows_pad
                a_dev = self.fine_op
            else:
                npad = round_up(a_l.shape[0], ROW_ALIGN)
                a_dev = choose_format(a_l, dtype=dtype)
            dinv = np.ones(npad)
            dinv[: a_l.shape[0]] = 1.0 / np.where(d != 0, d, 1.0)
            np_c = round_up(p_s.shape[1], ROW_ALIGN)
            # P: (n_f, n_c) rectangular — ELL without identity padding
            p_dev = _pack_rect(p_s, dtype, npad, np_c)
            pt_dev = _pack_rect(p_s.transpose(), dtype, np_c, npad)
            self.levels.append(dict(
                a=a_dev,
                dinv=jnp.asarray(dinv, dtype=dtype),
                p=p_dev, pt=pt_dev,
                restrict=functools.partial(spmv, pt_dev),
                prolong=functools.partial(spmv, p_dev),
                n_f=npad, n_c=np_c))
        # coarsest: dense inverse (identity-padded)
        self._set_coarse_inv(a, round_up(a.shape[0], ROW_ALIGN), dtype)
        if p["smoother: type"] == "chebyshev":
            if self.fine_op is None:
                raise ValueError(
                    "smoother: type 'chebyshev' requires 'fine: "
                    "matrix-free operator' (the fused polynomial "
                    "smoother runs on the StencilOp); use the "
                    "CHEBYSHEV preconditioner for stored matrices")
            from .chebyshev import fused_stencil_chebyshev

            # degree = sweeps+1 Chebyshev polynomial on the stencil
            # (ops/stencil.py); an empty hierarchy (problem
            # at or below 'coarse: max size') is just the dense solve
            if self.levels:
                self.levels[0]["cheb"] = fused_stencil_chebyshev(
                    self.fine_op, degree=self.sweeps + 1)

    def _compute_structured(self, p) -> None:
        """Classified StencilOp hierarchy: reshape transfers, EXACT
        Galerkin coarse levels stored as DIA, fused-polynomial Chebyshev
        on the fine level (coarse DIA levels smooth with damped Jacobi —
        their cost is negligible next to level 0)."""
        op = self._stencil
        dtype = p["dtype"] or np.dtype(op.dtype)
        self.fine_op = op
        metas, coarsest_csr, coarsest_npad = build_classified_hierarchy(
            op, int(p["max levels"]), int(p["coarse: max size"]),
            float(p["sa: damping factor"]),
            float(p["aggregation: drop tol"]), dtype)
        use_cheb = p["smoother: type"] == "chebyshev"
        self.levels = []
        for i, meta in enumerate(metas):
            rep, dims, dev = meta["rep"], meta["dims"], meta["dev"]
            npad_f = dev.n_rows_pad
            npad_c = (metas[i + 1]["dev"].n_rows_pad
                      if i + 1 < len(metas) else coarsest_npad)
            n_c = (int(np.prod(metas[i + 1]["dims"]))
                   if i + 1 < len(metas)
                   else coarsest_csr.shape[0])
            diag_tab = rep.table[(0, 0, 0)]
            if np.ptp(diag_tab) == 0:
                dinv = jnp.full((1,), float(1.0 / diag_tab.flat[0]),
                                dtype=dtype)
            else:
                dv = np.ones(npad_f)
                d = rep.diag_vector(dims)
                dv[: len(d)] = 1.0 / np.where(d != 0, d, 1.0)
                dinv = jnp.asarray(dv, dtype=dtype)
            restrict, prolong = _structured_transfers(
                dev, dims, npad_c, n_c, meta["block"], meta["omega"],
                dinv)
            lvl = dict(a=dev, restrict=restrict, prolong=prolong,
                       dinv=dinv, n_f=npad_f, n_c=npad_c, dims=dims,
                       block=meta["block"], omega=meta["omega"],
                       n_c_log=n_c)
            if use_cheb and i == 0:
                from .chebyshev import fused_stencil_chebyshev

                # degree = sweeps+1 Chebyshev apply at ~one SpMV's
                # traffic; the Gershgorin bound replaces the on-device
                # power-method λmax estimate (exact-enough upper bound
                # for constant stencils, zero device work at setup)
                lvl["cheb"] = fused_stencil_chebyshev(
                    op, degree=self.sweeps + 1, lmax=rep.gershgorin())
            self.levels.append(lvl)
        self._set_coarse_inv(coarsest_csr, coarsest_npad, dtype)

    def _set_coarse_inv(self, a: CsrHost, npad: int, dtype) -> None:
        nc = a.shape[0]
        dense = np.eye(npad)
        dense[:nc, :nc] = a.to_dense()
        # pseudo-inverse: semidefinite coarse operators (e.g. Hiptmair's
        # auxiliary Gt A G with constants in the null space) stay stable
        self.coarse_inv = jnp.asarray(np.linalg.pinv(dense, rcond=1e-12),
                                      dtype=dtype)

    def n_levels(self) -> int:
        return len(self.levels) + 1

    # -- functional (jit-argument) form -------------------------------------
    def state(self):
        """Device arrays of the hierarchy as a pytree — pass this as a
        jit ARGUMENT and apply with :meth:`apply_state` when the level
        operators are too large to bake as jit constants (closures over
        big arrays serialize into the remote-compile request; e.g. a
        256³ hierarchy's level-1 DIA data is ~260 MB)."""
        levels = []
        for lvl in self.levels:
            st = {"a": lvl["a"], "dinv": lvl["dinv"]}
            if "p" in lvl:
                st["p"], st["pt"] = lvl["p"], lvl["pt"]
            levels.append(st)
        return {"levels": levels, "coarse_inv": self.coarse_inv}

    def apply_state(self, st, r: jax.Array) -> jax.Array:
        """V-cycle reading the hierarchy arrays from ``st`` (a — possibly
        traced — pytree from :meth:`state`) instead of the baked-in
        constants. ``m.apply(r) == m.apply_state(m.state(), r)``."""
        levels = []
        for lvl, s in zip(self.levels, st["levels"]):
            l2 = dict(lvl, a=s["a"], dinv=s["dinv"])
            if "p" in s:
                l2["restrict"] = functools.partial(spmv, s["pt"])
                l2["prolong"] = functools.partial(spmv, s["p"])
            else:
                l2["restrict"], l2["prolong"] = _structured_transfers(
                    s["a"], lvl["dims"], lvl["n_c"], lvl["n_c_log"],
                    lvl["block"], lvl["omega"], s["dinv"])
            levels.append(l2)
        return self._vcycle_impl(levels, st["coarse_inv"], 0, r)

    def _smooth(self, lvl, x, b):
        dinv = lvl["dinv"] if b.ndim == 1 else lvl["dinv"][:, None]
        for _ in range(self.sweeps):
            x = x + self.omega * dinv * (b - spmv(lvl["a"], x))
        return x

    def _presmooth(self, k, lvl, b):
        ch = lvl.get("cheb")
        if ch is not None:
            return ch(b)                       # zero guess: x = p(A) b
        return self._smooth(lvl, jnp.zeros_like(b), b)

    def _postsmooth(self, k, lvl, x, b):
        ch = lvl.get("cheb")
        if ch is not None:
            return x + ch(b - spmv(lvl["a"], x))
        return self._smooth(lvl, x, b)

    def _vcycle_impl(self, levels, coarse_inv, k: int,
                     b: jax.Array) -> jax.Array:
        if k == len(levels):
            return jnp.matmul(coarse_inv, b, precision=HI)
        lvl = levels[k]
        x = self._presmooth(k, lvl, b)
        # gamma=1: V-cycle; gamma=2: W-cycle (MueLu Hierarchy::Iterate
        # cycle-type option, MueLu_Hierarchy_def.hpp:1081)
        for cyc in range(self.gamma):
            r = b - spmv(lvl["a"], x)
            e_c = self._vcycle_impl(levels, coarse_inv, k + 1,
                                    lvl["restrict"](r))
            x = x + lvl["prolong"](e_c)
        return self._postsmooth(k, lvl, x, b)

    def _vcycle(self, k: int, b: jax.Array) -> jax.Array:
        return self._vcycle_impl(self.levels, self.coarse_inv, k, b)

    def _apply(self, r: jax.Array) -> jax.Array:
        return self._vcycle(0, r)


def _pack_rect(m: CsrHost, dtype, n_rows_pad, n_cols_pad):
    from ..ops.formats import csr_to_ell

    return csr_to_ell(m, dtype=dtype, n_rows_pad=n_rows_pad,
                      identity_pad_rows=False)
