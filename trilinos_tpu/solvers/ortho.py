"""Orthogonalization managers.

JAX counterparts of Belos' ortho managers
(packages/belos/src/BelosDGKSOrthoManager.hpp:99-107,644 — classical GS with
conditional reorthogonalization; BelosICGSOrthoManager.hpp — iterated CGS
(CGS2); BelosIMGSOrthoManager.hpp — iterated MGS; BelosTsqrOrthoManager.hpp).

Every projection is one GEMM (the MvTransMv block inner product)
plus ONE psum over the row-shard axis; normalization of a block uses
Cholesky-QR (CholQR / CholQR2) — the communication-avoiding panel
factorization playing the role the reference gives TSQR
(packages/tpetra/tsqr/src/Tsqr.hpp): a single reduction per pass instead of
one per column.

Invariant used throughout: basis arrays carry *all* (static-shape) columns,
with not-yet-filled columns identically zero — projections against them are
then harmless no-ops, which is how dynamic basis growth is expressed in
XLA's fixed-shape world.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.blas import HI
from ..ops.smalldense import chol_inv_small
from ..parallel.comm import Comm, SerialComm

# Reference default thresholds (BelosDGKSOrthoManager.hpp:99-107).
DGKS_DEP_TOL = 1 / jnp.sqrt(2.0)
SING_TOL = 10.0  # times eps, for rank detection in normalize


def project_block(comm: Comm, v: jax.Array, w: jax.Array):
    """One classical-GS pass: c = vᵀw (GEMM + psum), w ← w − v c.

    v: (n, m) basis (unfilled columns zero); w: (n, k) block to project.
    v may be stored in a NARROWER dtype than w (bf16 basis, f32 work
    vector — the inexact-Krylov storage mode): the GEMMs then run
    bf16×f32 with accumulation in w's dtype, halving basis
    HBM traffic. Returns (w_new, c) in w's dtype."""
    c = comm.psum(jnp.einsum("nm,nk->mk", v, w,
                             preferred_element_type=w.dtype, precision=HI))
    return w - jnp.einsum("nm,mk->nk", v, c,
                          preferred_element_type=w.dtype, precision=HI), c


def cgs2_project(comm: Comm, v: jax.Array, w: jax.Array):
    """Iterated CGS (CGS2): two unconditional passes — the ICGS manager's
    default (BelosICGSOrthoManager.hpp, max_ortho_steps=2). Returns
    (w, c_total)."""
    w1, c1 = project_block(comm, v, w)
    w2, c2 = project_block(comm, v, w1)
    return w2, c1 + c2


def dgks_project(comm: Comm, v: jax.Array, w: jax.Array,
                 dep_tol: float = float(DGKS_DEP_TOL)):
    """Classical GS with *conditional* reorthogonalization: second pass only
    when the projected vector lost more than dep_tol of its mass
    (BelosDGKSOrthoManager.hpp:644 projectAndNormalizeWithMxImpl logic).

    The norm check adds one fused psum. All RHS columns reorthogonalize
    together if any needs it (block-wise decision keeps control flow static).
    """
    from ..ops.blas import local_dot

    norms_before = comm.psum(local_dot(w, w))
    w1, c1 = project_block(comm, v, w)
    norms_after = comm.psum(local_dot(w1, w1))
    need = jnp.any(norms_after < (dep_tol ** 2) * norms_before)

    def second(args):
        w1, c1 = args
        w2, c2 = project_block(comm, v, w1)
        return w2, c1 + c2

    return lax.cond(need, second, lambda a: a, (w1, c1))


def mgs_project(comm: Comm, v: jax.Array, w: jax.Array, n_valid: int | jax.Array):
    """Modified Gram-Schmidt: one reduction per basis column (m psums) —
    more stable per-pass than CGS but communication-heavy; provided for
    parity with IMGSOrthoManager. ``n_valid``: number of filled columns."""
    m = v.shape[1]

    def body(j, carry):
        w, c = carry
        vj = v[:, j]
        cj = comm.psum(jnp.einsum("nk,n->k", w, vj, precision=HI))
        cj = jnp.where(j < n_valid, cj, 0)
        w = w - vj[:, None] * cj[None, :]
        return w, c.at[j].set(cj)

    c0 = jnp.zeros((m, w.shape[1]), dtype=w.dtype)
    return lax.fori_loop(0, m, body, (w, c0))


def cholqr(comm: Comm, w: jax.Array, eps: float | None = None):
    """Cholesky-QR: G = wᵀw (one psum), R = chol(G)ᵀ, Q = w R⁻¹.

    Returns (q, r, rank_ok) where rank_ok flags columns that were not
    numerically dependent (diagonal of R above sing_tol)."""
    g = comm.psum(jnp.einsum("nk,nm->km", w, w,
                             preferred_element_type=w.dtype, precision=HI))
    eps = eps or float(jnp.finfo(w.dtype).eps)
    k = g.shape[0]
    # regularize hard-singular blocks so chol stays finite; flagged below.
    # The floor must stay strictly positive even for an ALL-ZERO panel
    # (g == 0 → chol(0) → 0 diagonal → NaN in the triangular solve; hit
    # by LOBPCG's collapsed p block after columns converge): tiny·I makes
    # chol return sqrt(tiny)·I and q come out exactly 0, rank_ok False.
    scale = jnp.sqrt(jnp.maximum(jnp.diag(g), 1e-300))
    tiny = jnp.asarray(jnp.finfo(w.dtype).tiny, g.dtype)
    floor_val = jnp.maximum(SING_TOL * eps * jnp.max(jnp.abs(g)), tiny)
    # small Cholesky + explicit R⁻¹ (smalldense.py): the (n, k)
    # triangular solve becomes ONE streaming GEMM
    l, linv = chol_inv_small(g + floor_val * jnp.eye(k, dtype=g.dtype))
    r = l.T
    q = jnp.einsum("nk,km->nm", w, linv.T,
                   preferred_element_type=w.dtype, precision=HI)
    rank_ok = jnp.diag(r) > jnp.sqrt(floor_val) * 10
    del scale
    return q, r, rank_ok


def cholqr2(comm: Comm, w: jax.Array):
    """CholQR2: two Cholesky-QR passes — orthogonality to machine precision
    for well-conditioned panels; the block-normalization workhorse."""
    q1, r1, ok1 = cholqr(comm, w)
    q2, r2, ok2 = cholqr(comm, q1)
    return q2, r2 @ r1, jnp.logical_and(ok1, ok2)


def svqb(comm: Comm, w: jax.Array):
    """SVQB orthonormalization (Stathopoulos/Wu): G = wᵀw, G = U Λ Uᵀ,
    Q = w U Λ^(−1/2) — the Anasazi SVQB manager
    (packages/anasazi/src/AnasaziSVQBOrthoManager.hpp). More robust than
    CholQR for nearly-dependent blocks; one psum + one small eigh."""
    g = comm.psum(jnp.einsum("nk,nm->km", w, w,
                             preferred_element_type=w.dtype, precision=HI))
    eps = jnp.finfo(w.dtype).eps
    # scale to unit diagonal first (the SVQB trick)
    d = jnp.sqrt(jnp.maximum(jnp.diag(g), eps))
    dinv = 1.0 / d
    g_s = g * dinv[:, None] * dinv[None, :]
    lam, u = jnp.linalg.eigh((g_s + g_s.T) / 2)
    lam_floor = jnp.maximum(lam, 10 * eps * jnp.max(lam))
    rank_ok = lam > 10 * eps * jnp.max(lam)
    q = jnp.matmul(w * dinv[None, :],
                   u * (1.0 / jnp.sqrt(lam_floor))[None, :], precision=HI)
    return q, rank_ok


def project_block_window(comm: Comm, v: jax.Array, w: jax.Array,
                         n_active, chunk: int = 8):
    """One classical-GS pass that reads ONLY the basis prefix containing
    active (filled) columns.

    The static-shape basis convention (unfilled columns zero) makes the
    plain ``project_block`` read all ``m`` columns every call — in a
    growing-basis loop (GMRES Arnoldi) that wastes up to 2× the HBM
    traffic on zeros. Here ``v`` is (n, mp) with ``mp % chunk == 0`` and
    ``n_active`` (traced) filled leading columns; the pass runs on the
    STATIC prefix ``v[:, :ceil(n_active/chunk)·chunk]`` selected by one
    ``lax.switch`` over the mp/chunk possible prefix lengths — each
    branch is a single fused GEMM on a statically-shaped slice, so only
    the taken branch's bytes move (the round-3 per-chunk
    ``lax.cond``+``dynamic_slice`` loop broke XLA fusion and lost 12×;
    this form keeps the one-GEMM structure of the full pass). Skipping
    is sound ONLY under the zero-padded-basis invariant (module
    docstring): any nonzero data in columns ≥ n_active inside the
    boundary chunk WOULD leak into c — those columns are not
    individually masked. Communication is UNCHANGED: one psum of the
    zero-padded (mp, k) coefficient block, exactly like the full-basis
    pass (the Belos MvTransMv + reduceAll split); branches hold no
    collectives, so shard_map sees one replicated-index switch with
    consistently device-varying operands and outputs.

    NOTE: under jax.vmap a traced per-batch ``n_active`` turns the
    ``lax.switch`` into select (every branch executes) — use the
    full-basis pass for batched projections.

    Opt-in only: nothing selects it by default, and on the GPU it has
    not been measured against the full-basis GEMM (ROADMAP D3).

    Returns (w2, c) with c zero-padded to (mp, k)."""
    n, mp = v.shape
    if mp % chunk:
        raise ValueError(f"basis columns {mp} not a multiple of chunk {chunk}")
    nc = mp // chunk
    k = w.shape[1]
    kidx = jnp.clip((jnp.asarray(n_active) - 1) // chunk, 0, nc - 1)

    def dots_branch(i):
        ncol = (i + 1) * chunk

        def br(v, w):
            c = jnp.einsum("nc,nk->ck", v[:, :ncol], w,
                           preferred_element_type=w.dtype, precision=HI)
            return jnp.pad(c, ((0, mp - ncol), (0, 0)))

        return br

    c = lax.switch(kidx, [dots_branch(i) for i in range(nc)], v, w)
    c = comm.psum(c)

    def upd_branch(i):
        ncol = (i + 1) * chunk

        def br(v, c, w):
            return w - jnp.einsum("nc,ck->nk", v[:, :ncol], c[:ncol],
                                  preferred_element_type=w.dtype,
                                  precision=HI)

        return br

    w2 = lax.switch(kidx, [upd_branch(i) for i in range(nc)], v, c, w)
    # n_active == 0 is a no-op (the old per-chunk loop's contract): the
    # switch always runs the one-chunk prefix, so mask it back out
    none_active = jnp.asarray(n_active) <= 0
    return (jnp.where(none_active, w, w2),
            jnp.where(none_active, jnp.zeros_like(c), c))


def cgs2_project_window(comm: Comm, v: jax.Array, w: jax.Array,
                        n_active, chunk: int = 8):
    """CGS2 (two unconditional passes) over the active window only."""
    w1, c1 = project_block_window(comm, v, w, n_active, chunk)
    w2, c2 = project_block_window(comm, v, w1, n_active, chunk)
    return w2, c1 + c2


def dgks_project_window(comm: Comm, v: jax.Array, w: jax.Array,
                        n_active, chunk: int = 8,
                        dep_tol: float = float(DGKS_DEP_TOL)):
    """DGKS (conditional second pass) over the active window only."""
    from ..ops.blas import local_dot

    norms_before = comm.psum(local_dot(w, w))
    w1, c1 = project_block_window(comm, v, w, n_active, chunk)
    norms_after = comm.psum(local_dot(w1, w1))
    need = jnp.any(norms_after < (dep_tol ** 2) * norms_before)

    def second(args):
        w1, c1 = args
        w2, c2 = project_block_window(comm, v, w1, n_active, chunk)
        return w2, c1 + c2

    return lax.cond(need, second, lambda a: a, (w1, c1))


def project_and_normalize(comm: Comm, v: jax.Array, w: jax.Array,
                          method: str = "CGS2"):
    """Full Belos-style projectAndNormalize: orthogonalize block w against
    basis v, then orthonormalize within the block.

    Returns (q, c, r, rank_ok): w ≈ v c + q r with qᵀq = I.
    ``method`` ∈ {"CGS2", "DGKS", "MGS1", "IMGS"} (MGS1 = single-pass MGS
    over all columns of v, assumed all valid; IMGS = two passes)."""
    if method == "CGS2":
        w2, c = cgs2_project(comm, v, w)
    elif method == "DGKS":
        w2, c = dgks_project(comm, v, w)
    elif method == "MGS1":
        w2, c = mgs_project(comm, v, w, v.shape[1])
    elif method == "IMGS":
        w1, c1 = mgs_project(comm, v, w, v.shape[1])
        w2, c2 = mgs_project(comm, v, w1, v.shape[1])
        c = c1 + c2
    else:
        raise ValueError(f"unknown ortho method {method!r}")
    q, r, rank_ok = cholqr2(comm, w2)
    return q, c, r, rank_ok


def valid_methods() -> tuple[str, ...]:
    """Names mirroring the reference's "Orthogonalization" parameter choices
    (BelosBlockGmresSolMgr.hpp:150-158: DGKS / ICGS / IMGS)."""
    return ("CGS2", "DGKS", "MGS1", "ICGS", "IMGS")


def resolve_method(name: str) -> str:
    """Map reference spellings to local implementations.

    IMGS resolves to a real iterated-MGS path (two modified-GS passes,
    one reduction per basis column per pass — BelosIMGSOrthoManager.hpp),
    NOT a silent CGS2 substitution; MGS/MGS1 is the single-pass variant."""
    alias = {"ICGS": "CGS2", "IMGS": "IMGS", "DGKS": "DGKS", "CGS2": "CGS2",
             "MGS1": "MGS1", "MGS": "MGS1"}
    try:
        return alias[name.upper()]
    except KeyError:
        raise ValueError(
            f"unknown orthogonalization {name!r}; valid: {valid_methods()}")


def masked_lstsq(h: jax.Array, rhs: jax.Array) -> jax.Array:
    """Least squares min ‖rhs − H y‖ for a full-length Arnoldi cycle's
    (m+1, m) Hessenberg, with numerically dependent trailing columns
    masked to y = 0 — the happy-breakdown guard: once the residual is
    captured mid-cycle the remaining columns are ~zero and the
    unguarded QR/triangular solve would corrupt the update (unit
    diagonal + zero rhs decouples the bad columns exactly because R is
    upper triangular). Shared by the GCRODR cycles."""
    dtype = h.dtype
    mk = h.shape[1]
    q_h, r_h = jnp.linalg.qr(h)
    diag = jnp.abs(jnp.diag(r_h))
    good = diag > 10 * jnp.finfo(dtype).eps * jnp.max(diag)
    r_m = jnp.where(jnp.logical_or(~good[None, :], ~good[:, None]),
                    jnp.eye(mk, dtype=dtype), r_h)
    rhs2 = rhs[:, None] if rhs.ndim == 1 else rhs
    qtr = jnp.where(good[:, None],
                    jnp.matmul(q_h.T, rhs2, precision=HI), 0.0)
    y = lax.linalg.triangular_solve(r_m, qtr, left_side=True, lower=False)
    y = jnp.where(good[:, None], y, 0.0)
    return y[:, 0] if rhs.ndim == 1 else y
