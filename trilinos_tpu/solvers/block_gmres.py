"""Block GMRES: one Krylov space shared by all right-hand sides.

JAX analogue of Belos::BlockGmresIter + BlockGmresSolMgr
(packages/belos/src/BelosBlockGmresIter.hpp:83,659 — block Arnoldi with
projectAndNormalize; per-step status testing at :676; least-squares update
``updateLSQR`` :742; packages/belos/src/BelosBlockGmresSolMgr.hpp:916 —
restart management; parameter surface :150-158/323-337).

Design for the accelerator:
  * block projection = CGS2/DGKS (two GEMM+psum passes) against the whole
    zero-padded basis; block normalization = CholQR2 — the TSQR-class
    single-reduction panel factorization (SURVEY.md §2.1 TSQR row);
  * the cycle is a static-shape ``while_loop`` over block Arnoldi steps
    with a PROGRESSIVE block QR of the Hessenberg matrix (the block
    analogue of Belos' Givens ``updateLSQR``): each step annihilates the
    new subdiagonal block with one small 2nb×2nb Householder QR, updates
    the transformed rhs g, and reads the per-column implicit residual from
    the next g block — so the cycle exits as soon as every column's
    estimate passes, and ``iters`` counts the block steps actually taken.
"""
from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax

from ..parallel.comm import Comm, SerialComm
from .base import Operator, SolveResult, identity_prec, rhs_norm_scale, hi_precision
from .ortho import cgs2_project, cholqr2, dgks_project, resolve_method


@hi_precision
def block_gmres(op: Operator, b: jax.Array, x0: jax.Array | None = None, *,
                prec: Operator | None = None, num_blocks: int = 30,
                max_restarts: int = 20, rtol: float = 1e-8,
                atol: float = 0.0, comm: Comm | None = None,
                ortho: str = "CGS2", basis_dtype=None) -> SolveResult:
    """Right-preconditioned block GMRES(m) for B of shape (n, nrhs).

    ``basis_dtype`` (e.g. ``jnp.bfloat16``): store the shared block
    Krylov basis — (m+1)·nrhs columns, the dominant HBM traffic of the
    block iteration — in a narrower dtype while the working block,
    CholQR panels, and progressive QR stay in b's dtype (see
    gmres(basis_dtype=...); the restart loop here is already
    TRUE-residual-gated, so narrow-basis cycles refine honestly)."""
    comm = comm or SerialComm()
    M = prec or identity_prec
    if b.ndim != 2:
        raise ValueError("block_gmres expects a 2-D multivector RHS")
    n, nb = b.shape
    m = num_blocks
    ortho_m = resolve_method(ortho)
    if ortho_m in ("MGS1", "IMGS"):
        # honest surface: the block iteration is written against block
        # (CGS-style) projections; per-column MGS lives in the scalar
        # gmres() core — raising beats silent substitution
        raise ValueError(
            "block_gmres supports CGS2/ICGS/DGKS orthogonalization; "
            "use gmres() for the MGS/IMGS path")
    project = cgs2_project if ortho_m != "DGKS" else dgks_project
    x = jnp.zeros_like(b) if x0 is None else x0
    dtype = b.dtype
    bdt = jnp.dtype(basis_dtype) if basis_dtype is not None else dtype

    from ..ops.blas import local_dot

    bnorm = jnp.sqrt(comm.psum(local_dot(b, b)))
    tol = rhs_norm_scale(bnorm, rtol, atol)
    mp1 = (m + 1) * nb

    def cycle(x):
        r = b - op(x)
        v0, r0_small, _ = cholqr2(comm, r)
        v = jnp.zeros((n, mp1), bdt)
        v = lax.dynamic_update_slice(v, v0.astype(bdt), (0, 0))
        # progressive QR state: qt = accumulated Qᵀ, rfac = R (unused
        # columns keep an identity diagonal so the final static-shape
        # triangular solve yields zeros for unused y rows), g = Qᵀ e1 R0
        qt = jnp.eye(mp1, dtype=dtype)
        rfac = jnp.eye(m * nb, dtype=dtype)
        g = jnp.zeros((mp1, nb), dtype)
        g = lax.dynamic_update_slice(g, r0_small, (0, 0))
        est0 = jnp.sqrt(jnp.sum(r0_small * r0_small, axis=0))

        def icond(s):
            v, qt, rfac, g, est, j = s
            return jnp.logical_and(j < m, jnp.any(est > tol))

        def istep(s):
            v, qt, rfac, g, _, j = s
            vj = lax.dynamic_slice(v, (0, j * nb), (n, nb)).astype(dtype)
            w = op(M(vj))
            w2, c = project(comm, v, w)
            q, r_small, _ = cholqr2(comm, w2)
            v = lax.dynamic_update_slice(v, q.astype(bdt), (0, (j + 1) * nb))
            hcol = lax.dynamic_update_slice(c, r_small, ((j + 1) * nb, 0))
            # apply accumulated transforms, then annihilate the new
            # subdiagonal block with one small complete QR
            cp = qt @ hcol
            top = lax.dynamic_slice(cp, (j * nb, 0), (nb, nb))
            bot = lax.dynamic_slice(cp, ((j + 1) * nb, 0), (nb, nb))
            qs, rs = jnp.linalg.qr(jnp.concatenate([top, bot], axis=0),
                                   mode="complete")
            rows = lax.dynamic_slice(qt, (j * nb, 0), (2 * nb, mp1))
            qt = lax.dynamic_update_slice(qt, qs.T @ rows, (j * nb, 0))
            g_rows = lax.dynamic_slice(g, (j * nb, 0), (2 * nb, nb))
            g = lax.dynamic_update_slice(g, qs.T @ g_rows, (j * nb, 0))
            col = lax.dynamic_update_slice(cp, rs[:nb], (j * nb, 0))
            col = lax.dynamic_update_slice(
                col, jnp.zeros((nb, nb), dtype), ((j + 1) * nb, 0))
            rfac = lax.dynamic_update_slice(rfac, col[: m * nb], (0, j * nb))
            # implicit residual per column: next g block row norms
            gres = lax.dynamic_slice(g, ((j + 1) * nb, 0), (nb, nb))
            est = jnp.sqrt(jnp.sum(gres * gres, axis=0))
            return v, qt, rfac, g, est, j + 1

        v, qt, rfac, g, est, j = lax.while_loop(
            icond, istep, (v, qt, rfac, g, est0, 0))
        # zero unused g rows so identity-diagonal columns give y = 0
        row = lax.broadcasted_iota(jnp.int32, (m * nb, 1), 0)
        g_used = jnp.where(row < j * nb, g[: m * nb], 0)
        y = jax.scipy.linalg.solve_triangular(rfac, g_used, lower=False)
        x = x + M(jnp.einsum("nm,mk->nk", v[:, : m * nb], y,
                             preferred_element_type=dtype))
        return x, j

    def res_norms(x):
        r = b - op(x)
        return jnp.sqrt(comm.psum(local_dot(r, r)))

    def cond(s):
        x, k, rn, steps = s
        return jnp.logical_and(k < max_restarts + 1, jnp.any(rn > tol))

    def body(s):
        x, k, _, steps = s
        x, j = cycle(x)
        return x, k + 1, res_norms(x), steps + j

    x, cycles, rn, steps = lax.while_loop(
        cond, body, (x, 0, res_norms(x), 0))
    return SolveResult(x=x, iters=steps, resnorm=rn, converged=rn <= tol)
