"""Block GCRO-DR: recycling GMRES for multiple right-hand sides.

JAX analogue of Belos::BlockGCRODRSolMgr
(packages/belos/src/BelosBlockGCRODRSolMgr.hpp — block Arnoldi with the
recycle-space deflation of Parks/de Sturler GCRO-DR; all nrhs columns
share ONE Krylov space and ONE recycle space U with C = A U, C^T C = I,
which survives restarts and subsequent related solves).

Per cycle (one jitted program):
  1. exact solve in range(U):  X += U C^T R,  R -= C C^T R
  2. block Arnoldi on the C-deflated operator: W = A V_j, W -= C(C^T W)
     (coefficients B_j recorded), CGS2 projection + CholQR2
     normalization — 4 reductions per block step
  3. block least squares  min ||E1 R0 - Hbar Y||  and the GCRO solution
     update  X += V Y - U (B Y)  (the -U B Y term keeps the new residual
     orthogonal to C exactly, BelosGCRODRIter's U-correction)
Recycle construction (host, after the first cycle, as in the scalar
gcrodr): harmonic Ritz vectors of the block Hessenberg from the
generalized eigenproblem  Hbar^T Hbar g = theta Hm^T g.
"""
from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..parallel.comm import Comm, SerialComm
from .base import Operator, SolveResult, hi_precision
from .gcrodr import (RecycleSpace, _orthonormalize_cu,
                     _right_prec_solve)
from .ortho import cgs2_project, cholqr2, masked_lstsq


@functools.partial(jax.jit, static_argnames=("op", "m", "comm"))
def _block_cycle(op, m, comm, b, x, u, c, has_recycle):
    """One block GCRO cycle. b, x: (n, nb); u, c: (n, k)."""
    from ..ops.blas import local_dot

    n, nb = b.shape
    k = u.shape[1]
    dtype = b.dtype
    r = b - op(x)
    ctr = comm.psum(c.T @ r)
    ctr = jnp.where(has_recycle, ctr, 0)
    x = x + u @ ctr
    r = r - c @ ctr

    v0, r0, _ = cholqr2(comm, r)
    mp1 = (m + 1) * nb
    v = jnp.zeros((n, mp1), dtype)
    v = lax.dynamic_update_slice(v, v0, (0, 0))
    h = jnp.zeros((mp1, m * nb), dtype)
    bmat = jnp.zeros((k, m * nb), dtype)

    def body(j, carry):
        v, h, bmat = carry
        vj = lax.dynamic_slice(v, (0, j * nb), (n, nb))
        w = op(vj)
        cw = comm.psum(c.T @ w)
        cw = jnp.where(has_recycle, cw, 0)
        w = w - c @ cw
        bmat = lax.dynamic_update_slice(bmat, cw, (0, j * nb))
        w2, hc = cgs2_project(comm, v, w)
        q, r_small, _ = cholqr2(comm, w2)
        v = lax.dynamic_update_slice(v, q, (0, (j + 1) * nb))
        hcol = lax.dynamic_update_slice(hc, r_small, ((j + 1) * nb, 0))
        h = lax.dynamic_update_slice(h, hcol, (0, j * nb))
        return v, h, bmat

    v, h, bmat = lax.fori_loop(0, m, body, (v, h, bmat))

    rhs = jnp.zeros((mp1, nb), dtype)
    rhs = lax.dynamic_update_slice(rhs, r0, (0, 0))
    # masked LS = the happy-breakdown guard (ortho.masked_lstsq)
    y = masked_lstsq(h, rhs)
    x = x + v[:, : m * nb] @ y - u @ jnp.where(has_recycle,
                                               bmat @ y, 0)
    r = b - op(x)
    rn = jnp.sqrt(comm.psum(local_dot(r, r)))
    return x, rn, v, h


def _block_harmonic_recycle(v_np, h_np, k):
    """k smallest harmonic Ritz vectors of the block Hessenberg:
    generalized eig Hbar^T Hbar g = theta Hm^T g (host scipy/numpy)."""
    import scipy.linalg as sla

    mnb = h_np.shape[1]
    hm = h_np[:mnb, :]
    try:
        theta, g = sla.eig(h_np.T @ h_np, hm.T, right=True)
    except Exception:
        return None
    finite = np.isfinite(theta)
    if finite.sum() < k:
        return None
    # drop non-finite pairs up front: NaNs poison the conjugate-pair
    # argmin bookkeeping below (a singular QZ pencil yields beta=0)
    theta, g = theta[finite], g[:, finite]
    order = np.argsort(np.abs(theta))
    cols, used = [], set()
    for idx in order:
        if len(cols) >= k:
            break
        if idx in used:
            continue
        vec = g[:, idx]
        if np.abs(theta[idx].imag) > 1e-12:
            cols.append(np.real(vec))
            cols.append(np.imag(vec))
            conj = np.argmin(np.abs(theta - np.conj(theta[idx])))
            used.add(int(conj))
        else:
            cols.append(np.real(vec))
        used.add(int(idx))
    p = np.stack(cols[:k], axis=1)
    return v_np[:, :mnb] @ p


@hi_precision
def block_gcrodr(op: Operator, b: jax.Array,
                 x0: jax.Array | None = None, *, num_blocks: int = 20,
                 recycle_dim: int = 8, max_cycles: int = 40,
                 rtol: float = 1e-8, atol: float = 0.0,
                 comm: Comm | None = None,
                 prec: Operator | None = None,
                 recycle: RecycleSpace | None = None
                 ) -> tuple[SolveResult, RecycleSpace]:
    """Solve A X = B (B of shape (n, nrhs)) with block recycling;
    returns (result, recycle_space). Pass the space into the next
    related solve to reuse it (the reference's sequence-of-systems
    feature, now amortized over all columns at once).

    ``prec``: right preconditioner M — solved as (A∘M) Y = R0 with
    X = X0 + M Y (see gcrodr; per-column tolerances carry over
    exactly). Reuse the returned recycle space only with the SAME
    preconditioner."""
    comm = comm or SerialComm()
    if b.ndim != 2:
        raise ValueError("block_gcrodr expects a 2-D multivector RHS")
    if prec is not None:
        return _right_prec_solve(
            lambda opc, r0, ta: block_gcrodr(
                opc, r0, num_blocks=num_blocks, recycle_dim=recycle_dim,
                max_cycles=max_cycles, rtol=0.0, atol=ta, comm=comm,
                recycle=recycle),
            op, prec, b, x0, rtol, atol, comm)
    from ..ops.blas import local_dot

    m = num_blocks
    k = recycle_dim
    n, nb = b.shape
    dtype = b.dtype
    x = jnp.zeros_like(b) if x0 is None else x0
    recycle = recycle or RecycleSpace()

    bnorm = np.asarray(jnp.sqrt(comm.psum(local_dot(b, b))))
    tol = rtol * np.where(bnorm > 0, bnorm, 1.0) + atol

    if recycle.u is not None:
        # re-map onto THIS operator (C = A U exactly — see
        # gcrodr; a stale C from a previous system diverges)
        u, c, has_rec = _orthonormalize_cu(op, comm,
                                           recycle.u.astype(dtype))
        if not has_rec:
            u = jnp.zeros((n, k), dtype)
            c = jnp.zeros((n, k), dtype)
    else:
        u = jnp.zeros((n, k), dtype)
        c = jnp.zeros((n, k), dtype)
        has_rec = False

    rn = np.full(nb, np.inf)
    cycles = 0
    while cycles < max_cycles and (rn > tol).any():
        x, rn_j, v_last, h_last = _block_cycle(op, m, comm, b, x, u, c,
                                               has_rec)
        rn = np.asarray(rn_j)
        cycles += 1
        if not has_rec:
            u_np = _block_harmonic_recycle(np.asarray(v_last),
                                           np.asarray(h_last), k)
            if u_np is not None:
                u, c, has_rec = _orthonormalize_cu(
                    op, comm, jnp.asarray(u_np, dtype=dtype))

    result = SolveResult(x=x, iters=jnp.asarray(cycles * m),
                         resnorm=jnp.asarray(rn),
                         converged=jnp.asarray(rn <= tol))
    return result, RecycleSpace(u if has_rec else None,
                                c if has_rec else None)
