"""GCRO-DR: GMRES with recycling (deflated restarts + cross-solve recycle).

JAX analogue of Belos::GCRODRSolMgr
(packages/belos/src/BelosGCRODRSolMgr.hpp — Parks/de Sturler GCRO-DR:
maintain a recycle space U with C = A U, CᵀC = I; each cycle solves
exactly in range(U), runs deflated Arnoldi in the complement, and refreshes
U from harmonic Ritz vectors; U survives restarts AND subsequent related
solves — the reference's flagship "sequence of systems" feature).

Structure: the per-cycle work (deflated Arnoldi + LS update) is one jitted
computation; the small harmonic-Ritz eigenproblem runs on host between
cycles (it needs a nonsymmetric eig, which XLA does not provide on the GPU) —
mirroring the SolMgr/Iteration split of the reference.
"""
from __future__ import annotations

import functools
from typing import Callable

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..parallel.comm import Comm, SerialComm, norm2
from .base import Operator, SolveResult, safe_divide, hi_precision
from .ortho import cgs2_project, masked_lstsq


class RecycleSpace:
    """Carrier for (U, C) across solves (A U = C, CᵀC = I)."""

    def __init__(self, u=None, c=None):
        self.u = u
        self.c = c

    @property
    def size(self) -> int:
        return 0 if self.u is None else self.u.shape[1]


def _right_prec_solve(inner, op, prec, b, x0, rtol, atol, comm):
    """Shared right-preconditioning wrapper (gcrodr/block_gcrodr —
    BelosGCRODRSolMgr's preconditioned mode): solve (A∘M) y = r0 with
    x = x0 + M y. Composed-system residuals ARE the true residuals of
    A x = b, so rtol·‖b‖ (columnwise for multivectors) translates to an
    absolute tolerance on the inner solve and certification carries
    over exactly. ``inner(op_composed, r0, tol_abs) -> (res, rec)``."""
    from ..ops.blas import local_dot

    x_base = jnp.zeros_like(b) if x0 is None else x0
    r0 = b if x0 is None else b - op(x_base)
    bnorm = np.asarray(jnp.sqrt(comm.psum(local_dot(b, b))))
    tol_abs = rtol * np.where(bnorm > 0, bnorm, 1.0) + atol
    res, rec = inner(lambda v: op(prec(v)), r0, tol_abs)
    return (SolveResult(x=x_base + prec(res.x), iters=res.iters,
                        resnorm=res.resnorm, converged=res.converged),
            rec)


@functools.partial(jax.jit, static_argnames=("op", "m", "comm"))
def _cycle(op, m, comm, b, x, u, c, has_recycle):
    """One GCRO cycle: U-correction + deflated Arnoldi(m) + LS update.
    u, c always have k columns (zeros when has_recycle is false)."""
    n = b.shape[0]
    dtype = b.dtype
    r = b - op(x)
    # exact solve in range(U): x += U Cᵀ r ; r ← (I − C Cᵀ) r
    ctr = comm.psum(c.T @ r)
    ctr = jnp.where(has_recycle, ctr, 0)
    x = x + u @ ctr
    r = r - c @ ctr
    beta = norm2(comm, r)
    v = jnp.zeros((n, m + 1), dtype).at[:, 0].set(safe_divide(r, beta))
    h = jnp.zeros((m + 1, m), dtype)
    bm = jnp.zeros((c.shape[1], m), dtype)  # B = Cᵀ A V_m

    def body(j, carry):
        v, h, bm = carry
        vj = lax.dynamic_slice(v, (0, j), (n, 1))[:, 0]
        w = op(vj)
        # deflate against C, then orthogonalize against V (CGS2)
        cw = comm.psum(c.T @ w)
        cw = jnp.where(has_recycle, cw, 0)
        w = w - c @ cw
        bm = lax.dynamic_update_slice(bm, cw[:, None], (0, j))
        w2, hc = cgs2_project(comm, v, w[:, None])
        w2 = w2[:, 0]
        hn = norm2(comm, w2)
        hcol = hc[:, 0].at[j + 1].set(hn)
        v = lax.dynamic_update_slice(v, safe_divide(w2, hn)[:, None],
                                     (0, j + 1))
        h = lax.dynamic_update_slice(h, hcol[:, None], (0, j))
        return v, h, bm

    v, h, bm = lax.fori_loop(0, m, body, (v, h, bm))
    e1 = jnp.zeros(m + 1, dtype).at[0].set(beta)
    # masked LS = the happy-breakdown guard: the cycle runs all m steps,
    # so a mid-cycle-captured residual leaves ~zero trailing columns
    # whose unguarded solve would corrupt x (ortho.masked_lstsq)
    y = masked_lstsq(h, e1)
    # GCRO update (Parks et al.; BelosGCRODRIter): A U = C exactly, so
    # x += V y − U (Cᵀ A V) y cancels the C-components of A V y and the
    # residual reduction equals the deflated-space LS reduction — without
    # the U term the C-pollution stalls the per-cycle true residual
    x = x + v[:, :m] @ y - u @ (bm @ y)
    r = b - op(x)
    rn = norm2(comm, r)
    return x, rn, v, h


def _harmonic_ritz_recycle(v_np, h_np, k):
    """New recycle basis from the k smallest harmonic Ritz vectors of H
    (host-side nonsymmetric eig, as in BelosGCRODRSolMgr getHarmonicVecs)."""
    m = h_np.shape[1]
    hm = h_np[:m, :]
    hlast = h_np[m, m - 1]
    try:
        f = np.linalg.solve(hm.T, np.eye(m)[:, -1])
    except np.linalg.LinAlgError:
        return None
    mat = hm + (hlast ** 2) * np.outer(f, np.eye(m)[-1])
    theta, g = np.linalg.eig(mat)
    order = np.argsort(np.abs(theta))
    cols = []
    used = set()
    for idx in order:
        if len(cols) >= k:
            break
        if idx in used:
            continue
        vec = g[:, idx]
        if np.abs(theta[idx].imag) > 1e-12:
            # complex pair -> two real vectors
            cols.append(np.real(vec))
            cols.append(np.imag(vec))
            conj = np.argmin(np.abs(theta - np.conj(theta[idx])))
            used.add(conj)
        else:
            cols.append(np.real(vec))
        used.add(idx)
    p = np.stack(cols[:k], axis=1)
    return v_np[:, :m] @ p


@hi_precision
def gcrodr(op: Operator, b: jax.Array, x0: jax.Array | None = None, *,
           num_blocks: int = 30, recycle_dim: int = 8,
           max_cycles: int = 40, rtol: float = 1e-8, atol: float = 0.0,
           comm: Comm | None = None,
           prec: Operator | None = None,
           recycle: RecycleSpace | None = None
           ) -> tuple[SolveResult, RecycleSpace]:
    """Solve with recycling; returns (result, recycle_space). Pass the
    returned space into the next related solve to reuse it.

    ``prec``: right preconditioner M — solved as (A∘M) y = r0 with
    x = x0 + M y (residuals of the composed system ARE the true
    residuals of A x = b, so tolerances and certification carry over
    exactly; BelosGCRODRSolMgr's preconditioned mode). The recycle
    space then lives in the composed-operator coordinates — reuse it
    only across solves with the SAME preconditioner."""
    comm = comm or SerialComm()
    if prec is not None:
        return _right_prec_solve(
            lambda opc, r0, ta: gcrodr(
                opc, r0, num_blocks=num_blocks, recycle_dim=recycle_dim,
                max_cycles=max_cycles, rtol=0.0, atol=ta, comm=comm,
                recycle=recycle),
            op, prec, b, x0, rtol, atol, comm)
    m = num_blocks
    k = recycle_dim
    x = jnp.zeros_like(b) if x0 is None else x0
    n = b.shape[0]
    dtype = b.dtype
    recycle = recycle or RecycleSpace()

    bnorm = float(norm2(comm, b))
    tol = rtol * (bnorm if bnorm > 0 else 1.0) + atol

    if recycle.u is not None:
        # re-map the recycle space onto THIS operator: C must equal
        # A U exactly for the U-correction/deflation to be sound, and
        # the sequence-of-systems use case hands us a CHANGED A (Belos
        # GCRODR recomputes C = A U per system in solve(); a stale C
        # makes the correction diverge — measured 1e12 blowup on a
        # drifting-values sequence). Costs k applies + one CholQR2.
        u, c, has_rec = _orthonormalize_cu(op, comm,
                                           recycle.u.astype(dtype))
        if not has_rec:
            u = jnp.zeros((n, k), dtype)
            c = jnp.zeros((n, k), dtype)
    else:
        u = jnp.zeros((n, k), dtype)
        c = jnp.zeros((n, k), dtype)
        has_rec = False

    rn = np.inf
    cycles = 0
    v_last = None
    h_last = None
    while cycles < max_cycles and rn > tol:
        x, rn_j, v_last, h_last = _cycle(op, m, comm, b, x, u, c, has_rec)
        rn = float(rn_j)
        cycles += 1
        if not has_rec:
            # build the recycle space from the first cycle's Arnoldi data
            u_np = _harmonic_ritz_recycle(np.asarray(v_last),
                                          np.asarray(h_last), k)
            if u_np is not None:
                u, c, has_rec = _orthonormalize_cu(op, comm,
                                                   jnp.asarray(u_np,
                                                               dtype=dtype))

    result = SolveResult(x=x, iters=jnp.asarray(cycles * m),
                         resnorm=jnp.asarray(rn),
                         converged=jnp.asarray(rn <= tol))
    return result, RecycleSpace(u if has_rec else None,
                                c if has_rec else None)


def _orthonormalize_cu(op, comm, u):
    """Given raw U, set C = A U, QR(C) → C orthonormal, U ← U R⁻¹.
    Third return is False when the panel is numerically rank-deficient
    (cholqr2 rank flags) — callers then drop the recycle space."""
    c_raw = op(u)
    from .ortho import cholqr2

    c_q, r_c, ok = cholqr2(comm, c_raw)
    u_new = lax.linalg.triangular_solve(r_c, u, left_side=False, lower=False)
    return u_new, c_q, bool(jnp.all(ok))
