"""True block conjugate gradients (shared Krylov space).

JAX analogue of Belos::BlockCGIter behind BlockCGSolMgr
(packages/belos/src/BelosBlockCGIter.hpp, BelosBlockCGSolMgr.hpp): all s
right-hand sides share ONE block Krylov space, so spectral information
discovered for any column accelerates every column — unlike the
pseudo-block ``cg``, whose columns run independent recurrences with
batched kernels. Per iteration: one block operator apply + TWO fused
block reductions (PᵀAP and ZᵀR ride one psum each as s×s GEMMs — the
MvTransMv shape, BelosMultiVecTraits.hpp:138-332) + two s×s host-free
least-squares solves on device.

Rank deficiency (converged or linearly dependent columns) is handled by
minimum-norm least-squares for the block coefficients instead of the
reference's column-deflation permutations — static shapes make removal
impossible, and the lstsq solution zeroes the defective directions'
updates, which is the same fixed point. All columns iterate until every
column passes (the shared space makes per-column freezing meaningless).

Convergence is certified by an explicit residual with bounded
tighten-retry like every driver here (Belos ImpResNorm discipline).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.blas import local_dot
from ..parallel.comm import Comm, SerialComm
from .base import (Operator, SolveResult, certified_solve, hi_precision,
                   identity_prec, rhs_norm_scale)


def _block_dot(comm: Comm, u: jax.Array, v: jax.Array) -> jax.Array:
    """(s, s) global block inner product UᵀV — exact f32 accumulation
    (a default-precision dot may round operands to TF32 on the GPU)."""
    return comm.psum(jnp.matmul(u.T, v,
                                precision=lax.Precision.HIGHEST))


def _ls_solve(a: jax.Array, rhs: jax.Array) -> jax.Array:
    """Minimum-norm solve of the small block system (rank-robust)."""
    return jnp.linalg.lstsq(a, rhs)[0]


@hi_precision
def block_cg(op: Operator, b: jax.Array, x0: jax.Array | None = None, *,
             prec: Operator | None = None, rtol: float = 1e-8,
             atol: float = 0.0, maxiter: int = 1000,
             comm: Comm | None = None) -> SolveResult:
    """Solve A X = B for an (n, s) block of right-hand sides in one
    shared block Krylov space. A must be SPD (and the preconditioner
    symmetric positive definite), like CG."""
    comm = comm or SerialComm()
    M = prec or identity_prec
    was_1d = b.ndim == 1
    if was_1d:
        b = b[:, None]
    x = jnp.zeros_like(b) if x0 is None else (
        x0[:, None] if was_1d and x0.ndim == 1 else x0)
    bb = comm.psum(local_dot(b, b))
    tol = rhs_norm_scale(jnp.sqrt(bb), rtol, atol)

    def solve_from(x, tol2, k0):
        r = b - op(x)
        z = M(r)
        p = z
        s_zr = _block_dot(comm, z, r)
        rr = comm.psum(local_dot(r, r))

        def cond(st):
            rr, k = st[5], st[6]
            return jnp.logical_and(k < maxiter, jnp.any(rr > tol2))

        def body(st):
            x, r, z, p, s_zr, rr, k = st
            ap = op(p)
            pap = _block_dot(comm, p, ap)
            alpha = _ls_solve(pap, s_zr)          # (s, s)
            hi = lax.Precision.HIGHEST            # exact f32 updates
            x = x + jnp.matmul(p, alpha, precision=hi)
            r = r - jnp.matmul(ap, alpha, precision=hi)
            z = M(r)
            s_new = _block_dot(comm, z, r)
            beta = _ls_solve(s_zr, s_new)
            p = z + jnp.matmul(p, beta, precision=hi)
            rr = comm.psum(local_dot(r, r))
            return (x, r, z, p, s_new, rr, k + 1)

        out = lax.while_loop(cond, body, (x, r, z, p, s_zr, rr, k0))
        return out[0], out[6]

    x, k, resnorm, conv = certified_solve(solve_from, op, b, x, tol,
                                          maxiter, comm)
    if was_1d:
        return SolveResult(x=x[:, 0], iters=k, resnorm=resnorm[0],
                           converged=conv[0])
    return SolveResult(x=x, iters=k, resnorm=resnorm, converged=conv)
