"""LSQR — least-squares solver via Golub-Kahan bidiagonalization.

JAX analogue of Belos::LSQRIter/LSQRSolMgr
(packages/belos/src/BelosLSQRIter.hpp). Needs the transpose apply
(``op_t``); with our formats that is the scatter-add transpose SpMV.
Single RHS (the reference's LSQR is single-vector too).
"""
from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax

from ..parallel.comm import Comm, SerialComm, norm2
from .base import Operator, SolveResult, safe_divide


def lsqr(op: Operator, op_t: Operator, b: jax.Array,
         x0: jax.Array | None = None, *, rtol: float = 1e-8,
         atol: float = 0.0, maxiter: int = 1000,
         damp: float = 0.0, comm: Comm | None = None) -> SolveResult:
    comm = comm or SerialComm()
    x = jnp.zeros_like(b) if x0 is None else x0

    u = b - op(x)
    beta = norm2(comm, u)
    u = safe_divide(u, beta)
    v = op_t(u)
    alpha = norm2(comm, v)
    v = safe_divide(v, alpha)
    w = v
    phibar = beta
    rhobar = alpha
    bnorm = norm2(comm, b)
    scale = jnp.where(bnorm > 0, bnorm, 1)
    tol = rtol * scale + atol

    def cond(s):
        x, u, v, w, alpha, beta, phibar, rhobar, k = s
        return jnp.logical_and(k < maxiter, jnp.abs(phibar) > tol)

    def body(s):
        x, u, v, w, alpha, beta, phibar, rhobar, k = s
        u = op(v) - alpha * u
        beta = norm2(comm, u)
        u = safe_divide(u, beta)
        v_new = op_t(u) - beta * v
        alpha = norm2(comm, v_new)
        v_new = safe_divide(v_new, alpha)
        # damping rotation first (sign of rhobar must be preserved):
        # [cs1 sn1; -sn1 cs1] eliminates damp against rhobar
        rhobar1 = jnp.sqrt(rhobar * rhobar + damp * damp)
        cs1 = jnp.where(rhobar1 != 0,
                        rhobar / jnp.where(rhobar1 != 0, rhobar1, 1), 1.0)
        phibar = cs1 * phibar  # cs1 carries rhobar's sign (scipy-style)
        # main plane rotation
        rho = jnp.sqrt(rhobar1 * rhobar1 + beta * beta)
        c = safe_divide(rhobar1, rho)
        s_ = safe_divide(beta, rho)
        theta = s_ * alpha
        rhobar = -c * alpha
        phi = c * phibar
        phibar = s_ * phibar
        x = x + safe_divide(phi, rho) * w
        w = v_new - safe_divide(theta, rho) * w
        return x, u, v_new, w, alpha, beta, phibar, rhobar, k + 1

    s0 = (x, u, v, w, alpha, beta, phibar, rhobar, 0)
    x, u, v, w, alpha, beta, phibar, rhobar, k = lax.while_loop(cond, body, s0)
    return SolveResult(x=x, iters=k, resnorm=jnp.abs(phibar),
                       converged=jnp.abs(phibar) <= tol)


def fixed_point(op: Operator, b: jax.Array, x0: jax.Array | None = None, *,
                prec: Operator | None = None, rtol: float = 1e-8,
                atol: float = 0.0, maxiter: int = 1000, omega: float = 1.0,
                comm: Comm | None = None) -> SolveResult:
    """Preconditioned Richardson iteration x ← x + ω M(b − A x)
    (Belos::FixedPointIter, packages/belos/src/BelosFixedPointIter.hpp)."""
    from ..ops.blas import local_dot
    from .base import identity_prec, rhs_norm_scale

    comm = comm or SerialComm()
    M = prec or identity_prec
    x = jnp.zeros_like(b) if x0 is None else x0
    bnorm = jnp.sqrt(comm.psum(local_dot(b, b)))
    tol = rhs_norm_scale(bnorm, rtol, atol)
    tol2 = tol * tol

    def rr(x):
        r = b - op(x)
        return comm.psum(local_dot(r, r))

    def cond(s):
        x, k, r2 = s
        return jnp.logical_and(k < maxiter, jnp.any(r2 > tol2))

    def body2(s):
        x, k, _ = s
        r = b - op(x)
        x = x + omega * M(r)
        return x, k + 1, rr(x)

    x, k, r2 = lax.while_loop(cond, body2, (x, 0, rr(x)))
    rn = jnp.sqrt(r2)
    return SolveResult(x=x, iters=k, resnorm=rn, converged=r2 <= tol2)
