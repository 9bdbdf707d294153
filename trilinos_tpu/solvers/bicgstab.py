"""BiCGStab — stabilized bi-conjugate gradients.

JAX analogue of Belos::BiCGStabIter
(packages/belos/src/BelosBiCGStabIter.hpp). Right-preconditioned form; per
iteration: 2 operator applies, 2 preconditioner applies, and 3 reduction
points (rho/convergence fused into one psum; <rhat,v>; <t,s>/<t,t> fused).

Multivector RHS is handled natively (per-column scalar recurrences, shared
batched kernels) — the pseudo-block pattern.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.blas import local_dot
from ..parallel.comm import Comm, SerialComm
from .base import (Operator, SolveResult, bcast_cols, certified_solve,
                   identity_prec, rhs_norm_scale, safe_divide)


def bicgstab(op: Operator, b: jax.Array, x0: jax.Array | None = None, *,
             prec: Operator | None = None, rtol: float = 1e-8,
             atol: float = 0.0, maxiter: int = 1000,
             comm: Comm | None = None) -> SolveResult:
    comm = comm or SerialComm()
    M = prec or identity_prec
    x = jnp.zeros_like(b) if x0 is None else x0

    bb = comm.psum(local_dot(b, b))
    tol = rhs_norm_scale(jnp.sqrt(bb), rtol, atol)

    def solve_from(x, tol2, k0):
        r = b - op(x)
        rhat = r  # shadow residual fixed at the segment's r0 (Belos
        # default; a certified tighten-retry restarts it from the true
        # residual, which is also the standard BiCGStab restart)
        d0 = comm.psum(jnp.stack([local_dot(rhat, r),
                                  local_dot(r, r)]))
        rho, rr = d0[0], d0[1]
        p = r
        v = jnp.zeros_like(r)
        one = jnp.ones_like(rho)

        def cond(s):
            x, r, p, v, rho, alpha, omega, rr, k = s
            return jnp.logical_and(k < maxiter, jnp.any(rr > tol2))

        def body(s):
            x, r, p, v, rho, alpha, omega, rr, k = s
            active = rr > tol2
            yv = M(p)
            v_new = op(yv)
            rhat_v = comm.psum(local_dot(rhat, v_new))
            alpha_new = jnp.where(active, safe_divide(rho, rhat_v), 0)
            s_vec = r - bcast_cols(alpha_new, v_new)
            zs = M(s_vec)
            t = op(zs)
            dt = comm.psum(jnp.stack([local_dot(t, s_vec),
                                      local_dot(t, t)]))
            omega_new = jnp.where(active, safe_divide(dt[0], dt[1]), 0)
            x = x + bcast_cols(alpha_new, yv) + bcast_cols(omega_new, zs)
            r_new = s_vec - bcast_cols(omega_new, t)
            d = comm.psum(jnp.stack([local_dot(rhat, r_new),
                                     local_dot(r_new, r_new)]))
            rho_new, rr_new = d[0], d[1]
            beta = jnp.where(
                active,
                safe_divide(rho_new, rho)
                * safe_divide(alpha_new, omega_new), 0)
            p = r_new + bcast_cols(beta, p - bcast_cols(omega_new, v_new))
            return (x, r_new, p, v_new, jnp.where(active, rho_new, rho),
                    alpha_new, omega_new, jnp.where(active, rr_new, rr),
                    k + 1)

        state = (x, r, p, v, rho, one, one, rr, k0)
        out = lax.while_loop(cond, body, state)
        return out[0], out[8]

    x, k, resnorm, conv = certified_solve(solve_from, op, b, x, tol,
                                          maxiter, comm)
    return SolveResult(x=x, iters=k, resnorm=resnorm, converged=conv)
