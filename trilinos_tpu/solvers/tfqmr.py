"""TFQMR — transpose-free quasi-minimal residual (Freund '93).

JAX analogue of Belos::TFQMRIter
(packages/belos/src/BelosTFQMRIter.hpp). Two operator applies per outer
step (one per inner half-step), no transpose apply needed. The loop
tests the quasi-residual τ directly (the reference's implicit test);
since τ can UNDERestimate the true residual by up to √(2k+2), the final
result is certified by an explicit residual recompute and — when τ
undershot — resumed with a tightened loop threshold
(``certified_solve``, the BelosStatusTestImpResNorm loss-of-accuracy
recovery), so ``converged``/``resnorm`` are always honest.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.blas import local_dot
from ..parallel.comm import Comm, SerialComm
from .base import (Operator, SolveResult, bcast_cols, certified_solve,
                   identity_prec, rhs_norm_scale, safe_divide)


def tfqmr(op: Operator, b: jax.Array, x0: jax.Array | None = None, *,
          prec: Operator | None = None, rtol: float = 1e-8,
          atol: float = 0.0, maxiter: int = 1000,
          comm: Comm | None = None) -> SolveResult:
    comm = comm or SerialComm()
    M = prec or identity_prec
    x = jnp.zeros_like(b) if x0 is None else x0

    def amul(v):
        return op(M(v))

    bb = comm.psum(local_dot(b, b))
    tol = rhs_norm_scale(jnp.sqrt(bb), rtol, atol)

    def solve_from(x, tol2, k0):
        loop_tol = jnp.sqrt(tol2)  # τ is a norm, not a squared norm
        # solve A M du = r0 (u-space), then x = x0 + M du — keeps an
        # arbitrary x0 consistent with right preconditioning
        r0 = b - op(x)
        du = jnp.zeros_like(b)
        rr0 = comm.psum(local_dot(r0, r0))
        tau = jnp.sqrt(rr0)
        rtilde = r0
        w = r0
        u = r0
        v = amul(u)
        d = jnp.zeros_like(b)
        rho = rr0
        theta = jnp.zeros_like(tau)
        eta = jnp.zeros_like(tau)
        alpha = jnp.zeros_like(tau)

        def cond(s):
            (x, w, u, v, d, rho, tau, theta, eta, alpha, k) = s
            return jnp.logical_and(k < maxiter, jnp.any(tau > loop_tol))

        def body(s):
            (x, w, u, v, d, rho, tau, theta, eta, alpha, k) = s
            active = tau > loop_tol
            # parity is per-SEGMENT (k counts cumulative iterations
            # across certified tighten-retries; the first step of each
            # segment must be the alpha-computing even half-step)
            even = ((k - k0) % 2) == 0

            def half_even(args):
                x, w, u, v, d, rho, tau, theta, eta, alpha = args
                sigma = comm.psum(local_dot(rtilde, v))
                alpha_n = jnp.where(active, safe_divide(rho, sigma), 0)
                return x, w, u, v, d, rho, tau, theta, eta, alpha_n

            def half_odd(args):
                return args

            x, w, u, v, d, rho, tau, theta, eta, alpha = lax.cond(
                even, half_even, half_odd,
                (x, w, u, v, d, rho, tau, theta, eta, alpha))

            au = amul(u)
            w_new = w - bcast_cols(alpha, au)
            d = u + bcast_cols(
                jnp.where(alpha != 0,
                          safe_divide(theta * theta, alpha) * eta, 0), d)
            ww = comm.psum(local_dot(w_new, w_new))
            theta_new = safe_divide(jnp.sqrt(ww), tau)
            c = safe_divide(1.0, jnp.sqrt(1.0 + theta_new * theta_new))
            tau_new = tau * theta_new * c
            eta_new = c * c * alpha
            x = x + bcast_cols(jnp.where(active, eta_new, 0), d)

            def odd_update(args):
                u, v, rho = args
                rho_new = comm.psum(local_dot(rtilde, w_new))
                beta = safe_divide(rho_new, rho)
                u_new = w_new + bcast_cols(beta, u)
                au_new = amul(u_new)
                v_new = au_new + bcast_cols(
                    beta, au + bcast_cols(beta, v))
                return u_new, v_new, rho_new

            def even_update(args):
                u, v, rho = args
                # second half-step: u ← u − α v
                return u - bcast_cols(alpha, v), v, rho

            u, v, rho = lax.cond(jnp.logical_not(even), odd_update,
                                 even_update, (u, v, rho))
            return (x, w_new, u, v, d, rho,
                    jnp.where(active, tau_new, tau),
                    jnp.where(active, theta_new, theta),
                    jnp.where(active, eta_new, eta), alpha, k + 1)

        state = (du, w, u, v, d, rho, tau, theta, eta, alpha, k0)
        out = lax.while_loop(cond, body, state)
        du, k = out[0], out[10]
        return x + M(du), k

    x, k, resnorm, conv = certified_solve(solve_from, op, b, x, tol,
                                          maxiter, comm)
    return SolveResult(x=x, iters=k, resnorm=resnorm, converged=conv)
