"""MINRES — minimal residual for symmetric (possibly indefinite) systems.

JAX analogue of Belos::MinresIter
(packages/belos/src/BelosMinresIter.hpp). Lanczos three-term recurrence +
on-the-fly Givens; per iteration 1 operator apply, 1 preconditioner apply,
and 1 fused reduction. Preconditioner must be SPD (applied symmetrically
via the M-inner-product formulation, as in the reference).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.blas import local_dot
from ..parallel.comm import Comm, SerialComm
from .base import (Operator, SolveResult, bcast_cols, certified_solve,
                   identity_prec, rhs_norm_scale, safe_divide)


def minres(op: Operator, b: jax.Array, x0: jax.Array | None = None, *,
           prec: Operator | None = None, rtol: float = 1e-8,
           atol: float = 0.0, maxiter: int = 1000,
           comm: Comm | None = None) -> SolveResult:
    comm = comm or SerialComm()
    M = prec or identity_prec
    x = jnp.zeros_like(b) if x0 is None else x0

    bb = comm.psum(local_dot(b, b))
    tol = rhs_norm_scale(jnp.sqrt(bb), rtol, atol)
    return _minres_certified(op, M, b, x, tol, maxiter, comm)


def _minres_certified(op, M, b, x0, tol, maxiter, comm):
    def solve_from(x, tol2, k0):
        return _minres_loop(op, M, b, x, tol2, maxiter, comm, k0)

    x, k, resnorm, conv = certified_solve(solve_from, op, b, x0, tol,
                                          maxiter, comm)
    return SolveResult(x=x, iters=k, resnorm=resnorm, converged=conv)


def _minres_loop(op, M, b, x, tol2, maxiter, comm, k0):
    loop_tol = jnp.sqrt(tol2)  # phibar is a norm, not a squared norm
    r1 = b - op(x)
    y = M(r1)
    beta1_sq = comm.psum(local_dot(r1, y))
    beta1 = jnp.sqrt(jnp.maximum(beta1_sq, 0))

    zero = jnp.zeros_like(beta1)
    one = jnp.ones_like(beta1)
    state = dict(
        x=x, r1=r1, r2=r1, y=y,
        w=jnp.zeros_like(b), w2=jnp.zeros_like(b),
        beta=beta1, beta1=beta1, phibar=beta1,
        oldb=zero, dbar=zero, epsln=zero,
        cs=-one, sn=zero, phi=beta1, k=jnp.asarray(k0))

    def cond(s):
        return jnp.logical_and(s["k"] < maxiter,
                               jnp.any(s["phibar"] > loop_tol))

    def body(s):
        active = s["phibar"] > loop_tol
        v = bcast_cols(safe_divide(one, s["beta"]), s["y"])
        yv = op(v)
        # single fused reduction point for alfa; beta needs the updated r
        alfa = comm.psum(local_dot(v, yv))
        yv = yv - bcast_cols(safe_divide(alfa, s["beta"]), s["r2"])
        yv = yv - bcast_cols(safe_divide(s["beta"], s["oldb"])
                             * jnp.where(s["k"] > 0, 1.0, 0.0), s["r1"])
        r1n = s["r2"]
        r2n = yv
        yn = M(r2n)
        beta_sq = comm.psum(local_dot(r2n, yn))
        beta_new = jnp.sqrt(jnp.maximum(beta_sq, 0))
        # Givens update of the tridiagonal factorization
        oldeps = s["epsln"]
        delta = s["cs"] * s["dbar"] + s["sn"] * alfa
        gbar = s["sn"] * s["dbar"] - s["cs"] * alfa
        epsln = s["sn"] * beta_new
        dbar = -s["cs"] * beta_new
        gamma = jnp.sqrt(gbar * gbar + beta_new * beta_new)
        gamma = jnp.maximum(gamma, jnp.finfo(gbar.dtype).tiny)
        cs = safe_divide(gbar, gamma)
        sn = safe_divide(beta_new, gamma)
        phi = cs * s["phibar"]
        phibar = sn * s["phibar"]
        # solution update
        denom = safe_divide(one, gamma)
        w1 = s["w2"]
        w2n = s["w"]
        w = bcast_cols(denom, v - bcast_cols(oldeps, w1)
                       - bcast_cols(delta, w2n))
        xn = s["x"] + bcast_cols(jnp.where(active, phi, 0), w)
        return dict(
            x=xn, r1=r1n, r2=r2n, y=yn, w=w, w2=w2n,
            beta=beta_new, beta1=s["beta1"],
            phibar=jnp.where(active, phibar, s["phibar"]),
            oldb=s["beta"], dbar=dbar, epsln=epsln,
            cs=cs, sn=sn, phi=phi, k=s["k"] + 1)

    out = lax.while_loop(cond, body, state)
    return out["x"], out["k"]
