"""Anderson acceleration for fixed-point iterations.

JAX analogue of NOX::Solver::AndersonAcceleration
(reference: packages/nox/src/NOX_Solver_AndersonAcceleration.H:78-94 —
first step x1 = x0 + beta*M(x0)F(x0); thereafter the new iterate is the
least-squares mixing sum_i alpha_i [x_{k-i} + beta M F(x_{k-i})] over a
depth-m history, with optional QR-dropping when the history becomes
ill-conditioned).

Formulation (Walker-Ni "type II", the same one NOX implements via
updated QR): with residual r_k = g(x_k) - x_k, difference histories
dX = [x_{k-m+1}-x_{k-m} ...], dR likewise, solve the tiny m×m
least-squares  min ||r_k - dR gamma||  and take
    x_{k+1} = x_k + beta r_k - (dX + beta dR) gamma.

The histories live as (m, n) device arrays; the normal-equations solve
is an m×m host-side lstsq (m <= 10), so each iteration is one g()
evaluation plus two small GEMMs — entirely dense device work at scale.
"""
from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..parallel.comm import Comm
from .base import NonlinearResult, default_comm, fnorm2


def anderson(g: Callable[[jax.Array], jax.Array], x0: jax.Array, *,
             m: int = 5, beta: float = 1.0,
             maxiter: int = 200, rtol: float = 1e-8, atol: float = 0.0,
             drop_tol: float = 1e10,
             comm: Comm | None = None) -> NonlinearResult:
    """Accelerate the fixed-point iteration x <- g(x).

    Convergence is ||g(x)-x|| <= rtol*||g(x0)-x0|| + atol. ``m`` is the
    mixing depth ("Storage Depth" in NOX), ``beta`` the damping ("Mixing
    Parameter"). ``drop_tol`` bounds the condition estimate of the
    difference history; the oldest columns are dropped beyond it (the
    role of NOX's QR-dropping, NOX_Solver_AndersonAcceleration.H:102).

    To accelerate a *preconditioned residual* iteration (NOX's
    formulation), pass ``g = lambda x: x + beta_M(prec(F(x)))``.
    """
    comm = default_comm(comm)
    g_jit = jax.jit(g)
    res_sq = jax.jit(lambda y, gy: fnorm2(comm, gy - y))

    x = x0
    gx = g_jit(x)
    rnorm = float(np.sqrt(jax.device_get(res_sq(x, gx))))
    target = rtol * rnorm + atol
    xs: list[jax.Array] = [x]
    rs: list[jax.Array] = [gx - x]
    it = 0
    converged = rnorm <= target

    while not converged and it < maxiter:
        r = rs[-1]
        if len(xs) >= 2:
            dX = jnp.stack([xs[i + 1] - xs[i]
                            for i in range(len(xs) - 1)])   # (mk, n)
            dR = jnp.stack([rs[i + 1] - rs[i]
                            for i in range(len(rs) - 1)])
            # tiny normal-equations solve on host; comm.psum makes the
            # Gram matrix global under shard_map
            gram = np.asarray(jax.device_get(
                comm.psum(dR @ dR.conj().T)))
            rhs = np.asarray(jax.device_get(comm.psum(dR @ r.conj())))
            # condition-based history dropping (NOX's QR drop role)
            while gram.shape[0] > 1:
                cond = np.linalg.cond(gram)
                if np.isfinite(cond) and cond <= drop_tol:
                    break
                gram = gram[1:, 1:]
                rhs = rhs[1:]
                dX = dX[1:]
                dR = dR[1:]
                xs = xs[1:]
                rs = rs[1:]
            gamma = jnp.asarray(
                np.linalg.lstsq(gram, rhs, rcond=None)[0], x.dtype)
            x_new = (x + beta * r
                     - (dX + beta * dR).T @ gamma)
        else:
            x_new = x + beta * r      # first step: damped Picard
        x = x_new
        gx = g_jit(x)
        rnorm = float(np.sqrt(jax.device_get(res_sq(x, gx))))
        xs.append(x)
        rs.append(gx - x)
        if len(xs) > m + 1:           # history window of m differences
            xs = xs[1:]
            rs = rs[1:]
        it += 1
        converged = rnorm <= target

    return NonlinearResult(
        x=x, iters=jnp.asarray(it), fnorm=jnp.asarray(rnorm),
        converged=jnp.asarray(bool(converged)),
        inner_iters=jnp.asarray(0))
