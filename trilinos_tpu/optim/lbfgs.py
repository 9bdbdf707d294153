"""Limited-memory BFGS with Armijo backtracking (ROL analogue).

Reference anchors: packages/rol/src/step/ROL_LineSearchStep.hpp
(descent step = secant direction + line search),
ROL_lBFGS.hpp (the two-loop recursion over the (s, y) history),
ROL_Secant.hpp (curvature-pair acceptance), ROL_BackTracking.hpp.

JAX-native form: the history lives as two fixed-shape (m, n) device
arrays (newest pair LAST) and the entire two-loop recursion is one
jitted `lax.fori_loop` program with a validity mask over the not-yet-
filled slots — fixed shapes, no per-iteration retrace, one compile per
(objective, memory)."""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .base import OptimizeResult, _obj_fns


@functools.lru_cache(maxsize=64)
def _two_loop(obj, m: int):
    _ = _obj_fns(obj)  # shared cache warmup; direction needs only g

    @jax.jit
    def direction(g, S, Y, rho, k, gamma):
        """-H_k g via the two-loop recursion; slots [m-k, m) are valid
        (newest last)."""
        def bwd(i_, carry):
            i = m - 1 - i_
            q, alpha = carry
            valid = i >= m - k
            a = jnp.where(valid, rho[i] * jnp.vdot(S[i], q), 0.0)
            return q - a * Y[i], alpha.at[i].set(a)

        q, alpha = jax.lax.fori_loop(
            0, m, bwd, (g, jnp.zeros(m, g.dtype)))
        r = gamma * q

        def fwd(i, r):
            valid = i >= m - k
            b = jnp.where(valid, rho[i] * jnp.vdot(Y[i], r), 0.0)
            return r + jnp.where(valid, alpha[i] - b, 0.0) * S[i]

        r = jax.lax.fori_loop(0, m, fwd, r)
        return -r

    return direction


def _wolfe_search(val_grad, x, d, fx, slope, *, c1, c2, noise,
                  maxsteps):
    """Strong-Wolfe line search (Nocedal-Wright Alg. 3.5/3.6
    bracket + zoom; the guarantee that s.y > 0 so every secant pair is
    storable — Armijo alone lets the curvature pair go negative in a
    curved valley and freezes the L-BFGS history).

    Returns (t, f_t, g_t, evals) or (None, ...) on failure. ``noise``
    is the rounding-level allowance on the sufficient-decrease test."""
    def phi(t):
        f_t, g_t = val_grad(x + t * d)
        return float(f_t), g_t, float(jnp.vdot(g_t, d))

    evals = 0

    def zoom(lo, f_lo, hi, budget):
        nonlocal evals
        f_best = f_lo
        for _ in range(budget):
            t = 0.5 * (lo + hi)
            f_t, g_t, dphi_t = phi(t)
            evals += 1
            if (f_t > fx + c1 * t * slope + noise) or f_t >= f_best:
                hi = t
            else:
                if abs(dphi_t) <= -c2 * slope:
                    return t, f_t, g_t
                if dphi_t * (hi - lo) >= 0:
                    hi = lo
                lo, f_best = t, f_t
        f_t, g_t, _ = phi(lo)
        evals += 1
        return lo, f_t, g_t

    t_prev, f_prev = 0.0, fx
    t = 1.0
    for i in range(maxsteps):
        f_t, g_t, dphi_t = phi(t)
        evals += 1
        if (f_t > fx + c1 * t * slope + noise) or (i > 0
                                                   and f_t >= f_prev):
            t, f_t, g_t = zoom(t_prev, f_prev, t, maxsteps - i)
            return t, f_t, g_t, evals
        if abs(dphi_t) <= -c2 * slope:
            return t, f_t, g_t, evals
        if dphi_t >= 0:
            t, f_t, g_t = zoom(t, f_t, t_prev, maxsteps - i)
            return t, f_t, g_t, evals
        t_prev, f_prev = t, f_t
        t *= 2.0
    return (t, f_t, g_t, evals) if f_t <= fx + noise else (None, fx,
                                                           None, evals)


def lbfgs(obj, x0, *, memory: int = 10, gtol: float = 1e-6,
          maxiter: int = 500, c1: float = 1e-4, c2: float = 0.9,
          ls_maxsteps: int = 25) -> OptimizeResult:
    """Minimize smooth ``obj(x) -> scalar`` by L-BFGS (ROL
    "Line Search" step with the "Limited-Memory BFGS" secant and the
    strong-Wolfe "Cubic Interpolation"-class search ROL pairs it with).

    The Wolfe curvature condition |g_new.d| <= c2 |g.d| guarantees
    s.y > 0, so every accepted step yields a valid secant pair; pairs
    are additionally gated on s.y > 1e-10 ||s|| ||y|| (ROL_Secant's
    updateStorage acceptance test) and the initial Hessian scaling is
    the Barzilai-Borwein gamma = s.y / y.y."""
    val_grad, _, value = _obj_fns(obj)
    direction = _two_loop(obj, memory)
    n = x0.shape[0]
    m = memory

    S = jnp.zeros((m, n), x0.dtype)
    Y = jnp.zeros((m, n), x0.dtype)
    rho = jnp.zeros(m, x0.dtype)
    k = 0
    gamma = 1.0

    x = x0
    fx, g = val_grad(x)
    fx = float(fx)
    gnorm = float(jnp.linalg.norm(g))
    eps = float(jnp.finfo(x.dtype).eps)
    it = inner = 0
    while gnorm > gtol and it < maxiter:
        d = direction(g, S, Y, rho, jnp.asarray(k),
                      jnp.asarray(gamma, x.dtype))
        slope = float(jnp.vdot(g, d))
        if slope >= 0:  # stale curvature produced an ascent direction
            d, slope = -g, -gnorm * gnorm
        # sufficient decrease cannot be resolved below the rounding
        # noise of f — allow it (else f32 runs backtrack forever near
        # the optimum; same safeguard as the trust-region rho)
        noise = 10.0 * eps * max(abs(fx), 1.0)
        t, f_new, g_new, evals = _wolfe_search(
            val_grad, x, d, fx, slope, c1=c1, c2=c2, noise=noise,
            maxsteps=ls_maxsteps)
        inner += evals
        if t is None:
            break
        x_new = x + t * d
        s = x_new - x
        yv = g_new - g
        sy = float(jnp.vdot(s, yv))
        if sy > 1e-10 * float(jnp.linalg.norm(s)
                              * jnp.linalg.norm(yv)):
            S = jnp.roll(S, -1, axis=0).at[-1].set(s)
            Y = jnp.roll(Y, -1, axis=0).at[-1].set(yv)
            rho = jnp.roll(rho, -1).at[-1].set(1.0 / sy)
            k = min(k + 1, m)
            gamma = sy / float(jnp.vdot(yv, yv))
        x, g = x_new, g_new
        fx = f_new
        gnorm = float(jnp.linalg.norm(g))
        it += 1
    return OptimizeResult(x=x, fval=fx, gnorm=gnorm, iters=it,
                          converged=gnorm <= gtol, inner_iters=inner)
