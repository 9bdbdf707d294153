"""Parameter continuation (LOCA analogue): natural and pseudo-arclength.

Reference anchors: packages/nox/src-loca/src/LOCA_Stepper.C (the outer
stepper: predict -> corrector solve -> adapt step size),
LOCA_MultiContinuation_ArcLengthGroup.C / ArcLengthConstraint.C (the
bordered arc-length system).

JAX-native form: the bordered corrector is solved MATRIX-FREE — the
augmented unknown is u = [x; lam] and the augmented residual

    G(u) = [ F(x, lam) ; xi * tx.(x - xp) + (1-xi) * tl (lam - lp) - 0 ]

is handed to the same JFNK Newton driver (newton.py), so LOCA's
bordered-solve machinery (block elimination, Householder projections)
collapses into one autodiff JVP on the stacked vector. Tangents come
from the secant of the last two accepted points (LOCA's secant
predictor).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..parallel.comm import Comm
from .base import default_comm
from .newton import newton_krylov

ParamResidual = Callable[[jax.Array, jax.Array], jax.Array]


@dataclasses.dataclass
class ContinuationResult:
    """Accepted continuation points."""

    params: np.ndarray          # (nsteps,) parameter values
    xs: list[jax.Array]         # solution at each accepted point
    fnorms: np.ndarray          # corrector final residual norms
    steps_failed: int           # rejected corrector solves


def continuation(f: ParamResidual, x0: jax.Array, *,
                 p0: float, p_final: float, dp0: float,
                 arclength: bool = False,
                 dp_min: float = 1e-6, dp_max: float | None = None,
                 max_steps: int = 100,
                 newton_rtol: float = 1e-8, newton_atol: float = 1e-10,
                 newton_maxiter: int = 20,
                 grow_iters: int = 4, shrink_iters: int = 10,
                 comm: Comm | None = None) -> ContinuationResult:
    """Trace F(x, p) = 0 from (x0, p0) toward p_final.

    natural (arclength=False): p is stepped explicitly and each corrector
    solves F(., p)=0 warm-started from the last point (LOCA "Natural"
    continuation). arclength=True: pseudo-arclength steps along the
    secant tangent, solving the bordered system above — it can round
    turning points where natural continuation stalls (LOCA "Arc Length").

    Step adaptation follows LOCA_Stepper's agressive/failed-step policy:
    halve on corrector failure, grow 1.5x when the corrector converged
    in <= grow_iters Newton iterations, shrink 0.7x above shrink_iters.
    """
    comm = default_comm(comm)
    dp_max = dp_max if dp_max is not None else abs(p_final - p0)
    direction = 1.0 if p_final >= p0 else -1.0
    dp = direction * abs(dp0)

    params = [float(p0)]
    xs = [x0]
    fnorms = [float(np.sqrt(jax.device_get(
        jnp.vdot(f(x0, jnp.asarray(p0, x0.dtype)),
                 f(x0, jnp.asarray(p0, x0.dtype))).real)))]
    failed = 0
    x, p = x0, float(p0)

    def solve_natural(xg, pv):
        fp = lambda y: f(y, jnp.asarray(pv, xg.dtype))
        return newton_krylov(fp, xg, maxiter=newton_maxiter,
                             rtol=newton_rtol, atol=newton_atol,
                             comm=comm)

    xi = 0.5  # arclength scaling between state and parameter parts

    def solve_arc(xg, pg, xp, pp, tx, tl, ds):
        n = xg.shape[0]

        def g(u):
            xv, lam = u[:n], u[n]
            r = f(xv, lam)
            arc = (xi * jnp.vdot(tx, xv - xp).real
                   + (1 - xi) * tl * (lam - pp) - ds)
            return jnp.concatenate([r, arc[None].astype(r.dtype)])

        u0 = jnp.concatenate([xg, jnp.asarray([pg], xg.dtype)])
        res = newton_krylov(g, u0, maxiter=newton_maxiter,
                            rtol=newton_rtol, atol=newton_atol,
                            comm=comm)
        return res, res.x[:n], float(jax.device_get(res.x[n]))

    for _ in range(max_steps):
        if direction * (p - p_final) >= 0:
            break
        dp = direction * min(abs(dp), dp_max,
                             max(direction * (p_final - p), dp_min))
        if arclength and len(xs) >= 2:
            # secant tangent from the last two accepted points,
            # normalized in the xi-weighted arclength norm
            tx_raw = xs[-1] - xs[-2]
            tl_raw = params[-1] - params[-2]
            ds0 = float(np.sqrt(
                xi * float(jax.device_get(jnp.vdot(tx_raw, tx_raw).real))
                + (1 - xi) * tl_raw * tl_raw))
            scale = abs(dp) / max(abs(tl_raw), 1e-12)  # step sized in p
            ds = scale * ds0
            tx = tx_raw / max(ds0, 1e-300)
            tl = tl_raw / max(ds0, 1e-300)
            x_guess = xs[-1] + scale * tx_raw
            p_guess = p + scale * tl_raw
            res, x_new, p_new = solve_arc(x_guess, p_guess, xs[-1], p,
                                          tx, tl, ds)
        else:
            p_new = p + dp
            x_guess = (xs[-1] + (xs[-1] - xs[-2]) * (dp / (params[-1]
                       - params[-2])) if len(xs) >= 2
                       and params[-1] != params[-2] else x)
            res = solve_natural(x_guess, p_new)
            x_new = res.x

        if bool(jax.device_get(res.converged)):
            x, p = x_new, float(p_new)
            params.append(p)
            xs.append(x)
            fnorms.append(float(jax.device_get(res.fnorm)))
            it = int(jax.device_get(res.iters))
            if it <= grow_iters:
                dp *= 1.5
            elif it >= shrink_iters:
                dp *= 0.7
        else:
            failed += 1
            dp *= 0.5
            if abs(dp) < dp_min:
                break

    return ContinuationResult(params=np.asarray(params), xs=xs,
                              fnorms=np.asarray(fnorms),
                              steps_failed=failed)
