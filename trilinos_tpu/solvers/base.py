"""Shared solver infrastructure: result records, operator protocol.

The solver layer is written against two tiny protocols, the analogue of
Belos' MultiVecTraits / OperatorTraits firewall
(packages/belos/src/BelosMultiVecTraits.hpp:138-332, BelosOperatorTraits.hpp):

  * an *operator* is any callable ``y = op(x)`` on (n_pad,) or (n_pad, k)
    arrays — solvers never see matrix internals;
  * a *multivector* is a plain jnp array; its reductions go through a
    ``Comm`` (one psum for the global part).

This keeps every Krylov driver mesh-agnostic: the same code runs serial,
under shard_map over a device mesh axis, or wrapped in pjit.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax

Operator = Callable[[jax.Array], jax.Array]


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SolveResult:
    """What a solve returns (jittable pytree)."""

    x: jax.Array
    iters: jax.Array  # iterations performed (scalar int)
    resnorm: jax.Array  # final residual norm(s), per RHS column
    converged: jax.Array  # bool per RHS column
    # optional κ(M·A) estimate from the solver's own recurrence
    # coefficients (AZ_cg_condnum analogue); None unless requested
    condest: jax.Array | None = None
    # optional per-iteration implicit residual norms: (maxiter+1,) or
    # (maxiter+1, k), NaN past the final iteration — the residual trace
    # Belos prints via StatusTestOutput (BelosStatusTestOutput.hpp),
    # returned as data; None unless history=True was requested
    history: jax.Array | None = None


def hi_precision(fn: Callable) -> Callable:
    """Trace the wrapped driver under ``jax.default_matmul_precision
    ("highest")``: the DEFAULT matmul precision may run f32 products in
    TF32 on the GPU (~1e-3 relative per contraction — see ops/blas.py
    HI), which poisons Rayleigh-Ritz projections and basis collapses
    written with plain ``@``. The context applies at TRACE time, so
    inner ``jax.jit`` closures created inside the call inherit it.
    TT_GEMM_PRECISION=default disables (the ops/blas.py HI lever)."""
    import functools

    from ..ops.blas import _MODE as mode  # validated at blas import time

    if mode == "default":
        return fn

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision(mode):
            return fn(*args, **kwargs)

    return wrapped


def identity_prec(x: jax.Array) -> jax.Array:
    return x


def bcast_cols(scalars: jax.Array, v: jax.Array) -> jax.Array:
    """Broadcast per-column scalars onto a (n,) or (n, k) multivector."""
    if v.ndim == 1:
        return scalars * v
    return scalars[None, :] * v


def safe_divide(num: jax.Array, den: jax.Array) -> jax.Array:
    """num/den with 0 where den==0 (guards frozen/converged columns)."""
    return jnp.where(den != 0, num / jnp.where(den != 0, den, 1), 0)


def rhs_norm_scale(bnorm: jax.Array, rtol, atol) -> jax.Array:
    """Convergence threshold ||r|| <= rtol*||b|| + atol, with the Belos
    convention that a zero RHS scales by 1 (BelosStatusTestGenResNorm
    scaling of the implicit residual)."""
    scale = jnp.where(bnorm > 0, bnorm, 1)
    return rtol * scale + atol


def certified_solve(solve_from, op, b, x0, tol, maxiter, comm,
                    aux0=None, halt=None):
    """Run a solver loop, certify with an explicit residual, and — when
    the recurrence undershoots (f32 drift: the implicit residual crosses
    the tolerance a few percent before the true one) — RESUME with a
    16x tightened loop threshold until the certified residual passes or
    maxiter is exhausted. This is the compiled-loop form of Belos'
    ImpResNorm loss-of-accuracy recovery (BelosStatusTestImpResNorm.hpp:
    47-88: tighten currTolerance and keep iterating).

    solve_from(x, tol2_loop, k0) -> (x, k) continues the iteration from
    ``x`` (k counts cumulative iterations; must not exceed maxiter).

    aux0: optional auxiliary pytree threaded through the retry loop —
    solve_from is then called as (x, tol2, k0, aux) -> (x, k, aux) and
    the final aux is returned as a 5th result (solvers use it to record
    recurrence coefficients, e.g. the CG Lanczos condition estimate).

    Tightening attempts are capped (4 passes): an UNATTAINABLE tolerance
    (e.g. rtol 1e-8 in f32) is reported as converged=False after a
    bounded amount of extra work instead of spinning to maxiter — the
    loss-of-accuracy exit of the reference test.

    halt: optional predicate (k, rr) -> bool (rr = squared residual):
    True means the solve ended for a reason tightening cannot cure (a
    user StatusTest fired) — skip the retry passes instead of
    re-entering the loop for no progress.
    """
    from ..ops.blas import local_dot

    tol2 = tol * tol

    def true_rr(x):
        r = b - op(x)
        return comm.psum(local_dot(r, r))

    def cond(s):
        x, k, t2, rr, tries, aux = s
        go = jnp.logical_and(
            jnp.logical_and(k < maxiter, tries < 4),
            jnp.any(rr > tol2))
        if halt is not None:
            go = jnp.logical_and(
                go, ~jnp.logical_and(tries > 0, halt(k, rr)))
        return go

    def body(s):
        x, k, t2, _, tries, aux = s
        if aux0 is None:
            x, k = solve_from(x, t2, k)
        else:
            x, k, aux = solve_from(x, t2, k, aux)
        return (x, k, t2 * jnp.asarray(0.0625, t2.dtype), true_rr(x),
                tries + 1, aux)

    t2_0 = tol2 * jnp.ones_like(jnp.asarray(tol))
    x, k, t2, rr, tries, aux = lax.while_loop(
        cond, body,
        (x0, 0, t2_0, jnp.full_like(t2_0, jnp.inf), 0, aux0))
    resnorm = jnp.sqrt(rr)
    if aux0 is None:
        return x, k, resnorm, resnorm <= tol
    return x, k, resnorm, resnorm <= tol, aux


def certify_residual(op: Operator, b: jax.Array, x: jax.Array, tol, comm):
    """Explicit-residual certification at convergence.

    Recurrence residuals drift from the true residual in finite precision;
    Belos cross-checks the implicit residual with an explicitly computed
    one before declaring convergence (BelosStatusTestImpResNorm.hpp:47-88,
    the "loss of accuracy" test). Every Krylov driver here calls this once
    after its iteration loop: one extra operator apply + one reduction.

    Returns (resnorm_true, converged) with per-column semantics.
    """
    from ..ops.blas import local_dot

    r = b - op(x)
    rr = comm.psum(local_dot(r, r))
    resnorm = jnp.sqrt(rr)
    return resnorm, resnorm <= tol
