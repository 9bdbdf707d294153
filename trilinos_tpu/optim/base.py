"""Shared optimization infrastructure (ROL analogue).

Reference anchors: packages/rol/src/algorithm/ROL_Algorithm.hpp (the
run loop: compute step -> update -> status test), ROL_StatusTest.hpp
(gtol/stol/maxit), ROL_Objective.hpp (value/gradient/hessVec protocol).

JAX-native design, same shape as the ``nonlinear`` package: the outer
loop runs on the host (ROL's Algorithm::run is a host loop over
abstract-vector ops too); value, gradient, Hessian-vector products, and
inner subproblem solves are jitted device programs cached PER OBJECTIVE
(`_obj_fns`) with the iterate as a jit argument — one compile serves
the whole optimization run. ROL's Objective asks users to implement
``gradient`` and ``hessVec`` by hand (or falls back to finite
differences, ROL_Objective_def.hpp); here `jax.grad` and
forward-over-reverse `jax.jvp` of the gradient supply both exactly.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp


@dataclasses.dataclass
class OptimizeResult:
    x: jax.Array
    fval: float
    gnorm: float            # ||grad|| (projected grad for bounds)
    iters: int
    converged: bool
    inner_iters: int = 0    # truncated-CG / line-search evaluations


@functools.lru_cache(maxsize=64)
def _obj_fns(obj):
    """Jitted (value+grad, hessian-vector) pair per objective.

    The objective may take extra jit-traced arguments after x
    (``obj(x, *args)`` — e.g. the multiplier/penalty state of the
    augmented Lagrangian), so one compile serves a whole family of
    subproblems."""
    val_grad = jax.jit(jax.value_and_grad(obj))

    @jax.jit
    def hvp(x, v, *args):
        return jax.jvp(lambda xx: jax.grad(obj)(xx, *args), (x,),
                       (v,))[1]

    value = jax.jit(obj)
    return val_grad, hvp, value
