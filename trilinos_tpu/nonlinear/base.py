"""Shared nonlinear-solver infrastructure.

JAX analogue of the NOX abstract layer
(reference: packages/nox/src/NOX_Solver_Generic.H,
NOX_Abstract_Group.C — iterate/status protocol over an abstract vector).

Design: the nonlinear OUTER loop runs on the host (NOX's solvers are host
loops over Group operations too); every inner piece — residual evaluation,
Jacobian-vector products, the Krylov correction solve, line-search merit
evaluations — is a jitted device program. Newton iteration counts are
small (5-20) and each step is dominated by an inner Krylov solve, so the
host round-trips are noise; in exchange the outer loop can do data-driven
step control (forcing terms, backtracking, trust-region radius) without
compiling a mega-while-loop.

The residual is any callable ``F(x) -> r`` built from jax primitives.
Jacobian actions come from ``jax.jvp`` (exact, forward-mode) rather than
NOX's finite-difference MatrixFree operator
(NOX_Epetra_MatrixFree.H — eta-perturbation directional differences):
autodiff gives the directional derivative to machine precision at the
same cost, which removes NOX's perturbation-parameter tuning entirely.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp

from ..parallel.comm import Comm, SerialComm

Residual = Callable[[jax.Array], jax.Array]


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class NonlinearResult:
    """What a nonlinear solve returns."""

    x: jax.Array
    iters: jax.Array        # outer (Newton/Anderson) iterations
    fnorm: jax.Array        # final ||F(x)||_2
    converged: jax.Array    # bool
    inner_iters: jax.Array  # total inner Krylov iterations (0 if none)


def fnorm2(comm: Comm, r: jax.Array) -> jax.Array:
    """Global squared two-norm of a residual vector."""
    return comm.psum(jnp.vdot(r, r).real)


def make_jvp_operator(f: Residual, x: jax.Array):
    """Exact Jacobian-action operator v -> F'(x) v via forward-mode AD.

    The closure re-linearizes at the captured x; under jit the linearize
    happens once per trace. This is the JFNK operator handed to GMRES
    (reference contrast: NOX_Epetra_MatrixFree.H computes
    (F(x+eta v)-F(x))/eta instead)."""
    def op(v: jax.Array) -> jax.Array:
        return jax.jvp(f, (x,), (v,))[1]
    return op


def make_vjp_operator(f: Residual, x: jax.Array):
    """Transpose Jacobian action v -> F'(x)^T v via reverse-mode AD
    (used by the trust-region Cauchy step: grad 0.5||F||^2 = J^T F)."""
    _, pullback = jax.vjp(f, x)

    def op(v: jax.Array) -> jax.Array:
        return pullback(v)[0]
    return op


_SERIAL = SerialComm()


def default_comm(comm: Comm | None) -> Comm:
    # singleton: the comm participates in newton._jfnk_pieces' cache key,
    # and a fresh SerialComm per call would defeat the cross-call cache
    return comm if comm is not None else _SERIAL
