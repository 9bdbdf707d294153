"""LinearProblem: the (A, X, B, preconditioners) container.

JAX analogue of ``Belos::LinearProblem``
(packages/belos/src/BelosLinearProblem.hpp:170-492 — holds operator, LHS,
RHS, left/right preconditioners; ``apply`` composes prec∘op; tracks the
current residual; ``updateSolution`` at :745).

The composition rules match the reference:
  * left prec  M_L: solve M_L A x = M_L b (residual measured in M_L-space)
  * right prec M_R: solve A M_R u = b, x = M_R u
Both at once gives the split-preconditioned operator M_L A M_R.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp

from .base import Operator


@dataclasses.dataclass
class LinearProblem:
    op: Operator
    b: jax.Array
    x0: jax.Array | None = None
    left_prec: Operator | None = None
    right_prec: Operator | None = None
    # optional composable StatusTest (solvers.status.Test): evaluated
    # in-loop by CG/GMRES SolverManagers in ADDITION to the built-in
    # resnorm/maxiter stopping — the user-defined StatusTest slot of
    # Belos::SolverManager (setUserConvStatusTest)
    stop_test: Callable | None = None

    def set_problem(self) -> "LinearProblem":
        """Finalize (Belos setProblem): default X0 = 0."""
        if self.x0 is None:
            self.x0 = jnp.zeros_like(self.b)
        return self

    # -- composed operator quantities -------------------------------------
    def composed_op(self) -> Operator:
        op = self.op
        ml, mr = self.left_prec, self.right_prec

        def apply(v):
            w = mr(v) if mr is not None else v
            w = op(w)
            return ml(w) if ml is not None else w

        return apply

    def composed_rhs(self) -> jax.Array:
        return self.left_prec(self.b) if self.left_prec is not None else self.b

    def recover_solution(self, u: jax.Array) -> jax.Array:
        """Map the solver-variable solution back to x (right-prec undo)."""
        return self.right_prec(u) if self.right_prec is not None else u

    def residual(self, x: jax.Array) -> jax.Array:
        """True (unpreconditioned) residual b − A x."""
        return self.b - self.op(x)
