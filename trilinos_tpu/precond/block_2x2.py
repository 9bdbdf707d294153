"""Blocked operators and 2×2 block preconditioners.

JAX analogue of Xpetra's BlockedCrsMatrix
(packages/xpetra/src/BlockedCrsMatrix/ — an operator stored as a grid of
sub-blocks with a MapExtractor) and of Teko's block preconditioner
factories (packages/teko/src/Teko_BlockPreconditionerFactory.hpp — block
Jacobi/Gauss-Seidel, and the NS-style approximate Schur complement of
teko/src/NS/, here as ``SimpleSchur2x2``).

A ``BlockedOperator`` holds the four sub-operators as callables; the
preconditioners take per-block *inverse approximations* (any framework
preconditioner or callable), so e.g. AMG-on-A00 + Jacobi-on-A11 composes
naturally.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp

Op = Callable


@dataclasses.dataclass
class BlockedOperator2x2:
    """y = [[a00, a01], [a10, a11]] @ [x0; x1] with x split at ``split``."""

    a00: Op
    a01: Op
    a10: Op
    a11: Op
    split: int  # rows of the first block (padded)

    def __call__(self, x: jax.Array) -> jax.Array:
        x0, x1 = x[: self.split], x[self.split:]
        y0 = self.a00(x0) + self.a01(x1)
        y1 = self.a10(x0) + self.a11(x1)
        return jnp.concatenate([y0, y1], axis=0)


def block_diagonal_prec(inv00: Op, inv11: Op, split: int) -> Op:
    """Teko block-Jacobi: M⁻¹ = diag(Â00⁻¹, Â11⁻¹)."""

    def apply(r):
        return jnp.concatenate([inv00(r[:split]), inv11(r[split:])], axis=0)

    return apply


def block_lower_triangular_prec(inv00: Op, a10: Op, inv11: Op,
                                split: int) -> Op:
    """Teko block-Gauss-Seidel (lower): solve Â00 y0 = r0, then
    Â11 y1 = r1 − A10 y0."""

    def apply(r):
        y0 = inv00(r[:split])
        y1 = inv11(r[split:] - a10(y0))
        return jnp.concatenate([y0, y1], axis=0)

    return apply


def simple_schur_2x2(inv00: Op, a01: Op, a10: Op, inv_schur: Op,
                     split: int) -> Op:
    """SIMPLE-style approximate block-LU (Teko NS family):
        y0' = Â00⁻¹ r0
        y1  = Ŝ⁻¹ (r1 − A10 y0')       (Ŝ ≈ A11 − A10 Â00⁻¹ A01)
        y0  = y0' − Â00⁻¹ (A01 y1)
    """

    def apply(r):
        y0p = inv00(r[:split])
        y1 = inv_schur(r[split:] - a10(y0p))
        y0 = y0p - inv00(a01(y1))
        return jnp.concatenate([y0, y1], axis=0)

    return apply


def lsc_inv_schur(inv_bqbt: Op, b: Op, f: Op, bt: Op,
                  qinv: Op | None = None) -> Op:
    """Teko NS least-squares-commutator Schur inverse
    (teko/src/NS/Teko_LSCPreconditionerFactory.hpp / Elman et al.):
    for the saddle operator [[F, B^T], [B, 0]] with S = -B F^-1 B^T,

        S^-1 ~= -(B Q^-1 B^T)^-1 (B Q^-1 F Q^-1 B^T) (B Q^-1 B^T)^-1

    ``inv_bqbt`` is a solver for the pressure Poisson-like operator
    B Q^-1 B^T (any framework solver/preconditioner — AMG is the usual
    choice), ``qinv`` the (diagonal/lumped) velocity mass inverse
    (identity if None). Exact when F commutes with the projection
    (e.g. F = c I); plug the result into ``simple_schur_2x2``."""
    qi = qinv or (lambda v: v)

    def inv_schur(r):
        y = inv_bqbt(r)
        y = b(qi(f(qi(bt(y)))))
        return -inv_bqbt(y)

    return inv_schur


def diag_schur_approx(a11_diag_inv: jax.Array, a10: Op, a01: Op,
                      a00_diag_inv: jax.Array):
    """Cheap Ŝ⁻¹ builder: Ŝ = diag(A11) − A10 diag(A00)⁻¹ A01 applied via
    one Jacobi sweep (callable suitable for ``simple_schur_2x2``)."""

    def inv_schur(r):
        d = a11_diag_inv if r.ndim == 1 else a11_diag_inv[:, None]
        return d * r

    return inv_schur
