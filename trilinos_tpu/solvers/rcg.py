"""RCG — recycling conjugate gradients (deflated CG for SPD sequences).

JAX analogue of Belos::RCGSolMgr/RCGIter
(packages/belos/src/BelosRCGSolMgr.hpp, BelosRCGIter.hpp): for a sequence
of SPD systems with the same (or slowly varying) operator, maintain a
recycle subspace U spanning the lowest modes; each solve starts with the
exact solution in span(U) and iterates deflated CG in the A-orthogonal
complement — the low eigenvalues that throttle CG never re-enter.

Implementation: the recycle space is built from the smallest Ritz vectors
of a Lanczos run on the first solve (eigen.lanczos_eigs); the deflation
projector uses the small factor (UᵀAU)⁻¹ (recomputed per recycle set).
The deflated iteration is standard projected CG — every apply is followed
by removal of the AU components.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.blas import local_dot
from ..parallel.comm import Comm, SerialComm
from .base import (Operator, SolveResult, bcast_cols, certified_solve,
                   hi_precision, identity_prec, rhs_norm_scale,
                   safe_divide)


class CgRecycleSpace:
    def __init__(self, u=None, au=None, utau_inv=None):
        self.u = u
        self.au = au
        self.utau_inv = utau_inv

    @property
    def size(self) -> int:
        return 0 if self.u is None else self.u.shape[1]


def _build_recycle(op, comm, v0, k: int):
    from ..eigen.lanczos import lanczos_eigs

    theta, u = lanczos_eigs(op, v0, nev=k, m=min(4 * k + 20,
                                                 v0.shape[0] - 1),
                            which="SA", comm=comm)
    au = op(u)
    utau = comm.psum(u.T @ au)
    utau_inv = jnp.linalg.inv((utau + utau.T) / 2)
    return CgRecycleSpace(u, au, utau_inv)


@hi_precision
def rcg(op: Operator, b: jax.Array, x0: jax.Array | None = None, *,
        recycle_dim: int = 8, rtol: float = 1e-8, atol: float = 0.0,
        maxiter: int = 1000, comm: Comm | None = None,
        prec: Operator | None = None,
        recycle: CgRecycleSpace | None = None
        ) -> tuple[SolveResult, CgRecycleSpace]:
    """Deflated/recycling CG for SPD sequences (single RHS). Returns
    (result, recycle_space); pass the space into the next related solve.

    ``prec``: optional SPD preconditioner M ≈ A⁻¹ — deflated PCG (the
    BelosRCGIter iteration is preconditioned too): z = M r feeds the
    search directions and the rz recurrence while convergence is still
    gated on the UNpreconditioned residual (and certified explicitly);
    the deflation projector stays A-orthogonal, so deflation and
    preconditioning compose. The recycle space must come from the same
    (op, prec) family to stay effective."""
    comm = comm or SerialComm()
    x = jnp.zeros_like(b) if x0 is None else x0
    M = prec or identity_prec

    if recycle is None or recycle.u is None:
        r0 = b - op(x)
        recycle = _build_recycle(op, comm, r0, recycle_dim)
    else:
        # re-map the recycle space onto THIS operator: the deflation
        # projector and the span(U) exact solve use A U and (UᵀAU)⁻¹ —
        # stale factors from a previous system of the sequence break
        # A-orthogonality and the idempotence the tighten-retry relies
        # on (same defect class fixed in gcrodr). Costs k applies.
        u0 = recycle.u
        au0 = op(u0)
        utau = comm.psum(u0.T @ au0)
        recycle = CgRecycleSpace(
            u0, au0, jnp.linalg.inv((utau + utau.T) / 2))
    u, au, utau_inv = recycle.u, recycle.au, recycle.utau_inv

    def deflate(v):
        """A-orthogonal projection against U (Def-CG projector):
        v ← v − U (UᵀAU)⁻¹ (AU)ᵀ v  — keeps search directions p ⊥_A U."""
        return v - u @ (utau_inv @ comm.psum(au.T @ v))

    bnorm = jnp.sqrt(comm.psum(local_dot(b, b)))
    tol = rhs_norm_scale(bnorm, rtol, atol)

    def solve_from(x, tol2, k0):
        # exact solve in span(U): x += U (UᵀAU)⁻¹ Uᵀ r (idempotent, so
        # repeating it on a certified tighten-retry segment is safe)
        r = b - op(x)
        x = x + u @ (utau_inv @ comm.psum(u.T @ r))
        r = b - op(x)
        z = M(r)
        # rr gates convergence; rz drives the PCG recurrence — one
        # fused psum for the pair (identical collective count either way)
        d = comm.psum(jnp.stack([local_dot(r, r), local_dot(r, z)]))
        rr, rz = d[0], d[1]
        p = deflate(z)

        def cond(s):
            x, r, p, rr, rz, k = s
            return jnp.logical_and(k < maxiter, rr > tol2)

        def body(s):
            x, r, p, rr, rz, k = s
            ap = op(p)
            pap = comm.psum(local_dot(p, ap))
            alpha = safe_divide(rz, pap)
            x = x + alpha * p
            r = r - alpha * ap
            z = M(r)
            d = comm.psum(jnp.stack([local_dot(r, r), local_dot(r, z)]))
            rr_new, rz_new = d[0], d[1]
            beta = safe_divide(rz_new, rz)
            p = deflate(z) + beta * p
            return x, r, p, rr_new, rz_new, k + 1

        x, r, p, rr, rz, k = lax.while_loop(cond, body,
                                            (x, r, p, rr, rz, k0))
        return x, k

    x, k, resnorm, conv = certified_solve(solve_from, op, b, x, tol,
                                          maxiter, comm)
    return (SolveResult(x=x, iters=k, resnorm=resnorm, converged=conv),
            recycle)


@hi_precision
def pcpg(op: Operator, b: jax.Array, constraint_basis: jax.Array,
         x0: jax.Array | None = None, *, rtol: float = 1e-8,
         atol: float = 0.0, maxiter: int = 1000,
         comm: Comm | None = None,
         prec: Operator | None = None) -> SolveResult:
    """PCPG — projected/constrained preconditioned CG
    (Belos::PCPGSolMgr, packages/belos/src/BelosPCPGSolMgr.hpp): CG
    constrained to the A-orthogonal complement of a user-supplied subspace
    (e.g. coarse rigid-body modes in FETI-style solvers). Implemented on
    the same deflation machinery as RCG, with the user's basis as U."""
    comm = comm or SerialComm()
    u = constraint_basis
    au = op(u)
    utau = comm.psum(u.T @ au)
    utau_inv = jnp.linalg.inv((utau + utau.T) / 2)
    res, _ = rcg(op, b, x0, recycle_dim=u.shape[1], rtol=rtol, atol=atol,
                 maxiter=maxiter, comm=comm, prec=prec,
                 recycle=CgRecycleSpace(u, au, utau_inv))
    return res
