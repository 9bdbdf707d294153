"""Spectral transformations: shift-invert eigensolving.

Reference role: Anasazi computes interior eigenvalues by handing the
solver a spectrally transformed operator — classically
(A - sigma I)^-1 backed by an Amesos2 direct factorization (the
"shift-and-invert" mode of AnasaziBlockKrylovSchur examples).

JAX-native form: the inverse apply is an INNER Krylov solve per outer
operator application (matrix-free — a sparse factorization has no
efficient accelerator apply, see SURVEY hard-part #4), so the whole transformed
eigensolve stays jittable. (A - sigma I) is symmetric indefinite for
interior shifts, so MINRES is the default inner solver. Eigenvalues of
the transformed operator are theta = 1/(lambda - sigma); ``eigs_near``
recovers lambda = sigma + 1/theta and returns the pairs nearest the
shift.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..parallel.comm import Comm
from .lanczos import lanczos_eigs


def shift_invert(op, sigma: float, *, solver=None,
                 rtol: float | None = None, maxiter: int = 1000,
                 prec=None):
    """Return the transformed operator v -> (A - sigma I)^-1 v as a
    jittable callable (inner Krylov solve per apply). ``op`` is any
    operator callable; ``solver`` defaults to MINRES (symmetric
    indefinite). ``rtol`` defaults dtype-aware at apply time: 1e-10 in
    f64, 1e-6 in f32 (an f32 inner solve cannot reach 1e-10 and would
    burn maxiter on every apply — see docs/PRECISION.md)."""
    if solver is None:
        from ..solvers import minres as solver

    def shifted(v):
        return op(v) - sigma * v

    def apply(v):
        tol = rtol
        if tol is None:
            tol = 1e-10 if v.dtype == jnp.float64 else 1e-6
        res = solver(shifted, v, rtol=tol, maxiter=maxiter,
                     **({"prec": prec} if prec is not None else {}))
        return res.x

    return apply


def eigs_near(op, sigma: float, nev: int, v0: jax.Array, *,
              m: int | None = None, inner_rtol: float | None = None,
              inner_maxiter: int = 1000, comm: Comm | None = None):
    """Eigenpairs of symmetric ``op`` nearest the shift ``sigma``
    (Anasazi shift-and-invert mode): Lanczos on (A - sigma I)^-1, then
    lambda = sigma + 1/theta. Returns (eigenvalues (nev,),
    eigenvectors (n, nev)), sorted by |lambda - sigma|."""
    sinv = shift_invert(op, sigma, rtol=inner_rtol,
                        maxiter=inner_maxiter)
    theta, vecs = lanczos_eigs(sinv, v0, nev, m, which="LM", comm=comm)
    lam = sigma + 1.0 / theta
    order = jnp.argsort(jnp.abs(lam - sigma))
    return lam[order], vecs[:, order]
