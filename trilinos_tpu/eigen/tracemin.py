"""TraceMin eigensolver (symmetric, smallest eigenpairs).

JAX analogue of Anasazi::TraceMin
(packages/anasazi/src/AnasaziTraceMinSolMgr.hpp, AnasaziTraceMinBase.hpp):
minimize trace(Y' A Y) over Y'Y = I by alternating
  1. an (inexact) block linear solve A Z = Y — here a fixed-iteration
     block CG, the saddle-point-free variant TraceMin-Davidson also uses,
  2. orthonormalization of Z (CholQR2 — one reduction),
  3. Rayleigh-Ritz on the new basis.
Inverse-iteration-like convergence to the SMALLEST eigenpairs; every
outer step is a fixed-shape jitted device program (inner CG included),
so the whole solver compiles once.
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..parallel.comm import Comm, SerialComm
from ..solvers.base import Operator, hi_precision
from ..solvers.ortho import cholqr2
from .krylov_schur import EigsResult


@hi_precision
def tracemin(op: Operator, n: int, nev: int, *, block: int | None = None,
             m: Operator | None = None,
             inner_iters: int = 15, tol: float = 1e-8, maxiter: int = 100,
             v0: jax.Array | None = None, comm: Comm | None = None,
             dtype=jnp.float64) -> EigsResult:
    """``nev`` smallest eigenpairs of a symmetric positive definite
    operator. ``block`` (default nev+2) is the subspace width; the inner
    solve runs ``inner_iters`` CG steps per column (unpreconditioned).

    ``m``: optional SPD mass operator → GENERALIZED pencil A x = λ M x
    (trace-minimization over YᵀMY = I — TraceMin's original setting,
    AnasaziTraceMinBase.hpp; BasicEigenproblem setM,
    AnasaziBasicEigenproblem.hpp:60): the inner solve targets A Z = M Y
    and the Rayleigh-Ritz whitens with the projected mass Gram."""
    comm = comm or SerialComm()
    s = block or min(nev + 2, n)
    mass = m

    def mop(v):
        return v if mass is None else mass(v)

    rng = np.random.default_rng(11)
    if v0 is None:
        v0 = jnp.asarray(rng.standard_normal((n, s)), dtype=dtype)

    def inner_cg(rhs):
        """Fixed-iteration block CG for A Z = rhs (columnwise)."""
        x = jnp.zeros_like(rhs)
        r = rhs
        p = r
        rr = comm.psum(jnp.sum(r * r, axis=0))

        def body(i, st):
            x, r, p, rr = st
            ap = op(p)
            pap = comm.psum(jnp.sum(p * ap, axis=0))
            alpha = jnp.where(pap > 0, rr / jnp.where(pap > 0, pap, 1), 0)
            x = x + alpha[None, :] * p
            r = r - alpha[None, :] * ap
            rr_new = comm.psum(jnp.sum(r * r, axis=0))
            beta = jnp.where(rr > 0, rr_new / jnp.where(rr > 0, rr, 1), 0)
            p = r + beta[None, :] * p
            return x, r, p, rr_new

        x, r, p, rr = lax.fori_loop(0, inner_iters, body, (x, r, p, rr))
        return x

    @jax.jit
    def step(y):
        z = inner_cg(mop(y))
        q, _, _ = cholqr2(comm, z)
        aq = op(q)
        if mass is None:
            h = comm.psum(q.T @ aq)
            h = (h + h.T) / 2
            theta, w = jnp.linalg.eigh(h)  # ascending
            y_new = q @ w
            ay = aq @ w
            res = ay - y_new * theta[None, :]
        else:
            from .lobpcg import _rayleigh_ritz

            mq = mass(q)
            theta, w = _rayleigh_ritz(comm, q, aq, q.shape[1], mq)
            y_new = q @ w
            ay = aq @ w
            res = ay - (mq @ w) * theta[None, :]
        resn = jnp.sqrt(comm.psum(jnp.sum(res * res, axis=0)))
        return y_new, theta, resn

    y = cholqr2(comm, v0.astype(dtype))[0]
    theta = resn = None
    converged = False
    it = 0
    for it in range(1, maxiter + 1):
        y, theta, resn = step(y)
        scale = np.maximum(np.abs(np.asarray(theta[:nev])), 1.0)
        converged = bool((np.asarray(resn[:nev]) <= tol * scale).all())
        if converged:
            break

    return EigsResult(
        eigenvalues=np.asarray(theta[:nev]),
        eigenvectors=np.asarray(y[:, :nev]),
        resnorms=np.asarray(resn[:nev]), iters=it, converged=converged)
