"""LOBPCG — locally optimal block preconditioned conjugate gradients.

JAX analogue of Anasazi::LOBPCG
(packages/anasazi/src/AnasaziLOBPCGSolMgr.hpp, AnasaziLOBPCG.hpp). The
method is the most accelerator-friendly eigensolver in the reference's set: each
iteration is one block SpMM + small (3·nb)² Rayleigh-Ritz eigenproblem —
GEMMs plus one psum, no sequential recurrences.

Basis conditioning is handled the way the reference's SVQB ortho manager
does (packages/anasazi/src/AnasaziSVQBOrthoManager.hpp) but via CholQR2
panels, consistent with the rest of the framework.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax

from ..parallel.comm import Comm, SerialComm
from ..solvers.base import Operator, identity_prec, hi_precision
from ..solvers.ortho import cholqr2


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class EigenResult:
    eigenvalues: jax.Array  # (nev,)
    eigenvectors: jax.Array  # (n, nev)
    iters: jax.Array
    resnorms: jax.Array  # (nev,)


def _rayleigh_ritz(comm: Comm, s: jax.Array, a_s: jax.Array, nev: int,
                   m_s: jax.Array | None = None):
    """Solve the projected eigenproblem on basis S:
    (SᵀAS) y = θ (SᵀMS) y, with M = I when ``m_s`` is None (standard)
    and ``m_s = M·S`` for a generalized pencil (Ax = λMx — every Anasazi
    eigenproblem carries an optional M,
    packages/anasazi/src/AnasaziBasicEigenproblem.hpp:60 setM)."""
    g_a = comm.psum(jnp.einsum("nk,nm->km", s, a_s))
    g_m = comm.psum(jnp.einsum("nk,nm->km", s, m_s if m_s is not None
                               else s))
    # SVQB-style whitening (AnasaziSVQBOrthoManager.hpp): G_m = U Λ Uᵀ,
    # keep only directions with Λ above the dependence threshold, map
    # T = U Λ^(-1/2) on the kept set. Eigendecomposition (not Cholesky)
    # because near convergence the [X W P] blocks become dependent to
    # rounding level and G_m picks up slightly NEGATIVE eigenvalues that
    # break chol — the observed LOBPCG NaN mode at tight tolerances.
    eps = jnp.finfo(s.dtype).eps
    k = g_m.shape[0]
    lam_m, u_m = jnp.linalg.eigh((g_m + g_m.T) / 2)
    good = lam_m > 1e3 * eps * jnp.maximum(jnp.max(lam_m), eps)
    inv_sqrt = jnp.where(
        good, 1.0 / jnp.sqrt(jnp.maximum(lam_m, jnp.finfo(s.dtype).tiny)),
        0.0)
    t = u_m * inv_sqrt[None, :]
    a_w = t.T @ ((g_a + g_a.T) / 2) @ t
    # discarded (dependent/null) directions have zero rows/cols in a_w —
    # their Ritz values would be spurious 0s; push them to the top so the
    # nev-smallest selection never picks them
    big = jnp.asarray(1e30, s.dtype)
    a_w = a_w + jnp.diag(jnp.where(good, 0.0, big))
    theta, y_w = jnp.linalg.eigh((a_w + a_w.T) / 2)
    y = t @ y_w
    return theta[:nev], y[:, :nev]


@hi_precision
def lobpcg(op: Operator, x0: jax.Array, *, prec: Operator | None = None,
           m: Operator | None = None,
           which: str = "SM", tol: float = 1e-6, maxiter: int = 200,
           comm: Comm | None = None) -> EigenResult:
    """Compute the ``nev = x0.shape[1]`` smallest ("SM") or largest ("LM")
    eigenpairs of the symmetric operator ``op``.

    ``m``: optional SPD mass operator for the GENERALIZED pencil
    A x = λ M x (e.g. an FE mass matrix) — LOBPCG's native habitat
    (AnasaziLOBPCG.hpp is written for pencils; BasicEigenproblem setM,
    AnasaziBasicEigenproblem.hpp:60). The basis stays Euclidean-
    orthonormalized for conditioning; the M metric enters through the
    projected Gram matrix SᵀMS (whitened in the Rayleigh-Ritz) and the
    residual r = A x − M x θ."""
    comm = comm or SerialComm()
    M = prec or identity_prec
    n, nev = x0.shape
    sign = 1.0 if which == "SM" else -1.0
    a = (lambda v: op(v)) if which == "SM" else (lambda v: -op(v))
    mass = m

    def mop(v):
        return v if mass is None else mass(v)

    x, _, _ = cholqr2(comm, x0)
    ax = a(x)
    mx = mop(x)
    theta, y = _rayleigh_ritz(comm, x, ax, nev,
                              mx if mass is not None else None)
    x = x @ y
    ax = ax @ y
    mx = mx @ y
    p = jnp.zeros_like(x)

    def resnorms(x, ax, mx, theta):
        r = ax - mx * theta[None, :]
        return jnp.sqrt(comm.psum(jnp.einsum("nk,nk->k", r, r)))

    def cond(st):
        x, ax, mx, p, theta, k, rn = st
        return jnp.logical_and(k < maxiter, jnp.any(rn > tol))

    def body(st):
        x, ax, mx, p, theta, k, rn = st
        r = ax - mx * theta[None, :]
        w = M(r)
        w, _, _ = cholqr2(comm, w)
        p_n, _, _ = cholqr2(comm, p)
        use_p = k > 0
        s = jnp.concatenate(
            [x, w, jnp.where(use_p, p_n, jnp.zeros_like(p_n))], axis=1)
        a_s = jnp.concatenate([ax, a(w),
                               jnp.where(use_p, a(p_n),
                                         jnp.zeros_like(p_n))], axis=1)
        m_s = jnp.concatenate([mx, mop(w),
                               jnp.where(use_p, mop(p_n),
                                         jnp.zeros_like(p_n))], axis=1) \
            if mass is not None else None
        theta_new, y = _rayleigh_ritz(comm, s, a_s, nev, m_s)
        x_new = s @ y
        ax_new = a_s @ y
        mx_new = m_s @ y if mass is not None else x_new
        # p = component of the update outside current x
        p_new = s[:, nev:] @ y[nev:, :]
        rn_new = resnorms(x_new, ax_new, mx_new, theta_new)
        return x_new, ax_new, mx_new, p_new, theta_new, k + 1, rn_new

    st = (x, ax, mx, p, theta, 0, resnorms(x, ax, mx, theta))
    x, ax, mx, p, theta, k, rn = lax.while_loop(cond, body, st)
    return EigenResult(eigenvalues=sign * theta, eigenvectors=x, iters=k,
                       resnorms=rn)


@hi_precision
def power_method(op: Operator, v0: jax.Array, *, maxiter: int = 100,
                 tol: float = 1e-8, comm: Comm | None = None):
    """Largest-|λ| eigenpair (the reference uses this inside Chebyshev,
    Ifpack2_Details_Chebyshev_def.hpp powerMethod)."""
    comm = comm or SerialComm()

    def norm(v):
        return jnp.sqrt(comm.psum(jnp.vdot(v, v)))

    def body(st):
        v, lam, k, delta = st
        w = op(v)
        lam_new = norm(w)
        v_new = w / jnp.maximum(lam_new, 1e-300)
        return v_new, lam_new, k + 1, jnp.abs(lam_new - lam)

    def cond(st):
        v, lam, k, delta = st
        return jnp.logical_and(k < maxiter, delta > tol * jnp.abs(lam))

    v = v0 / norm(v0)
    v, lam, k, _ = lax.while_loop(cond, body, (v, 1.0 * norm(v0), 0,
                                               jnp.asarray(jnp.inf,
                                                           v0.dtype)))
    return lam, v, k
