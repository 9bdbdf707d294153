"""Lanczos / block-Krylov-Schur-lite eigensolvers.

JAX coverage of Anasazi's Krylov eigensolvers
(packages/anasazi/src/AnasaziBlockKrylovSchurSolMgr.hpp — Arnoldi/Lanczos
factorization + Schur/eig of the projected matrix). Round-1 scope: a
fixed-length Lanczos (symmetric) and Arnoldi (general) factorization with
full CGS2 reorthogonalization and a host-size projected eigensolve —
the restart machinery (implicit Krylov-Schur) is future work.
"""
from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax

from ..parallel.comm import Comm, SerialComm, norm2
from ..solvers.base import Operator, safe_divide, hi_precision
from ..solvers.ortho import cgs2_project


@hi_precision
def arnoldi(op: Operator, v0: jax.Array, m: int, *,
            comm: Comm | None = None):
    """m-step Arnoldi with CGS2: returns (V (n, m+1), H (m+1, m))."""
    comm = comm or SerialComm()
    n = v0.shape[0]
    dtype = v0.dtype
    beta0 = norm2(comm, v0)
    v = jnp.zeros((n, m + 1), dtype).at[:, 0].set(safe_divide(v0, beta0))
    h = jnp.zeros((m + 1, m), dtype)

    def body(j, carry):
        v, h = carry
        vj = lax.dynamic_slice(v, (0, j), (n, 1))[:, 0]
        w = op(vj)
        w2, c = cgs2_project(comm, v, w[:, None])
        w2 = w2[:, 0]
        hnorm = norm2(comm, w2)
        hcol = c[:, 0].at[j + 1].set(hnorm)
        v = lax.dynamic_update_slice(v, safe_divide(w2, hnorm)[:, None],
                                     (0, j + 1))
        h = lax.dynamic_update_slice(h, hcol[:, None], (0, j))
        return v, h

    v, h = lax.fori_loop(0, m, body, (v, h))
    return v, h


@hi_precision
def lanczos_eigs(op: Operator, v0: jax.Array, nev: int, m: int | None = None,
                 *, which: str = "LM", comm: Comm | None = None):
    """Symmetric eigenpairs via a full-reorthogonalized Lanczos run of
    length m (default 4·nev+20): eigh of the projected tridiagonal
    (here: the full Hessenberg, which for symmetric op IS tridiagonal up
    to roundoff). Returns (eigenvalues (nev,), eigenvectors (n, nev))."""
    comm = comm or SerialComm()
    m = m or min(4 * nev + 20, v0.shape[0] - 1)
    v, h = arnoldi(op, v0, m, comm=comm)
    t = (h[:m, :] + h[:m, :].T) / 2
    theta, y = jnp.linalg.eigh(t)
    if which == "LM":
        idx = jnp.argsort(-jnp.abs(theta))[:nev]
    elif which == "LA":
        idx = jnp.argsort(-theta)[:nev]
    elif which == "SA":
        idx = jnp.argsort(theta)[:nev]
    else:
        raise ValueError(f"unknown which={which!r}")
    vecs = v[:, :m] @ y[:, idx]
    return theta[idx], vecs
