"""Generalized Davidson eigensolver (nonsymmetric, preconditioned).

JAX analogue of Anasazi::GeneralizedDavidson
(packages/anasazi/src/AnasaziGeneralizedDavidsonSolMgr.hpp,
AnasaziGeneralizedDavidson.hpp): expand a search space with
preconditioned residual blocks, project the NONSYMMETRIC operator onto
it, extract the wanted invariant subspace via a SORTED REAL SCHUR
factorization of the small projected matrix (all-real arithmetic —
complex conjugate pairs stay as 2×2 blocks, exactly the reference's
LAPACK xGEES path), restart by collapsing onto that subspace.

Split: the n-sized work (basis matvecs, projections, CGS2+CholQR2
orthogonalization) is jitted device code; the k×k Schur sort runs in
scipy on host — the MultiVec/LAPACK split of the reference.
"""
from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from ..parallel.comm import Comm, SerialComm
from ..solvers.base import Operator, hi_precision
from ..solvers.ortho import cgs2_project, cholqr2
from .krylov_schur import (EigsResult, _expansion_quality,
                           _filter_rescale_block, _mcholqr2,
                           _mortho_block)


def _schur_select(h: np.ndarray, nsel: int, which: str):
    """Sorted real Schur of the projected matrix: returns (t, z, vals)
    with the ``nsel`` wanted eigenvalues leading (conjugate pairs kept
    whole, so the actual leading block may be nsel+1 wide)."""
    import scipy.linalg as sla

    t, z = sla.schur(h, output="real")
    vals = sla.eigvals(t)
    key = {
        "LM": lambda w: -np.abs(w),
        "SM": lambda w: np.abs(w),
        "LR": lambda w: -w.real,
        "SR": lambda w: w.real,
    }[which](vals)
    order = np.argsort(key, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    # bubble wanted eigenvalues to the front by swapping adjacent Schur
    # blocks (trexc-style, via scipy's ordered schur re-sort)
    sel = rank < nsel
    # keep conjugate pairs together: a 2x2 block is selected if either
    # of its eigenvalues is
    t, z, sdim = sla.schur(h, output="real",
                           sort=lambda wr, wi: bool(
                               sel[np.argmin(np.abs(vals - (wr + 1j * wi)))]))
    vals_sorted = sla.eigvals(t)
    return t, z, vals_sorted, max(int(sdim), 1)


@hi_precision
def generalized_davidson(op: Operator, n: int, nev: int, *,
                         nb: int | None = None, smax: int | None = None,
                         prec=None, which: str = "LM", tol: float = 1e-8,
                         maxiter: int = 200, v0: jax.Array | None = None,
                         comm: Comm | None = None,
                         dtype=jnp.float64, m=None) -> EigsResult:
    """``nev`` eigenvalues of a general (nonsymmetric) real operator.

    which: LM/SM/LR/SR (largest/smallest magnitude, largest/smallest real
    part). Eigenvalues are returned as a complex array; ``eigenvectors``
    spans the real invariant subspace (columns pair up for complex
    conjugate eigenvalues, the reference's real-Schur convention).

    ``m``: optional SPD mass operator → GENERALIZED pencil A x = λ M x
    (AnasaziGeneralizedDavidson.hpp solves the projected pencil via QZ).
    Here the search space is kept M-orthonormal instead (SᵀMS = I), so
    the projected pencil (SᵀAS, SᵀMS) degenerates to the STANDARD
    nonsymmetric problem SᵀAS z = λ z and the real-Schur machinery is
    unchanged; the pencil residual is r = A x − (M x)·T. Schur restart
    preserves M-orthonormality (zk has orthonormal columns). Requires M
    SPD (an FE mass matrix) — the reference's indefinite-B QZ path is
    out of scope.
    """
    comm = comm or SerialComm()
    nb = nb or nev
    smax = smax or max(4 * nev, 6 * nb)
    smax = min(smax, (n // nb) * nb)
    prec = prec or (lambda r: r)
    mass = m
    rng = np.random.default_rng(13)

    @functools.lru_cache(maxsize=None)
    def proj_fn(k):
        @jax.jit
        def proj(s, as_, ms_):
            h = comm.psum(s[:, :k].T @ as_[:, :k])
            g = (comm.psum(s[:, :k].T @ ms_[:, :k])
                 if mass is not None else jnp.eye(k, dtype=s.dtype))
            return h, g
        return proj

    def _whitened_schur(h, g):
        """Sorted real Schur of the projected pencil against the
        MEASURED M-Gram: G = LLᵀ, h̃ = L⁻¹ h L⁻ᵀ, z = L⁻ᵀ z̃. Keeps the
        reported Ritz values exact for the actual space under f32
        basis-orthonormality drift (see davidson._whitened_eigh); the
        returned z columns are M-orthonormal combinations, so Schur
        restarts preserve M-orthonormality too. mass=None → G = I."""
        import scipy.linalg as sla

        if mass is None:
            return _schur_select(h, nev, which)
        g = (g + g.T) / 2
        eps = np.finfo(h.dtype).eps
        k = h.shape[0]
        lmat = np.linalg.cholesky(
            g + (10 * eps) * (np.trace(g) / k) * np.eye(k, dtype=g.dtype))
        y = sla.solve_triangular(lmat, h, lower=True)
        hw = sla.solve_triangular(lmat, y.T, lower=True).T
        t, zt, vals, sdim = _schur_select(hw, nev, which)
        z = sla.solve_triangular(lmat.T, zt, lower=False)
        return t, z, vals, sdim

    @functools.lru_cache(maxsize=None)
    def resid_fn(k, msel):
        @jax.jit
        def resid(s, as_, ms_, z, tmm):
            x = s[:, :k] @ z
            ax = as_[:, :k] @ z
            mx = ms_[:, :k] @ z if mass is not None else x
            r = ax - mx @ tmm
            resn = jnp.sqrt(comm.psum(jnp.sum(r * r, axis=0)))
            return x, r, resn
        return resid

    @functools.lru_cache(maxsize=None)
    def expand_fn(k):
        @jax.jit
        def expand(s, ms_, t):
            nb_ = t.shape[1]
            if mass is None:
                t2, _ = cgs2_project(comm, s, t)
                q, _, _ = cholqr2(comm, t2)
                return q, q, jnp.ones((nb_,), q.dtype), \
                    jnp.zeros((nb_,), q.dtype)
            q, mq = _mortho_block(comm, mass, s, ms_, t)
            # block quality (see davidson.py: f32 M-CholQR on a
            # near-singular block yields columns whose true M-norm is
            # far from 1 — the host filters/rescales before insertion)
            bq, cmax = _expansion_quality(comm, q, mq, ms_, k)
            return q, mq, bq, cmax
        return expand

    if v0 is None:
        v0 = jnp.asarray(rng.standard_normal((n, nb)), dtype=dtype)
    if mass is None:
        q0, _, _ = cholqr2(comm, v0.astype(dtype))
        mq0 = q0
    else:
        q0, mq0 = _mcholqr2(comm, mass, v0.astype(dtype))
    s = jnp.zeros((n, smax), dtype).at[:, :nb].set(q0)
    as_ = jnp.zeros((n, smax), dtype).at[:, :nb].set(op(q0))
    ms_ = (jnp.zeros((n, smax), dtype).at[:, :nb].set(mq0)
           if mass is not None else s)
    k = nb
    vals = x = resn = None
    converged = False
    iters = 0

    for it in range(maxiter):
        iters = it + 1
        h, g = proj_fn(k)(s, as_, ms_)
        t, z, w, msel = _whitened_schur(np.asarray(h), np.asarray(g))
        msel = min(msel, k)
        zsel = jnp.asarray(z[:, :msel], dtype=dtype)
        tmm = jnp.asarray(t[:msel, :msel], dtype=dtype)
        x, r, resn = resid_fn(k, msel)(s, as_, ms_, zsel, tmm)
        vals = w[:msel]
        scale = np.maximum(np.abs(np.asarray(vals)), 1.0)
        converged = bool(
            (np.asarray(resn)[:min(nev, msel)]
             <= tol * scale[:min(nev, msel)]).all())
        if converged:
            break
        if k + nb > smax:
            # restart: collapse onto the leading sorted Schur basis
            keep = min(max(2 * nev, nb), smax - nb, k)
            zk = jnp.asarray(z[:, :keep], dtype=dtype)
            s_new = jnp.zeros_like(s).at[:, :keep].set(s[:, :k] @ zk)
            as_ = jnp.zeros_like(as_).at[:, :keep].set(as_[:, :k] @ zk)
            if mass is not None:
                ms_ = jnp.zeros_like(ms_).at[:, :keep].set(ms_[:, :k] @ zk)
            s = s_new
            if mass is None:
                ms_ = s
            k = keep
            continue
        # expansion: preconditioned residual block of the leading
        # min(nb, msel) directions
        blk = r[:, : min(nb, msel)]
        if blk.shape[1] < nb:
            # fill with random combinations of the CACHED A·S columns:
            # fresh Krylov-type directions that stay in the true (zero-
            # pad-row) subspace — raw random vectors would inject pad
            # components that are (A=0, M=0)-degenerate
            c = jnp.asarray(rng.standard_normal((k, nb - blk.shape[1])),
                            dtype=dtype)
            blk = jnp.concatenate([blk, as_[:, :k] @ c], axis=1)
        q, mq, bq, cmax = expand_fn(k)(s, ms_, prec(blk))
        if mass is not None:
            filtered = _filter_rescale_block(q, mq, bq, cmax)
            if filtered is None:
                break  # expansion fully degenerate: honest stagnation
            q, mq = filtered
        g = q.shape[1]
        s = s.at[:, k:k + g].set(q)
        as_ = as_.at[:, k:k + g].set(op(q))
        if mass is not None:
            ms_ = ms_.at[:, k:k + g].set(mq)
        else:
            ms_ = s
        k += g

    return EigsResult(
        eigenvalues=np.asarray(vals), eigenvectors=np.asarray(x),
        resnorms=np.asarray(resn), iters=iters, converged=converged)
