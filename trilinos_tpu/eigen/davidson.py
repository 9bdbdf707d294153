"""Block Davidson eigensolver (symmetric, preconditioned).

JAX analogue of Anasazi::BlockDavidson
(packages/anasazi/src/AnasaziBlockDavidsonSolMgr.hpp,
AnasaziBlockDavidson.hpp): expand a search space with PRECONDITIONED
residual blocks, Rayleigh-Ritz on the space, restart with the leading
Ritz block when the space is full; optional LOCKING of converged
eigenpairs (SolMgr parameters "Use Locking" [default false],
"Locking Tolerance" [default 0.1·tol], "Max Locked" [default nev] —
AnasaziBlockDavidsonSolMgr.hpp:153-157).

Structure: the per-step device work (Rayleigh-Ritz projection, residual,
preconditioner apply, CGS2+CholQR2 orthogonalization of the new block)
is jitted per active-space size (a handful of distinct sizes, cached
across restarts); the O(k^3) eigh of the projected matrix runs on device
(small), the expansion bookkeeping on host — the MultiVec/LAPACK split of
the reference.

Locking layout: basis columns [0, nlock) hold frozen converged Ritz
vectors; the ACTIVE space is columns [nlock, k). Rayleigh-Ritz runs on
the active slice only; expansion blocks orthogonalize against the FULL
basis (locked included), which keeps the active space deflated exactly
like the reference's locked-vector projections.
"""
from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.blas import HI
from ..ops.smalldense import chol_inv_small
from ..parallel.comm import Comm, SerialComm
from ..solvers.base import Operator, hi_precision
from ..solvers.ortho import cgs2_project, cholqr2
from .krylov_schur import (EigsResult, _expansion_quality,
                           _filter_rescale_block, _mcholqr2,
                           _mortho_block)


@hi_precision
def block_davidson(op: Operator, n: int, nev: int, *, nb: int | None = None,
                   smax: int | None = None, prec=None, which: str = "SA",
                   tol: float = 1e-8, maxiter: int = 200,
                   v0: jax.Array | None = None, comm: Comm | None = None,
                   dtype=jnp.float64, m=None, locking: bool = False,
                   lock_tol: float | None = None,
                   max_locked: int | None = None) -> EigsResult:
    """``nev`` extreme eigenpairs of a SYMMETRIC operator.

    which: SA (smallest algebraic, the Davidson sweet spot with an SPD
    preconditioner) or LA. ``prec`` approximates (A - sigma I)^-1 — any
    preconditioner apply works.

    ``m``: optional SPD mass operator → GENERALIZED pencil A x = λ M x
    (AnasaziBasicEigenproblem.hpp:60 setM; BlockDavidson is written for
    pencils). The search space is kept M-orthonormal (SᵀMS = I) so the
    Rayleigh-Ritz projection stays a STANDARD symmetric eigenproblem;
    residuals are r = A x − (M x) θ. No M-solve is needed — Davidson
    expansion is preconditioned residuals, not a Krylov space of M⁻¹A.

    ``locking``: freeze eigenpairs whose residual reaches ``lock_tol``
    (default 0.1·tol) in a locked basis prefix; the active iteration
    continues deflated against them. Up to ``max_locked`` (default nev)
    pairs lock — the Anasazi "Use Locking" machinery.
    """
    comm = comm or SerialComm()
    nb = nb or nev
    smax = smax or max(4 * nev, 6 * nb)
    smax = min((smax // nb) * nb, (n // nb) * nb)
    prec = prec or (lambda r: r)
    mass = m
    lock_tol = lock_tol if lock_tol is not None else 0.1 * tol
    max_locked = max_locked if max_locked is not None else nev
    rng = np.random.default_rng(7)

    def _whitened_eigh(kmat, s_a, ms_a):
        """Rayleigh-Ritz against the MEASURED M-Gram (whitened pencil):
        G = SᵀMS, K̃ = L⁻¹ K L⁻ᵀ with G = LLᵀ, z = L⁻ᵀ z̃. With an exact
        G this is plain eigh; with the f32 drift the basis accumulates
        (M-orthonormality error compounds across restarts), it keeps the
        REPORTED Ritz values exact for the actual space — basis drift
        then costs efficiency, never accuracy (the SVQB-style whitening
        tracemin.py already uses). mass=None → G = I exactly.
        ``s_a``/``ms_a``: the ACTIVE basis slice (n, ka)."""
        ka = kmat.shape[0]
        if mass is None:
            return jnp.linalg.eigh(kmat)
        gmat = comm.psum(s_a.T @ ms_a)
        gmat = (gmat + gmat.T) / 2
        eps = jnp.finfo(kmat.dtype).eps
        gmat = gmat + (10 * eps) * (jnp.trace(gmat) / ka) * jnp.eye(
            ka, dtype=gmat.dtype)
        # explicit L⁻¹ (ops/smalldense.py): the three whitening solves
        # become three small GEMMs, pinned like every Rayleigh-Ritz product
        linv = chol_inv_small(gmat)[1]
        hw = jnp.matmul(jnp.matmul(linv, kmat, precision=HI), linv.T,
                        precision=HI)
        theta, zt = jnp.linalg.eigh((hw + hw.T) / 2)
        z = jnp.matmul(linv.T, zt, precision=HI)
        return theta, z

    def _wanted_cols(z, theta, ka, width):
        """Leading ``width`` wanted directions of the ACTIVE projection
        (SA: ascending head; LA: descending tail)."""
        if which == "SA":
            return z[:, :width], theta[:width]
        return z[:, ka - width:][:, ::-1], theta[ka - width:][::-1]

    @functools.lru_cache(maxsize=None)
    def make_step(k, nlock):
        ka = k - nlock
        nsel = min(max(nev - nlock, 1), ka)
        nbw = min(nb, ka)

        @jax.jit
        def step(s, as_, ms_):
            s_a, as_a = s[:, nlock:k], as_[:, nlock:k]
            ms_a = ms_[:, nlock:k]
            kmat = comm.psum(s_a.T @ as_a)
            kmat = (kmat + kmat.T) / 2
            theta, z = _whitened_eigh(kmat, s_a, ms_a)  # ascending
            zsel, tsel = _wanted_cols(z, theta, ka, nsel)
            zblk, tblk = _wanted_cols(z, theta, ka, nbw)
            x = s_a @ zsel
            ax = as_a @ zsel
            mx = ms_a @ zsel if mass is not None else x
            r = ax - mx * tsel[None, :]
            resn = jnp.sqrt(comm.psum(jnp.sum(r * r, axis=0)))
            # expansion block: preconditioned residuals of the leading
            xb = (ms_a if mass is not None else s_a) @ zblk
            rb = as_a @ zblk - xb * tblk[None, :]
            t = prec(rb)
            if mass is None:
                t2, _ = cgs2_project(comm, s, t)  # padded basis is fine
                q, _, _ = cholqr2(comm, t2)
                mq = q
                bq = jnp.eye(nbw, dtype=q.dtype)
                cmax = jnp.zeros((nbw,), q.dtype)
            else:
                # In f32 a near-singular expansion block (converged
                # residuals) defeats M-CholQR — the Gram's rounding
                # noise is the same order as the chol floor — and
                # inserting such a column poisons the projected matrix
                # with spurious Ritz values (observed: λ 30-75×
                # λmax). The host filters/rescales on the quality
                # measures (_select_expansion_columns).
                q, mq = _mortho_block(comm, mass, s, ms_, t)
                bq, cmax = _expansion_quality(comm, q, mq, ms_, k)
            return theta, z, tsel, x, resn, q, mq, bq, cmax

        return step

    @functools.lru_cache(maxsize=None)
    def rotate_active(k, nlock, ka_new):
        """S_a ← S_a z (and caches): make active columns Ritz vectors,
        keeping ``ka_new`` of them. Used for locking and restarts."""
        @jax.jit
        def rot(s, as_, ms_, zk):
            s_new = jnp.zeros_like(s[:, nlock:]).at[:, :ka_new].set(
                s[:, nlock:k] @ zk)
            as_new = jnp.zeros_like(s_new).at[:, :ka_new].set(
                as_[:, nlock:k] @ zk)
            out_s = lax.dynamic_update_slice(s, s_new, (0, nlock))
            out_as = lax.dynamic_update_slice(as_, as_new, (0, nlock))
            if mass is None:
                return out_s, out_as, out_s
            ms_new = jnp.zeros_like(s_new).at[:, :ka_new].set(
                ms_[:, nlock:k] @ zk)
            return out_s, out_as, lax.dynamic_update_slice(
                ms_, ms_new, (0, nlock))

        return rot

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
    nlock = 0
    locked_theta: list[float] = []
    locked_resn: list[float] = []
    theta = x = resn = None
    converged = False
    iters = 0

    for it in range(maxiter):
        iters = it + 1
        theta_a, z, tsel, x, resn, q, mq, bq, cmax = make_step(
            k, nlock)(s, as_, ms_)
        resn_np = np.asarray(resn)
        tsel_np = np.asarray(tsel)
        scale = np.maximum(np.abs(tsel_np), 1.0)
        need = nev - nlock
        conv_mask = resn_np[:need] <= tol * scale[:need]
        converged = bool(conv_mask.all()) and need <= len(resn_np)
        if converged:
            theta = tsel_np[:need]
            break
        if locking and nlock < max_locked:
            # lock the leading CONSECUTIVE pairs at the locking tolerance
            lockable = resn_np <= lock_tol * scale
            g = 0
            while (g < len(lockable) and lockable[g]
                   and nlock + g < max_locked):
                g += 1
            g = min(g, k - nlock - 1)  # keep ≥1 active column
            if g > 0:
                ka = k - nlock
                # rotate the whole active space onto its Ritz basis
                # (wanted-first order); the first g become locked
                zfull, tfull = _wanted_cols(z, theta_a, ka, ka)
                s, as_, ms_ = rotate_active(k, nlock, ka)(
                    s, as_, ms_, zfull)
                locked_theta.extend(np.asarray(tfull)[:g].tolist())
                locked_resn.extend(resn_np[:g].tolist())
                nlock += g
                continue  # re-project against the shrunken active space
        if k + nb > smax:
            # restart: collapse the ACTIVE space to the leading Ritz
            # block(s). z has orthonormal columns, so S·z stays
            # (M-)orthonormal: (S z)ᵀ M (S z) = zᵀ (SᵀMS) z = zᵀz = I.
            ka = k - nlock
            keep = min(max(2 * (nev - nlock), nb), smax - nlock - nb, ka)
            keep = max(keep, 1)
            zk, _ = _wanted_cols(z, theta_a, ka, keep)
            s, as_, ms_ = rotate_active(k, nlock, keep)(s, as_, ms_, zk)
            k = nlock + keep
            continue
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

    # assemble results: locked prefix + active leading pairs
    n_active_out = nev - nlock
    if n_active_out > 0 and x is not None:
        theta_out = np.concatenate([np.asarray(locked_theta),
                                    np.asarray(tsel)[:n_active_out]])
        vecs_out = np.concatenate(
            [np.asarray(s[:, :nlock]), np.asarray(x)[:, :n_active_out]],
            axis=1)
        resn_out = np.concatenate([np.asarray(locked_resn),
                                   np.asarray(resn)[:n_active_out]])
    else:
        theta_out = np.asarray(locked_theta)[:nev]
        vecs_out = np.asarray(s[:, :min(nlock, nev)])
        resn_out = np.asarray(locked_resn)[:nev]
        converged = len(theta_out) >= nev
    return EigsResult(
        eigenvalues=theta_out, eigenvectors=vecs_out,
        resnorms=resn_out, iters=iters, converged=converged)
