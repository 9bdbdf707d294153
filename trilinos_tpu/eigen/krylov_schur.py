"""Block Krylov–Schur eigensolver with thick (implicit) restarts.

JAX analogue of Anasazi::BlockKrylovSchur
(packages/anasazi/src/AnasaziBlockKrylovSchurSolMgr.hpp,
AnasaziBlockKrylovSchur.hpp — block Arnoldi expansion + Schur
decomposition of the projected matrix + implicit restart keeping the
wanted Ritz block). Block size nb > 1 captures eigenvalue multiplicities
a single-vector Krylov space cannot (the reason the reference's flagship
is BLOCK Krylov-Schur).

Division of labor (the same split the reference makes between MultiVecs
and LAPACK): the block Arnoldi expansion — batched SpMM + CGS2 block
projections + CholQR2 panel orthogonalization — is ONE jitted device
program over the static-shape padded basis; the small (m x m) Schur
decomposition, Ritz ordering and restart assembly run on host
(scipy/LAPACK) once per restart.

The restart is Stewart's Krylov–Schur transformation: from
A V_m = V_m H + V_b B E_m', order the Schur form T = Q' H Q so the wanted
Ritz values lead, keep k columns:
    A (V_m Q_k) = (V_m Q_k) T_k + V_b (B Q[m-nb:m, :k])
— a valid generalized Krylov decomposition whose expansion continues with
plain block Arnoldi (projection is against the whole basis anyway).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import scipy.linalg as sla

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.blas import HI
from ..ops.smalldense import chol_inv_small
from ..parallel.comm import Comm, SerialComm, norm2
from ..solvers.base import Operator, safe_divide, hi_precision
from ..solvers.ortho import cgs2_project, cholqr2


@dataclasses.dataclass
class EigsResult:
    eigenvalues: np.ndarray  # (nev,) complex (real for symmetric)
    eigenvectors: np.ndarray  # (n, nev)
    resnorms: np.ndarray  # (nev,) Ritz residual estimates
    iters: int  # Arnoldi (column) steps performed
    converged: bool


def _extend(op, comm, m, nb):
    """Jitted block-Arnoldi expansion: block steps k/nb..m/nb-1 on (V,H).

    V: (n, m+nb) padded basis; H: (m+nb, m)."""

    def run(v, h, k):
        n = v.shape[0]

        def body(jb, carry):
            v, h = carry
            j = jb * nb
            vj = lax.dynamic_slice(v, (0, j), (n, nb))
            w = op(vj) if nb > 1 else op(vj[:, 0])[:, None]
            w2, c = cgs2_project(comm, v, w)
            q, r_small, _ = cholqr2(comm, w2)
            hcol = lax.dynamic_update_slice(c, r_small, (j + nb, 0))
            v = lax.dynamic_update_slice(v, q, (0, j + nb))
            h = lax.dynamic_update_slice(h, hcol, (0, j))
            return v, h

        return lax.fori_loop(k // nb, m // nb, body, (v, h))

    return jax.jit(run)


def _mproject(comm, v, vm, w):
    """One classical-GS pass in the M inner product: c = (MV)ᵀw."""
    c = comm.psum(jnp.einsum("nm,nk->mk", vm, w,
                             preferred_element_type=w.dtype, precision=HI))
    return w - v @ c, c


def _mcholqr(comm, m_op, w):
    """CholQR in the M metric: G = wᵀMw, Q = w R⁻¹ with QᵀMQ = I.
    Returns (q, mq, r)."""
    mw = m_op(w)
    g = comm.psum(jnp.einsum("nk,nm->km", w, mw,
                             preferred_element_type=w.dtype, precision=HI))
    k = g.shape[0]
    eps = jnp.finfo(w.dtype).eps
    floor = 10.0 * eps * jnp.maximum(jnp.max(jnp.abs(g)), eps)
    l, linv = chol_inv_small((g + g.T) / 2
                             + floor * jnp.eye(k, dtype=g.dtype))
    r = l.T
    # one small R⁻¹ + two streaming GEMMs instead of two (n, k)
    # triangular-solve lowerings (ops/smalldense.py)
    rinv = linv.T
    q = jnp.einsum("nk,km->nm", w, rinv,
                    preferred_element_type=w.dtype, precision=HI)
    mq = jnp.einsum("nk,km->nm", mw, rinv,
                     preferred_element_type=w.dtype, precision=HI)
    return q, mq, r


def _mortho_block(comm, m_op, v, vm, w):
    """Robust M-orthonormalization of an expansion block against a basis
    (DGKS-style renormalized CGS2 in the M metric).

    Plain project²+CholQR collapses when a column of ``w`` is nearly in
    span(v) (a CONVERGED Davidson residual is eps-level noise): the
    projected remainder is cancellation junk, the CholQR floor then
    yields a near-zero-M-norm column, and the projected matrix grows a
    spurious ≈0 eigenvalue that SM/SR selection picks up. The classical
    remedy (BelosDGKSOrthoManager.hpp:99-107 renormalizes when the norm
    drops): rescale every column to unit M-norm BETWEEN passes, so a
    cancellation-dominated direction re-enters the next projection as an
    honest unit vector and leaves block-orthonormalized. All inputs keep
    exactly-zero pad rows, so junk directions stay in the true subspace.
    Returns (q, mq) with qᵀMq ≈ I."""
    from ..ops.blas import local_dot

    tiny = jnp.finfo(w.dtype).tiny

    def renorm(x, mx):
        d = comm.psum(local_dot(x, mx))
        inv = 1.0 / jnp.sqrt(jnp.maximum(d, tiny))
        return x * inv[None, :], mx * inv[None, :]

    w, _ = renorm(w, m_op(w))
    w, _ = _mproject(comm, v, vm, w)
    q, mq, _ = _mcholqr(comm, m_op, w)
    w, _ = renorm(q, mq)
    w, _ = _mproject(comm, v, vm, w)
    q, mq, _ = _mcholqr(comm, m_op, w)
    return q, mq


def _select_expansion_columns(b, cmax, *, corr_tol=2e-3, basis_tol=2e-3):
    """Host-side quality filter for an M-orthonormalized expansion block.

    ``b``: the block's TRUE M-Gram qᵀMq (nb×nb, recomputed after CholQR —
    in f32 the CholQR-implied identity can be far from the truth when the
    block was near-singular); ``cmax``: per-column max |(MS)ᵀq| vs the
    basis. Keeps column j iff its M-norm² is bounded away from 0, its
    cross-Gram vs the basis is tight, and its correlation with every
    previously-kept column is below ``corr_tol`` (greedy). Returns
    (kept_indices, per-column 1/√(M-norm²) rescale) — rescaling the kept
    columns to exactly unit M-norm removes the first-order Rayleigh-
    quotient inflation that un-checked junk columns cause (observed on
    chip: spurious Ritz values 30-75× λmax). Healthy f64 blocks pass
    untouched (d≈1, off-diag≈1e-15)."""
    b = np.asarray(b)
    cmax = np.asarray(cmax)
    d = np.diag(b)
    kept = []
    for j in range(b.shape[0]):
        if not np.isfinite(d[j]) or d[j] < 0.25:
            continue
        if cmax[j] > basis_tol * np.sqrt(d[j]):
            continue
        if any(abs(b[i, j]) / np.sqrt(d[i] * d[j]) > corr_tol
               for i in kept):
            continue
        kept.append(j)
    return (np.asarray(kept, dtype=int),
            1.0 / np.sqrt(np.maximum(d, 1e-300)))


def _filter_rescale_block(q, mq, bq, cmax):
    """Host-side application of ``_select_expansion_columns``: keep the
    healthy columns of an M-orthonormalized expansion block, rescaled to
    exactly unit M-norm. Returns (q, mq) or None when every column is
    degenerate (the caller should stop: honest stagnation). Shared by
    the Davidson-family solvers."""
    good, colscale = _select_expansion_columns(bq, cmax)
    if len(good) == 0:
        return None
    if len(good) == bq.shape[0] and np.allclose(colscale, 1.0, atol=1e-3):
        return q, mq  # healthy block: skip the device gather/rescale
    idx = jnp.asarray(good)
    inv = jnp.asarray(colscale[good], q.dtype)[None, :]
    return jnp.take(q, idx, axis=1) * inv, jnp.take(mq, idx, axis=1) * inv


def _mcholqr2(comm, m_op, w):
    """Two M-metric CholQR passes (the CholQR2 of the M inner product):
    returns (q, mq) with qᵀMq ≈ I to working precision for
    well-conditioned panels."""
    q, mq, _ = _mcholqr(comm, m_op, w)
    q, mq, _ = _mcholqr(comm, m_op, q)
    return q, mq


def _expansion_quality(comm, q, mq, ms_, k):
    """Block quality measures for the host-side expansion filter: the
    TRUE M-Gram qᵀMq and the worst cross-Gram entry vs the basis prefix
    (see _select_expansion_columns). Shared by the Davidson family."""
    from ..ops.blas import mv_trans_mv

    bq = comm.psum(mv_trans_mv(q, mq))
    cmax = jnp.max(jnp.abs(comm.psum(mv_trans_mv(ms_[:, :k], q))), axis=0)
    return bq, cmax


def _extend_gen(op, m_op, m_solve, comm, m, nb):
    """Generalized block-Lanczos expansion in the M inner product:
    K = M⁻¹A applies (``m_solve`` approximating M⁻¹), projections
    against the M-orthonormal basis via the cached MV block, panel
    normalization by M-metric CholQR (two passes). Produces
    K·V_m = V_{m+nb}·H with VᵀMV = I — the generalized eigenproblem
    reduction every Anasazi SolMgr supports through setM
    (AnasaziBasicEigenproblem.hpp:60)."""

    def run(v, vm, h, k):
        n = v.shape[0]

        def body(jb, carry):
            v, vm, h = carry
            j = jb * nb
            vj = lax.dynamic_slice(v, (0, j), (n, nb))
            av = op(vj) if nb > 1 else op(vj[:, 0])[:, None]
            w = m_solve(av)
            w, c1 = _mproject(comm, v, vm, w)
            w, c2 = _mproject(comm, v, vm, w)
            q, mq, r_small = _mcholqr(comm, m_op, w)
            hcol = lax.dynamic_update_slice(c1 + c2, r_small, (j + nb, 0))
            v = lax.dynamic_update_slice(v, q, (0, j + nb))
            vm = lax.dynamic_update_slice(vm, mq, (0, j + nb))
            h = lax.dynamic_update_slice(h, hcol, (0, j))
            return v, vm, h

        return lax.fori_loop(k // nb, m // nb, body, (v, vm, h))

    return jax.jit(run)


def _crit(w, which):
    if which == "LM":
        return np.abs(w)
    if which == "SM":
        return -np.abs(w)
    if which == "LR":
        return np.real(w)
    if which == "SR":
        return -np.real(w)
    raise ValueError(f"unknown which={which!r}")


def _ordschur(hm: np.ndarray, which: str, keep: int):
    """Ordered real Schur form: the ``keep`` most-wanted eigenvalues moved
    to the leading block (LAPACK trsen via scipy.schur(sort=...)); the
    sort predicate is a robust threshold on the selection criterion."""
    w_all = sla.eigvals(hm)
    vals = _crit(w_all, which)
    cutoff = np.sort(vals)[-keep]
    eps = 1e-12 * max(1.0, float(np.abs(vals).max()))

    def sort_fn(re, im):
        return bool(_crit(re + 1j * im, which) >= cutoff - eps)

    t_mat, q, sdim = sla.schur(hm, output="real", sort=sort_fn)
    theta_sorted = sla.eigvals(t_mat)
    return t_mat, q, theta_sorted


@hi_precision
def block_krylov_schur(op: Operator, n: int, nev: int, *,
                       m: int | None = None, nb: int = 1,
                       which: str = "LM", tol: float = 1e-8,
                       max_restarts: int = 50, symmetric: bool = False,
                       v0: jax.Array | None = None,
                       comm: Comm | None = None,
                       mass: Operator | None = None,
                       m_solve: Operator | None = None,
                       m_solve_iters: int = 30,
                       dtype=jnp.float64) -> EigsResult:
    """Compute ``nev`` eigenpairs of ``op`` (length-n vectors; for nb > 1
    the operator must accept (n, nb) multivectors).

    which: LM (largest magnitude) / SM / LR / SR. ``symmetric=True`` uses
    eigh for the projected problem (thick-restart block Lanczos).

    ``mass``: optional SPD mass operator → GENERALIZED pencil
    A x = λ M x (AnasaziBasicEigenproblem.hpp:60 setM): the recurrence
    runs on K = M⁻¹A in the M inner product (M-orthonormal basis,
    M-metric CholQR panels), so the projected H is the standard
    reduction of the pencil and the Schur/restart machinery is
    unchanged. ``m_solve`` approximates M⁻¹ (default: a fixed
    ``m_solve_iters``-step unpreconditioned CG on M — exact enough for
    well-conditioned FE mass matrices)."""
    comm = comm or SerialComm()
    m = m or min(max(2 * nev + 12, 20), n - nb)
    m = (m // nb) * nb
    keep_target = min(nev + max(nev // 2, 4), m - 2 * nb)
    keep_target = max((keep_target // nb) * nb, nb)
    if mass is not None and m_solve is None:
        def m_solve(rhs, _mass=mass, _iters=m_solve_iters):
            x = jnp.zeros_like(rhs)
            r = rhs
            p = r
            rr = comm.psum(jnp.sum(r * r, axis=0))

            def body(i, st):
                x, r, p, rr = st
                ap = _mass(p)
                pap = comm.psum(jnp.sum(p * ap, axis=0))
                alpha = jnp.where(pap > 0, rr / jnp.where(pap > 0, pap, 1),
                                  0)
                x = x + alpha[None, :] * p
                r = r - alpha[None, :] * ap
                rr_new = comm.psum(jnp.sum(r * r, axis=0))
                beta = jnp.where(rr > 0, rr_new / jnp.where(rr > 0, rr, 1),
                                 0)
                p = r + beta[None, :] * p
                return x, r, p, rr_new

            x, *_ = lax.fori_loop(0, _iters, body, (x, r, p, rr))
            return x

    extend = (_extend(op, comm, m, nb) if mass is None
              else _extend_gen(op, mass, m_solve, comm, m, nb))

    rng = np.random.default_rng(42)
    if v0 is None:
        v0 = jnp.asarray(rng.standard_normal((n, nb)), dtype=dtype)
    elif v0.ndim == 1:
        v0 = jnp.concatenate(
            [v0[:, None],
             jnp.asarray(rng.standard_normal((n, nb - 1)), dtype=dtype)],
            axis=1) if nb > 1 else v0[:, None]
    if mass is None:
        q0, _, _ = cholqr2(comm, v0.astype(dtype))
        mq0 = None
    else:
        q0, mq0 = _mcholqr2(comm, mass, v0.astype(dtype))
    v = jnp.zeros((n, m + nb), dtype)
    v = v.at[:, :nb].set(q0)
    vm = (jnp.zeros((n, m + nb), dtype).at[:, :nb].set(mq0)
          if mass is not None else None)
    h = jnp.zeros((m + nb, m), dtype)
    k = 0
    total_steps = 0
    res = np.full(nev, np.inf)
    converged = False

    for restart in range(max_restarts + 1):
        if mass is None:
            v, h = extend(v, h, k)
        else:
            v, vm, h = extend(v, vm, h, k)
        total_steps += (m - k)
        hn = np.asarray(h, dtype=np.float64)
        hm = hn[:m, :m]
        b_blk = hn[m:m + nb, m - nb:m]  # residual coupling block

        if symmetric:
            theta_all, q = np.linalg.eigh((hm + hm.T) / 2)
            order = np.argsort(-_crit(theta_all, which))
            q = q[:, order]
            theta_sorted = theta_all[order]
            t_mat = np.diag(theta_sorted)
        else:
            t_mat, q, theta_sorted = _ordschur(hm, which, keep_target)

        # Ritz residuals of the leading nev: ||B Q[m-nb:m, j]||
        coup = b_blk @ q[m - nb:m, :]
        res = np.linalg.norm(coup[:, :nev].reshape(nb, nev), axis=0)
        scale = np.maximum(np.abs(theta_sorted[:nev]), 1e-30)
        converged = bool((res <= tol * scale).all())
        if converged or restart == max_restarts:
            break

        # thick restart: keep a multiple of nb; don't split a 2x2 block
        keep = keep_target
        if not symmetric and keep < m and t_mat[keep, keep - 1] != 0:
            keep += nb
        qk = jnp.asarray(q[:, :keep], dtype=dtype)
        v_new = jnp.zeros_like(v)
        v_new = v_new.at[:, :keep].set(v[:, :m] @ qk)
        v_new = v_new.at[:, keep:keep + nb].set(v[:, m:m + nb])
        if mass is not None:
            vm_new = jnp.zeros_like(vm)
            vm_new = vm_new.at[:, :keep].set(vm[:, :m] @ qk)
            vm_new = vm_new.at[:, keep:keep + nb].set(vm[:, m:m + nb])
            vm = vm_new
        h_new = np.zeros_like(hn)
        h_new[:keep, :keep] = t_mat[:keep, :keep]
        h_new[keep:keep + nb, :keep] = coup[:, :keep]
        v = v_new
        h = jnp.asarray(h_new, dtype=dtype)
        k = keep

    # eigenpairs from the final projected matrix
    if symmetric:
        theta_fin, z_all = np.linalg.eigh((hn[:m, :m] + hn[:m, :m].T) / 2)
        w_all = theta_fin.astype(complex)
    else:
        w_all, z_all = np.linalg.eig(hn[:m, :m])
    order = np.argsort(-_crit(w_all, which))[:nev]
    w_small = w_all[order]
    z = z_all[:, order]
    x = np.asarray(v[:, :m], dtype=np.float64) @ z
    x = x / np.linalg.norm(x, axis=0, keepdims=True)
    if symmetric:
        w_small = w_small.real
        x = x.real
    return EigsResult(eigenvalues=w_small, eigenvectors=x,
                      resnorms=res, iters=total_steps, converged=converged)
