"""Conjugate-gradient family.

JAX-native Krylov drivers with the capability surface of the reference's
CG stack:
  * ``cg``              — preconditioned (pseudo-block) CG, the analogue of
    Belos::PseudoBlockCGIter (packages/belos/src/BelosPseudoBlockCGIter.hpp:411).
    Per iteration: 1 operator apply + 2 global reductions (the r·z and r·r
    dots share a single fused psum).
  * ``cg_single_reduce``— Chronopoulos/Gear CG with ONE reduction per
    iteration, the analogue of Belos::CGSingleRedIter's fused MvTransMv
    (packages/belos/src/BelosCGSingleRedIter.hpp:79,477-483).
  * ``cg_pipeline``     — pipelined CG: the reduction for iteration k is
    issued before the operator apply whose result is needed at k+1, so
    XLA's latency-hiding scheduler overlaps all-reduce with SpMV — the
    compiled-collective form of Belos_Tpetra_CgPipeline
    (packages/belos/tpetra/src/solvers/Belos_Tpetra_CgPipeline.hpp:99-109,
    "matrix op moved up to overlap with all-reduce").

Multivector RHS: all reductions are columnwise; converged columns are
frozen by masking their step sizes to zero (pseudo-block deflation).
"""
from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.blas import local_dot
from ..parallel.comm import Comm, SerialComm
from .base import (Operator, SolveResult, bcast_cols, certified_solve,
                   certify_residual, identity_prec, rhs_norm_scale,
                   safe_divide)


def _tridiag_condest(alphas: jax.Array, betas: jax.Array,
                     m: jax.Array) -> jax.Array:
    """κ estimate from CG coefficients via the CG↔Lanczos connection
    (AztecOO's AZ_cg_condnum, az_aztec_defs.h:266): the Lanczos
    tridiagonal of M·A has diag_j = 1/α_j + β_{j-1}/α_{j-1} and
    offdiag_j = √β_j / α_j; its extreme eigenvalues (Ritz values of the
    first min(iters, window) steps) give λmax/λmin. Ritz interlacing
    makes this a (typically tight) LOWER bound on the true κ(M·A).

    alphas/betas: (cw,) recorded coefficients; m: number of valid steps.
    Unused slots are filled with the first Rayleigh quotient 1/α_0 —
    always inside the Ritz interval, so padding never moves the extremes.
    """
    cw = alphas.shape[0]
    j = jnp.arange(cw)
    valid = jnp.logical_and(j < m, alphas != 0)
    a_safe = jnp.where(valid, alphas, 1.0)
    b_rec = jnp.where(valid, betas, 0.0)
    a_prev = jnp.concatenate([jnp.ones((1,), a_safe.dtype),
                              a_safe[:-1]])
    b_prev = jnp.concatenate([jnp.zeros((1,), b_rec.dtype),
                              b_rec[:-1]])
    fill = jnp.where(valid[0], 1.0 / a_safe[0], 1.0)
    diag = jnp.where(valid, 1.0 / a_safe + b_prev / a_prev, fill)
    valid_next = jnp.concatenate(
        [valid[1:], jnp.zeros((1,), jnp.bool_)])
    off = jnp.where(jnp.logical_and(valid, valid_next),
                    jnp.sqrt(jnp.maximum(b_rec, 0.0)) / a_safe, 0.0)
    t = (jnp.diag(diag) + jnp.diag(off[:-1], 1)
         + jnp.diag(off[:-1], -1))
    w = jnp.linalg.eigvalsh(t)
    lo = jnp.maximum(w[0], jnp.asarray(jnp.finfo(w.dtype).tiny, w.dtype))
    return w[-1] / lo


def cg(op: Operator, b: jax.Array, x0: jax.Array | None = None, *,
       prec: Operator | None = None, rtol: float = 1e-8, atol: float = 0.0,
       maxiter: int = 1000, comm: Comm | None = None,
       condest_window: int = 0, stop=None,
       history: bool = False, compensated: bool = False) -> SolveResult:
    """Preconditioned CG (left-preconditioned in the M-inner-product form).

    condest_window > 0 additionally records the first ``condest_window``
    (α, β) recurrence pairs and returns a FREE per-column condition
    estimate κ(M·A) in ``SolveResult.condest`` — the AZ_cg_condnum
    output of AztecOO (az_aztec_defs.h:266-272), at the cost of one
    small host-free eigvalsh after the loop (no extra applies or
    reductions). A tighten-retry resumption starts a fresh Lanczos
    process; the recorded beta at the seam is zeroed so T is the direct
    sum of genuine Lanczos blocks and the Ritz-interlacing lower-bound
    property survives retries.

    ``stop``: optional composable StatusTest (solvers.status), evaluated
    per iteration — Passed (for every column) means stop early; combined
    with the built-in resnorm/maxiter checks. ``history=True`` records
    the per-iteration recurrence residual norms into
    ``SolveResult.history`` ((maxiter+1,) or (maxiter+1, k), NaN past
    the end) — the StatusTestOutput residual trace as data."""
    comm = comm or SerialComm()
    M = prec or identity_prec
    x = jnp.zeros_like(b) if x0 is None else x0
    cw = int(min(condest_window, maxiter))
    use_aux = bool(cw) or history

    if compensated:
        # double-single Dot2 reductions (ops/compensated.py): recurrence
        # coefficients alpha/beta carry ~eps accuracy instead of
        # ~log(n)·eps — the f32-chip answer to Belos' f64 tolerance
        # machinery (SURVEY hard part #5). The pair's two [hi, lo]
        # blocks ride ONE fused psum — same collective count as the
        # plain path (the per-pair latency parity the compensated.py
        # design promises).
        from ..ops.compensated import (_renorm, comp_dot_global,
                                       comp_local_dot)

        def dot_pair(u1, v1, u2, v2):
            s = comm.psum(jnp.stack([comp_local_dot(u1, v1),
                                     comp_local_dot(u2, v2)]))
            h1, l1 = _renorm(s[0, 0], s[0, 1])
            h2, l2 = _renorm(s[1, 0], s[1, 1])
            return h1 + l1, h2 + l2

        def dot_one(u, v):
            return comp_dot_global(comm, u, v)
    else:
        def dot_pair(u1, v1, u2, v2):
            d = comm.psum(jnp.stack([local_dot(u1, v1),
                                     local_dot(u2, v2)]))
            return d[0], d[1]

        def dot_one(u, v):
            return comm.psum(local_dot(u, v))

    bb = dot_one(b, b)
    tol = rhs_norm_scale(jnp.sqrt(bb), rtol, atol)

    def stop_passed(k, rr):
        from .status import SolverState

        return jnp.all(stop(SolverState(
            iters=k, resnorm=jnp.sqrt(rr), rhs_norm=jnp.sqrt(bb))))

    def solve_from(x, tol2, k0, aux=None):
        r = b - op(x)
        z = M(r)
        p = z
        rz, rr = dot_pair(r, z, r, r)
        if history:
            # index k0: the (explicitly computed) residual entering this
            # segment — ‖b−Ax0‖ on the first pass
            aux = dict(aux)
            aux["hist"] = aux["hist"].at[k0].set(jnp.sqrt(rr))

        def cond(s):
            rr, k = s[5], s[6]
            go = jnp.logical_and(k < maxiter, jnp.any(rr > tol2))
            if stop is not None:
                go = jnp.logical_and(go, ~stop_passed(k, rr))
            return go

        def body(s):
            x, r, z, p, rz, rr, k = s[:7]
            active = rr > tol2
            ap = op(p)
            pap = dot_one(p, ap)
            alpha = jnp.where(active, safe_divide(rz, pap), 0)
            x = x + bcast_cols(alpha, p)
            r = r - bcast_cols(alpha, ap)
            z = M(r)
            rz_new, rr_new = dot_pair(r, z, r, r)
            beta = jnp.where(active, safe_divide(rz_new, rz), 0)
            p = z + bcast_cols(beta, p)
            out = (x, r, z, p, jnp.where(active, rz_new, rz),
                   jnp.where(active, rr_new, rr), k + 1)
            if use_aux:
                aux = dict(s[7])
                if cw:
                    alphas, betas = aux["lanczos"]
                    idx = jnp.minimum(k, cw - 1)
                    ok = k < cw
                    alphas = alphas.at[idx].set(
                        jnp.where(ok, alpha, alphas[idx]))
                    betas = betas.at[idx].set(
                        jnp.where(ok, beta, betas[idx]))
                    # a tighten-retry resumption (k0 > 0) starts a FRESH
                    # Lanczos process: sever the spurious coupling to the
                    # previous segment by zeroing the recorded beta at the
                    # seam — T becomes block-diagonal, the direct sum of
                    # genuine Lanczos blocks, so its extreme Ritz values
                    # stay inside [λmin, λmax]
                    pidx = jnp.minimum(jnp.maximum(k0 - 1, 0), cw - 1)
                    seam = jnp.logical_and(
                        jnp.logical_and(k == k0, k0 > 0), k0 - 1 < cw)
                    betas = betas.at[pidx].set(
                        jnp.where(seam, 0.0, betas[pidx]))
                    aux["lanczos"] = (alphas, betas)
                if history:
                    aux["hist"] = aux["hist"].at[k + 1].set(
                        jnp.where(active, jnp.sqrt(rr_new),
                                  aux["hist"][k + 1]))
                out = out + (aux,)
            return out

        st = (x, r, z, p, rz, rr, k0) + ((aux,) if use_aux else ())
        out = lax.while_loop(cond, body, st)
        return (out[0], out[6]) + ((out[7],) if use_aux else ())

    if use_aux:
        rdt = jnp.real(jnp.zeros((), b.dtype)).dtype
        cshape = () if b.ndim == 1 else (b.shape[1],)
        aux0 = {}
        if cw:
            aux0["lanczos"] = (jnp.zeros((cw,) + cshape, rdt),
                               jnp.zeros((cw,) + cshape, rdt))
        if history:
            aux0["hist"] = jnp.full((maxiter + 1,) + cshape, jnp.nan, rdt)
        x, k, resnorm, conv, aux = certified_solve(
            solve_from, op, b, x, tol, maxiter, comm, aux0=aux0,
            halt=stop_passed if stop is not None else None)
        ce = None
        if cw:
            alphas, betas = aux["lanczos"]
            m = jnp.minimum(k, cw)
            if b.ndim == 1:
                ce = _tridiag_condest(alphas, betas, m)
            else:
                ce = jax.vmap(_tridiag_condest,
                              in_axes=(1, 1, None))(alphas, betas, m)
        return SolveResult(x=x, iters=k, resnorm=resnorm, converged=conv,
                           condest=ce, history=aux.get("hist"))

    x, k, resnorm, conv = certified_solve(
        solve_from, op, b, x, tol, maxiter, comm,
        halt=stop_passed if stop is not None else None)
    return SolveResult(x=x, iters=k, resnorm=resnorm, converged=conv)


def stochastic_cg(op: Operator, b: jax.Array, x0: jax.Array | None = None, *,
                  prec: Operator | None = None, rtol: float = 1e-8,
                  atol: float = 0.0, maxiter: int = 1000,
                  comm: Comm | None = None,
                  key: jax.Array | None = None
                  ) -> tuple[SolveResult, jax.Array]:
    """Stochastic CG (Parker–Fox): solves A x = b and simultaneously draws
    y ~ N(0, A^-1) by accumulating y += (xi_k / sqrt(p'Ap)) p with scalar
    iid xi_k ~ N(0,1) per iteration — the algorithm of
    Belos::PseudoBlockStochasticCGSolMgr / StochasticCGIter
    (packages/belos/src/BelosPseudoBlockStochasticCGIter.hpp).

    Returns (SolveResult, y). The sample distribution is exact when CG runs
    to full accuracy in exact arithmetic; like the reference, partial
    convergence yields an approximate sample from the dominant subspace.
    """
    comm = comm or SerialComm()
    M = prec or identity_prec
    x = jnp.zeros_like(b) if x0 is None else x0
    key = jax.random.PRNGKey(0) if key is None else key

    r = b - op(x)
    z = M(r)
    p = z
    y = jnp.zeros_like(b)
    d0 = comm.psum(jnp.stack([local_dot(r, z), local_dot(r, r),
                              local_dot(b, b)]))
    rz, rr, bb = d0[0], d0[1], d0[2]
    tol = rhs_norm_scale(jnp.sqrt(bb), rtol, atol)
    tol2 = tol * tol
    ncols = () if b.ndim == 1 else (b.shape[1],)

    def cond(s):
        x, y, r, z, p, rz, rr, k, key = s
        return jnp.logical_and(k < maxiter, jnp.any(rr > tol2))

    def body(s):
        x, y, r, z, p, rz, rr, k, key = s
        active = rr > tol2
        ap = op(p)
        pap = comm.psum(local_dot(p, ap))
        alpha = jnp.where(active, safe_divide(rz, pap), 0)
        key, sub = jax.random.split(key)
        xi = jax.random.normal(sub, ncols, dtype=b.dtype)
        s_coef = jnp.where(active, xi * jax.lax.rsqrt(
            jnp.where(pap > 0, pap, 1)), 0)
        x = x + bcast_cols(alpha, p)
        y = y + bcast_cols(s_coef, p)
        r = r - bcast_cols(alpha, ap)
        z = M(r)
        d = comm.psum(jnp.stack([local_dot(r, z), local_dot(r, r)]))
        rz_new, rr_new = d[0], d[1]
        beta = jnp.where(active, safe_divide(rz_new, rz), 0)
        p = z + bcast_cols(beta, p)
        return (x, y, r, z, p, jnp.where(active, rz_new, rz),
                jnp.where(active, rr_new, rr), k + 1, key)

    s = (x, y, r, z, p, rz, rr, 0, key)
    x, y, r, z, p, rz, rr, k, key = lax.while_loop(cond, body, s)
    resnorm, conv = certify_residual(op, b, x, tol, comm)
    return SolveResult(x=x, iters=k, resnorm=resnorm, converged=conv), y


def cg_single_reduce(op: Operator, b: jax.Array, x0: jax.Array | None = None, *,
                     prec: Operator | None = None, rtol: float = 1e-8,
                     atol: float = 0.0, maxiter: int = 1000,
                     comm: Comm | None = None) -> SolveResult:
    """Chronopoulos–Gear CG: one fused reduction per iteration.

    Recurrences (z = M r, w = A z):
        delta = <z, w>, rz = <r, z>, rr = <r, r>   — ONE psum
        beta  = rz / rz_prev  (0 on first step)
        alpha = rz / (delta - beta * rz / alpha_prev)
    """
    comm = comm or SerialComm()
    M = prec or identity_prec
    x = jnp.zeros_like(b) if x0 is None else x0

    bb = comm.psum(local_dot(b, b))
    tol = rhs_norm_scale(jnp.sqrt(bb), rtol, atol)

    def solve_from(x, tol2, k0):
        r = b - op(x)
        z = M(r)
        w = op(z)
        d0 = comm.psum(jnp.stack([local_dot(r, z), local_dot(z, w),
                                  local_dot(r, r)]))
        rz, delta, rr = d0[0], d0[1], d0[2]
        alpha = safe_divide(rz, delta)
        beta = jnp.zeros_like(alpha)
        p = z
        q = w

        def cond(s):
            x, r, z, p, q, w, rz, rr, alpha, beta, k = s
            return jnp.logical_and(k < maxiter, jnp.any(rr > tol2))

        def body(s):
            x, r, z, p, q, w, rz, rr, alpha, beta, k = s
            active = rr > tol2
            a = jnp.where(active, alpha, 0)
            x = x + bcast_cols(a, p)
            r = r - bcast_cols(a, q)
            z = M(r)
            w = op(z)
            d = comm.psum(jnp.stack([local_dot(r, z), local_dot(z, w),
                                     local_dot(r, r)]))
            rz_new, delta, rr_new = d[0], d[1], d[2]
            beta_new = jnp.where(active, safe_divide(rz_new, rz), 0)
            alpha_new = safe_divide(
                rz_new, delta - beta_new * safe_divide(rz_new, alpha))
            alpha_new = jnp.where(active, alpha_new, alpha)
            p = z + bcast_cols(beta_new, p)
            q = w + bcast_cols(beta_new, q)
            return (x, r, z, p, q, w, jnp.where(active, rz_new, rz),
                    jnp.where(active, rr_new, rr), alpha_new, beta_new,
                    k + 1)

        s = (x, r, z, p, q, w, rz, rr, alpha, beta, k0)
        out = lax.while_loop(cond, body, s)
        return out[0], out[10]

    x, k, resnorm, conv = certified_solve(solve_from, op, b, x, tol,
                                          maxiter, comm)
    return SolveResult(x=x, iters=k, resnorm=resnorm, converged=conv)


def cg_pipeline(op: Operator, b: jax.Array, x0: jax.Array | None = None, *,
                prec: Operator | None = None, rtol: float = 1e-8,
                atol: float = 0.0, maxiter: int = 1000,
                comm: Comm | None = None,
                replace_every: int = 50) -> SolveResult:
    """Pipelined CG (Ghysels–Vanroose) with periodic residual replacement.

    Inside one jitted while-loop body the fused reduction's result feeds
    nothing until after the next ``op(...)`` has been emitted, so the XLA
    latency-hiding scheduler overlaps the all-reduce with the SpMV (the
    compiled-collective equivalent of Belos_Tpetra_CgPipeline's early idot,
    packages/belos/tpetra/src/solvers/Belos_Tpetra_CgPipeline.hpp:99-109).

    The extra recurrence vectors drift in finite precision (classic
    pipelined-CG stagnation — observed ~1e-2 in f32 without a guard), so
    every ``replace_every`` iterations the pipelined state is rebuilt from
    the TRUE residual r = b - A x and the current search direction — the
    residual-replacement safeguard Belos pairs with its implicit-residual
    convergence tests (BelosStatusTestImpResNorm.hpp:47-88). The segment
    boundary restarts the alpha recurrence from the directly computed
    <r,u>/<p,Ap>, which is the exact CG step for the preserved direction.
    """
    comm = comm or SerialComm()
    M = prec or identity_prec
    x = jnp.zeros_like(b) if x0 is None else x0

    bb = comm.psum(local_dot(b, b))
    tol = rhs_norm_scale(jnp.sqrt(bb), rtol, atol)

    def refresh(x, p):
        """Rebuild pipelined state from scratch (replacement step)."""
        r = b - op(x)
        u = M(r)
        w = op(u)
        s_v = op(p)
        q = M(s_v)
        z = op(q)
        d = comm.psum(jnp.stack([local_dot(r, u), local_dot(w, u),
                                 local_dot(r, r), local_dot(p, s_v)]))
        gamma, rr, pap = d[0], d[2], d[3]
        alpha = safe_divide(gamma, pap)
        return r, u, w, s_v, q, z, gamma, rr, alpha

    def make_inner(tol2):
        def inner_cond(st):
            (x, r, u, w, m_, n_, z, q, p, s_v, gamma, rr, alpha, k,
             k0) = st
            return jnp.logical_and(
                jnp.logical_and(k < maxiter, k - k0 < replace_every),
                jnp.any(rr > tol2))

        def inner_body(st):
            (x, r, u, w, m_, n_, z, q, p, s_v, gamma, rr, alpha, k,
             k0) = st
            active = rr > tol2
            a = jnp.where(active, alpha, 0)
            x = x + bcast_cols(a, p)
            r = r - bcast_cols(a, s_v)
            u = u - bcast_cols(a, q)
            w = w - bcast_cols(a, z)
            # issue the fused reduction for this step ...
            d = comm.psum(jnp.stack([local_dot(r, u), local_dot(w, u),
                                     local_dot(r, r)]))
            # ... then emit the next apply chain; XLA overlaps them
            m_next = M(w)
            n_next = op(m_next)
            gamma_new, delta, rr_new = d[0], d[1], d[2]
            beta_new = jnp.where(active, safe_divide(gamma_new, gamma), 0)
            alpha_new = safe_divide(
                gamma_new, delta - beta_new * safe_divide(gamma_new, alpha))
            alpha_new = jnp.where(active, alpha_new, alpha)
            p = u + bcast_cols(beta_new, p)
            s_v = w + bcast_cols(beta_new, s_v)
            q = m_next + bcast_cols(beta_new, q)
            z = n_next + bcast_cols(beta_new, z)
            return (x, r, u, w, m_next, n_next, z, q, p, s_v,
                    jnp.where(active, gamma_new, gamma),
                    jnp.where(active, rr_new, rr), alpha_new, k + 1, k0)

        return inner_cond, inner_body

    def solve_from(x, tol2, k0):
        p0 = M(b - op(x))
        inner_cond, inner_body = make_inner(tol2)

        def outer_cond(st):
            x, p, rr, k = st
            return jnp.logical_and(k < maxiter, jnp.any(rr > tol2))

        def outer_body(st):
            x, p, rr, k = st
            r, u, w, s_v, q, z, gamma, rr, alpha = refresh(x, p)
            m_ = M(w)
            n_ = op(m_)
            ist = (x, r, u, w, m_, n_, z, q, p, s_v, gamma, rr, alpha,
                   k, k)
            out = lax.while_loop(inner_cond, inner_body, ist)
            return (out[0], out[8], out[11], out[13])

        x, p, rr, k = lax.while_loop(
            outer_cond, outer_body,
            (x, p0, jnp.full_like(tol2, jnp.inf), k0))
        return x, k

    x, k, resnorm, conv = certified_solve(solve_from, op, b, x, tol,
                                          maxiter, comm)
    return SolveResult(x=x, iters=k, resnorm=resnorm, converged=conv)
