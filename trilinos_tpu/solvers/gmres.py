"""GMRES family: restarted GMRES(m), pseudo-block (per-RHS) GMRES, and
flexible GMRES.

JAX counterparts of Belos' GMRES stack:
  * iteration core     — BelosBlockGmresIter.hpp:659-742 (op apply :694,
    projectAndNormalize :717, Givens updateLSQR :742)
  * restart management — BelosBlockGmresSolMgr.hpp:916 solve() loop
  * pseudo-block       — BelosPseudoBlockGmresIter.hpp (independent
    per-column spaces; here expressed with jax.vmap over RHS columns so the
    operator still sees the full batched SpMM)
  * flexible GMRES     — BelosBlockFGmresIter.hpp (changing right prec).

Static-shape design: the Krylov basis V is a fixed (n, m+1) array whose
not-yet-filled columns are zero; projections against zero columns are
no-ops, so one CGS2/DGKS block projection per iteration costs a constant
two GEMM+psum passes regardless of the current basis size. The Hessenberg
matrix carries Givens rotations on the fly (small (m+1,) vector math that
rides along in the compiled loop).
"""
from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax

from ..parallel.comm import Comm, SerialComm, norm2
from .base import Operator, SolveResult, identity_prec, rhs_norm_scale, safe_divide, hi_precision
from .ortho import (cgs2_project, cgs2_project_window, dgks_project,
                    dgks_project_window, mgs_project, resolve_method)


def _givens_apply(cs, sn, h, j):
    """Apply stored rotations 0..j-1 to the new Hessenberg column h."""
    m = cs.shape[0]

    def body(i, h):
        apply = i < j
        hi, hi1 = h[i], h[i + 1]
        t1 = cs[i] * hi + sn[i] * hi1
        t2 = -sn[i] * hi + cs[i] * hi1
        h = h.at[i].set(jnp.where(apply, t1, hi))
        h = h.at[i + 1].set(jnp.where(apply, t2, hi1))
        return h

    return lax.fori_loop(0, m, body, h)


def _hbar_sv_range(h_raw: jax.Array, j: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Extreme squared singular values of the rectangular Arnoldi
    Hessenberg H̄_j ((j+1)×j, zero-padded to (m+1, m)).

    Since A'V_j = V_{j+1}H̄_j with orthonormal V, every singular value of
    H̄_j lies inside [σmin(A'), σmax(A')] — so σmax(H̄)/σmin(H̄) is a
    PROVABLE lower bound on κ₂ of the preconditioned operator even for
    nonsymmetric A' (the reference's AZ_pgmres_condnum uses the square
    projection V_jᵀA'V_j instead, aztecoo/src/az_gmres_condnum.c:754-838,
    which can overshoot for non-normal operators). Computed as the
    extreme eigenvalues of the masked Gram matrix H̄ᵀH̄, with unused
    diagonal slots filled by the first column's squared norm — a value
    inside [σmin², σmax²] (any column norm is), so padding never moves
    the extremes. j == 0 returns (1, 1) → condest 1."""
    m = h_raw.shape[1]
    idx = jnp.arange(m)
    colv = idx < j
    rowv = jnp.arange(m + 1) <= j
    hm = jnp.where(colv[None, :] & rowv[:, None], h_raw, 0.0)
    gram = hm.T @ hm
    fill = jnp.where(j > 0, gram[0, 0], 1.0)
    outer = colv[None, :] & colv[:, None]
    gm = jnp.where(outer, gram, fill * jnp.eye(m, dtype=gram.dtype))
    w = jnp.linalg.eigvalsh(gm)
    tiny = jnp.asarray(jnp.finfo(w.dtype).tiny, w.dtype)
    return w[-1], jnp.maximum(w[0], tiny)


def _gmres_single(op: Operator, b: jax.Array, x0: jax.Array, *,
                  prec: Operator, flexible: bool, restart: int,
                  maxiter: int, rtol: float, atol: float, comm: Comm,
                  ortho: str, condest: bool = False,
                  window_chunk: int | None = None,
                  stop=None, history: bool = False,
                  compensated: bool = False,
                  basis_dtype=None):
    """Restarted right-preconditioned GMRES for ONE RHS column (n,).

    ``window_chunk``: when set, the Arnoldi projection reads only the
    static basis prefix holding filled columns (one lax.switch over
    prefix lengths, ortho.project_block_window) — at step j the CGS
    pass touches ceil((j+1)/chunk)·chunk columns instead of all m+1.
    None (the DEFAULT) = classic full-basis projection, also used by
    the vmap'd pseudo-block path, where lax.switch degrades to select.
    The windowed form is not measured on the GPU yet (ROADMAP D3)."""
    m = restart
    n = b.shape[0]
    dtype = b.dtype
    # inexact-Krylov basis storage (e.g. bf16): the Arnoldi basis —
    # the proven HBM bottleneck of the iteration (see window_chunk
    # note) — is STORED narrow while every working vector, reduction,
    # and Givens scalar stays in b's dtype. The projection GEMMs read the
    # narrow basis with wide accumulation (ortho.project_block), so
    # projection traffic halves. The Arnoldi relation then holds to
    # basis-dtype accuracy: attainable rtol floors near eps(bdt)
    # (~4e-3 bf16) — certified honestly by the explicit residual
    # check. Use directly for loose tolerances/smoothing, or as an
    # FGMRES inner solver where the f32 outer corrects the inexact
    # inner directions (inexact-Krylov theory).
    bdt = jnp.dtype(basis_dtype) if basis_dtype is not None else dtype
    if compensated:
        # double-single NORM reductions (ops/compensated.py Dot2): the
        # residual/normalization norms driving the Givens recurrence and
        # the convergence decision are accurate to ~eps instead of
        # ~log(n)·eps — the f32-chip answer to Belos' f64 tolerance
        # machinery (SURVEY hard part #5). Projections stay plain GEMMs:
        # Dot2-GEMM projections re-read the full basis per tree sweep
        # and do not move the certified attainable rtol — the
        # attainability floor
        # is the f32 storage of x and the SpMV rounding, which
        # certified_solve's tighten-retry already reaches (see
        # docs/PRECISION.md round-4 measurements).
        from ..ops.compensated import comp_norm2

        def _norm2(c_, x):
            return comp_norm2(c_, x)
    else:
        _norm2 = norm2
    if ortho in ("MGS1", "IMGS"):
        # true (iterated) modified Gram-Schmidt: one reduction per basis
        # column per pass, masked to the j+1 filled columns — the
        # BelosIMGSOrthoManager path (BelosIMGSOrthoManager.hpp:1).
        # Communication-heavy by construction (that's MGS); no windowing.
        mcols = m + 1
        passes = 2 if ortho == "IMGS" else 1

        def project(v, w, j):
            w1, c1 = mgs_project(comm, v, w, j + 1)
            if passes == 2:
                w2, c2 = mgs_project(comm, v, w1, j + 1)
                return w2, c1 + c2
            return w1, c1
    elif window_chunk:
        mcols = -(-(m + 1) // window_chunk) * window_chunk
        proj_w = (cgs2_project_window if ortho == "CGS2"
                  else dgks_project_window)

        def project(v, w, j):
            w2, c = proj_w(comm, v, w, j + 1, window_chunk)
            return w2, c[:m + 1]
    else:
        mcols = m + 1
        proj_f = cgs2_project if ortho == "CGS2" else dgks_project

        def project(v, w, j):
            return proj_f(comm, v, w)

    bnorm = _norm2(comm, b)
    tol = rhs_norm_scale(bnorm, rtol, atol)

    def stop_passed(iters, res):
        """Composable StatusTest evaluation (Belos stest_->checkStatus,
        BelosBlockGmresIter.hpp:676): Passed means STOP."""
        from .status import SolverState

        return stop(SolverState(iters=iters, resnorm=res, rhs_norm=bnorm))

    def cycle(x, r0, beta, total_iters, hist):
        """One restart cycle from the TRUE residual r0 (‖r0‖ = beta).

        Returns the updated x together with its freshly computed true
        residual — restarts are TRUE-residual-gated (the implicit |g|
        only exits the inner loop), so inexact-Arnoldi error (bf16
        basis storage, f32 rounding) is corrected by further cycles
        instead of terminating the solve a hair above tol. Costs no
        extra operator applies: the residual computation moved from
        cycle start to cycle end."""
        v = jnp.zeros((n, mcols), bdt)
        v = v.at[:, 0].set(safe_divide(r0, beta).astype(bdt))
        # the Z basis is filled with device-varying preconditioned vectors
        # inside the while_loop — promote the replicated zero init so the
        # carry types agree under shard_map
        z = comm.pvary(jnp.zeros((n, m), dtype)) if flexible else None
        h_rot = jnp.zeros((m + 1, m), dtype)  # rotated Hessenberg (R factor)
        h_raw = jnp.zeros((m + 1, m), dtype) if condest else None
        cs = jnp.zeros(m, dtype)
        sn = jnp.zeros(m, dtype)
        g = jnp.zeros(m + 1, dtype).at[0].set(beta)
        if history:
            # cycle 0 records the initial implicit residual ‖r0‖
            hist = hist.at[0].set(jnp.where(total_iters == 0, beta, hist[0]))

        def cond(s):
            v, z, h_rot, h_raw, cs, sn, g, hist, j = s
            go = jnp.logical_and(j < m, jnp.abs(g[j]) > tol)
            if stop is not None:
                go = jnp.logical_and(
                    go, ~stop_passed(total_iters + j, jnp.abs(g[j])))
            return go

        def body(s):
            v, z, h_rot, h_raw, cs, sn, g, hist, j = s
            vj = lax.dynamic_slice_in_dim(v, j, 1, axis=1)[:, 0].astype(dtype)
            zj = prec(vj)
            if flexible:
                z = lax.dynamic_update_slice(z, zj[:, None], (0, j))
            w = op(zj)
            # block projection against the (zero-padded) basis — full or
            # active-window chunked, per window_chunk
            w2, hcol = project(v, w[:, None], j)
            w2 = w2[:, 0]
            hnorm = _norm2(comm, w2)
            h = hcol[:, 0].at[j + 1].set(hnorm)
            if condest:
                h_raw = lax.dynamic_update_slice(h_raw, h[:, None], (0, j))
            v = lax.dynamic_update_slice(
                v, safe_divide(w2, hnorm).astype(bdt)[:, None], (0, j + 1))
            # Givens: rotate new column, create rotation j, update g
            h = _givens_apply(cs, sn, h, j)
            hj, hj1 = h[j], h[j + 1]
            denom = jnp.sqrt(hj * hj + hj1 * hj1)
            c_new = jnp.where(denom > 0, hj / jnp.where(denom > 0, denom, 1), 1.0)
            s_new = jnp.where(denom > 0, hj1 / jnp.where(denom > 0, denom, 1), 0.0)
            cs = cs.at[j].set(c_new)
            sn = sn.at[j].set(s_new)
            h = h.at[j].set(denom).at[j + 1].set(0)
            g = g.at[j + 1].set(-s_new * g[j])
            g = g.at[j].set(c_new * g[j])
            h_rot = lax.dynamic_update_slice(h_rot, h[:, None], (0, j))
            if history:
                # |g[j+1]| IS the implicit residual after step j (the
                # quantity StatusTestGenResNorm tracks per iteration)
                hist = hist.at[total_iters + j + 1].set(jnp.abs(g[j + 1]))
            return (v, z, h_rot, h_raw, cs, sn, g, hist, j + 1)

        state = (v, z, h_rot, h_raw, cs, sn, g, hist, 0)
        v, z, h_rot, h_raw, cs, sn, g, hist, j = lax.while_loop(
            cond, body, state)

        # masked back-substitution: y = R⁻¹ g on the leading j×j block
        idx = jnp.arange(m)
        r_small = h_rot[:m, :]
        diag_fix = jnp.where(idx >= j, 1.0, 0.0)
        r_masked = jnp.where(
            jnp.logical_or(idx[None, :] >= j, idx[:, None] >= j),
            jnp.diag(diag_fix), r_small)
        g_masked = jnp.where(idx < j, g[:m], 0)
        y = lax.linalg.triangular_solve(
            r_masked, g_masked[:, None], left_side=True, lower=False)[:, 0]
        correction = (jnp.einsum("nm,m->n", v[:, :m], y,
                                 preferred_element_type=dtype)
                      if not flexible else z @ y)
        if not flexible:
            correction = prec(correction)
        x = x + correction
        # end-of-cycle TRUE residual (the ImpResNorm "loss of accuracy"
        # guard, BelosStatusTestImpResNorm.hpp:47-88, applied at every
        # restart rather than once at exit)
        r_new = b - op(x)
        beta_new = _norm2(comm, r_new)
        out = (x, r_new, beta_new, total_iters + j, hist)
        if condest:
            out = out + _hbar_sv_range(h_raw, j)
        return out

    # stagnation (loss-of-accuracy) guard: a cycle that fails to reduce
    # the true residual by at least this factor ends the solve — the
    # Belos ImpResNorm LOA status (BelosStatusTestImpResNorm.hpp:47-88).
    # Without it an unattainable rtol would burn the whole maxiter
    # budget re-running identical cycles (the true-residual gate keeps
    # restarting; the old implicit gate exited after one quiet cycle).
    stall_ratio = 1.0 - 1.0 / 1024.0

    def outer_cond(s):
        res, total, prev = s[2], s[3], s[-1]
        go = jnp.logical_and(total < maxiter, res > tol)
        go = jnp.logical_and(go, res < prev * stall_ratio)
        if stop is not None:
            go = jnp.logical_and(go, ~stop_passed(total, res))
        return go

    def outer_body(s):
        out = cycle(s[0], s[1], s[2], s[3], s[4])
        if condest:
            # each restart cycle samples the operator's singular range
            # through a fresh Krylov basis: keep the widest certified
            # bracket (running max σmax², min σmin²)
            out = out[:5] + (jnp.maximum(out[5], s[5]),
                             jnp.minimum(out[6], s[6]))
        # the finished cycle's entry residual becomes prev
        return out + (s[2],)

    # per-iteration implicit resnorms (StatusTestOutput residual trace,
    # BelosStatusTestOutput.hpp); NaN marks never-reached iterations.
    # Sized maxiter+m+1: the outer loop starts a cycle whenever
    # total < maxiter, so the LAST cycle can run to total+m iterations —
    # a (maxiter+1,) buffer would silently drop (OOB scatter) the trace
    # of iterations that actually executed.
    hist0 = (jnp.full(maxiter + m + 1, jnp.nan, dtype) if history else None)
    # one cycle always runs; then restart while the TRUE residual needs it
    r0 = b - op(x0)
    beta0 = _norm2(comm, r0)
    st = cycle(x0, r0, beta0, 0, hist0) + (beta0,)
    st = lax.while_loop(outer_cond, outer_body, st)
    x, res_true, total = st[0], st[2], st[3]
    ce = jnp.sqrt(st[5] / st[6]) if condest else None
    return x, total, res_true, res_true <= tol, ce, st[4]


@hi_precision
def gmres(op: Operator, b: jax.Array, x0: jax.Array | None = None, *,
          prec: Operator | None = None, flexible: bool = False,
          restart: int = 30, maxiter: int = 1000, rtol: float = 1e-8,
          atol: float = 0.0, comm: Comm | None = None,
          ortho: str = "CGS2", condest: bool = False,
          window_chunk: int | None = None,
          stop=None, history: bool = False,
          compensated: bool = False,
          basis_dtype=None) -> SolveResult:
    """Restarted GMRES(m) with right preconditioning.

    Multivector RHS runs as pseudo-block GMRES: jax.vmap over columns gives
    each column its own Krylov space and Hessenberg, while the operator
    apply and the CGS2 reductions remain batched over all columns (the
    compiled analogue of BelosPseudoBlockGmresIter's shared kernels).

    condest=True additionally reports a FREE κ₂ estimate of the
    preconditioned operator in ``SolveResult.condest`` — the AZ_condnum
    output of AztecOO's AZ_pgmres_condnum (az_gmres_condnum.c) — from
    the singular range of the Arnoldi Hessenberg (one small eigvalsh per
    restart cycle; no extra applies or reductions). Here it is a
    provable LOWER bound on κ₂ even for nonsymmetric operators (the
    rectangular H̄, not the square projection the reference uses).

    ``stop``: optional composable StatusTest (solvers.status) evaluated
    in-loop per iteration AND at restart boundaries; Passed means stop
    (Belos stest_->checkStatus, BelosBlockGmresIter.hpp:676). Combined
    (OR) with the built-in resnorm/maxiter checks.

    ``basis_dtype``: store the Krylov basis in a narrower dtype (e.g.
    ``jnp.bfloat16``) while all working vectors, reductions, and the
    Givens recurrence stay in b's dtype — the inexact-Krylov storage
    mode for the HBM-bound projection (basis reads halve; the GEMMs
    consume bf16 with wide accumulation). Each cycle's
    reachable reduction is limited by eps(basis_dtype), but the restart
    recomputes r = b − Ax in working precision, so the outer loop acts
    as iterative refinement and reaches far tighter tolerances
    (measured: 6e-6 from a bf16 basis on Laplace2D; unattainable
    requests report converged=False via the explicit-residual check).
    Intended for loose/medium-tolerance solves, smoothing, and FGMRES
    inner solves. Beyond-reference feature: Belos has no
    mixed-precision basis storage.

    ``history=True``: record the per-iteration implicit residual norms
    (|g_{j+1}| from the Givens recurrence — exactly what
    StatusTestGenResNorm tracks) into ``SolveResult.history``, a
    (maxiter+restart+1,) array (or (maxiter+restart+1, k) for
    multivector RHS) with NaN past the final iteration — the
    StatusTestOutput residual trace (BelosStatusTestOutput.hpp) as data
    instead of printing. (The +restart headroom covers the final cycle,
    which may run past maxiter.)
    """
    comm = comm or SerialComm()
    prec = prec or identity_prec
    ortho_m = resolve_method(ortho)
    x0 = jnp.zeros_like(b) if x0 is None else x0

    core = functools.partial(
        _gmres_single, op, prec=prec, flexible=flexible, restart=restart,
        maxiter=maxiter, rtol=rtol, atol=atol, comm=comm, ortho=ortho_m,
        condest=condest, stop=stop, history=history,
        compensated=compensated, basis_dtype=basis_dtype,
        # vmap turns the window's lax.cond into select (both branches
        # run) — chunking only pays on the single-RHS path
        window_chunk=window_chunk if b.ndim == 1 else None)

    if b.ndim == 1:
        x, iters, res, conv, ce, hist = core(b, x0)
    else:
        out_axes = (1, 0, 0, 0, 0 if condest else None,
                    1 if history else None)
        x, iters, res, conv, ce, hist = jax.vmap(core, in_axes=1,
                                                 out_axes=out_axes)(b, x0)
        iters = jnp.max(iters)
    return SolveResult(x=x, iters=iters, resnorm=res, converged=conv,
                       condest=ce, history=hist)


@hi_precision
def fgmres(op: Operator, b: jax.Array, x0: jax.Array | None = None,
           **kw) -> SolveResult:
    """Flexible GMRES (variable right preconditioner per iteration)."""
    return gmres(op, b, x0, flexible=True, **kw)
