"""Communication-avoiding GMRES variants: single-reduce and pipelined.

JAX counterparts of the reference's native Tpetra solvers:
  * ``gmres_single_reduce`` — ONE fused reduction per Arnoldi step: the
    classical-Gram-Schmidt projection coefficients Vᵀw and the norm wᵀw
    ride in a single psum; the normalization constant comes from the
    Pythagorean identity ‖w − Vh‖² = wᵀw − hᵀh ("delayed normalization").
    Analogue of Belos_Tpetra_GmresSingleReduce.hpp
    (packages/belos/tpetra/src/solvers/).
  * ``gmres_pipeline`` — Ghysels p(1) pipelined GMRES: the reduction for
    step j is issued, the next SpMV u = A z_j runs before its result is
    consumed (XLA latency-hiding overlaps them), and the Krylov shadow
    basis Z = (A∘M) V is corrected afterwards:
        v_{j+1} = (z_j − V h)/‖·‖,  z_{j+1} = (u − Z h)/‖·‖.
    Analogue of Belos_Tpetra_GmresPipeline.hpp.

Both report the certified TRUE residual (explicit recompute) like the rest
of the GMRES family (BelosStatusTestImpResNorm.hpp:47-88).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.blas import local_dot
from ..parallel.comm import Comm, SerialComm, norm2
from .base import Operator, SolveResult, identity_prec, rhs_norm_scale, safe_divide, hi_precision
from .gmres import _givens_apply


def _lsq_update(cs, sn, g, h_rot, h, j):
    """Givens step shared by both variants: rotate the new Hessenberg
    column, create rotation j, update the rhs g and the R factor."""
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
    return cs, sn, g, h_rot


def _solve_y(h_rot, g, j, m):
    """Masked back-substitution on the leading j×j block."""
    idx = jnp.arange(m)
    diag_fix = jnp.where(idx >= j, 1.0, 0.0)
    r_masked = jnp.where(
        jnp.logical_or(idx[None, :] >= j, idx[:, None] >= j),
        jnp.diag(diag_fix), h_rot[:m, :])
    g_masked = jnp.where(idx < j, g[:m], 0)
    return lax.linalg.triangular_solve(
        r_masked, g_masked[:, None], left_side=True, lower=False)[:, 0]


def _sr_single(op, b, x0, *, prec, restart, maxiter, rtol, atol, comm):
    m = restart
    n = b.shape[0]
    dtype = b.dtype
    bnorm = norm2(comm, b)
    tol = rhs_norm_scale(bnorm, rtol, atol)

    def cycle(x, total_iters):
        r0 = b - op(x)
        beta = norm2(comm, r0)
        v = jnp.zeros((n, m + 1), dtype).at[:, 0].set(safe_divide(r0, beta))
        h_rot = jnp.zeros((m + 1, m), dtype)
        cs = jnp.zeros(m, dtype)
        sn = jnp.zeros(m, dtype)
        g = jnp.zeros(m + 1, dtype).at[0].set(beta)

        def cond(s):
            v, h_rot, cs, sn, g, j = s
            return jnp.logical_and(j < m, jnp.abs(g[j]) > tol)

        def body(s):
            v, h_rot, cs, sn, g, j = s
            vj = lax.dynamic_slice_in_dim(v, j, 1, axis=1)[:, 0]
            w = op(prec(vj))
            # ONE reduction: [Vᵀw ; wᵀw]
            d = comm.psum(jnp.concatenate([v.T @ w, local_dot(w, w)[None]]))
            hcol, ww = d[: m + 1], d[m + 1]
            w2 = w - v @ hcol
            hnorm = jnp.sqrt(jnp.maximum(ww - jnp.sum(hcol * hcol), 0))
            h = hcol.at[j + 1].set(hnorm)
            v = lax.dynamic_update_slice(
                v, safe_divide(w2, hnorm)[:, None], (0, j + 1))
            cs, sn, g, h_rot = _lsq_update(cs, sn, g, h_rot, h, j)
            return (v, h_rot, cs, sn, g, j + 1)

        v, h_rot, cs, sn, g, j = lax.while_loop(
            cond, body, (v, h_rot, cs, sn, g, 0))
        y = _solve_y(h_rot, g, j, m)
        x = x + prec(v[:, :m] @ y)
        # single-pass CGS can lose orthogonality and make |g[j]| lie low;
        # gate restarts on the TRUE residual (one extra reduction/cycle)
        res = norm2(comm, b - op(x))
        return x, total_iters + j, res

    def outer_cond(s):
        x, total, res = s
        return jnp.logical_and(total < maxiter, res > tol)

    def outer_body(s):
        x, total, _ = s
        return cycle(x, total)

    x, total, res = cycle(x0, 0)
    x, total, res = lax.while_loop(outer_cond, outer_body, (x, total, res))
    res_true = norm2(comm, b - op(x))
    return x, total, res_true, res_true <= tol


def _pipe_single(op, b, x0, *, prec, restart, maxiter, rtol, atol, comm):
    m = restart
    n = b.shape[0]
    dtype = b.dtype
    bnorm = norm2(comm, b)
    tol = rhs_norm_scale(bnorm, rtol, atol)
    op_eff = lambda u: op(prec(u))

    def cycle(x, total_iters):
        r0 = b - op(x)
        beta = norm2(comm, r0)
        v = jnp.zeros((n, m + 1), dtype).at[:, 0].set(safe_divide(r0, beta))
        z = jnp.zeros((n, m + 1), dtype)
        z = z.at[:, 0].set(op_eff(v[:, 0]))  # shadow basis Z = (A∘M) V
        h_rot = jnp.zeros((m + 1, m), dtype)
        cs = jnp.zeros(m, dtype)
        sn = jnp.zeros(m, dtype)
        g = jnp.zeros(m + 1, dtype).at[0].set(beta)

        def cond(s):
            v, z, h_rot, cs, sn, g, j = s
            return jnp.logical_and(j < m, jnp.abs(g[j]) > tol)

        def body(s):
            v, z, h_rot, cs, sn, g, j = s
            zj = lax.dynamic_slice_in_dim(z, j, 1, axis=1)[:, 0]
            # issue the fused reduction for step j ...
            d = comm.psum(jnp.concatenate([v.T @ zj,
                                           local_dot(zj, zj)[None]]))
            # ... and emit the next SpMV before consuming it (overlap)
            u = op_eff(zj)
            hcol, ww = d[: m + 1], d[m + 1]
            w2 = zj - v @ hcol
            hnorm = jnp.sqrt(jnp.maximum(ww - jnp.sum(hcol * hcol), 0))
            inv = safe_divide(jnp.ones_like(hnorm), hnorm)
            v = lax.dynamic_update_slice(v, (w2 * inv)[:, None], (0, j + 1))
            z = lax.dynamic_update_slice(
                z, ((u - z @ hcol) * inv)[:, None], (0, j + 1))
            h = hcol.at[j + 1].set(hnorm)
            cs, sn, g, h_rot = _lsq_update(cs, sn, g, h_rot, h, j)
            return (v, z, h_rot, cs, sn, g, j + 1)

        v, z, h_rot, cs, sn, g, j = lax.while_loop(
            cond, body, (v, z, h_rot, cs, sn, g, 0))
        y = _solve_y(h_rot, g, j, m)
        x = x + prec(v[:, :m] @ y)
        # single-pass CGS can lose orthogonality and make |g[j]| lie low;
        # gate restarts on the TRUE residual (one extra reduction/cycle)
        res = norm2(comm, b - op(x))
        return x, total_iters + j, res

    def outer_cond(s):
        x, total, res = s
        return jnp.logical_and(total < maxiter, res > tol)

    def outer_body(s):
        x, total, _ = s
        return cycle(x, total)

    x, total, res = cycle(x0, 0)
    x, total, res = lax.while_loop(outer_cond, outer_body, (x, total, res))
    res_true = norm2(comm, b - op(x))
    return x, total, res_true, res_true <= tol


def _wrap(core_single, op, b, x0, prec, restart, maxiter, rtol, atol, comm):
    comm = comm or SerialComm()
    prec = prec or identity_prec
    x0 = jnp.zeros_like(b) if x0 is None else x0
    core = functools.partial(core_single, op, prec=prec, restart=restart,
                             maxiter=maxiter, rtol=rtol, atol=atol,
                             comm=comm)
    if b.ndim == 1:
        x, iters, res, conv = core(b, x0)
    else:
        x, iters, res, conv = jax.vmap(
            core, in_axes=1, out_axes=(1, 0, 0, 0))(b, x0)
        iters = jnp.max(iters)
    return SolveResult(x=x, iters=iters, resnorm=res, converged=conv)


@hi_precision
def gmres_single_reduce(op: Operator, b: jax.Array,
                        x0: jax.Array | None = None, *,
                        prec: Operator | None = None, restart: int = 30,
                        maxiter: int = 1000, rtol: float = 1e-8,
                        atol: float = 0.0,
                        comm: Comm | None = None) -> SolveResult:
    """GMRES(m) with one fused reduction per Arnoldi step."""
    return _wrap(_sr_single, op, b, x0, prec, restart, maxiter, rtol, atol,
                 comm)


@hi_precision
def gmres_pipeline(op: Operator, b: jax.Array,
                   x0: jax.Array | None = None, *,
                   prec: Operator | None = None, restart: int = 30,
                   maxiter: int = 1000, rtol: float = 1e-8,
                   atol: float = 0.0,
                   comm: Comm | None = None) -> SolveResult:
    """Ghysels p(1) pipelined GMRES(m): reduction overlapped with SpMV."""
    return _wrap(_pipe_single, op, b, x0, prec, restart, maxiter, rtol,
                 atol, comm)
