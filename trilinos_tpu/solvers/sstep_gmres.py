"""s-step (communication-avoiding) GMRES.

JAX analogue of the reference's native Tpetra s-step GMRES
(packages/belos/tpetra/src/solvers/Belos_Tpetra_GmresSstep.hpp:305 —
matrix-powers blocks orthogonalized en bloc, cutting the number of global
reductions per basis vector).

Per block of s basis vectors: s operator applies, ONE CGS2 block
projection (2 psums) and ONE CholQR2 (2 psums) — 4 reductions per s
vectors versus ~3 per vector for standard Arnoldi/GMRES. On a pod slice
where the all-reduce latency rivals the SpMV time, this is the lever the
reference builds GmresSstep for.

Bookkeeping (monomial basis, σ-scaled for conditioning): each block
produces W = [w₁..w_s], w_k = (A w_{k-1})/σ with w₀ = q (the last basis
vector). The relation A·[q w₁..w_{s-1}] = σ·[w₁..w_s] lets both sides be
expressed in the final orthonormal basis, so GMRES reduces to a small
least-squares with the assembled coefficient matrices — no per-vector
Hessenberg updates, no extra reductions.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..parallel.comm import Comm, SerialComm, norm2
from .base import Operator, SolveResult, identity_prec, rhs_norm_scale, safe_divide, hi_precision
from .ortho import cgs2_project, cholqr2


def leja_order(vals) -> np.ndarray:
    """Modified Leja ordering (host-side): start at max modulus, then
    greedily maximize Π|z - chosen| (via Σ log to avoid overflow);
    a complex value is immediately followed by its conjugate so the
    Newton basis can fuse the pair into a real quadratic stage.
    (Bai/Hu/Reichel; Hoemmen's CA-GMRES uses exactly this ordering.)"""
    remaining = list(np.asarray(vals, complex))
    out: list[complex] = []
    while remaining:
        if not out:
            idx = int(np.argmax(np.abs(remaining)))
        else:
            chosen = np.asarray(out)
            score = [float(np.sum(np.log(
                np.maximum(np.abs(chosen - z), 1e-300))))
                for z in remaining]
            idx = int(np.argmax(score))
        z = remaining.pop(idx)
        out.append(z)
        if abs(z.imag) > 1e-12 * max(1.0, abs(z)) and remaining:
            d = [abs(w - np.conj(z)) for w in remaining]
            j = int(np.argmin(d))
            if d[j] <= 1e-8 * max(1.0, abs(z)):
                out.append(remaining.pop(j))
    return np.asarray(out)


def ritz_shifts(op: Operator, b: jax.Array, s: int,
                comm: Comm | None = None) -> np.ndarray:
    """s Leja-ordered Ritz values from an s-step Arnoldi on b — the
    Newton-basis shifts for CA-GMRES (host-side setup; the reference's
    GmresSstep sticks to the σ-scaled monomial basis, which loses
    linear independence for larger s — Newton shifts are the standard
    fix from the CA-Krylov literature)."""
    from ..eigen.lanczos import arnoldi

    v, h = arnoldi(op, b, s, comm=comm)
    hm = np.asarray(h)[:s, :s]
    return leja_order(np.linalg.eigvals(hm))


def estimate_opnorm(apply, n: int, dtype, comm: Comm | None = None,
                    iters: int = 3, seed: int = 0) -> float:
    """Crude ‖A‖₂ estimate by a few power iterations (host-side setup).
    The single-chip and distributed s-step drivers both use THIS
    function so their σ basis scalings — and hence iteration counts —
    are comparable."""
    comm = comm or SerialComm()
    v = jnp.asarray(np.random.default_rng(seed).standard_normal(n),
                    dtype=dtype)
    v = v / norm2(comm, v)
    sig = 1.0
    for _ in range(iters):
        w = apply(v)
        sig = norm2(comm, w)
        v = safe_divide(w, sig)
    return max(float(sig), 1e-30)


def newton_basis_stages(shifts, sigma: float):
    """(alpha, beta, gamma) per stage for the σ-scaled Newton basis
    w_k = (A - λ_k) w_{k-1} / σ. Adjacent conjugate pairs (as produced
    by leja_order) are fused into a REAL quadratic: the pair's second
    stage computes w_{k+1} = ((A - a) w_k + (b²/σ) w_{k-1})/σ so that
    σ² w_{k+1} = ((A - a)² + b²) w_{k-1} = (A - λ)(A - λ̄) w_{k-1}."""
    inv = 1.0 / float(sigma)
    shifts = np.asarray(shifts, complex)
    out: list[tuple[float, float, float]] = []
    i = 0
    while i < len(shifts):
        z = shifts[i]
        if abs(z.imag) <= 1e-12 * max(1.0, abs(z)):
            out.append((inv, -z.real * inv, 0.0))
            i += 1
            continue
        if (i + 1 >= len(shifts)
                or abs(shifts[i + 1] - np.conj(z))
                > 1e-8 * max(1.0, abs(z))):
            raise ValueError(
                "complex shifts must come in adjacent conjugate pairs "
                "(order them with leja_order)")
        a, bb = z.real, abs(z.imag)
        out.append((inv, -a * inv, 0.0))
        out.append((inv, -a * inv, (bb * bb) * inv * inv))
        i += 2
    return out


@hi_precision
def sstep_gmres(op: Operator, b: jax.Array, x0: jax.Array | None = None, *,
                s: int = 4, t_blocks: int = 8, max_restarts: int = 20,
                rtol: float = 1e-8, atol: float = 0.0, sigma: float | None = None,
                prec: Operator | None = None,
                comm: Comm | None = None,
                powers_fn: Callable | None = None,
                shifts=None, basis_dtype=None) -> SolveResult:
    """Restarted s-step GMRES: m = s·t_blocks basis vectors per cycle.

    shifts: optional length-s Newton-basis shifts (use ``ritz_shifts``
    for Leja-ordered Ritz values): w_k = (A - λ_k) w_{k-1}/σ instead of
    the monomial w_k = A w_{k-1}/σ — much better basis conditioning for
    larger s. Complex shifts must come in adjacent conjugate pairs
    (fused into real quadratic stages). The small-matrix bookkeeping is
    basis-generic: A·[w_0..w_{s-1}] = [w_0..w_s]·B with B read off the
    recurrence coefficients.

    powers_fn: explicit basis generator replacing the s operator
    applies of each block — ``powers_fn(q, sigma) -> (n, s)`` producing the SAME recurrence as
    the loop basis (monomial, or Newton when ``shifts`` is given). The
    distributed CA driver passes the one-exchange halo matrix-powers
    generator here (requires ``sigma`` to be given, since the host-side
    estimate cannot run inside shard_map).

    basis_dtype (e.g. ``jnp.bfloat16``): store the orthonormal basis V
    narrow while the matrix-powers block, CholQR panels, and small
    matrices stay in b's dtype — the CGS2 block projection (the 4
    full-basis reads per s vectors) halves its HBM traffic; restarts
    are true-residual-gated, so narrow-basis cycles refine honestly
    (see gmres(basis_dtype=...))."""
    comm = comm or SerialComm()
    M = prec or identity_prec
    x = jnp.zeros_like(b) if x0 is None else x0
    n = b.shape[0]
    m = s * t_blocks
    dtype = b.dtype
    bdt = jnp.dtype(basis_dtype) if basis_dtype is not None else dtype

    def opM(v):
        return op(M(v))

    if powers_fn is not None and sigma is None:
        raise ValueError("powers_fn requires an explicit sigma (the "
                         "host-side estimate cannot run inside "
                         "shard_map)")
    if powers_fn is not None and prec is not None:
        raise ValueError("powers_fn generates an unpreconditioned "
                         "basis; prec cannot be combined with it")

    if sigma is None:
        sigma = estimate_opnorm(opM, n, dtype, comm)

    if shifts is not None:
        stage_coeffs = newton_basis_stages(shifts, sigma)
        if len(stage_coeffs) != s:
            raise ValueError(f"need exactly s={s} shifts")
    else:
        stage_coeffs = [(1.0 / sigma, 0.0, 0.0)] * s

    # recurrence coefficients as device constants (loop basis + the
    # basis-change bookkeeping below)
    alphas_c = jnp.asarray([a for a, _, _ in stage_coeffs], dtype)
    betas_c = jnp.asarray([bt for _, bt, _ in stage_coeffs], dtype)
    gammas_c = jnp.asarray([g for _, _, g in stage_coeffs], dtype)
    inv_alpha_c = jnp.asarray([1.0 / a for a, _, _ in stage_coeffs],
                              dtype)

    bnorm = norm2(comm, b)
    tol = rhs_norm_scale(bnorm, rtol, atol)

    def cycle(x):
        r = b - op(x)
        beta = norm2(comm, r)
        v = jnp.zeros((n, m + 1), bdt).at[:, 0].set(
            safe_divide(r, beta).astype(bdt))
        ex = jnp.zeros((m + 1, m), dtype)  # X (search dirs) in V coords
        fy = jnp.zeros((m + 1, m), dtype)  # A·X/1 in V coords

        def blk_body(blk, carry):
            v, ex, fy = carry
            j0 = blk * s
            q = lax.dynamic_slice(v, (0, j0), (n, 1))[:, 0].astype(dtype)

            # matrix powers W (n, s): w_k = α_k A w_{k-1} + β_k w_{k-1}
            # + γ_k w_{k-2} (monomial: α=1/σ, β=γ=0)
            if powers_fn is not None:
                wmat = powers_fn(q, sigma)
            else:
                def pw(i, carry):
                    w_prev, w_prev2, wmat = carry
                    w = (alphas_c[i] * opM(w_prev)
                         + betas_c[i] * w_prev + gammas_c[i] * w_prev2)
                    wmat = lax.dynamic_update_slice(wmat, w[:, None],
                                                    (0, i))
                    return w, w_prev, wmat

                # inits derived from q so the carry keeps q's varying
                # manual axes under shard_map (plain zeros would be
                # replicated and trip the vma check)
                wmat0 = q[:, None] * jnp.zeros((1, s), dtype)
                _, _, wmat = lax.fori_loop(0, s, pw,
                                           (q, q * 0.0, wmat0))
            # block orthogonalization: W = V C + Q R  (4 reductions total)
            w2, c_full = cgs2_project(comm, v, wmat)
            q_new, r_small, _ = cholqr2(comm, w2)
            v = lax.dynamic_update_slice(v, q_new.astype(bdt), (0, j0 + 1))
            # global coords of w^{(k)}: C[:,k] + R[:,k] at slots j0+1..j0+s
            g = c_full  # (m+1, s)
            blkpart = lax.dynamic_slice(g, (j0 + 1, 0), (s, s))
            g = lax.dynamic_update_slice(g, blkpart + r_small, (j0 + 1, 0))
            # X columns j0..j0+s-1: [e_{j0}, g_1..g_{s-1}]
            e_col = jnp.zeros((m + 1, 1), dtype).at[j0, 0].set(1.0)
            x_blk = jnp.concatenate([e_col, g[:, : s - 1]], axis=1)
            ex = lax.dynamic_update_slice(ex, x_blk, (0, j0))
            # Y columns from the recurrence read backwards:
            # A w_{k-1} = (w_k - β_k w_{k-1} - γ_k w_{k-2}) / α_k
            # (monomial: fy = σ·[g_1 .. g_s])
            g_prev1 = x_blk                     # [g_0 .. g_{s-1}]
            g_prev2 = jnp.concatenate(
                [jnp.zeros((m + 1, 1), dtype), x_blk[:, : s - 1]],
                axis=1)                         # [0, g_0 .. g_{s-2}]
            fy_blk = ((g - g_prev1 * betas_c[None, :]
                       - g_prev2 * gammas_c[None, :])
                      * inv_alpha_c[None, :])
            fy = lax.dynamic_update_slice(fy, fy_blk, (0, j0))
            return v, ex, fy

        v, ex, fy = lax.fori_loop(0, t_blocks, blk_body, (v, ex, fy))
        e1 = jnp.zeros(m + 1, dtype).at[0].set(beta)
        # masked LS (ortho.masked_lstsq): the cycle always generates all
        # m basis vectors, so a mid-cycle-captured residual leaves
        # rank-deficient trailing columns in fy whose unguarded QR solve
        # would corrupt x (the GCRODR happy-breakdown defect class)
        from .ortho import masked_lstsq

        y = masked_lstsq(fy, e1)
        x = x + M(jnp.einsum("nm,m->n", v, ex @ y,
                             preferred_element_type=dtype))
        return x

    def res_norm(x):
        return norm2(comm, b - op(x))

    def cond(st):
        x, k, rn = st
        return jnp.logical_and(k < max_restarts + 1, rn > tol)

    def body(st):
        x, k, _ = st
        x = cycle(x)
        return x, k + 1, res_norm(x)

    x, cycles, rn = lax.while_loop(cond, body, (x, 0, res_norm(x)))
    return SolveResult(x=x, iters=cycles * m, resnorm=rn,
                       converged=rn <= tol)
