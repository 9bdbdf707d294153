"""Unrolled small-dense factorizations (k ≤ 16) for the solver hot loops.

Reference role: the small-dense Teuchos::LAPACK calls inside Belos/Anasazi
managers (packages/teuchos/numerics/src/Teuchos_LAPACK.hpp:96).

1. The triangular *inverse* turns the big (n, k) triangular solve of
   CholQR into one streaming GEMM ``w @ R⁻¹`` — one fused pass over the
   panel instead of the column-recurrence ``triangular_solve`` lowering,
   and it composes with the CGS2 GEMMs in the same fusion.
2. The unrolled straight-line forms (one (k,)-row FMA per step) give XLA
   one small fusion instead of a library call or a While loop between the
   Gram psum and the panel-scaling GEMM.

For k > UNROLL_MAX the jnp/lax primitives are used unchanged (their
O(k³) work then amortizes the loop overhead).
"""
from __future__ import annotations

import jax.numpy as jnp
from jax import lax

# Above this size XLA's own Cholesky + triangular solve win: inside
# CholQR2 on a 2M-row panel on an H100 (700 W) the unrolled forms took 0.70 /
# 0.85 / 1.91 ms at k = 8 / 16 / 32 and the library calls 0.78 / 0.88 /
# 1.60 ms (scripts/kernel_baselines.py).
UNROLL_MAX = 16


def chol_small(g: jnp.ndarray) -> jnp.ndarray:
    """Lower Cholesky factor of a small SPD matrix (unrolled k ≤ 16).

    Same contract as ``jnp.linalg.cholesky`` (no SPD floor added here —
    callers keep their own regularization). Column-wise
    Cholesky–Banachiewicz: step j is one (k,k)@(k,) FMA + rsqrt.
    """
    k = g.shape[0]
    if k > UNROLL_MAX:
        return jnp.linalg.cholesky(g)
    l = jnp.zeros_like(g)
    rows = jnp.arange(k)
    for j in range(k):
        # s[i] = g[i,j] - Σ_{p<j} l[i,p]·l[j,p]  (columns ≥ j still zero)
        s = g[:, j] - l @ l[j, :]
        col = s * lax.rsqrt(s[j])
        l = l.at[:, j].set(jnp.where(rows >= j, col, 0.0))
    return l


def tri_inv_small(r: jnp.ndarray, *, lower: bool = False) -> jnp.ndarray:
    """Inverse of a small triangular matrix (unrolled k ≤ 16).

    Row back-substitution on R·X = I: step i is one (k,)@(k,k) FMA.
    """
    k = r.shape[0]
    if k > UNROLL_MAX:
        return lax.linalg.triangular_solve(
            r, jnp.eye(k, dtype=r.dtype), left_side=True, lower=lower)
    eye = jnp.eye(k, dtype=r.dtype)
    x = jnp.zeros_like(r)
    order = range(k) if lower else reversed(range(k))
    for i in order:
        # R[i,i]·X[i,:] = e_i − Σ_{m≠i} R[i,m]·X[m,:]  (unset rows zero)
        x = x.at[i, :].set((eye[i] - r[i, :] @ x) / r[i, i])
    return x


def chol_inv_small(g: jnp.ndarray):
    """(L, L⁻¹) of a small SPD matrix. Callers wanting R = Lᵀ factors
    use ``rinv = linv.T``."""
    l = chol_small(g)
    return l, tri_inv_small(l, lower=True)


def chol_solve_small(g: jnp.ndarray, rhs: jnp.ndarray) -> jnp.ndarray:
    """g⁻¹ rhs for small SPD g via the factor inverse (no floor added)."""
    _, linv = chol_inv_small(g)
    return linv.T @ (linv @ rhs)
