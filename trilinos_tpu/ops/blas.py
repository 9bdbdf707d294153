"""Dense vector/multivector kernels (local part).

JAX analogue of KokkosBlas1/3 free functions
(reference: packages/kokkos-kernels/src/blas/KokkosBlas1_axpby.hpp,
KokkosBlas1_dot.hpp, KokkosBlas3_gemm.hpp) plus the Belos MultiVecTraits
block operations (packages/belos/src/BelosMultiVecTraits.hpp:138-332):
``mv_trans_mv`` is MvTransMv (the block inner product whose global part is
one psum), ``mv_times_mat_add_mv`` is the rank-k Krylov basis update.

All functions are local: callers in the distributed layer follow the
reduction-producing ones (`dot`, `norm2`, `mv_trans_mv`) with a psum over
the row-shard axis — mirroring the reference's lclDot + reduceAll split
(packages/tpetra/core/src/Tpetra_MultiVector_def.hpp:1845-1929).

Multivectors are (n_rows_pad, nrhs) arrays; padding rows must stay zero,
which every op here preserves.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

# Solver-grade GEMM precision. On the GPU an f32 matmul at DEFAULT
# precision may run on the tensor cores in TF32 (10-bit mantissa, ~1e-3
# relative error per contraction). Correctness-critical reductions
# (CG/GMRES dots, CholQR Grams, Rayleigh-Ritz projections, dense coarse
# solves) must not run at that precision in an f32 solver, so HIGHEST —
# full f32 (and full f64 under x64) — is pinned here. The cost on the GPU
# is the f32 instead of the TF32 tensor-core rate for these products;
# they are narrow (k ≤ a few dozen columns) and memory-bound, so the
# cost is expected to be small (not measured yet; docs/PRECISION.md).
# TT_GEMM_PRECISION=default reverts to the backend default (A/B lever;
# also disables the hi_precision driver decorator in solvers/base.py);
# TT_GEMM_PRECISION=high is the middle setting.
import os as _os

_PRECS = {"default": None, "high": jax.lax.Precision.HIGH,
          "highest": jax.lax.Precision.HIGHEST}
_MODE = _os.environ.get("TT_GEMM_PRECISION", "highest").lower()
if _MODE not in _PRECS:
    raise ValueError(
        f"TT_GEMM_PRECISION={_MODE!r}: expected one of {sorted(_PRECS)}")
HI = _PRECS[_MODE]


def axpby(alpha, x: jax.Array, beta, y: jax.Array) -> jax.Array:
    """alpha*x + beta*y (KokkosBlas1::axpby)."""
    return alpha * x + beta * y


def update(alpha, x, beta, y, gamma, z):
    """alpha*x + beta*y + gamma*z (Tpetra::MultiVector::update 3-arg form)."""
    return alpha * x + beta * y + gamma * z


def scale(alpha, x: jax.Array) -> jax.Array:
    return alpha * x


def local_dot(x: jax.Array, y: jax.Array) -> jax.Array:
    """Columnwise dot of two (n, k) multivectors → (k,) (local part)."""
    if x.ndim == 1:
        return jnp.vdot(x, y, precision=HI)
    return jnp.einsum("nk,nk->k", x, y, precision=HI)


def local_norm2_sq(x: jax.Array) -> jax.Array:
    return local_dot(x, x)


def mv_trans_mv(a: jax.Array, b: jax.Array, alpha=1.0) -> jax.Array:
    """C = alpha * aᵀ b for (n, ka), (n, kb) → (ka, kb). The Krylov block
    inner product: one GEMM locally, one psum globally."""
    c = jnp.einsum("nk,nm->km", a, b, preferred_element_type=a.dtype,
                   precision=HI)
    return alpha * c


def mv_times_mat_add_mv(alpha, a: jax.Array, b_small: jax.Array,
                        beta, c: jax.Array) -> jax.Array:
    """C = alpha * A @ B + beta * C — the MvTimesMatAddMv rank-k update
    (A is (n, ka), B a small replicated (ka, kc) host-ish matrix)."""
    prod = jnp.einsum("nk,km->nm", a, b_small.astype(a.dtype),
                      preferred_element_type=a.dtype, precision=HI)
    if isinstance(beta, (int, float)) and beta == 0:
        return alpha * prod
    return alpha * prod + beta * c


def set_block(src: jax.Array, dst: jax.Array, cols: tuple[int, ...]) -> jax.Array:
    """Write src's columns into dst at static column positions (SetBlock)."""
    return dst.at[:, jnp.array(cols)].set(src)


def mv_random(key, n: int, k: int, dtype=jnp.float32, n_valid: int | None = None):
    """MvRandom: random multivector with zeroed padding rows."""
    x = jax.random.normal(key, (n, k), dtype=dtype)
    if n_valid is not None and n_valid < n:
        mask = (jnp.arange(n) < n_valid)[:, None]
        x = jnp.where(mask, x, 0)
    return x
