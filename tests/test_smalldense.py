"""Unrolled small-dense kernels vs the jnp/lax reference lowerings.

These straight-line forms replace tiny While-loop factorizations on the
solver hot paths (ops/smalldense.py); reference role: the in-manager
Teuchos::LAPACK small-dense calls (Teuchos_LAPACK.hpp:96).
"""
import numpy as np
import pytest

import jax.numpy as jnp
from jax import lax

from trilinos_tpu.ops.smalldense import (chol_small, chol_solve_small,
                                         tri_inv_small)


@pytest.mark.parametrize("k", [1, 2, 3, 8, 17, 32])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_chol_small_matches_jnp(k, dtype, rng):
    a = rng.standard_normal((k, k)).astype(dtype)
    g = a @ a.T + k * np.eye(k, dtype=dtype)
    l = np.asarray(chol_small(jnp.asarray(g)))
    ref = np.linalg.cholesky(g)
    tol = 1e-5 if dtype == np.float32 else 1e-12
    assert np.allclose(l, ref, rtol=tol, atol=tol * np.abs(ref).max())
    assert np.allclose(np.triu(l, 1), 0.0)


@pytest.mark.parametrize("k", [1, 2, 8, 32])
@pytest.mark.parametrize("lower", [False, True])
def test_tri_inv_small(k, lower, rng):
    a = rng.standard_normal((k, k)) + 3 * np.eye(k)
    r = np.tril(a) if lower else np.triu(a)
    inv = np.asarray(tri_inv_small(jnp.asarray(r), lower=lower))
    assert np.allclose(inv @ r, np.eye(k), atol=1e-10)
    # inverse of a triangular matrix stays triangular (unset rows zero)
    assert np.allclose(np.tril(inv, -1) if not lower else np.triu(inv, 1), 0)


def test_chol_solve_small(rng):
    k = 8
    a = rng.standard_normal((k, k))
    g = a @ a.T + k * np.eye(k)
    rhs = rng.standard_normal((k, 3))
    x = np.asarray(chol_solve_small(jnp.asarray(g), jnp.asarray(rhs)))
    assert np.allclose(g @ x, rhs, atol=1e-9)


@pytest.mark.parametrize("k", range(1, 33))
def test_chol_inv_small(k, rng):
    """(L, L⁻¹) for every unrolled size k = 1…32, f32 against numpy."""
    from trilinos_tpu.ops.smalldense import chol_inv_small

    a = rng.standard_normal((k, k)).astype(np.float32)
    g = a @ a.T + k * np.eye(k, dtype=np.float32)
    l, linv = chol_inv_small(jnp.asarray(g))
    ref = np.linalg.cholesky(g.astype(np.float64))
    assert np.allclose(np.asarray(l), ref, rtol=1e-4,
                       atol=1e-4 * np.abs(ref).max())
    assert np.allclose(np.asarray(linv, np.float64) @ ref, np.eye(k),
                       atol=1e-4)


def test_fallback_above_unroll_max(rng):
    k = 40  # > UNROLL_MAX exercises the jnp/lax fallback path
    a = rng.standard_normal((k, k)).astype(np.float64)
    g = a @ a.T + k * np.eye(k)
    l = np.asarray(chol_small(jnp.asarray(g)))
    assert np.allclose(l, np.linalg.cholesky(g), atol=1e-9)
    r = np.triu(rng.standard_normal((k, k)) + 3 * np.eye(k))
    inv = np.asarray(tri_inv_small(jnp.asarray(r)))
    assert np.allclose(inv @ r, np.eye(k), atol=1e-9)
