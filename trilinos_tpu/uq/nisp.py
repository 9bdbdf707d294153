"""Non-intrusive spectral projection (NISP) + PCE sampling statistics.

Reference: Stokhos' pseudospectral layer
(Stokhos_PseudoSpectralOperator.hpp, Stokhos_QuadraturePseudoSpectral*):
run the deterministic model at quadrature points, project the outputs
onto the PC basis.

Device mapping: the model runs over the quadrature ensemble via ``jax.vmap``
(the reference's "ensemble propagation" from stokhos/src/sacado — a
vectorized scalar type; vmap IS that transformation in JAX), then the
projection is one (Q,P) GEMM.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .pce import PCE, QuadExpansion


def nisp_project(fn, expansion: QuadExpansion, vectorized: bool = False):
    """PCE of ``fn(xi)`` (xi: (d,) germ sample -> scalar or array).

    ``vectorized=True`` means fn already maps (Q, d) -> (Q, ...);
    otherwise it is vmapped over the quadrature points.
    """
    pts = jnp.asarray(expansion.quad.points)
    vals = fn(pts) if vectorized else jax.vmap(fn)(pts)  # (Q, ...)
    coeffs = jnp.einsum("q...,q,qk->...k", vals, expansion.w, expansion.psi, precision="highest")
    return PCE(coeffs, expansion)


def sample_pce(pce: PCE, samples: np.ndarray) -> jnp.ndarray:
    """Realizations of the PCE at germ samples (S, d)."""
    return pce.eval(samples)


def pce_mean(pce: PCE):
    return pce.mean()


def pce_variance(pce: PCE):
    return pce.variance()


def pce_std(pce: PCE):
    return pce.std()
