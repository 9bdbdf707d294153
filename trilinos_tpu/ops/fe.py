"""Finite-element assembly helpers.

JAX analogue of Tpetra's FE assembly variants
(packages/tpetra/core/src/Tpetra_FECrsMatrix_decl.hpp:224-230,
Tpetra_FEMultiVector_decl.hpp — overlapping ownership with beginFill/
endFill phases that Export-sum shared contributions).

On the device the whole element loop is one vectorized scatter: element matrices
(ne, k, k) with connectivity (ne, k) expand to COO triples and sum —
``CsrHost.from_coo``'s ADD combine IS the endFill Export-sum. The
device-side incremental variant (``fe_apply_local``) assembles matrix-free:
y = Σ_e P_eᵀ (K_e (P_e x)) as gather → batched matmul → scatter-add,
useful when the mesh changes every step.
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from .formats import CsrHost


def fe_assemble(connect: np.ndarray, elem_mats: np.ndarray,
                n_dofs: int) -> CsrHost:
    """Assemble element matrices into a global CSR.

    connect: (ne, k) global dof ids per element
    elem_mats: (ne, k, k) element stiffness matrices
    """
    connect = np.asarray(connect, dtype=np.int64)
    elem_mats = np.asarray(elem_mats)
    ne, k = connect.shape
    rows = np.repeat(connect, k, axis=1).reshape(-1)  # (ne*k*k,)
    cols = np.tile(connect, (1, k)).reshape(-1)
    vals = elem_mats.reshape(-1)
    return CsrHost.from_coo(rows, cols, vals, (n_dofs, n_dofs),
                            sum_duplicates=True)


def fe_assemble_vector(connect: np.ndarray, elem_vecs: np.ndarray,
                       n_dofs: int) -> np.ndarray:
    """Assemble element load vectors (ne, k) → global (n_dofs,)
    (FEMultiVector endFill ADD-combine analogue)."""
    out = np.zeros(n_dofs, dtype=np.asarray(elem_vecs).dtype)
    np.add.at(out, np.asarray(connect, dtype=np.int64).reshape(-1),
              np.asarray(elem_vecs).reshape(-1))
    return out


def fe_apply_local(connect: jax.Array, elem_mats: jax.Array,
                   x: jax.Array) -> jax.Array:
    """Matrix-free FE operator apply: y = Σ_e P_eᵀ K_e P_e x.

    Gather dof values per element, batched k×k matmuls, scatter-add
    back — assembly-free, ideal when K_e changes every step.
    """
    was_1d = x.ndim == 1
    x2 = x[:, None] if was_1d else x
    gathered = x2.at[connect].get(mode="promise_in_bounds")  # (ne, k, m)
    local = jnp.einsum("eij,ejm->eim", elem_mats,
                       gathered.astype(elem_mats.dtype),
                       preferred_element_type=elem_mats.dtype)
    y = jnp.zeros_like(x2)
    y = y.at[connect.reshape(-1)].add(
        local.reshape(-1, x2.shape[1]), mode="promise_in_bounds")
    return y[:, 0] if was_1d else y
