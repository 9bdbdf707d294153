"""Direct-solver-as-preconditioner (Amesos2Wrapper).

JAX analogue of Ifpack2::Details::Amesos2Wrapper
(packages/ifpack2/src/Ifpack2_Details_Amesos2Wrapper_decl.hpp): wraps the
sparse direct factorization (solvers.direct.SparseLu — native
Gilbert-Peierls LU) as an Ifpack2-lifecycle preconditioner. The reference
uses this for exact subdomain/coarse solves; on the device the jittable apply is
a dense inverse assembled COLUMN-BY-COLUMN from the sparse factors (one
sparse solve per unit vector at compute() time), so the device apply is
one dense matmul — the right trade for the small systems this is for.
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..ops.formats import CsrHost, round_up, ROW_ALIGN
from ..utils.params import Param
from .base import Preconditioner

_SPECS = {
    "dtype": Param("dtype", None),
    # Amesos2 backend choice: "KLU2" = LU with partial pivoting (any
    # matrix); "TACHO"/"CHOLMOD" = LL^T (SPD only, half the fill/flops)
    "solver": Param("solver", "KLU2",
                    choices=("KLU2", "TACHO", "CHOLMOD")),
}


class DirectPrec(Preconditioner):
    def _do_initialize(self) -> None:
        self.params.validate(_SPECS)
        if not isinstance(self.a, CsrHost):
            raise TypeError("DirectPrec expects a CsrHost matrix")

    def _do_compute(self) -> None:
        from ..solvers.direct import SparseCholesky, SparseLu

        dtype = self.params["dtype"] or self.a.vals.dtype
        n = self.a.shape[0]
        npad = round_up(n, ROW_ALIGN)
        cls = (SparseCholesky if self.params["solver"] in
               ("TACHO", "CHOLMOD") else SparseLu)
        slu = cls(self.a).factor()
        inv = np.eye(npad)
        eye = np.eye(n)
        cols = slu.solve(eye)  # A^-1 (n solves against unit vectors)
        inv[:n, :n] = cols
        self.inv_dense = jnp.asarray(inv, dtype=dtype)

    def _apply(self, r: jax.Array) -> jax.Array:
        m = self.inv_dense.shape[0]
        npad_in = r.shape[0]
        if npad_in == m:
            return self.inv_dense @ r
        if npad_in > m:  # caller uses a larger pad: identity on the tail
            y = self.inv_dense @ r[:m]
            return jnp.concatenate([y, r[m:]], axis=0)
        rp = jnp.zeros((m,) + r.shape[1:], r.dtype).at[:npad_in].set(r)
        return (self.inv_dense @ rp)[:npad_in]
