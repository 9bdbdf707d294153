"""Additive Schwarz domain-decomposition preconditioner.

JAX analogue of Ifpack2::AdditiveSchwarz
(packages/ifpack2/src/Ifpack2_AdditiveSchwarz_decl.hpp — overlapping
subdomains built via Import in Ifpack2_OverlappingRowMatrix_decl.hpp,
an inner solver per subdomain, combine-mode options).

Accelerator-first shape: subdomains are padded to one uniform size and their
factorized inverses are applied as ONE batched dense matmul
(the DenseContainer strategy of BlockRelaxation, scaled up) — instead of
per-subdomain sparse solves. Overlap is built on host by distance-1 graph
expansion (`overlap` rounds). Combine modes: 'add' (classic AS) and
'restricted' (RAS — each row taken from its owning subdomain only, the
usual default for convergence).
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..ops.formats import CsrHost, round_up, ROW_ALIGN
from ..utils.params import Param
from .base import Preconditioner

_SPECS = {
    "schwarz: num subdomains": Param("schwarz: num subdomains", 4),
    "schwarz: overlap level": Param("schwarz: overlap level", 1),
    "schwarz: combine mode": Param("schwarz: combine mode", "restricted",
                                   choices=("add", "restricted")),
    "schwarz: subdomain ids": Param(
        "schwarz: subdomain ids", None,
        doc="optional length-n part array from parallel.partition; "
            "default is contiguous chunks"),
    "dtype": Param("dtype", None),
}


class AdditiveSchwarz(Preconditioner):
    def _do_initialize(self) -> None:
        self.params.validate(_SPECS)
        if not isinstance(self.a, CsrHost):
            raise TypeError("AdditiveSchwarz expects a CsrHost matrix")

    def _do_compute(self) -> None:
        p = self.params
        nd = int(p["schwarz: num subdomains"])
        overlap = int(p["schwarz: overlap level"])
        dtype = p["dtype"] or self.a.vals.dtype
        n = self.a.shape[0]
        subsets = []
        if p["schwarz: subdomain ids"] is not None:
            owners = np.asarray(p["schwarz: subdomain ids"], dtype=np.int64)
            if owners.shape != (n,) or owners.max() >= nd:
                raise ValueError("subdomain ids must be length n with "
                                 "ids < num subdomains")
        else:
            chunk = -(-n // nd)
            owners = np.minimum(np.arange(n) // chunk, nd - 1)
        for d in range(nd):
            sel = np.where(owners == d)[0]
            cur = set(sel.tolist())
            for _ in range(overlap):
                grow = set()
                for i in list(cur):
                    cols, _ = self.a.row(i)
                    grow.update(int(c) for c in cols)
                cur |= grow
            subsets.append(np.array(sorted(cur), dtype=np.int64))
        smax = round_up(max(len(s) for s in subsets), 8)
        inv = np.zeros((nd, smax, smax))
        gather = np.zeros((nd, smax), dtype=np.int64)
        weight = np.zeros((nd, smax))
        for d, sub in enumerate(subsets):
            k = len(sub)
            loc = np.eye(smax)
            index = {int(g): j for j, g in enumerate(sub)}
            for j, i in enumerate(sub):
                cols, vals = self.a.row(int(i))
                loc[j, :k] = 0
                for c, v in zip(cols, vals):
                    jj = index.get(int(c))
                    if jj is not None:
                        loc[j, jj] = v
                if loc[j, j] == 0:
                    loc[j, j] = 1.0
            inv[d] = np.linalg.inv(loc)
            gather[d, :k] = sub
            if p["schwarz: combine mode"] == "restricted":
                weight[d, :k] = (owners[sub] == d).astype(float)
            else:
                weight[d, :k] = 1.0
        self.n = n
        self.inv = jnp.asarray(inv, dtype=dtype)
        self.gather = jnp.asarray(gather)
        self.weight = jnp.asarray(weight, dtype=dtype)
        self.npad = round_up(n, ROW_ALIGN)

    def _apply(self, r: jax.Array) -> jax.Array:
        was_1d = r.ndim == 1
        r2 = r[:, None] if was_1d else r
        # gather local RHS per subdomain: (nd, smax, k)
        local = r2.at[self.gather].get(mode="promise_in_bounds")
        sol = jnp.einsum("dij,djk->dik", self.inv,
                         local.astype(self.inv.dtype),
                         preferred_element_type=self.inv.dtype)
        sol = sol * self.weight[:, :, None]
        y = jnp.zeros_like(r2)
        y = y.at[self.gather.reshape(-1)].add(
            sol.reshape(-1, r2.shape[1]), mode="promise_in_bounds")
        return y[:, 0] if was_1d else y
