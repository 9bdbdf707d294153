"""Block relaxation with pluggable containers (Dense / TriDi / Banded).

JAX analogue of Ifpack2::BlockRelaxation + the Container family
(packages/ifpack2/src/Ifpack2_BlockRelaxation_decl.hpp,
Ifpack2_Container_decl.hpp, Ifpack2_TriDiContainer_decl.hpp,
Ifpack2_BandedContainer_decl.hpp; partition via LinearPartitioner,
Ifpack2_LinearPartitioner_decl.hpp).

Container semantics (matching the reference): each diagonal block of A is
APPROXIMATED by the container's structure —
  * Dense  — the full block, inverted (LAPACK getri analogue);
  * TriDi  — only the in-block tridiagonal entries; solved on device with
    a batched ``lax.linalg.tridiagonal_solve`` (O(block) work — the right
    container for line smoothing);
  * Banded — in-block entries within ``bandwidth``; factor stored as the
    dense inverse of the banded approximation (the apply is a batched
    GEMM like Dense — on the accelerator that IS the fast path for the small
    blocks the reference's banded LAPACK solve targets).

Apply = damped block-Jacobi sweeps x += omega * C^-1 (r - A x), one fused
XLA computation per sweep.
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.formats import CsrHost, choose_format, round_up, ROW_ALIGN
from ..ops.matvec import spmv
from ..utils.params import Param
from .base import Preconditioner

_SPECS = {
    "relaxation: container": Param("relaxation: container", "Dense",
                                   choices=("Dense", "TriDi", "Banded",
                                            "SparseILU0", "Database")),
    "partitioner: block size": Param("partitioner: block size", 4),
    "relaxation: sweeps": Param("relaxation: sweeps", 1),
    "relaxation: damping factor": Param("relaxation: damping factor", 1.0),
    "banded: bandwidth": Param("banded: bandwidth", 1),
    "database schwarz: patch tolerance": Param(
        "database schwarz: patch tolerance", 1e-12,
        doc="blocks equal entrywise within this tol share one inverse"),
    "dtype": Param("dtype", None),
}


class BlockRelaxation(Preconditioner):
    def _do_initialize(self) -> None:
        self.params.validate(_SPECS)
        if not isinstance(self.a, CsrHost):
            raise TypeError("BlockRelaxation expects a CsrHost matrix")

    def _do_compute(self) -> None:
        p = self.params
        dtype = p["dtype"] or self.a.vals.dtype
        bs = int(p["partitioner: block size"])
        container = str(p["relaxation: container"])
        kb = int(p["banded: bandwidth"])
        n = self.a.shape[0]
        nb = -(-n // bs)
        npad = round_up(nb * bs, ROW_ALIGN)
        nb_pad = npad // bs
        self.block_size = bs
        self.n_pad = nb_pad * bs
        self.container = container
        self.sweeps = int(p["relaxation: sweeps"])
        self.omega = float(p["relaxation: damping factor"])
        self.a_dev = choose_format(self.a, dtype=dtype)

        if container == "SparseILU0":
            # Ifpack2 SparseContainer analogue (recursive preconditioner
            # per block, Ifpack2_SparseContainer_decl.hpp): ILU(0) of the
            # block-diagonal filter — the fill pattern stays inside the
            # blocks, so one factorization covers all containers
            from .ilu import Ilu0

            rows = np.repeat(np.arange(n, dtype=np.int64),
                             self.a.row_lengths())
            cols_g = self.a.cols.astype(np.int64)
            keep = rows // bs == cols_g // bs
            filt = CsrHost.from_coo(rows[keep], cols_g[keep],
                                    self.a.vals[keep], self.a.shape)
            self.inner = Ilu0(filt, {"dtype": dtype}).compute()
            return

        # extract per-block structures (LinearPartitioner blocks)
        dense = np.tile(np.eye(bs, dtype=np.float64), (nb_pad, 1, 1))
        for ib in range(nb):
            lo, hi = ib * bs, min((ib + 1) * bs, n)
            blk = np.eye(bs)
            for li, i in enumerate(range(lo, hi)):
                cols, vals = self.a.row(i)
                sel = (cols >= lo) & (cols < hi)
                blk[li, :] = 0
                blk[li, cols[sel] - lo] = vals[sel]
                if blk[li, li] == 0:
                    blk[li, li] = 1.0
            dense[ib] = blk
        if container == "TriDi":
            d = np.einsum("bii->bi", dense).copy()
            dl = np.zeros((nb_pad, bs))
            du = np.zeros((nb_pad, bs))
            dl[:, 1:] = np.einsum("bii->bi", dense[:, 1:, :-1])
            du[:, :-1] = np.einsum("bii->bi", dense[:, :-1, 1:])
            self.tridi = tuple(jnp.asarray(v, dtype=dtype)
                               for v in (dl, d, du))
        elif container == "Database":
            # Ifpack2::DatabaseSchwarz analogue
            # (Ifpack2_DatabaseSchwarz_decl.hpp): on structured meshes
            # most diagonal patches are IDENTICAL — detect duplicates
            # within the patch tolerance and invert each unique patch
            # once. Apply gathers the shared inverses (XLA fuses the
            # gather into the batched-matmul operand read).
            ptol = float(p["database schwarz: patch tolerance"])
            q = np.round(dense / max(ptol, 1e-300)).astype(np.int64)
            _, first, idx = np.unique(
                q.reshape(nb_pad, -1), axis=0, return_index=True,
                return_inverse=True)
            uniq = dense[first]
            inv_u = np.empty_like(uniq)
            for ib in range(len(first)):
                blk = uniq[ib]
                if abs(np.linalg.det(blk)) < 1e-300:
                    blk = np.diag(np.where(np.diag(blk) != 0,
                                           np.diag(blk), 1.0))
                inv_u[ib] = np.linalg.inv(blk)
            self.n_patches = len(first)
            self.inv_unique = jnp.asarray(inv_u, dtype=dtype)
            self.patch_idx = jnp.asarray(idx.reshape(-1), dtype=jnp.int32)
        else:
            if container == "Banded":
                i_idx = np.arange(bs)
                mask = np.abs(i_idx[:, None] - i_idx[None, :]) <= kb
                dense = np.where(mask[None], dense, 0.0)
                # keep diagonal nonzero
                dg = np.einsum("bii->bi", dense)
                np.einsum("bii->bi", dense)[...] = np.where(dg != 0, dg, 1)
            inv = np.empty_like(dense)
            for ib in range(nb_pad):
                blk = dense[ib]
                if abs(np.linalg.det(blk)) < 1e-300:
                    blk = np.diag(np.where(np.diag(blk) != 0,
                                           np.diag(blk), 1.0))
                inv[ib] = np.linalg.inv(blk)
            self.inv_blocks = jnp.asarray(inv, dtype=dtype)

    def _container_solve(self, r2: jax.Array) -> jax.Array:
        """(npad_in, k) -> (npad_in, k): batched per-block solves."""
        if self.container == "SparseILU0":
            return self.inner.apply(r2)
        bs = self.block_size
        npad_in = r2.shape[0]
        x2 = r2
        if npad_in < self.n_pad:
            x2 = jnp.pad(x2, ((0, self.n_pad - npad_in), (0, 0)))
        xb = x2[: self.n_pad].reshape(-1, bs, x2.shape[1])
        if self.container == "TriDi":
            dl, d, du = self.tridi
            yb = jax.vmap(lax.linalg.tridiagonal_solve)(
                dl, d, du, xb.astype(d.dtype))
        elif self.container == "Database":
            inv = self.inv_unique.at[self.patch_idx].get(
                mode="promise_in_bounds")
            yb = jnp.einsum("bij,bjk->bik", inv,
                            xb.astype(inv.dtype),
                            preferred_element_type=inv.dtype)
        else:
            yb = jnp.einsum("bij,bjk->bik", self.inv_blocks,
                            xb.astype(self.inv_blocks.dtype),
                            preferred_element_type=self.inv_blocks.dtype)
        y = yb.reshape(-1, x2.shape[1])
        if y.shape[0] < npad_in:
            y = jnp.pad(y, ((0, npad_in - y.shape[0]), (0, 0)))
        return y[:npad_in]

    def _apply(self, r: jax.Array) -> jax.Array:
        was_1d = r.ndim == 1
        r2 = r[:, None] if was_1d else r
        x = self.omega * self._container_solve(r2)
        for _ in range(self.sweeps - 1):
            res = r2 - spmv(self.a_dev, x[:, 0])[:, None] if was_1d \
                else r2 - spmv(self.a_dev, x)
            x = x + self.omega * self._container_solve(res)
        return x[:, 0] if was_1d else x
