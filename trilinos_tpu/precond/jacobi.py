"""Point relaxation (Jacobi family) and block-Jacobi preconditioners.

JAX analogue of Ifpack2::Relaxation
(packages/ifpack2/src/Ifpack2_Relaxation_decl.hpp:92-124 — "relaxation:
type"/"sweeps"/"damping factor" parameters; ApplyInverseJacobi
Ifpack2_Relaxation_def.hpp:1390) and of Ifpack2::BlockRelaxation with
DenseContainer (packages/ifpack2/src/Ifpack2_BlockRelaxation_decl.hpp,
Ifpack2_Container_decl.hpp — dense per-block LAPACK solves).

Design notes:
  * multi-sweep Jacobi needs the operator; it packs the matrix via
    ``choose_format`` at compute() unless an operator is supplied.
  * Gauss-Seidel is intentionally NOT point-sequential here: the accelerator
    equivalent (multicolor GS over stencil colorings) lands with the
    coloring module; Jacobi/Chebyshev are the first-class accelerator smoothers.
  * BlockJacobi inverts the dense diagonal blocks on host at compute()
    (the DenseContainer LAPACK step) and applies them as one batched
    (nb, bs, bs) × (nb, bs, k) batched matmul.
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..ops.formats import CsrHost, choose_format, round_up, ROW_ALIGN
from ..ops.matvec import spmv
from ..utils.params import Param
from .base import Preconditioner

_RELAX_SPECS = {
    "relaxation: type": Param("relaxation: type", "Jacobi",
                              choices=("Jacobi", "l1 Jacobi")),
    "relaxation: sweeps": Param("relaxation: sweeps", 1),
    "relaxation: damping factor": Param("relaxation: damping factor", 1.0),
    "relaxation: l1 eta": Param("relaxation: l1 eta", 1.5),
    "dtype": Param("dtype", None),
}


class Relaxation(Preconditioner):
    """Damped (l1-)Jacobi: apply ≈ sweeps of y ← y + ω D⁻¹ (x − A y)."""

    def _do_initialize(self) -> None:
        self.params.validate(_RELAX_SPECS)
        if not isinstance(self.a, CsrHost):
            raise TypeError("Relaxation expects a CsrHost matrix")

    def _do_compute(self) -> None:
        p = self.params
        dtype = p["dtype"] or self.a.vals.dtype
        n = self.a.shape[0]
        npad = round_up(n, ROW_ALIGN)
        d = self.a.diagonal().astype(np.float64)
        if p["relaxation: type"] == "l1 Jacobi":
            # l1 variant: add η · (off-process/off-diag absolute row sums)
            # (Ifpack2_Relaxation l1 option; serial: all off-diag mass)
            lens = self.a.row_lengths()
            rows = np.repeat(np.arange(n), lens)
            off = self.a.cols != rows
            abs_sum = np.zeros(n)
            np.add.at(abs_sum, rows[off], np.abs(self.a.vals[off]))
            d = d + p["relaxation: l1 eta"] * abs_sum
        dinv = np.ones(npad)
        with np.errstate(divide="ignore"):
            safe = np.where(d != 0, d, 1.0)
        dinv[:n] = 1.0 / safe
        self.dinv = jnp.asarray(dinv, dtype=dtype)
        self.omega = float(p["relaxation: damping factor"])
        self.sweeps = int(p["relaxation: sweeps"])
        if self.sweeps > 1:
            self._dev = choose_format(self.a, dtype=dtype)
        else:
            self._dev = None

    def _apply(self, x: jax.Array) -> jax.Array:
        dinv = self.dinv if x.ndim == 1 else self.dinv[:, None]
        y = self.omega * dinv * x
        for _ in range(self.sweeps - 1):
            r = x - spmv(self._dev, y)
            y = y + self.omega * dinv * r
        return y


_BJ_SPECS = {
    "partitioner: block size": Param("partitioner: block size", 4),
    "dtype": Param("dtype", None),
}


class BlockJacobi(Preconditioner):
    """Non-overlapping block Jacobi with dense inverted diagonal blocks."""

    def _do_initialize(self) -> None:
        self.params.validate(_BJ_SPECS)

    def _do_compute(self) -> None:
        bs = int(self.params["partitioner: block size"])
        dtype = self.params["dtype"] or self.a.vals.dtype
        n = self.a.shape[0]
        nb = -(-n // bs)
        npad = round_up(nb * bs, ROW_ALIGN)
        nb_pad = npad // bs if npad % bs == 0 else -(-npad // bs)
        blocks = np.tile(np.eye(bs, dtype=np.float64), (nb_pad, 1, 1))
        for ib in range(nb):
            lo, hi = ib * bs, min((ib + 1) * bs, n)
            blk = np.eye(bs)
            for local_i, i in enumerate(range(lo, hi)):
                cols, vals = self.a.row(i)
                sel = (cols >= lo) & (cols < hi)
                blk[local_i, :] = 0
                blk[local_i, cols[sel] - lo] = vals[sel]
                if not (cols[sel] == i).any():
                    blk[local_i, local_i] += 0.0
            # singular guard: fall back to diagonal
            if abs(np.linalg.det(blk)) < 1e-300:
                blk = np.diag(np.where(np.diag(blk) != 0, np.diag(blk), 1.0))
            blocks[ib] = np.linalg.inv(blk)
        self.block_size = bs
        self.n_pad = nb_pad * bs
        self.inv_blocks = jnp.asarray(blocks, dtype=dtype)

    def _apply(self, x: jax.Array) -> jax.Array:
        bs = self.block_size
        was_1d = x.ndim == 1
        x2 = x[:, None] if was_1d else x
        npad_in = x2.shape[0]
        if npad_in < self.n_pad:
            x2 = jnp.pad(x2, ((0, self.n_pad - npad_in), (0, 0)))
        xb = x2[: self.n_pad].reshape(-1, bs, x2.shape[1])
        yb = jnp.einsum("bij,bjk->bik", self.inv_blocks,
                        xb.astype(self.inv_blocks.dtype),
                        preferred_element_type=self.inv_blocks.dtype)
        y = yb.reshape(-1, x2.shape[1])[:npad_in]
        if y.shape[0] < npad_in:
            y = jnp.pad(y, ((0, npad_in - y.shape[0]), (0, 0)))
        return y[:, 0] if was_1d else y
