"""Hiptmair two-space (hybrid) smoother/preconditioner.

JAX analogue of Ifpack2::Hiptmair
(packages/ifpack2/src/Ifpack2_Hiptmair_decl.hpp): for curl-curl (Maxwell /
eddy-current) systems A = C'C + sigma*M on EDGE unknowns, point smoothers
stall on the huge near-null gradient space of C'C. Hiptmair interleaves
  1. a point smoother sweep on the edge space,
  2. a correction solved in the auxiliary NODE space: project the
     residual through the discrete gradient D (edges x nodes), smooth on
     A_aux = D' A D, prolongate back,
  3. another edge-space sweep (symmetrized -> usable with CG).

All three stages are damped-Jacobi sweeps on device formats, so the whole
apply is one fused XLA computation.
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..ops.formats import CsrHost, choose_format, round_up, ROW_ALIGN
from ..ops.matvec import spmv
from ..utils.params import Param
from .base import Preconditioner

_SPECS = {
    "hiptmair: smoother sweeps": Param("hiptmair: smoother sweeps", 2),
    "hiptmair: damping factor": Param("hiptmair: damping factor", 0.8),
    # sub-preconditioner for the auxiliary (node) space — any factory
    # name; the reference's default is Chebyshev, and AMG on the node
    # space gives the RefMaxwell-strength variant
    "hiptmair: aux preconditioner": Param("hiptmair: aux preconditioner",
                                          "CHEBYSHEV"),
    "hiptmair: aux parameters": Param("hiptmair: aux parameters", None),
    "dtype": Param("dtype", None),
}


class Hiptmair(Preconditioner):
    """create('HIPTMAIR', a, params, aux_op=D) — ``a`` is the edge-space
    matrix (CsrHost); ``aux_op`` the discrete gradient D (CsrHost,
    n_edges x n_nodes). A_aux = D' A D is formed at compute()."""

    def __init__(self, a, params=None, aux_op: CsrHost | None = None):
        super().__init__(a, params)
        self.d_host = aux_op

    def _do_initialize(self) -> None:
        self.params.validate(_SPECS)
        if not isinstance(self.a, CsrHost):
            raise TypeError("Hiptmair expects a CsrHost edge matrix")
        if self.d_host is None:
            raise ValueError("Hiptmair needs aux_op=D (discrete gradient)")

    def _do_compute(self) -> None:
        from ..ops.matrix_ops import spgemm

        p = self.params
        dtype = p["dtype"] or self.a.vals.dtype
        d = self.d_host
        a_aux = spgemm(d.transpose(), spgemm(self.a, d))
        n_e = round_up(self.a.shape[0], ROW_ALIGN)
        n_n = round_up(a_aux.shape[0], ROW_ALIGN)
        self.a_dev = choose_format(self.a, dtype=dtype)
        self.aux_dev = choose_format(a_aux, dtype=dtype)
        from ..precond.amg import _pack_rect

        self.d_dev = _pack_rect(d, dtype, n_e, n_n)
        self.dt_dev = _pack_rect(d.transpose(), dtype, n_n, n_e)

        def dinv_of(m, npad):
            dg = m.diagonal().astype(np.float64)
            v = np.ones(npad)
            v[: len(dg)] = 1.0 / np.where(dg != 0, dg, 1.0)
            return jnp.asarray(v, dtype=dtype)

        self.dinv_e = dinv_of(self.a, n_e)
        self.sweeps = int(p["hiptmair: smoother sweeps"])
        self.omega = float(p["hiptmair: damping factor"])
        from .base import create as _create

        aux_name = str(p["hiptmair: aux preconditioner"])
        self.aux_prec = _create(aux_name, a_aux,
                                p["hiptmair: aux parameters"]).compute()

    def _smooth(self, mat, dinv, x, b):
        di = dinv if b.ndim == 1 else dinv[:, None]
        for _ in range(self.sweeps):
            x = x + self.omega * di * (b - spmv(mat, x))
        return x

    def _apply(self, r: jax.Array) -> jax.Array:
        x = self._smooth(self.a_dev, self.dinv_e,
                         jnp.zeros_like(r), r)  # edge pre-smooth
        res = r - spmv(self.a_dev, x)
        r_n = spmv(self.dt_dev, res)  # project to node space
        e_n = self.aux_prec.apply(r_n)  # auxiliary-space correction
        x = x + spmv(self.d_dev, e_n)  # prolongate correction
        return self._smooth(self.a_dev, self.dinv_e, x, r)  # post-smooth
