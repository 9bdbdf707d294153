"""Two-level overlapping Schwarz with a GDSW-type coarse space.

JAX analogue of ShyLU-DD / FROSch
(packages/shylu/shylu_dd/frosch/ — `FROSch_TwoLevelPreconditioner`,
GDSW/RGDSW coarse spaces in FROSch_GDSWCoarseOperator /
FROSch_RGDSWCoarseOperator; the BDDC sibling lives in
packages/shylu/shylu_dd/bddc/). One-level overlapping Schwarz is not
numerically scalable — CG iterations grow with the number of subdomains;
the coarse level restores nd-independent convergence.

Design (RGDSW "Option 1" coarse space, accelerator-first apply):
  * first level  — the existing batched-RAS AdditiveSchwarz (one batched
    batched matmul over padded subdomain inverses);
  * coarse space — one basis function per subdomain: value on the
    interface = inverse multiplicity (partition of unity across the
    subdomains touching each interface row), harmonically extended into
    the subdomain interiors by solving A_II Phi_I = -A_IG Phi_G with the
    native sparse LU (interiors are decoupled, so one global factor of
    A_II covers every subdomain);
  * coarse solve — Phi (Phi^T A Phi)^-1 Phi^T as two skinny GEMMs plus a
    tiny dense solve, all fused by XLA on device;
  * coupling     — additive: M^-1 = Phi A0^-1 Phi^T + sum_d R_d^T A_d^-1 R_d.

The "constant" coarse option (Nicolaides / piecewise-constant vectors,
no extension solve) is kept for comparison and as the cheap fallback.
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..ops.formats import CsrHost, round_up, ROW_ALIGN
from ..utils.params import Param
from .base import Preconditioner
from .schwarz import AdditiveSchwarz

_SPECS = {
    "schwarz: num subdomains": Param("schwarz: num subdomains", 4),
    "schwarz: overlap level": Param("schwarz: overlap level", 1),
    "schwarz: combine mode": Param("schwarz: combine mode", "restricted",
                                   choices=("add", "restricted")),
    "coarse space: type": Param("coarse space: type", "rgdsw",
                                choices=("rgdsw", "constant")),
    "coarse space: coupling": Param(
        "coarse space: coupling", "hybrid", choices=("hybrid", "additive"),
        doc="hybrid = symmetric multiplicative M = C + (I-CA) M1 (I-AC) "
            "(FROSch's default, stronger); additive = M1 + C"),
    "schwarz: subdomain ids": Param(
        "schwarz: subdomain ids", None,
        doc="optional length-n part array from parallel.partition; "
            "default is contiguous chunks"),
    "dtype": Param("dtype", None),
}


def _submatrix(a: CsrHost, row_sel: np.ndarray, col_sel: np.ndarray,
               row_pos: np.ndarray, col_pos: np.ndarray) -> CsrHost:
    """A[row_sel, col_sel] as CsrHost, using precomputed global→local
    position maps (-1 = dropped)."""
    rows = np.repeat(np.arange(a.shape[0], dtype=np.int64),
                     a.row_lengths())
    cols = a.cols.astype(np.int64)
    keep = (row_pos[rows] >= 0) & (col_pos[cols] >= 0)
    return CsrHost.from_coo(row_pos[rows[keep]], col_pos[cols[keep]],
                            a.vals[keep],
                            (len(row_sel), len(col_sel)),
                            sum_duplicates=False)


class TwoLevelSchwarz(Preconditioner):
    def _do_initialize(self) -> None:
        self.params.validate(_SPECS)
        if not isinstance(self.a, CsrHost):
            raise TypeError("TwoLevelSchwarz expects a CsrHost matrix")

    def _do_compute(self) -> None:
        p = self.params
        nd = int(p["schwarz: num subdomains"])
        dtype = p["dtype"] or self.a.vals.dtype
        n = self.a.shape[0]

        # ---- first level: batched RAS over the same partition ----------
        self.level1 = AdditiveSchwarz(self.a, {
            "schwarz: num subdomains": nd,
            "schwarz: overlap level": int(p["schwarz: overlap level"]),
            "schwarz: combine mode": str(p["schwarz: combine mode"]),
            "schwarz: subdomain ids": p["schwarz: subdomain ids"],
            "dtype": dtype,
        }).compute()

        # ---- subdomain ownership (non-overlapping) ---------------------
        part = p["schwarz: subdomain ids"]
        if part is None:
            chunk = -(-n // nd)
            owners = np.minimum(np.arange(n) // chunk, nd - 1)
        else:
            owners = np.asarray(part, dtype=np.int64)
            if owners.shape != (n,) or owners.max() >= nd:
                raise ValueError("subdomain ids must be length n with "
                                 "ids < num subdomains")

        rows = np.repeat(np.arange(n, dtype=np.int64),
                         self.a.row_lengths())
        cols = self.a.cols.astype(np.int64)

        # subdomains adjacent to each row (itself + neighbors' owners)
        # interface = rows adjacent to more than one subdomain
        adj = np.zeros((n, nd), dtype=bool)
        adj[np.arange(n), owners] = True
        adj[rows, owners[cols]] = True
        multiplicity = adj.sum(axis=1)
        interface = multiplicity > 1

        phi = np.zeros((n, nd))
        gamma = np.where(interface)[0]
        phi[gamma] = adj[gamma] / multiplicity[gamma, None]

        if str(p["coarse space: type"]) == "constant":
            # Nicolaides: piecewise-constant on the whole subdomain
            phi = np.zeros((n, nd))
            phi[np.arange(n), owners] = 1.0
        else:
            # harmonic extension into interiors:  A_II phi_I = -A_IG phi_G
            from ..solvers.direct import SparseLu

            inter = np.where(~interface)[0]
            if len(inter) and len(gamma):
                pos_i = np.full(n, -1, dtype=np.int64)
                pos_i[inter] = np.arange(len(inter))
                pos_g = np.full(n, -1, dtype=np.int64)
                pos_g[gamma] = np.arange(len(gamma))
                a_ii = _submatrix(self.a, inter, inter, pos_i, pos_i)
                a_ig = _submatrix(self.a, inter, gamma, pos_i, pos_g)
                rhs = np.zeros((len(inter), nd))
                r2 = np.repeat(np.arange(len(inter), dtype=np.int64),
                               a_ig.row_lengths())
                np.subtract.at(rhs, r2,
                               a_ig.vals[:, None]
                               * phi[gamma][a_ig.cols.astype(np.int64)])
                phi[inter] = SparseLu(a_ii).factor().solve(rhs)

        # ---- coarse operator A0 = Phi^T A Phi (host, exact) ------------
        a_phi = np.zeros((n, nd))
        np.add.at(a_phi, rows, self.a.vals[:, None] * phi[cols])
        a0 = phi.T @ a_phi
        # guard: a singular coarse block (empty subdomain) gets identity
        for d in range(nd):
            if abs(a0[d, d]) < 1e-300:
                a0[d, d] = 1.0
        self.npad = round_up(n, ROW_ALIGN)
        phi_pad = np.zeros((self.npad, nd))
        phi_pad[:n] = phi
        self.phi = jnp.asarray(phi_pad, dtype=dtype)
        a0i = np.linalg.inv(a0)
        # exact symmetry matters: CG needs C = Phi A0^-1 Phi^T symmetric
        self.a0_inv = jnp.asarray((a0i + a0i.T) / 2, dtype=dtype)
        self.coarse_dim = nd
        self.coupling = str(p["coarse space: coupling"])
        if self.coupling == "hybrid":
            from ..ops.formats import choose_format

            self.a_dev = choose_format(self.a, dtype=dtype)

    def _coarse(self, r2: jax.Array) -> jax.Array:
        """C r = Phi A0^-1 Phi^T r (two skinny GEMMs + tiny solve)."""
        rpad = r2
        if r2.shape[0] < self.npad:
            rpad = jnp.pad(r2, ((0, self.npad - r2.shape[0]), (0, 0)))
        rc = self.phi.T.astype(r2.dtype) @ rpad[: self.npad]
        yc = self.a0_inv.astype(r2.dtype) @ rc
        y0 = self.phi.astype(r2.dtype) @ yc
        if y0.shape[0] < r2.shape[0]:
            y0 = jnp.pad(y0, ((0, r2.shape[0] - y0.shape[0]), (0, 0)))
        return y0[: r2.shape[0]]

    def _amul(self, x2: jax.Array) -> jax.Array:
        """A x for the hybrid coupling, on the internal device format."""
        from ..ops.matvec import spmv

        m = self.a_dev.n_rows_pad
        xp = x2
        if x2.shape[0] < m:
            xp = jnp.pad(x2, ((0, m - x2.shape[0]), (0, 0)))
        y = spmv(self.a_dev, xp[:m, 0] if x2.shape[1] == 1 else xp[:m])
        y = y[:, None] if y.ndim == 1 else y
        if y.shape[0] < x2.shape[0]:
            y = jnp.pad(y, ((0, x2.shape[0] - y.shape[0]), (0, 0)))
        return y[: x2.shape[0]]

    def _apply(self, r: jax.Array) -> jax.Array:
        was_1d = r.ndim == 1
        r2 = r[:, None] if was_1d else r
        if self.coupling == "additive":
            y = self.level1._apply(r2) + self._coarse(r2)
        else:
            # symmetric hybrid: y = C r + (I - C A) M1 (I - A C) r
            y0 = self._coarse(r2)
            y1 = self.level1._apply(r2 - self._amul(y0))
            y = y0 + y1 - self._coarse(self._amul(y1))
        return y[:, 0] if was_1d else y
