"""ILUT — threshold incomplete LU.

JAX analogue of Ifpack2::ILUT
(packages/ifpack2/src/Ifpack2_ILUT_decl.hpp:91 — dual-threshold Saad
ILUT(p, τ): drop entries below τ·‖row‖, keep the p largest per row in
each factor). Factorization on host (numpy row sweep; the native C++
version is a future drop-in), application via the same fixed-sweep Jacobi
triangular solves as ILU(0) (SURVEY.md hard-part #4).
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
    "fact: ilut level-of-fill": Param("fact: ilut level-of-fill", 1.5,
                                      doc="keep ~fill·(row nnz) per factor"),
    "fact: drop tolerance": Param("fact: drop tolerance", 1e-4),
    "fact: sweeps": Param("fact: sweeps", 6),
    "dtype": Param("dtype", None),
}


def ilut_factor(a: CsrHost, fill: float = 1.5, droptol: float = 1e-4
                ) -> tuple[CsrHost, CsrHost]:
    """Saad's ILUT(p, τ): returns (L unit-lower incl diag, U upper).

    Uses the native C++ row sweep (native/src/tt_native.cpp:tt_ilut —
    same drop/keep semantics) when the library is available; the numpy/
    dict sweep below is the always-works fallback."""
    n = a.shape[0]
    from ..native import ilut_native

    nat = ilut_native(n, a.row_ptr, a.cols, a.vals.astype(np.float64),
                      fill, droptol)
    if nat is not None:
        l_ptr, l_cols, l_vals, u_ptr, u_cols, u_vals = nat
        l_rows_r = np.repeat(np.arange(n), np.diff(l_ptr))
        u_rows_r = np.repeat(np.arange(n), np.diff(u_ptr))
        l_m = CsrHost.from_coo(
            np.concatenate([l_rows_r, np.arange(n)]),
            np.concatenate([l_cols.astype(np.int64), np.arange(n)]),
            np.concatenate([l_vals, np.ones(n)]), a.shape,
            sum_duplicates=False)
        u_m = CsrHost.from_coo(u_rows_r, u_cols.astype(np.int64), u_vals,
                               a.shape, sum_duplicates=False)
        return l_m, u_m
    u_rows: list[dict] = []
    l_rows: list[dict] = []
    for i in range(n):
        cols, vals = a.row(i)
        w = dict(zip(cols.tolist(), vals.tolist()))
        row_norm = float(np.linalg.norm(vals)) or 1.0
        tau = droptol * row_norm
        p_keep = max(int(fill * len(cols)), 1)
        import heapq

        heap = [c for c in w if c < i]
        heapq.heapify(heap)
        seen = set(heap)
        while heap:
            k = heapq.heappop(heap)
            uk = u_rows[k]
            ukk = uk.get(k, 0.0)
            if ukk == 0.0:
                continue
            lik = w[k] / ukk
            if abs(lik) < tau:
                del w[k]
                continue
            w[k] = lik
            for j, uv in uk.items():
                if j > k:
                    fill_new = j not in w
                    w[j] = w.get(j, 0.0) - lik * uv
                    if fill_new and j < i and j not in seen:
                        heapq.heappush(heap, j)
                        seen.add(j)
        lower = {c: v for c, v in w.items() if c < i and abs(v) >= tau}
        upper = {c: v for c, v in w.items() if c >= i
                 and (c == i or abs(v) >= tau)}
        if len(lower) > p_keep:
            keep = sorted(lower, key=lambda c: -abs(lower[c]))[:p_keep]
            lower = {c: lower[c] for c in keep}
        if len(upper) > p_keep + 1:
            keep = sorted((c for c in upper if c != i),
                          key=lambda c: -abs(upper[c]))[:p_keep]
            upper = {c: upper[c] for c in keep} | (
                {i: upper[i]} if i in upper else {})
        if i not in upper:
            upper[i] = row_norm * 1e-12  # zero-pivot guard
        l_rows.append(lower)
        u_rows.append(upper)
    lr, lc, lv, ur, uc, uv = [], [], [], [], [], []
    for i in range(n):
        for c, v in l_rows[i].items():
            lr.append(i)
            lc.append(c)
            lv.append(v)
        lr.append(i)
        lc.append(i)
        lv.append(1.0)
        for c, v in u_rows[i].items():
            ur.append(i)
            uc.append(c)
            uv.append(v)
    l_m = CsrHost.from_coo(np.array(lr), np.array(lc), np.array(lv),
                           a.shape, sum_duplicates=False)
    u_m = CsrHost.from_coo(np.array(ur), np.array(uc), np.array(uv),
                           a.shape, sum_duplicates=False)
    return l_m, u_m


class Ilut(Preconditioner):
    def _do_initialize(self) -> None:
        self.params.validate(_SPECS)
        if not isinstance(self.a, CsrHost):
            raise TypeError("Ilut expects a CsrHost matrix")

    def _do_compute(self) -> None:
        p = self.params
        dtype = p["dtype"] or self.a.vals.dtype
        l_m, u_m = ilut_factor(self.a, float(p["fact: ilut level-of-fill"]),
                               float(p["fact: drop tolerance"]))
        n = self.a.shape[0]
        npad = round_up(n, ROW_ALIGN)
        self._l = choose_format(l_m, dtype=dtype)
        self._u = choose_format(u_m, dtype=dtype)
        du = u_m.diagonal().astype(np.float64)
        dinv = np.ones(npad)
        dinv[:n] = 1.0 / np.where(du != 0, du, 1.0)
        self._udinv = jnp.asarray(dinv, dtype=dtype)
        self.sweeps = int(p["fact: sweeps"])

    def _apply(self, r: jax.Array) -> jax.Array:
        udinv = self._udinv if r.ndim == 1 else self._udinv[:, None]
        y = r
        for _ in range(self.sweeps):
            y = r - (spmv(self._l, y) - y)
        x = udinv * y
        for _ in range(self.sweeps):
            x = x + udinv * (y - spmv(self._u, x))
        return x
