"""GMRES-polynomial preconditioner.

JAX analogue of Belos' Hybrid/Poly GMRES preconditioner
(packages/belos/src/BelosGmresPolySolMgr.hpp — builds a GmresPolyOp via
generateArnoldiPoly; application replayed through the Arnoldi recurrence,
BelosGmresPolyOp.hpp:198,254,259 ApplyArnoldiPoly).

Setup (compute): run `degree` Arnoldi steps on a seed vector, keep the
small Hessenberg H and the least-squares solution y of min‖βe₁ − H y‖ on
host. Apply: replay the recurrence
    w₀ = v;  w_{j+1} = (A w_j − Σ_{i≤j} H[i,j] w_i) / H[j+1,j]
accumulating p(A)v = Σ y_j w_j — ``degree`` SpMVs + rank-1 updates,
fully unrolled and fused by XLA, zero reductions at apply time.
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..ops.formats import CsrHost, choose_format, round_up, ROW_ALIGN
from ..ops.matvec import spmv
from ..parallel.comm import SerialComm
from ..utils.params import Param
from .base import Preconditioner

_SPECS = {
    "poly: degree": Param("poly: degree", 10),
    "poly: seed": Param("poly: seed", 0),
    "dtype": Param("dtype", None),
}


class GmresPoly(Preconditioner):
    def _do_initialize(self) -> None:
        self.params.validate(_SPECS)
        if not isinstance(self.a, CsrHost):
            raise TypeError("GmresPoly expects a CsrHost matrix")

    def _do_compute(self) -> None:
        d = int(self.params["poly: degree"])
        dtype = self.params["dtype"] or self.a.vals.dtype
        n = self.a.shape[0]
        npad = round_up(n, ROW_ALIGN)
        self._dev = choose_format(self.a, dtype=dtype)

        rng = np.random.default_rng(int(self.params["poly: seed"]))
        v0 = np.zeros(npad)
        v0[:n] = rng.standard_normal(n)
        op = lambda v: spmv(self._dev, v)
        self.h, self.y, self.degree = gmres_poly_setup(
            op, jnp.asarray(v0, dtype=dtype), d)

    def _apply(self, r: jax.Array) -> jax.Array:
        """p(A) r via the Arnoldi-recurrence replay (ApplyArnoldiPoly)."""
        return gmres_poly_apply(lambda v: spmv(self._dev, v), self.h,
                                self.y, self.degree, r)


def gmres_poly_setup(op, v0: jax.Array, degree: int):
    """Host-driven Arnoldi on ANY operator callable (generateArnoldiPoly,
    BelosGmresPolyOp.hpp:198): returns (H, y, deg) with y the least-squares
    polynomial coefficients. ``v0`` is the (padded) seed vector — for a
    distributed (global-view) operator pass ``row_map.to_padded(seed)``
    so pad rows stay zero; dots/norms on global sharded arrays are
    GSPMD-partitioned automatically."""
    v0 = v0 / jnp.linalg.norm(v0)
    v = [v0]
    d = degree
    h = np.zeros((d + 1, d))
    breakdown = d
    for j in range(d):
        w = op(v[j])
        # CGS2 projection against all previous vectors
        for _ in range(2):
            coeffs = np.array([float(jnp.vdot(vi, w)) for vi in v])
            for i, vi in enumerate(v):
                w = w - coeffs[i] * vi
            h[: j + 1, j] += coeffs
        hj1 = float(jnp.linalg.norm(w))
        h[j + 1, j] = hj1
        if hj1 < 1e-14:
            breakdown = j + 1
            break
        v.append(w / hj1)
    deg = breakdown
    beta_e1 = np.zeros(deg + 1)
    beta_e1[0] = 1.0  # seed was normalized
    y, *_ = np.linalg.lstsq(h[: deg + 1, :deg], beta_e1, rcond=None)
    return h[: deg + 1, :deg], y, deg


def gmres_poly_apply(op, h: np.ndarray, y: np.ndarray, d: int,
                     r: jax.Array) -> jax.Array:
    """Replay the Arnoldi recurrence to apply p(A)r (ApplyArnoldiPoly,
    BelosGmresPolyOp.hpp:254-259): ``d`` operator applies + rank-1
    updates, unrolled for XLA fusion, zero reductions at apply time.

    Coefficients are cast to r's dtype: setup always runs the small
    Hessenberg/lstsq math in f64 on host, but an f32 solve under x64
    mode must not promote the polynomial apply to f64."""
    h = np.asarray(h, dtype=r.dtype)
    y = np.asarray(y, dtype=r.dtype)
    out = y[0] * r
    ws = [r]
    for j in range(d - 1):
        aw = op(ws[j])
        for i in range(j + 1):
            aw = aw - h[i, j] * ws[i]
        wj1 = aw / h[j + 1, j]
        ws.append(wj1)
        out = out + y[j + 1] * wj1
    return out


def gmres_poly_op(op, v0: jax.Array, degree: int = 10):
    """One-call operator-based GmresPoly: setup on ``v0`` then return the
    apply closure. Works unchanged on a distributed global-view operator
    (``parallel.driver.global_operator``) — the JAX-native route to a
    DISTRIBUTED polynomial preconditioner (the reference applies
    GmresPolyOp to any Tpetra::Operator)."""
    h, y, deg = gmres_poly_setup(op, v0, degree)
    return lambda r: gmres_poly_apply(op, h, y, deg, r)
