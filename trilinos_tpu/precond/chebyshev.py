"""Chebyshev polynomial smoother/preconditioner.

JAX analogue of Ifpack2::Chebyshev
(packages/ifpack2/src/Ifpack2_Chebyshev_decl.hpp:199,
Ifpack2_Details_Chebyshev_def.hpp:827,1434 — λmax from a power method on
D⁻¹A unless "chebyshev: max eigenvalue" is supplied; parameter surface at
Ifpack2_Details_Chebyshev_decl.hpp:177-191). This is the ideal accelerator
preconditioner: apply = degree SpMVs + fused axpbys, zero reductions.

The per-sweep fused operation w ← α D⁻¹ (b − A x) + β w mirrors the
reference's ScaledDampedResidual fused kernel
(Ifpack2_Details_ScaledDampedResidual_decl.hpp:77) — XLA fuses the
diagonal scale and update into the SpMV epilogue automatically.
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
    "chebyshev: degree": Param("chebyshev: degree", 1),
    "chebyshev: max eigenvalue": Param("chebyshev: max eigenvalue", None),
    "chebyshev: min eigenvalue": Param("chebyshev: min eigenvalue", None),
    "chebyshev: ratio eigenvalue": Param("chebyshev: ratio eigenvalue", 30.0),
    "chebyshev: eigenvalue max iterations": Param(
        "chebyshev: eigenvalue max iterations", 10),
    "chebyshev: boost factor": Param("chebyshev: boost factor", 1.1),
    "dtype": Param("dtype", None),
}


class Chebyshev(Preconditioner):
    def _do_initialize(self) -> None:
        self.params.validate(_SPECS)
        if not isinstance(self.a, CsrHost):
            raise TypeError("Chebyshev expects a CsrHost matrix")

    def _power_method(self, iters: int) -> float:
        """λmax of D⁻¹A by power iteration (the reference default,
        Ifpack2_Details_Chebyshev_def.hpp powerMethod)."""
        n = self.a.shape[0]
        rng = np.random.default_rng(0)
        v = jnp.asarray(rng.standard_normal(self.dinv.shape[0]),
                        dtype=self.dinv.dtype)
        v = v / jnp.linalg.norm(v)
        lam = 1.0
        for _ in range(iters):
            w = self.dinv * spmv(self._dev, v)
            lam = float(jnp.linalg.norm(w))
            v = w / jnp.maximum(lam, 1e-30)
        return lam

    def _do_compute(self) -> None:
        p = self.params
        dtype = p["dtype"] or self.a.vals.dtype
        n = self.a.shape[0]
        npad = round_up(n, ROW_ALIGN)
        self._dev = choose_format(self.a, dtype=dtype)
        d = self.a.diagonal().astype(np.float64)
        dinv = np.ones(npad)
        dinv[:n] = 1.0 / np.where(d != 0, d, 1.0)
        self.dinv = jnp.asarray(dinv, dtype=dtype)
        lmax = p["chebyshev: max eigenvalue"]
        if lmax is None:
            lmax = self._power_method(int(p["chebyshev: eigenvalue max iterations"]))
            lmax *= float(p["chebyshev: boost factor"])
        lmin = p["chebyshev: min eigenvalue"]
        if lmin is None:
            lmin = lmax / float(p["chebyshev: ratio eigenvalue"])
        self.lmax = float(lmax)
        self.lmin = float(lmin)
        self.degree = int(p["chebyshev: degree"])

    def _apply(self, b: jax.Array) -> jax.Array:
        """Chebyshev semi-iteration on the Jacobi-scaled system with zero
        initial guess (Saad, Iterative Methods, Alg. 12.1)."""
        dinv = self.dinv if b.ndim == 1 else self.dinv[:, None]
        theta = (self.lmax + self.lmin) / 2
        delta = (self.lmax - self.lmin) / 2
        sigma1 = theta / delta
        rho = 1.0 / sigma1
        z = dinv * b  # z0 = M⁻¹ r0, r0 = b (x0 = 0)
        d_vec = z / theta
        x = d_vec
        r = b
        for _ in range(self.degree - 1):
            r = r - spmv(self._dev, d_vec)  # fused scaled-damped residual
            z = dinv * r
            rho_new = 1.0 / (2 * sigma1 - rho)
            d_vec = (rho_new * rho) * d_vec + (2 * rho_new / delta) * z
            x = x + d_vec
            rho = rho_new
        return x


def fused_stencil_chebyshev(op, degree: int, lmax: float | None = None,
                            lmin: float | None = None,
                            ratio: float = 30.0, boost: float = 1.1,
                            eig_iters: int = 10):
    """Chebyshev preconditioner apply for a CONSTANT-diagonal
    matrix-free StencilOp, evaluated as one recurrence chain
    (ops/stencil.py ``stencil_poly_xla``). Same semi-iteration as the
    Chebyshev class (lmax/lmin are bounds on the Jacobi-scaled operator
    D^-1 A, with the class's power-method + boost defaults); returns a
    callable for use as ``prec=`` in any solver."""
    from ..ops.stencil import (StencilOp, stencil_chebyshev_setup,
                               stencil_poly_xla)

    if not isinstance(op, StencilOp):
        raise TypeError("fused_stencil_chebyshev expects a StencilOp")
    stages = stencil_chebyshev_setup(op, degree, lmax, lmin, ratio,
                                     boost, eig_iters)
    return lambda b: stencil_poly_xla(op, stages, b)
