"""Polynomial chaos expansion (PCE) arithmetic.

Reference: Stokhos_OrthogPolyApprox.hpp (the coefficient container),
Stokhos_QuadOrthogPolyExpansion.hpp (arithmetic by quadrature: evaluate
both operands at the quadrature points, combine pointwise, project back),
Stokhos_DivisionExpansionStrategy.hpp (division = linear solve against
the triple-product operator).

Device mapping: an expansion is three static dense arrays — the (P,P,P)
triple-product tensor, the (Q,P) quadrature basis table, and the (Q,)
weights. Multiply is one einsum; every nonlinear op is two GEMMs around
an elementwise function; division is a (P,P) dense solve. All sizes are
compile-time constants, so chained PCE arithmetic fuses into a single
XLA program (the reference evaluates op-by-op on host arrays).

Coefficients are ORTHONORMAL-basis coefficients: mean = c[0],
variance = sum(c[1:]**2).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .product_basis import TotalOrderBasis
from .quadrature import Quadrature, tensor_quadrature


class QuadExpansion:
    """Arithmetic engine bound to one basis + one quadrature rule."""

    def __init__(self, basis: TotalOrderBasis,
                 quad: Quadrature | None = None):
        self.basis = basis
        if quad is None:
            # exact for products of two basis polys (degree 2p)
            quad = tensor_quadrature(basis.bases, basis.order + 1)
        self.quad = quad
        self.cijk = jnp.asarray(basis.triple_product_tensor())
        self.psi = jnp.asarray(basis.evaluate(quad.points))   # (Q, P)
        self.w = jnp.asarray(quad.weights)

    @property
    def size(self) -> int:
        return self.basis.size

    # -- coefficient-space ops ---------------------------------------
    def times(self, a, b):
        return jnp.einsum("...i,...j,ijk->...k", a, b, self.cijk, precision="highest")

    def divide(self, a, b):
        """c with b*c = a: solve sum_j (sum_i b_i C[i,j,k]) c_j = a_k."""
        m = jnp.einsum("...i,ijk->...jk", b, self.cijk, precision="highest")
        return jnp.linalg.solve(jnp.swapaxes(m, -1, -2), a[..., None])[..., 0]

    def unary(self, fn, a):
        """Project fn(a) back onto the basis by quadrature."""
        vals = jnp.einsum("...i,qi->...q", a, self.psi, precision="highest")
        return jnp.einsum("...q,q,qk->...k", fn(vals), self.w, self.psi,
                          precision="highest")

    def binary(self, fn, a, b):
        va = jnp.einsum("...i,qi->...q", a, self.psi, precision="highest")
        vb = jnp.einsum("...i,qi->...q", b, self.psi, precision="highest")
        return jnp.einsum("...q,q,qk->...k", fn(va, vb), self.w, self.psi,
                          precision="highest")

    # -- constructors --------------------------------------------------
    def constant(self, value):
        c = jnp.zeros(self.size).at[0].set(value)
        return PCE(c, self)

    def variable(self, d: int):
        """The d-th germ xi_d as a PCE (its first-order basis term; the
        1-D families here have <psi_1, x> = sqrt(beta_1) * <psi_1^2>)."""
        t = self.basis.terms
        (row,) = np.nonzero((t[:, d] == 1) & (t.sum(axis=1) == 1))
        b1 = self.basis.bases[d]
        c = np.zeros(self.size)
        c[row[0]] = np.sqrt(b1.beta[1])
        c[0] = b1.alpha[0]
        return PCE(jnp.asarray(c), self)


class PCE:
    """A random variable as orthonormal-PC coefficients (..., P)."""

    def __init__(self, coeffs, expansion: QuadExpansion):
        self.c = jnp.asarray(coeffs)
        self.ex = expansion

    def _lift(self, other):
        if isinstance(other, PCE):
            return other.c
        return jnp.zeros_like(self.c).at[..., 0].set(other)

    def __add__(self, o):
        return PCE(self.c + self._lift(o), self.ex)

    __radd__ = __add__

    def __sub__(self, o):
        return PCE(self.c - self._lift(o), self.ex)

    def __rsub__(self, o):
        return PCE(self._lift(o) - self.c, self.ex)

    def __neg__(self):
        return PCE(-self.c, self.ex)

    def __mul__(self, o):
        if isinstance(o, PCE):
            return PCE(self.ex.times(self.c, o.c), self.ex)
        return PCE(self.c * o, self.ex)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, PCE):
            return PCE(self.ex.divide(self.c, o.c), self.ex)
        return PCE(self.c / o, self.ex)

    def __rtruediv__(self, o):
        return PCE(self.ex.divide(self._lift(o), self.c), self.ex)

    def __pow__(self, n: int):
        if not isinstance(n, int) or n < 0:
            return self.apply(lambda v: v ** n)
        out = self.ex.constant(1.0)
        base = self
        while n:
            if n & 1:
                out = out * base
            base = base * base
            n >>= 1
        return out

    def apply(self, fn):
        return PCE(self.ex.unary(fn, self.c), self.ex)

    def exp(self):
        return self.apply(jnp.exp)

    def log(self):
        return self.apply(jnp.log)

    def sqrt(self):
        return self.apply(jnp.sqrt)

    def sin(self):
        return self.apply(jnp.sin)

    def cos(self):
        return self.apply(jnp.cos)

    # -- statistics ----------------------------------------------------
    def mean(self):
        return self.c[..., 0]

    def variance(self):
        return jnp.sum(self.c[..., 1:] ** 2, axis=-1)

    def std(self):
        return jnp.sqrt(self.variance())

    def eval(self, points):
        """Realizations at germ samples ``points`` (Q, d)."""
        psi = jnp.asarray(self.ex.basis.evaluate(np.asarray(points)))
        return jnp.einsum("...i,qi->...q", self.c, psi, precision="highest")
