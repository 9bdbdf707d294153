"""Matrix-free constant-coefficient stencil operator and its polynomials.

A Galeri stencil operator with CONSTANT coefficients (Laplace1D/2D/3D,
Brick3D, Star2D…) needs no stored matrix at all: the "values" are a
handful of scalars and the sparsity truncation at grid boundaries is a
closed-form validity mask computed from the row index. SpMV traffic drops
to read-x + write-y, versus (ndiags + 2) vector passes for stored DIA.

The reference's equivalent operator (Galeri_Cross2D.h etc.) materializes
the CSR; ``galeri.stencils`` can emit either the stored form or this
matrix-free form.

Every apply here is plain ``jax.numpy``: each term is a rolled copy of x
under its boundary mask, and XLA fuses the whole multiply-add chain into
one loop over the vector.

The polynomial applies evaluate a three-term recurrence chain

    u_0 = x
    u_j = alpha_j * (A u_{j-1}) + beta_j * u_{j-1}
          + gamma_j * u_{j-2} + zeta_j * x          (j = 1..s)

which expresses Chebyshev smoothing sweeps (Saad Alg. 12.1 /
Ifpack2_Details_ChebyshevKernel_decl.hpp), damped-Jacobi / Richardson
sweeps, and the matrix-powers basis of s-step GMRES
(Belos_Tpetra_GmresSstep.hpp:305).
"""
from __future__ import annotations

import dataclasses

import numpy as np

import jax
import jax.numpy as jnp

from .formats import round_up


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class StencilOp:
    """Matrix-free stencil operator on a lexicographic grid.

    dims: (nx, ny, nz) — gid = ix + nx*(iy + ny*iz) (Galeri convention)
    offsets: per-term grid offsets (dx, dy, dz)
    coeffs: per-term constant coefficients
    """

    dims: tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    offsets: tuple[tuple[int, ...], ...] = dataclasses.field(
        metadata=dict(static=True))
    coeffs: tuple[float, ...] = dataclasses.field(metadata=dict(static=True))
    n_rows_pad: int = dataclasses.field(metadata=dict(static=True))
    dtype: str = dataclasses.field(metadata=dict(static=True), default="float32")

    @classmethod
    def create(cls, dims, stencil, n_rows_pad=None, dtype="float32",
               pad_align=1024):
        dims3 = tuple(dims) + (1,) * (3 - len(dims))
        offs, coeffs = [], []
        for off, c in stencil:
            off3 = tuple(off) + (0,) * (3 - len(off))
            offs.append(off3)
            coeffs.append(float(c))
        n = int(np.prod(dims3))
        if n_rows_pad is None:
            n_rows_pad = round_up(n, pad_align)
        return cls(dims=dims3, offsets=tuple(offs), coeffs=tuple(coeffs),
                   n_rows_pad=n_rows_pad, dtype=dtype)

    @property
    def n_rows(self) -> int:
        return int(np.prod(self.dims))

    n_cols = n_rows

    def __call__(self, x):
        """Operator-protocol apply (solvers take callables; passing the
        StencilOp itself also lets structure-aware drivers recover the
        stencil)."""
        return stencil_spmv_xla(self, x)

    @property
    def shape(self):
        n = self.n_rows
        return (n, n)

    @property
    def nnz(self) -> int:
        n_val = 0
        nx, ny, nz = self.dims
        for (dx, dy, dz) in self.offsets:
            n_val += ((nx - abs(dx)) * (ny - abs(dy)) * (nz - abs(dz)))
        return n_val

    def lin_offset(self, off3) -> int:
        nx, ny, _ = self.dims
        dx, dy, dz = off3
        return dx + nx * (dy + ny * dz)

    def transposed(self) -> "StencilOp":
        """Aᵀ: the same stencil with every offset negated."""
        return dataclasses.replace(
            self, offsets=tuple(tuple(-d for d in o) for o in self.offsets))


def stencil_spmv_xla(op: StencilOp, x: jax.Array,
                     z_bounds=None) -> jax.Array:
    """y = A x for x of shape (n_pad,) or (n_pad, k); padding rows are
    identity.

    z_bounds: optional traced (2,) int32 valid-z-plane range [z_lo, z_hi)
    for the boundary masks (default (0, nz)). The distributed z-slab path
    uses it: a shard's extended slab holds ghost planes that are real
    interior data (no masking at the cut) or lie beyond the global
    boundary (masked)."""
    was_1d = x.ndim == 1
    x2 = x[:, None] if was_1d else x
    n, npad = op.n_rows, op.n_rows_pad
    nx, ny, nz = op.dims
    z_lo, z_hi = (0, nz) if z_bounds is None else (z_bounds[0],
                                                   z_bounds[1])
    # int32 on purpose: with x64 enabled a default arange is int64, whose
    # division and remainder are emulated on the GPU
    gid = jnp.arange(npad, dtype=jnp.int32)
    ix = gid % nx
    iy = (gid // nx) % ny
    iz = gid // (nx * ny)
    y = jnp.zeros_like(x2)
    for off3, c in zip(op.offsets, op.coeffs):
        o = op.lin_offset(off3)
        dx, dy, dz = off3
        valid = gid < n
        valid &= (ix + dx >= 0) & (ix + dx < nx)
        valid &= (iy + dy >= 0) & (iy + dy < ny)
        valid &= (iz + dz >= z_lo) & (iz + dz < z_hi)
        shifted = jnp.roll(x2, -o, axis=0) if o else x2
        y = y + jnp.where(valid[:, None], c * shifted, 0)
    y = jnp.where((gid >= n)[:, None], x2, y)
    return y[:, 0] if was_1d else y


def _poly_terms(op: StencilOp, stages, x: jax.Array, z_bounds):
    """u_1..u_s of the recurrence chain; padding rows propagate u_{j-1}
    unchanged."""
    pad = jnp.arange(op.n_rows_pad, dtype=jnp.int32) >= op.n_rows
    if x.ndim == 2:
        pad = pad[:, None]
    u_prev2 = jnp.zeros_like(x)
    u_prev = x
    outs = []
    for (a, bt, g, z) in stages:
        u = jnp.zeros_like(x)
        if a:
            u = a * stencil_spmv_xla(op, u_prev, z_bounds)
        if bt:
            u = u + bt * u_prev
        if g:
            u = u + g * u_prev2
        if z:
            u = u + z * x
        u = jnp.where(pad, u_prev, u)
        u_prev2, u_prev = u_prev, u
        outs.append(u)
    return outs


def stencil_poly_xla(op: StencilOp, stages, x: jax.Array,
                     z_bounds=None) -> jax.Array:
    """u_s of the recurrence chain. stages: sequence of (alpha, beta,
    gamma, zeta) per stage j=1..s; gamma_1 must be 0 (there is no
    u_{-1})."""
    return _poly_terms(op, stages, x, z_bounds)[-1]


def stencil_powers_xla(op: StencilOp, stages, x: jax.Array,
                       z_bounds=None) -> jax.Array:
    """Matrix-powers basis: the (s, n) stack of u_1..u_s."""
    return jnp.stack(_poly_terms(op, stages, x, z_bounds))


def chebyshev_stages(lmax: float, lmin: float, degree: int,
                     dinv: float):
    """Stage coefficients reproducing the framework's Chebyshev
    semi-iteration (precond/chebyshev.py, Saad Alg. 12.1) on the
    Jacobi-scaled system with CONSTANT diagonal 1/dinv and zero initial
    guess: u_degree == Chebyshev(degree).apply(b)."""
    theta = (lmax + lmin) / 2.0
    delta = (lmax - lmin) / 2.0
    sigma1 = theta / delta
    rho = 1.0 / sigma1
    stages = [(0.0, 0.0, 0.0, dinv / theta)]   # x_1 = D^-1 b / theta
    for j in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        rr = rho_new * rho
        w = 2.0 * rho_new / delta * dinv
        # x_{j+1} = -w A x_j + (1+rr) x_j - rr x_{j-1} + w b
        gamma = 0.0 if j == 0 else -rr         # x_0 = 0 kills the term
        stages.append((-w, 1.0 + rr, gamma, w))
        rho = rho_new
    return tuple(stages)


def stencil_chebyshev_setup(op: StencilOp, degree: int,
                            lmax: float | None = None,
                            lmin: float | None = None,
                            ratio: float = 30.0, boost: float = 1.1,
                            eig_iters: int = 10):
    """Shared setup for the stencil Chebyshev paths (single-device
    preconditioner and the distributed CA smoother): validates the
    constant diagonal, estimates lmax of D^-1 A by a power method
    (the Chebyshev class's default + boost), applies the lmin ratio,
    and returns the stage coefficients."""
    center = [c for o3, c in zip(op.offsets, op.coeffs)
              if o3 == (0, 0, 0)]
    if not center or center[0] == 0.0:
        raise ValueError("stencil has no (constant) diagonal term")
    dinv = 1.0 / center[0]
    if lmax is None:
        v = jnp.asarray(np.random.default_rng(0).standard_normal(
            op.n_rows_pad), dtype=jnp.float32)
        v = v / jnp.linalg.norm(v)
        lam = 1.0
        for _ in range(eig_iters):
            w = dinv * stencil_spmv_xla(op, v)
            lam = float(jnp.linalg.norm(w))
            v = w / max(lam, 1e-30)
        lmax = lam * boost
    if lmin is None:
        lmin = lmax / ratio
    return chebyshev_stages(float(lmax), float(lmin), degree, dinv)


def power_stages(s: int):
    """u_s = A^s x."""
    return tuple((1.0, 0.0, 0.0, 0.0) for _ in range(s))


def monomial_stages(s: int, sigma: float = 1.0):
    """σ-scaled monomial Krylov basis: u_j = (A u_{j-1})/σ, the basis
    the s-step GMRES block loop builds (one norm-scale per step keeps
    the powers from over/underflowing)."""
    inv = 1.0 / float(sigma)
    return tuple((inv, 0.0, 0.0, 0.0) for _ in range(s))


# Newton-basis stages (with conjugate-pair fusion) live with their
# consumer: solvers.sstep_gmres.newton_basis_stages — append a 0.0 zeta
# to feed them to the polynomial applies.


def richardson_stages(omega: float, s: int, dinv: float):
    """Damped-Jacobi sweeps on Ax=b with x_0=0:
    x_{j+1} = x_j + omega D^-1 (b - A x_j)."""
    w = omega * dinv
    stages = [(0.0, 0.0, 0.0, w)]
    for _ in range(s - 1):
        stages.append((-w, 1.0, 0.0, w))
    return tuple(stages)
