"""Stochastic Galerkin operators and preconditioners.

Reference: stokhos/src/epetra —
- Stokhos_MatrixFreeOperator.{hpp,cpp}: y_i = sum_k sum_j C[i,j,k] A_k x_j
  applied block-by-block without assembling the (n*P) system;
- Stokhos_MeanBasedPreconditioner.hpp: M = I_P (x) prec(A_0);
- Stokhos_ApproxJacobiPreconditioner.hpp /
  Stokhos_ApproxGaussSeidelPreconditioner.hpp: a few block
  Jacobi/Gauss-Seidel sweeps using only the mean-block solve;
- Stokhos_FullyAssembledOperator.hpp: the explicit Kronecker-sum matrix.

Device mapping: the PC coefficient field is ONE dense (n_pad, P) block; each
A_k applies to all P columns at once through the multivector SpMM path
and the stochastic coupling is a (P,P) GEMM against the k-th slice
of the triple-product tensor. The k loop is a static Python loop (K =
#PCE terms of the operator, typically d+1 for affine coefficients), so
XLA sees one fused program per apply — no per-block dispatch like the
reference's Epetra block operators.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..ops.matvec import spmv
from .product_basis import TotalOrderBasis


def _as_apply(a):
    return a if callable(a) else (lambda x, a=a: spmv(a, x))


class SGOperator:
    """Matrix-free stochastic Galerkin operator.

    ``mats``: K operators (device sparse formats or callables), the PC
    coefficients of the random operator A(xi) = sum_k A_k psi_k(xi).
    ``basis``: the solution-space PC basis (P = basis.size).
    Acts on (n, P) coefficient blocks; ``flat`` wraps it for (n*P,)
    vectors so every existing Krylov driver can consume it.
    """

    def __init__(self, mats, basis: TotalOrderBasis, cijk=None):
        self.applies = [_as_apply(a) for a in mats]
        self.k = len(self.applies)
        self.basis = basis
        c = basis.triple_product_tensor() if cijk is None else np.asarray(cijk)
        if self.k > c.shape[0]:
            raise ValueError(
                f"{self.k} operator terms but basis has only {c.shape[0]}")
        # ck[k] = C[:, :, k] slice used as the right GEMM factor
        self.ck = jnp.asarray(c[:, :, :self.k].transpose(2, 0, 1))

    @classmethod
    def from_affine(cls, mats, basis: TotalOrderBasis) -> "SGOperator":
        """Build from the AFFINE germ form A(xi) = mats[0] + sum_d
        mats[1+d] * xi_d (the natural output of a KL expansion).

        The germ xi_d is not the orthonormal basis function: xi_d =
        alpha_0 + sqrt(beta_1) psi_{i(d)}, where i(d) is the first-order
        term of dimension d in the basis ordering — so each mode is
        rescaled and rerouted to its basis slot, and any non-centered
        alpha_0 folds into the mean block. Getting this wrong is a silent
        ~O(sqrt(beta_1)) moment error, hence the dedicated constructor.
        """
        if len(mats) != basis.dim + 1:
            raise ValueError(
                f"affine form needs {basis.dim + 1} terms, got {len(mats)}")
        t = basis.terms
        first_order = [None] * basis.dim
        for d in range(basis.dim):
            (row,) = np.nonzero((t[:, d] == 1) & (t.sum(axis=1) == 1))
            first_order[d] = int(row[0])
        applies = [_as_apply(a) for a in mats]
        a0_extra = []  # (alpha0, apply) terms folded into the mean block
        ordered: list = [None] * (max(first_order) + 1)
        for d in range(basis.dim):
            b1 = basis.bases[d]
            s = float(np.sqrt(b1.beta[1]))
            ordered[first_order[d]] = \
                (lambda u, f=applies[1 + d], s=s: s * f(u))
            if b1.alpha[0] != 0.0:
                a0_extra.append((float(b1.alpha[0]), applies[1 + d]))

        def mean_apply(u, f0=applies[0], extra=tuple(a0_extra)):
            y = f0(u)
            for a0, f in extra:
                y = y + a0 * f(u)
            return y

        ordered[0] = mean_apply
        zero = (lambda u: jnp.zeros_like(u))
        return cls([f if f is not None else zero for f in ordered], basis)

    def __call__(self, u: jnp.ndarray) -> jnp.ndarray:
        """u: (n, P) -> (n, P)."""
        y = self.applies[0](u)  # C[:,:,0] = I for orthonormal bases
        for k in range(1, self.k):
            # HIGHEST precision: a TF32 default on the GPU costs ~3
            # digits of attainable residual in f32 solves
            y = y + jnp.matmul(self.applies[k](u), self.ck[k],
                               precision="highest")
        return y

    def flat(self, n_rows: int):
        p = self.basis.size

        def apply_flat(x):
            return self(x.reshape(n_rows, p)).reshape(-1)

        return apply_flat


def mean_based_prec(prec0, basis: TotalOrderBasis, n_rows: int | None = None):
    """M^-1 = I_P (x) prec0: apply the mean-block preconditioner to every
    PC column (Stokhos_MeanBasedPreconditioner.hpp:47). ``prec0`` must
    accept (n, P) blocks (all the local preconditioners here do).
    Returns a flat-vector callable if ``n_rows`` is given, else a block
    callable."""
    if n_rows is None:
        return prec0
    p = basis.size

    def apply_flat(x):
        return prec0(x.reshape(n_rows, p)).reshape(-1)

    return apply_flat


def _off_mean(sg: SGOperator, u):
    """The coupling part: sg(u) minus the block-diagonal A_0 term."""
    y = jnp.zeros_like(u)
    for k in range(1, sg.k):
        y = y + jnp.matmul(sg.applies[k](u), sg.ck[k], precision="highest")
    return y


def approx_jacobi_prec(sg: SGOperator, prec0, n_iter: int = 2):
    """Block-Jacobi sweeps with the mean-block solve
    (Stokhos_ApproxJacobiPreconditioner.hpp:47): z <- M0^-1 (r - F z)
    where F is the off-mean stochastic coupling. n_iter=1 reduces to the
    mean-based preconditioner."""

    def apply_block(r):
        z = prec0(r)
        for _ in range(n_iter - 1):
            z = prec0(r - _off_mean(sg, z))
        return z

    return apply_block


def approx_gauss_seidel_prec(sg: SGOperator, prec0, n_iter: int = 1):
    """Symmetric block Gauss-Seidel sweeps over PC blocks in index order
    (Stokhos_ApproxGaussSeidelPreconditioner.hpp:47). Sequential over P
    blocks -> compile cost grows with P*K; intended for small P (the
    reference makes the same trade, it just pays it at run time).
    """
    p = sg.basis.size

    def apply_block(r):
        z = jnp.zeros_like(r)
        for _ in range(n_iter):
            for i in list(range(p)) + list(range(p - 2, -1, -1)):
                resid_i = r[:, i] - _off_mean(sg, z)[:, i]
                z = z.at[:, i].set(prec0(resid_i))
        return z

    return apply_block


def assemble_sg_dense(mats_dense, basis: TotalOrderBasis,
                      cijk=None) -> np.ndarray:
    """Explicitly assembled SG matrix sum_k C[:,:,k] (x) A_k, interleaved
    so x_flat = U.reshape(-1) with U (n, P)
    (Stokhos_FullyAssembledOperator.hpp:51 — there by Kronecker graph
    union; here dense, for verification and small direct solves)."""
    c = basis.triple_product_tensor() if cijk is None else np.asarray(cijk)
    p = basis.size
    n = np.asarray(mats_dense[0]).shape[0]
    out = np.zeros((n * p, n * p))
    for k, a in enumerate(mats_dense):
        out += np.kron(np.asarray(a), c[:, :, k])
    return out


def sg_solve(solver, sg: SGOperator, b_block: jnp.ndarray, *,
             prec=None, **kw):
    """Solve the SG system for the (n, P) coefficient block with any
    Krylov driver from ``trilinos_tpu.solvers`` (flattened vector form).
    Returns (U, SolveResult)."""
    n, p = b_block.shape
    flat_prec = None
    if prec is not None:
        flat_prec = (lambda x: prec(x.reshape(n, p)).reshape(-1))
    res = solver(sg.flat(n), b_block.reshape(-1), prec=flat_prec, **kw)
    return res.x.reshape(n, p), res
