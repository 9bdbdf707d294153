"""Stochastic Galerkin / polynomial chaos UQ (the Stokhos analogue).

Reference: packages/stokhos/src — OneDOrthogPolyBasis/RecurrenceBasis
(recurrence-defined 1-D orthogonal polynomials), CompletePolynomialBasis
(total-order multivariate product basis), Sparse3Tensor (the <psi_i psi_j
psi_k> triple products), TensorProduct/SparseGrid quadrature,
QuadOrthogPolyExpansion (PCE arithmetic by quadrature projection), and the
epetra/ SG operator layer (MatrixFreeOperator, MeanBasedPreconditioner,
ApproxJacobi/ApproxGaussSeidel, FullyAssembledOperator, KL random fields).

Accelerator-first design: all setup (recurrence coefficients, Golub–Welsch,
multi-index enumeration, Cijk products) happens ONCE on the host in numpy;
the device only ever sees static-shape dense arrays. PCE arithmetic is a
(P,P,P)×(…,P) einsum and quadrature projection is a pair of (Q,P) GEMMs —
both dense matmul work. The stochastic Galerkin apply is K sparse SpMMs over the
(n,P) coefficient block plus a (K,P,P) einsum, riding the existing
multivector SpMM kernels.
"""

from .bases import (OneDBasis, hermite_basis, jacobi_basis, legendre_basis,
                    rys_basis)
from .product_basis import TotalOrderBasis
from .quadrature import Quadrature, smolyak_quadrature, tensor_quadrature
from .pce import PCE, QuadExpansion
from .nisp import nisp_project, pce_mean, pce_std, pce_variance, sample_pce
from .sg import (SGOperator, assemble_sg_dense, mean_based_prec,
                 approx_jacobi_prec, approx_gauss_seidel_prec, sg_solve)
from .kl import ExponentialKL1D, exponential_kl

__all__ = [
    "OneDBasis", "hermite_basis", "legendre_basis", "jacobi_basis",
    "rys_basis", "TotalOrderBasis", "Quadrature", "tensor_quadrature",
    "smolyak_quadrature", "PCE", "QuadExpansion", "nisp_project",
    "pce_mean", "pce_variance", "pce_std", "sample_pce", "SGOperator",
    "assemble_sg_dense", "mean_based_prec", "approx_jacobi_prec",
    "approx_gauss_seidel_prec", "sg_solve", "ExponentialKL1D",
    "exponential_kl",
]
