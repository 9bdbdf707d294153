"""trilinos_tpu — a JAX-native distributed sparse linear-algebra and
Krylov-solver framework (JAX / XLA) with the capability surface of the
Trilinos solver stack (Tpetra + Belos + Ifpack2 + Galeri + Kokkos-Kernels).

Not a port: data layouts and communication are designed for XLA's
static-shape compilation model (fused shifted multiply-adds, batched
matmuls, compiled collectives). See SURVEY.md at the repo root for the reference analysis
and the layer-by-layer correspondence.
"""
from . import (fem, galeri, io, minitensor, nonlinear, ops, optim,
               parallel, piro, precond, solvers, uq, utils)
from .ops import CsrHost, choose_format, residual, spmm, spmv
from .parallel import SerialComm
from .solvers import cg

__version__ = "0.1.0"
