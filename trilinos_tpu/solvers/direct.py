"""Sparse direct solver with the Amesos2 lifecycle.

JAX analogue of Amesos2's adapter layer
(packages/amesos2/src/Amesos2_SolverCore_decl.hpp — the
preOrdering/symbolicFactorization/numericFactorization/solve lifecycle —
with the KLU2 default backend, Amesos2_KLU2_decl.hpp).

The factorization is host-side native C++ (Gilbert-Peierls left-looking
LU with partial pivoting — the KLU/SuperLU column algorithm; see
native/src/tt_native.cpp tt_splu), with a pure-numpy fallback via
scipy.sparse when the toolchain is unavailable. Sparse direct
factorization is inherently sequential-ish and belongs on the host in
this framework (setup-time activity); the SOLVE is exposed both as a
host call and as a dense-factor device apply for small systems (coarse
grids / subdomains), which is where direct solvers sit in the
preconditioning stack (SURVEY §2.1 Amesos2 row).
"""
from __future__ import annotations

import numpy as np

from ..ops.formats import CsrHost


class SparseLu:
    """Amesos2-style lifecycle: create → symbolic/numeric factorization →
    solve. (preOrdering is folded into the pivoting factorization.)"""

    def __init__(self, a: CsrHost):
        if a.shape[0] != a.shape[1]:
            raise ValueError("SparseLu needs a square matrix")
        self.a = a
        self._factors = None
        self._scipy = None

    # -- lifecycle --------------------------------------------------------
    def symbolic_factorization(self) -> "SparseLu":
        # symbolic structure is computed per-column inside the numeric
        # phase (Gilbert-Peierls interleaves them); kept for API parity
        return self

    def numeric_factorization(self) -> "SparseLu":
        from ..native import splu_native

        n = self.a.shape[0]
        f = splu_native(n, self.a.row_ptr, self.a.cols,
                        np.asarray(self.a.vals, dtype=np.float64))
        if f is not None:
            self._factors = f
            return self
        import scipy.sparse as sp
        import scipy.sparse.linalg as spla

        m = sp.csr_matrix(
            (np.asarray(self.a.vals, dtype=np.float64), self.a.cols,
             self.a.row_ptr), shape=self.a.shape).tocsc()
        self._scipy = spla.splu(m)
        return self

    def factor(self) -> "SparseLu":
        return self.symbolic_factorization().numeric_factorization()

    def solve(self, b: np.ndarray) -> np.ndarray:
        if self._factors is None and self._scipy is None:
            self.factor()
        b = np.asarray(b, dtype=np.float64)
        if b.ndim == 1:
            return self._solve1(b)
        return np.stack([self._solve1(b[:, j])
                         for j in range(b.shape[1])], axis=1)

    def _solve1(self, b):
        if self._factors is not None:
            from ..native import splu_solve_native

            return splu_solve_native(self._factors, b)
        return self._scipy.solve(b)

    @property
    def nnz_factors(self) -> int:
        if self._factors is not None:
            l_ptr, _, _, u_ptr = self._factors[0], None, None, self._factors[3]
            return int(l_ptr[-1] + u_ptr[-1])
        if self._scipy is not None:
            return int(self._scipy.L.nnz + self._scipy.U.nnz)
        return 0


class SparseCholesky:
    """Sparse LL^T for symmetric positive definite systems with the
    Amesos2 lifecycle — the Tacho / Cholmod role
    (packages/amesos2/src/Amesos2_Tacho_decl.hpp, Amesos2_Cholmod_decl.hpp;
    the node-level factorization lives in ShyLU's tacho package).

    Factorization is host-side native C++ (up-looking with
    elimination-tree symbolics, native/src/tt_native.cpp tt_spchol) —
    about half the fill and flops of LU on SPD systems and no pivoting.
    Falls back to :class:`SparseLu` when the toolchain is unavailable;
    raises ``ValueError`` on a non-SPD matrix (detected at the first
    non-positive reduced diagonal, like Tacho's chol failure)."""

    def __init__(self, a: CsrHost):
        if a.shape[0] != a.shape[1]:
            raise ValueError("SparseCholesky needs a square matrix")
        self.a = a
        self._factors = None
        self._fallback = None

    def symbolic_factorization(self) -> "SparseCholesky":
        # the elimination tree is built inside the native call; kept for
        # Amesos2 lifecycle parity
        return self

    def numeric_factorization(self) -> "SparseCholesky":
        from ..native import spchol_native

        n = self.a.shape[0]
        f = spchol_native(n, self.a.row_ptr, self.a.cols,
                          np.asarray(self.a.vals, dtype=np.float64))
        if f is not None:
            self._factors = f
            return self
        self._fallback = SparseLu(self.a).factor()
        return self

    def factor(self) -> "SparseCholesky":
        return self.symbolic_factorization().numeric_factorization()

    def solve(self, b: np.ndarray) -> np.ndarray:
        if self._factors is None and self._fallback is None:
            self.factor()
        if self._fallback is not None:
            return self._fallback.solve(b)
        from ..native import spchol_solve_native

        b = np.asarray(b, dtype=np.float64)
        if b.ndim == 1:
            return spchol_solve_native(self._factors, b)
        return np.stack([spchol_solve_native(self._factors, b[:, j])
                         for j in range(b.shape[1])], axis=1)

    @property
    def nnz_factors(self) -> int:
        if self._factors is not None:
            return int(self._factors[0][-1])
        if self._fallback is not None:
            return self._fallback.nnz_factors
        return 0


def direct_solve(a: CsrHost, b: np.ndarray) -> np.ndarray:
    """One-shot convenience: factor + solve (Amesos2::Solver::solve)."""
    return SparseLu(a).factor().solve(b)
