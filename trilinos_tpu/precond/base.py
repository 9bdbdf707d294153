"""Preconditioner lifecycle and factory.

JAX analogue of Ifpack2's preconditioner interface
(packages/ifpack2/src/Ifpack2_Preconditioner.hpp:81-107):
``initialize()`` does structure-only setup (graphs, colorings, level
sets — host side), ``compute()`` does numeric setup (factors, inverses,
eigenvalue estimates — producing device arrays), ``apply(x)`` is a pure
jittable function usable directly as the ``prec=`` argument of any solver.

The factory mirrors Ifpack2::Factory's string dispatch
(packages/ifpack2/src/Ifpack2_Factory_decl.hpp:105,135).
"""
from __future__ import annotations

from typing import Any

import numpy as np

import jax

from ..utils.params import ParameterList, make_params


class Preconditioner:
    """Base lifecycle: initialize → compute → apply."""

    def __init__(self, a, params: ParameterList | dict | None = None):
        self.a = a
        self.params = make_params(params)
        self._initialized = False
        self._computed = False

    # -- lifecycle ---------------------------------------------------------
    def initialize(self) -> "Preconditioner":
        self._do_initialize()
        self._initialized = True
        return self

    def compute(self) -> "Preconditioner":
        if not self._initialized:
            self.initialize()
        self._do_compute()
        self._computed = True
        return self

    def recompute(self, a_new) -> "Preconditioner":
        """Values-only numeric recompute: swap in a matrix with the SAME
        sparsity pattern and redo only the numeric phase — the
        initialize(graph)/compute(values) split of
        Ifpack2::Preconditioner (Ifpack2_Preconditioner.hpp:81-97;
        Tpetra resumeFill graph reuse, Tpetra_CrsMatrix_decl.hpp:2897).
        Structure built by initialize() (colorings, level sets, graphs)
        is reused; the hot path of nonlinear/transient outer loops."""
        old = self.a
        same_pattern = (
            not hasattr(old, "row_ptr") or not hasattr(a_new, "row_ptr")
            or (len(old.row_ptr) == len(a_new.row_ptr)
                and bool(np.array_equal(old.row_ptr, a_new.row_ptr))
                and bool(np.array_equal(old.cols, a_new.cols))))
        if not same_pattern:
            raise ValueError(
                "recompute() requires an unchanged sparsity pattern; "
                "build a new preconditioner for structural changes")
        self.a = a_new
        if not self._initialized:
            self.initialize()
        self._do_compute()
        self._computed = True
        return self

    def apply(self, x: jax.Array) -> jax.Array:
        if not self._computed:
            raise RuntimeError(
                f"{type(self).__name__}.apply() before compute()")
        return self._apply(x)

    def __call__(self, x: jax.Array) -> jax.Array:
        return self.apply(x)

    # -- subclass hooks ----------------------------------------------------
    def _do_initialize(self) -> None:
        pass

    def _do_compute(self) -> None:
        pass

    def _apply(self, x: jax.Array) -> jax.Array:
        raise NotImplementedError


def create(name: str, a, params: ParameterList | dict | None = None,
           **kw) -> Preconditioner:
    """String factory: name → computed preconditioner class instance.

    Accepted names follow the reference factory strings
    (Ifpack2_Factory: "RELAXATION", "CHEBYSHEV", "RILUK", "SCHWARZ", ...)
    plus local spellings.
    """
    from .amg import SaAmg
    from .block_amg import BlockStructuredAmg
    from .chebyshev import Chebyshev
    from .ilu import Ilu0
    from .ilut import Ilut
    from .jacobi import BlockJacobi, Relaxation
    from .multicolor_gs import MulticolorGaussSeidel
    from .containers import BlockRelaxation
    from .direct_prec import DirectPrec
    from .hiptmair import Hiptmair
    from .poly import GmresPoly
    from .schwarz import AdditiveSchwarz
    from .two_level_schwarz import TwoLevelSchwarz

    key = name.strip().upper()
    table: dict[str, Any] = {
        "JACOBI": Relaxation,
        "RELAXATION": Relaxation,
        "CHEBYSHEV": Chebyshev,
        "RILUK": Ilu0,
        "RBILUK": Ilu0,  # "fact: block size" > 1 → block-level ILU(k)
        "ILU": Ilu0,
        "ILU(0)": Ilu0,
        "ILUT": Ilut,
        "GMRESPOLY": GmresPoly,
        "POLY": GmresPoly,
        "BLOCK RELAXATION": BlockRelaxation,
        "TRIDI": BlockRelaxation,
        "BANDED RELAXATION": BlockRelaxation,
        "DATABASE SCHWARZ": BlockRelaxation,
        "BLOCK_JACOBI": BlockJacobi,
        "MT GAUSS-SEIDEL": MulticolorGaussSeidel,
        "GAUSS-SEIDEL": MulticolorGaussSeidel,
        "SCHWARZ": AdditiveSchwarz,
        "ADDITIVE SCHWARZ": AdditiveSchwarz,
        "TWO-LEVEL SCHWARZ": TwoLevelSchwarz,
        "FROSCH": TwoLevelSchwarz,
        "GDSW": TwoLevelSchwarz,
        "HIPTMAIR": Hiptmair,
        "AMESOS2": DirectPrec,
        "DIRECT": DirectPrec,
        "KLU2": DirectPrec,
        "TACHO": DirectPrec,
        "CHOLMOD": DirectPrec,
        "SA-AMG": SaAmg,
        "BLOCK SA-AMG": BlockStructuredAmg,
        "MUELU": SaAmg,
        "AMG": SaAmg,
    }
    if key not in table:
        raise ValueError(f"unknown preconditioner {name!r}; "
                         f"valid: {sorted(table)}")
    if key in ("TACHO", "CHOLMOD"):
        # copy: adding the backend default must not mutate a caller's
        # ParameterList (it may be reused for a different create())
        params = make_params(params).copy()
        if "solver" not in params:
            params["solver"] = key
    return table[key](a, params, **kw)
