"""Eigensolver factory: string + ParameterList driven eigensolves.

JAX analogue of ``Anasazi::Factory`` (packages/anasazi/src/
AnasaziFactory.hpp — creates a SolverManager from a name + ParameterList)
and ``Anasazi::BasicEigenproblem`` (AnasaziBasicEigenproblem.hpp — holds
the operator, preconditioner, nev, symmetry flag, and initial vector; the
solver managers read nev/initvec from the problem, not the list).

Parameter names follow the Anasazi SolMgr surface
(AnasaziBlockKrylovSchurSolMgr.hpp:? "Which", "Block Size", "Num Blocks",
"Maximum Restarts", "Convergence Tolerance", "Maximum Iterations") with
the same defaults where they exist.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

import jax.numpy as jnp

from ..parallel.comm import Comm, SerialComm
from ..utils.params import Param, ParameterList, make_params
from .davidson import block_davidson
from .gen_davidson import generalized_davidson
from .krylov_schur import block_krylov_schur
from .lanczos import lanczos_eigs
from .lobpcg import lobpcg, power_method
from .rtr import rtr
from .tracemin import tracemin

ALIASES = {
    "BLOCK KRYLOV SCHUR": "bks",
    "BLOCK_KRYLOV_SCHUR": "bks",
    "BKS": "bks",
    "LOBPCG": "lobpcg",
    "BLOCK DAVIDSON": "davidson",
    "BLOCK_DAVIDSON": "davidson",
    "GENERALIZED DAVIDSON": "gen_davidson",
    "GENERALIZED_DAVIDSON": "gen_davidson",
    "TRACE MIN": "tracemin",
    "TRACEMIN": "tracemin",
    "RTR": "rtr",
    "LANCZOS": "lanczos",
    "POWER": "power",
}

_SPECS = {
    # Anasazi sorts by "Which" ∈ {LM, SM, LR, SR} (AnasaziBasicSort.hpp)
    "Which": Param("Which", "LM", choices=("LM", "SM", "LR", "SR",
                                           "SA", "LA")),
    "Block Size": Param("Block Size", 0),       # 0 → solver default
    "Num Blocks": Param("Num Blocks", 0),       # 0 → solver default
    "Maximum Restarts": Param("Maximum Restarts", 20),
    "Convergence Tolerance": Param("Convergence Tolerance", 1e-8),
    "Maximum Iterations": Param("Maximum Iterations", 200),
    "Inner Iterations": Param("Inner Iterations", 15),  # TraceMin CG steps
    # Block Davidson locking (AnasaziBlockDavidsonSolMgr.hpp:153-157)
    "Use Locking": Param("Use Locking", False),
    "Locking Tolerance": Param("Locking Tolerance", 0.0),  # 0 → 0.1·tol
    "Max Locked": Param("Max Locked", 0),                  # 0 → nev
}

# symmetric-solver 'which' vocabulary: Anasazi sorts symmetric spectra by
# real part (SR/LR); davidson/lobpcg here use SA/LA and SM/LM respectively
_SYM_WHICH = {"SR": "SA", "SM": "SA", "SA": "SA",
              "LR": "LA", "LM": "LA", "LA": "LA"}
_LOBPCG_WHICH = {"SR": "SM", "SM": "SM", "SA": "SM",
                 "LR": "LM", "LM": "LM", "LA": "LM"}


def eigensolver_names() -> tuple[str, ...]:
    return tuple(sorted(ALIASES))


@dataclasses.dataclass
class EigenProblem:
    """Anasazi::BasicEigenproblem: operator + nev + symmetry + optional
    preconditioner/initial block. ``n`` is the (padded) vector length the
    operator acts on."""
    op: Callable
    n: int
    nev: int
    symmetric: bool = True      # setHermitian
    prec: Callable | None = None
    v0: np.ndarray | None = None  # initial block (n, w) or vector (n,)
    dtype: object = jnp.float64
    # optional SPD mass operator -> GENERALIZED pencil A x = lam M x
    # (BasicEigenproblem setM, AnasaziBasicEigenproblem.hpp:60); honored
    # by every symmetric kind (LOBPCG / TraceMin / Block Krylov-Schur /
    # Block Davidson / RTR) plus Generalized Davidson
    m: Callable | None = None


class EigenSolverManager:
    """Parameter-driven wrapper around one eigensolver driver."""

    def __init__(self, name: str, params: ParameterList | dict | None = None,
                 comm: Comm | None = None):
        key = name.strip().upper()
        if key not in ALIASES:
            raise ValueError(
                f"unknown eigensolver {name!r}; valid: {eigensolver_names()}")
        self.name = name
        self.kind = ALIASES[key]
        self.params = make_params(params)
        self.params.validate(_SPECS, strict=False)
        self.comm = comm or SerialComm()

    def _v0(self, problem: EigenProblem, width: int):
        if problem.v0 is not None:
            return jnp.asarray(problem.v0, dtype=problem.dtype)
        if width == 0:
            v = np.random.default_rng(7).standard_normal(problem.n)
        else:
            v = np.random.default_rng(7).standard_normal((problem.n, width))
        return jnp.asarray(v, dtype=problem.dtype)

    def solve(self, problem: EigenProblem):
        p = self.params
        tol = float(p["Convergence Tolerance"])
        maxiter = int(p["Maximum Iterations"])
        which = str(p["Which"])
        nev = problem.nev
        bs = int(p["Block Size"]) or 0
        nb = int(p["Num Blocks"]) or 0
        comm = self.comm
        op, n, dtype = problem.op, problem.n, problem.dtype

        if problem.m is not None and self.kind not in (
                "bks", "lobpcg", "tracemin", "davidson", "gen_davidson",
                "rtr"):
            # honest surface: only these kinds honor the generalized
            # pencil (Anasazi setM) — silently returning standard-problem
            # eigenpairs for Ax=λMx would be numerically wrong
            raise ValueError(
                f"{self.name!r} does not support a mass matrix (M); "
                "use 'Block Krylov-Schur', 'LOBPCG', 'TraceMin', "
                "'Block Davidson', 'Generalized Davidson', or 'RTR' "
                "for generalized problems")

        if self.kind == "bks":
            kw = dict(which=which, tol=tol,
                      max_restarts=int(p["Maximum Restarts"]),
                      symmetric=problem.symmetric, comm=comm, dtype=dtype)
            if bs:
                kw["nb"] = bs
            if nb:
                kw["m"] = nb * max(bs, 1)
            if problem.v0 is not None:
                kw["v0"] = jnp.asarray(problem.v0, dtype=dtype)
            if problem.m is not None:
                kw["mass"] = problem.m
            return block_krylov_schur(op, n, nev, **kw)
        if self.kind == "lobpcg":
            v0 = self._v0(problem, bs or nev)
            return lobpcg(op, v0, prec=problem.prec, m=problem.m,
                          which=_LOBPCG_WHICH[which], tol=tol,
                          maxiter=maxiter, comm=comm)
        if self.kind == "davidson":
            return block_davidson(
                op, n, nev, nb=bs or None,
                smax=(nb * bs) if (nb and bs) else None, prec=problem.prec,
                which=_SYM_WHICH[which], tol=tol, maxiter=maxiter,
                v0=(jnp.asarray(problem.v0, dtype=dtype)
                    if problem.v0 is not None else None),
                comm=comm, dtype=dtype, m=problem.m,
                locking=bool(p["Use Locking"]),
                lock_tol=float(p["Locking Tolerance"]) or None,
                max_locked=int(p["Max Locked"]) or None)
        if self.kind == "gen_davidson":
            return generalized_davidson(
                op, n, nev, nb=bs or None,
                smax=(nb * bs) if (nb and bs) else None, prec=problem.prec,
                which=which, tol=tol, maxiter=maxiter,
                v0=(jnp.asarray(problem.v0, dtype=dtype)
                    if problem.v0 is not None else None),
                comm=comm, dtype=dtype, m=problem.m)
        if self.kind == "tracemin":
            return tracemin(op, n, nev, block=bs or None, m=problem.m,
                            inner_iters=int(p["Inner Iterations"]), tol=tol,
                            maxiter=maxiter,
                            v0=(jnp.asarray(problem.v0, dtype=dtype)
                                if problem.v0 is not None else None),
                            comm=comm, dtype=dtype)
        if self.kind == "rtr":
            return rtr(op, n, nev, block=bs or None, tol=tol,
                       maxiter=maxiter,
                       v0=(jnp.asarray(problem.v0, dtype=dtype)
                           if problem.v0 is not None else None),
                       comm=comm, dtype=dtype, m=problem.m)
        if self.kind == "lanczos":
            v0 = self._v0(problem, 0)
            return lanczos_eigs(op, v0, nev, m=(nb or None), which=which,
                                comm=comm)
        if self.kind == "power":
            v0 = self._v0(problem, 0)
            return power_method(op, v0, maxiter=maxiter, tol=tol, comm=comm)
        raise AssertionError(self.kind)


def create_eigensolver(name: str, params=None,
                       comm: Comm | None = None) -> EigenSolverManager:
    """Anasazi::Factory::create analogue."""
    return EigenSolverManager(name, params, comm)
