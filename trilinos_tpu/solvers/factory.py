"""Solver factory and SolverManager: string + ParameterList driven solves.

JAX analogue of ``Belos::SolverFactory``
(packages/belos/src/BelosSolverFactory.hpp) with the alias table of
``Belos::Details::EBelosSolverType`` (src/Belos_Details_EBelosSolverType.cpp:
61-122), and of the SolverManager parameter surface
(packages/belos/src/BelosBlockGmresSolMgr.hpp:150-158,323-337; defaults
src/BelosTypes.hpp:291-313 — "Convergence Tolerance" 1e-8, "Maximum
Iterations", "Num Blocks", "Maximum Restarts", "Orthogonalization").

Verbosity note: solves compile to single jitted programs, so per-iteration
printing (StatusTestOutput) is not available inside the loop; the manager
prints the final summary (FINAL_SUMMARY verbosity) after the solve.
"""
from __future__ import annotations

from typing import Callable

import jax.numpy as jnp

from ..parallel.comm import Comm, SerialComm
from ..utils.output import MsgType, OutputManager
from ..utils.params import Param, ParameterList, make_params
from .base import SolveResult
from .bicgstab import bicgstab
from .block_gmres import block_gmres
from .cg import cg, cg_pipeline, cg_single_reduce, stochastic_cg
from .gmres import fgmres, gmres
from .linear_problem import LinearProblem
from .lsqr import fixed_point, lsqr
from .minres import minres
from .tfqmr import tfqmr

# canonical name -> implementation key (mirrors the reference alias table)
ALIASES = {
    "CG": "cg",
    "PSEUDOBLOCK CG": "cg",
    "PSEUDO BLOCK CG": "cg",
    "BLOCK CG": "block_cg",
    "SINGLE REDUCE CG": "cg_single_reduce",
    "PSEUDOBLOCK STOCHASTIC CG": "stochastic_cg",
    "STOCHASTIC CG": "stochastic_cg",
    "PIPELINED CG": "cg_pipeline",
    "GMRES": "gmres",
    "PSEUDOBLOCK GMRES": "gmres",
    "PSEUDO BLOCK GMRES": "gmres",
    "BLOCK GMRES": "block_gmres",
    "FLEXIBLE GMRES": "fgmres",
    "BICGSTAB": "bicgstab",
    "MINRES": "minres",
    "TFQMR": "tfqmr",
    "PSEUDOBLOCK TFQMR": "tfqmr",
    "LSQR": "lsqr",
    "FIXED POINT": "fixed_point",
    "GCRODR": "gcrodr",
    "S-STEP GMRES": "sstep",
    "SINGLE REDUCE GMRES": "gmres_sr",
    "PIPELINED GMRES": "gmres_pipe",
    "RCG": "rcg",
    "PCPG": "pcpg",
    "CA-GMRES": "sstep",
    "BLOCK GCRODR": "block_gcrodr",
    # GmresPolySolMgr (BelosGmresPolySolMgr.hpp): build the GMRES
    # polynomial from the problem, run the outer solve with p(A) as the
    # (composed) right preconditioner
    "HYBRID BLOCK GMRES": "hybrid_gmres",
    "GMRESPOLY": "hybrid_gmres",
    "SEED GMRES": "hybrid_gmres",
}

_SPECS = {
    "Convergence Tolerance": Param("Convergence Tolerance", 1e-8),
    "Maximum Iterations": Param("Maximum Iterations", 1000),
    "Num Blocks": Param("Num Blocks", 30),
    "Maximum Restarts": Param("Maximum Restarts", 20),
    "Block Size": Param("Block Size", 1),
    "Orthogonalization": Param("Orthogonalization", "ICGS",
                               choices=("DGKS", "ICGS", "IMGS", "CGS2",
                                        "MGS1")),
    "Verbosity": Param("Verbosity", int(MsgType.ERRORS)),
    "Damping": Param("Damping", 0.0),
    "Num Recycled Blocks": Param("Num Recycled Blocks", 8),
    "Step Size": Param("Step Size", 4),
    # s-step basis: Newton computes Leja-ordered Ritz shifts from an
    # s-step Arnoldi on b before the solve (better conditioned for
    # larger Step Size)
    "Step Basis": Param("Step Basis", "Monomial",
                        choices=("Monomial", "Newton")),
    "Fixed Point Omega": Param("Fixed Point Omega", 1.0),
    # GmresPolySolMgr: degree of the GMRES polynomial built before the
    # outer solve (reference default 25, BelosGmresPolySolMgr.hpp)
    "Maximum Degree": Param("Maximum Degree", 25),
    # AZ_cg_condnum / AZ_condnum analogue: CG records this many
    # coefficient pairs for the free Lanczos condition estimate; GMRES
    # treats any nonzero value as "report the Hessenberg singular-range
    # estimate". Both land in SolveResult.condest.
    "Estimate Condition Number": Param("Estimate Condition Number", 0),
    # StatusTestOutput residual-trace analogue: record per-iteration
    # implicit resnorms into SolveResult.history (CG/GMRES kinds)
    "Record Residual History": Param("Record Residual History", False),
    # JAX-native extension (no Belos counterpart): store the Krylov
    # basis in bf16 (GMRES / Flexible GMRES / Block GMRES kinds) —
    # halves basis HBM traffic;
    # restarts are true-residual-gated so the certified convergence
    # surface is unchanged
    "Basis Precision": Param("Basis Precision", "default",
                             choices=("default", "bf16")),
}


def solver_names() -> tuple[str, ...]:
    return tuple(sorted(ALIASES))


class SolverManager:
    """Parameter-driven wrapper around one Krylov driver."""

    def __init__(self, name: str, params: ParameterList | dict | None = None,
                 comm: Comm | None = None):
        key = name.strip().upper()
        if key not in ALIASES:
            raise ValueError(
                f"unknown solver {name!r}; valid: {solver_names()}")
        self.name = name
        self.kind = ALIASES[key]
        self.params = make_params(params)
        self.params.validate(_SPECS, strict=False)
        self.comm = comm or SerialComm()
        self.output = OutputManager(self.params["Verbosity"])

    def solve(self, problem: LinearProblem) -> SolveResult:
        problem.set_problem()
        p = self.params
        rtol = float(p["Convergence Tolerance"])
        maxiter = int(p["Maximum Iterations"])
        common = dict(rtol=rtol, comm=self.comm)
        op = problem.op
        b = problem.b
        x0 = problem.x0
        ortho = str(p["Orthogonalization"])
        hist = bool(p["Record Residual History"])
        basis_dtype = (jnp.bfloat16
                       if str(p["Basis Precision"]) == "bf16" else None)
        if basis_dtype is not None and self.kind not in (
                "gmres", "fgmres", "block_gmres", "sstep", "hybrid_gmres"):
            # honest surface (the IMGS lesson): kinds whose iteration
            # does not implement narrow-basis storage raise instead of
            # silently solving with the full-precision basis
            raise ValueError(
                f"{self.name!r} does not implement 'Basis Precision': "
                "'bf16'; supported kinds: GMRES, Flexible GMRES, Block "
                "GMRES, S-STEP/CA-GMRES, Hybrid Block GMRES")
        if self.kind == "cg":
            res = cg(op, b, x0, prec=problem.left_prec
                     or problem.right_prec, maxiter=maxiter,
                     condest_window=int(p["Estimate Condition Number"]),
                     history=hist, stop=getattr(problem, "stop_test", None),
                     **common)
        elif self.kind == "block_cg":
            from .block_cg import block_cg

            res = block_cg(op, b, x0, prec=problem.left_prec
                           or problem.right_prec, maxiter=maxiter,
                           **common)
        elif self.kind == "hybrid_gmres":
            from ..precond.poly import gmres_poly_apply, gmres_poly_setup

            m_user = problem.right_prec or problem.left_prec
            op_eff = (op if m_user is None
                      else (lambda v: op(m_user(v))))
            seed = b if b.ndim == 1 else b[:, 0]
            if float(jnp.linalg.norm(seed)) == 0.0:
                # a zero seed cannot build an Arnoldi polynomial (the
                # normalization is 0/0); fall back to plain GMRES,
                # which returns x = 0 converged like every other kind
                comp = m_user
            else:
                h, y, deg = gmres_poly_setup(op_eff, seed,
                                             int(p["Maximum Degree"]))
                poly = lambda v: gmres_poly_apply(op_eff, h, y, deg, v)
                comp = (poly if m_user is None
                        else (lambda v: m_user(poly(v))))
            res = gmres(op, b, x0, prec=comp,
                        restart=int(p["Num Blocks"]),
                        maxiter=maxiter, ortho=ortho,
                        basis_dtype=basis_dtype, **common)
        elif self.kind == "cg_single_reduce":
            res = cg_single_reduce(op, b, x0, prec=problem.left_prec
                                   or problem.right_prec, maxiter=maxiter,
                                   **common)
        elif self.kind == "cg_pipeline":
            res = cg_pipeline(op, b, x0, prec=problem.left_prec
                              or problem.right_prec, maxiter=maxiter,
                              **common)
        elif self.kind == "stochastic_cg":
            res, self.stochastic_vector = stochastic_cg(
                op, b, x0, prec=problem.left_prec or problem.right_prec,
                maxiter=maxiter, **common)
        elif self.kind in ("gmres_sr", "gmres_pipe"):
            from .gmres_ca import gmres_pipeline, gmres_single_reduce

            fn = (gmres_single_reduce if self.kind == "gmres_sr"
                  else gmres_pipeline)
            res = fn(op, b, x0, prec=problem.right_prec or problem.left_prec,
                     restart=int(p["Num Blocks"]), maxiter=maxiter, **common)
        elif self.kind in ("gmres", "fgmres"):
            fn = fgmres if self.kind == "fgmres" else gmres
            res = fn(op, b, x0, prec=problem.right_prec or problem.left_prec,
                     restart=int(p["Num Blocks"]), maxiter=maxiter,
                     ortho=ortho,
                     condest=bool(int(p["Estimate Condition Number"])),
                     history=hist, stop=getattr(problem, "stop_test", None),
                     basis_dtype=basis_dtype, **common)
        elif self.kind == "block_gmres":
            bb = b[:, None] if b.ndim == 1 else b
            xx = x0[:, None] if (x0 is not None and x0.ndim == 1) else x0
            res = block_gmres(op, bb, xx,
                              prec=problem.right_prec or problem.left_prec,
                              num_blocks=int(p["Num Blocks"]),
                              max_restarts=int(p["Maximum Restarts"]),
                              ortho=ortho, basis_dtype=basis_dtype,
                              **common)
            if b.ndim == 1:
                res = SolveResult(x=res.x[:, 0], iters=res.iters,
                                  resnorm=res.resnorm[0],
                                  converged=res.converged[0])
        elif self.kind == "bicgstab":
            res = bicgstab(op, b, x0, prec=problem.right_prec
                           or problem.left_prec, maxiter=maxiter, **common)
        elif self.kind == "minres":
            res = minres(op, b, x0, prec=problem.left_prec
                         or problem.right_prec, maxiter=maxiter, **common)
        elif self.kind == "tfqmr":
            res = tfqmr(op, b, x0, prec=problem.right_prec
                        or problem.left_prec, maxiter=maxiter, **common)
        elif self.kind == "lsqr":
            op_t = getattr(problem, "op_t", None)
            if op_t is None:
                raise ValueError("LSQR needs problem.op_t (transpose apply)")
            res = lsqr(op, op_t, b, x0, maxiter=maxiter,
                       damp=float(p["Damping"]), **common)
        elif self.kind == "pcpg":
            from .rcg import pcpg

            basis = getattr(problem, "constraint_basis", None)
            if basis is None:
                raise ValueError(
                    "PCPG needs problem.constraint_basis (n, k) array")
            res = pcpg(op, b, basis, x0, maxiter=maxiter,
                       prec=problem.left_prec or problem.right_prec,
                       **common)
        elif self.kind == "rcg":
            from .rcg import rcg

            res, self.cg_recycle_space = rcg(
                op, b, x0,
                recycle_dim=int(p["Num Recycled Blocks"]),
                maxiter=maxiter,
                prec=problem.left_prec or problem.right_prec,
                recycle=getattr(self, "cg_recycle_space", None), **common)
        elif self.kind == "sstep":
            from .sstep_gmres import sstep_gmres

            sstep = int(p["Step Size"])
            shifts = None
            sstep_prec = problem.right_prec or problem.left_prec
            if str(p["Step Basis"]).lower() == "newton":
                from .sstep_gmres import ritz_shifts

                # shifts must target the spectrum of the SAME operator
                # the basis recurrence applies (op∘M when preconditioned)
                op_m = (op if sstep_prec is None
                        else (lambda v: op(sstep_prec(v))))
                shifts = ritz_shifts(op_m, b, sstep, comm=self.comm)
            res = sstep_gmres(
                op, b, x0, s=sstep,
                t_blocks=max(int(p["Num Blocks"]) // sstep, 1),
                max_restarts=int(p["Maximum Restarts"]), shifts=shifts,
                prec=sstep_prec, basis_dtype=basis_dtype, **common)
        elif self.kind == "gcrodr":
            from .gcrodr import gcrodr

            res, self.recycle_space = gcrodr(
                op, b, x0, num_blocks=int(p["Num Blocks"]),
                recycle_dim=int(p["Num Recycled Blocks"]),
                max_cycles=int(p["Maximum Restarts"]) + 1,
                prec=problem.right_prec or problem.left_prec,
                recycle=getattr(self, "recycle_space", None), **common)
        elif self.kind == "block_gcrodr":
            from .block_gcrodr import block_gcrodr
            from .gcrodr import gcrodr as _g

            # single RHS: the block algorithm at nb=1 IS scalar GCRO-DR
            fn = _g if b.ndim == 1 else block_gcrodr
            res, self.recycle_space = fn(
                op, b, x0, num_blocks=int(p["Num Blocks"]),
                recycle_dim=int(p["Num Recycled Blocks"]),
                max_cycles=int(p["Maximum Restarts"]) + 1,
                prec=problem.right_prec or problem.left_prec,
                recycle=getattr(self, "recycle_space", None), **common)
        elif self.kind == "fixed_point":
            res = fixed_point(op, b, x0, prec=problem.left_prec
                              or problem.right_prec, maxiter=maxiter,
                              omega=float(p["Fixed Point Omega"]), **common)
        else:  # pragma: no cover
            raise AssertionError(self.kind)
        self.output.print(
            MsgType.FINAL_SUMMARY,
            f"[{self.name}] iters={int(res.iters)} "
            f"resnorm={float(jnp.max(res.resnorm)):.3e} "
            f"converged={bool(jnp.all(res.converged))}")
        return res


def create_solver(name: str, params=None, comm: Comm | None = None
                  ) -> SolverManager:
    return SolverManager(name, params, comm)


def build(params: ParameterList | dict, a_csr=None, comm: Comm | None = None):
    """Stratimikos-style one-stop builder
    (packages/stratimikos/src/Stratimikos_DefaultLinearSolverBuilder.hpp):
    one ParameterList selects solver AND preconditioner.

    Layout:
        {"Linear Solver Type": "GMRES",
         "Solver Types": {"GMRES": {...solver params...}},
         "Preconditioner Type": "CHEBYSHEV",
         "Preconditioner Types": {"CHEBYSHEV": {...prec params...}}}

    Returns (solver_manager, preconditioner_or_None). ``a_csr`` is needed
    when a preconditioner is requested.
    """
    p = make_params(params)
    sname = p.get("Linear Solver Type", "CG")
    sparams = p.sublist("Solver Types").sublist(sname)
    mgr = SolverManager(sname, sparams, comm)
    pname = p.get("Preconditioner Type", "None")
    prec = None
    if pname and pname != "None":
        from .. import precond as _precond

        if a_csr is None:
            raise ValueError("preconditioner requested but no matrix given")
        pparams = p.sublist("Preconditioner Types").sublist(pname)
        prec = _precond.create(pname, a_csr, pparams).compute()
    return mgr, prec
