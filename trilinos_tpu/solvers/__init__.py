from .base import Operator, SolveResult, identity_prec
from .cg import cg, cg_pipeline, cg_single_reduce, stochastic_cg
from .gmres import fgmres, gmres
from .gmres_ca import gmres_pipeline, gmres_single_reduce
from .block_gmres import block_gmres
from .bicgstab import bicgstab
from .minres import minres
from .tfqmr import tfqmr
from .lsqr import fixed_point, lsqr
from .gcrodr import RecycleSpace, gcrodr
from .block_gcrodr import block_gcrodr
from .rcg import CgRecycleSpace, pcpg, rcg
from .sstep_gmres import sstep_gmres
from .block_cg import block_cg
from .direct import SparseCholesky, SparseLu, direct_solve
from .pliris import dense_solve, dist_dense_solve
from .linear_problem import LinearProblem
from .factory import SolverManager, build, create_solver, solver_names
from . import ortho, status

__all__ = [
    "Operator",
    "SolveResult",
    "identity_prec",
    "cg",
    "cg_pipeline",
    "cg_single_reduce",
    "stochastic_cg",
    "gmres",
    "fgmres",
    "gmres_single_reduce",
    "gmres_pipeline",
    "block_gmres",
    "bicgstab",
    "minres",
    "tfqmr",
    "lsqr",
    "fixed_point",
    "gcrodr",
    "block_gcrodr",
    "RecycleSpace",
    "sstep_gmres",
    "rcg",
    "CgRecycleSpace",
    "pcpg",
    "LinearProblem",
    "block_cg",
    "SparseCholesky",
    "SparseLu",
    "direct_solve",
    "dense_solve",
    "dist_dense_solve",
    "SolverManager",
    "build",
    "create_solver",
    "solver_names",
    "ortho",
    "status",
]
