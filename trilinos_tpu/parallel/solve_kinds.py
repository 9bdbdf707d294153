"""Exhaustive distributed coverage of every factory solver kind.

The reference tests every Belos solver at 1..8 MPI ranks via a per-solver
CMake matrix (packages/belos/tpetra/test/BlockGmres/CMakeLists.txt:38
NUM_MPI_PROCS; same pattern for BlockCG/BiCGStab/...). The JAX analogue:
``run_all_solver_kinds(...)`` drives ONE distributed solve per
implementation kind in ``solvers.factory.ALIASES`` over a real
``jax.sharding.Mesh`` — fully-jitted drivers through ``dist_solve``
(shard_map), host-driven drivers (recycling spaces / polynomial setup
computed on host between device calls) through the global-view GSPMD
operator.

This module is the engine behind BOTH the driver's ``dryrun_multichip``
gate and the smoke-tier test (tests/test_smoke_solvers.py), closing the
round-3 coverage hole where a broken distributed GMRES passed the dryrun
because only CG-family kinds were exercised.
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp


def _shard_map_adapters(rtol: float, maxiter: int):
    """kind -> (adapter, rhs_ndim) for drivers that run entirely inside
    one shard_map program via ``driver.dist_solve``.

    Each adapter has the dist_solve solver signature
    ``(op, b, x0=..., prec=..., comm=...) -> SolveResult``."""
    from ..parallel.comm import norm2
    from ..solvers import (bicgstab, block_cg, block_gmres, cg, cg_pipeline,
                           cg_single_reduce, fgmres, fixed_point, gmres,
                           gmres_pipeline, gmres_single_reduce, minres,
                           pcpg, sstep_gmres, stochastic_cg, tfqmr)
    from ..solvers.base import SolveResult

    kw = dict(rtol=rtol, maxiter=maxiter)
    gkw = dict(rtol=rtol, maxiter=maxiter, restart=4)

    def first(fn):
        def run(op, b, x0=None, prec=None, comm=None, **extra):
            return fn(op, b, x0=x0, prec=prec, comm=comm, **extra)[0]
        return run

    def pcpg_adapter(op, b, x0=None, prec=None, comm=None):
        # constraint basis: the normalized RHS (any fixed subspace works
        # for a compile/exercise gate; FETI passes rigid-body modes)
        basis = (b / norm2(comm, b))[:, None]
        return pcpg(op, b, basis, x0, comm=comm, **kw)

    def sstep_adapter(op, b, x0=None, prec=None, comm=None):
        # sigma must be given: the host-side opnorm estimate cannot run
        # inside shard_map (same rule as driver.dist_sstep_gmres)
        return sstep_gmres(op, b, x0, s=2, t_blocks=2, max_restarts=1,
                           sigma=4.0, prec=prec,
                           rtol=rtol, comm=comm)

    def unblock(fn, **fkw):
        # run a block driver on a single RHS promoted to (n, 1), then
        # strip the column axis so out_specs match the 1-D pytree
        def run(op, b, x0=None, prec=None, comm=None):
            res = fn(op, b[:, None], None if x0 is None else x0[:, None],
                     prec=prec, comm=comm, **fkw)
            return SolveResult(x=res.x[:, 0], iters=res.iters,
                               resnorm=jnp.max(res.resnorm),
                               converged=jnp.all(res.converged))
        return run

    return {
        "cg": lambda op, b, x0=None, prec=None, comm=None:
            cg(op, b, x0, prec=prec, comm=comm, **kw),
        "cg_single_reduce": lambda op, b, x0=None, prec=None, comm=None:
            cg_single_reduce(op, b, x0, prec=prec, comm=comm, **kw),
        "cg_pipeline": lambda op, b, x0=None, prec=None, comm=None:
            cg_pipeline(op, b, x0, prec=prec, comm=comm, **kw),
        "stochastic_cg": first(lambda op, b, x0=None, prec=None, comm=None:
                               stochastic_cg(op, b, x0, prec=prec, comm=comm,
                                             **kw)),
        "block_cg": unblock(block_cg, **kw),
        "gmres": lambda op, b, x0=None, prec=None, comm=None:
            gmres(op, b, x0, prec=prec, comm=comm, **gkw),
        "fgmres": lambda op, b, x0=None, prec=None, comm=None:
            fgmres(op, b, x0, prec=prec, comm=comm, **gkw),
        "block_gmres": unblock(block_gmres, num_blocks=4, max_restarts=1,
                               rtol=rtol),
        "gmres_sr": lambda op, b, x0=None, prec=None, comm=None:
            gmres_single_reduce(op, b, x0, prec=prec, comm=comm, **gkw),
        "gmres_pipe": lambda op, b, x0=None, prec=None, comm=None:
            gmres_pipeline(op, b, x0, prec=prec, comm=comm, **gkw),
        "bicgstab": lambda op, b, x0=None, prec=None, comm=None:
            bicgstab(op, b, x0, prec=prec, comm=comm, **kw),
        "minres": lambda op, b, x0=None, prec=None, comm=None:
            minres(op, b, x0, prec=prec, comm=comm, **kw),
        "tfqmr": lambda op, b, x0=None, prec=None, comm=None:
            tfqmr(op, b, x0, prec=prec, comm=comm, **kw),
        "fixed_point": lambda op, b, x0=None, prec=None, comm=None:
            fixed_point(op, b, x0, prec=prec, comm=comm, omega=0.5, **kw),
        "pcpg": pcpg_adapter,
        "sstep": sstep_adapter,
    }


def _global_view_kinds(gop, gprec, bg, rtol: float, maxiter: int):
    """kind -> thunk for host-driven drivers (recycle-space eigensolves /
    polynomial Arnoldi run on host between jitted device calls): these use
    the GSPMD global-view operator, the distributed idiom the reference
    expresses through Anasazi/Belos over Tpetra operators."""
    from ..precond.poly import gmres_poly_apply, gmres_poly_setup
    from ..solvers import block_gcrodr, gcrodr, gmres, rcg

    def hybrid():
        h, y, deg = gmres_poly_setup(gop, bg, 4)
        poly = lambda v: gmres_poly_apply(gop, h, y, deg, v)
        return gmres(gop, bg, prec=poly, restart=4, rtol=rtol,
                     maxiter=maxiter)

    # gprec rides through the drivers' own prec= so a global_precond
    # plumbing regression over the mesh fails the gate
    return {
        "gcrodr": lambda: gcrodr(gop, bg, prec=gprec, num_blocks=4,
                                 recycle_dim=2, max_cycles=2,
                                 rtol=rtol)[0],
        "block_gcrodr": lambda: block_gcrodr(
            gop, jnp.stack([bg, 0.5 * bg], axis=1), prec=gprec,
            num_blocks=4, recycle_dim=2, max_cycles=2, rtol=rtol)[0],
        "rcg": lambda: rcg(gop, bg, prec=gprec, recycle_dim=2, rtol=rtol,
                           maxiter=maxiter)[0],
        "hybrid_gmres": hybrid,
    }


def run_all_solver_kinds(n_devices: int, *, rtol: float = 1e-4,
                         maxiter: int = 6, mesh=None) -> dict:
    """Distributed-solve every implementation kind the factory exposes on
    an ``n_devices`` ('rows',) mesh with a Jacobi DistPrecond; raises
    RuntimeError listing every kind that failed. Returns
    {kind: SolveResult}. Coverage is asserted against
    ``factory.ALIASES`` so adding a solver kind without wiring it here
    fails the dryrun."""
    from ..galeri import laplace2d
    from ..solvers import factory as fct
    from . import distmatrix as D
    from . import driver as drv

    adapters = _shard_map_adapters(rtol, maxiter)
    a = laplace2d(12, 2 * n_devices, dtype=np.float32)
    dm = D.distribute(a, n_devices)
    mesh = mesh or drv.make_mesh(n_devices)
    prec = drv.dist_jacobi(a, dm.row_map, dtype=np.float32)
    b = np.random.default_rng(0).standard_normal(
        a.shape[0]).astype(np.float32)
    bg = jnp.asarray(dm.row_map.to_padded(b))

    gop = drv.global_operator(dm, mesh)
    gprec = drv.global_precond(prec, dm, mesh)
    gkinds = _global_view_kinds(gop, gprec, bg, rtol, maxiter)

    all_kinds = set(fct.ALIASES.values())
    covered = (set(adapters) | set(gkinds)
               | {"lsqr"})  # lsqr runs via dist_lsqr (needs op + op_t)
    missing = all_kinds - covered
    if missing:
        raise RuntimeError(
            f"factory kinds with no distributed coverage: {sorted(missing)}"
            " — add adapters in parallel/solve_kinds.py")

    results, failures = {}, {}
    for kind in sorted(all_kinds):
        try:
            if kind == "lsqr":
                res = drv.dist_lsqr(dm, bg, mesh=mesh, rtol=rtol,
                                    maxiter=maxiter)
            elif kind in adapters:
                res = drv.dist_solve(adapters[kind], dm, bg, mesh=mesh,
                                     prec=prec)
            else:
                res = gkinds[kind]()
            jax.block_until_ready(res.x)
            if res.x.shape[0] != bg.shape[0]:
                raise AssertionError(
                    f"bad solution shape {res.x.shape} vs {bg.shape}")
            results[kind] = res
        except Exception as e:  # noqa: BLE001 — gate reports ALL failures
            failures[kind] = f"{type(e).__name__}: {e}"
    if failures:
        lines = "\n".join(f"  {k}: {v[:300]}" for k, v in
                          sorted(failures.items()))
        raise RuntimeError(
            f"{len(failures)} distributed solver kind(s) FAILED on the "
            f"{n_devices}-device mesh:\n{lines}")
    return results


def run_all_eigen_kinds(n_devices: int, *, tol: float = 1e-3,
                        maxiter: int = 40, mesh=None) -> dict:
    """Distributed-eigsolve every factory kind over the mesh — one small
    SPD standard problem per kind, plus the generalized pencil for every
    mass-aware kind (the Anasazi setM surface). Same contract as
    ``run_all_solver_kinds``: coverage asserted against
    ``eigen.factory.ALIASES``; raises listing every failing kind."""
    from ..eigen import (block_davidson, block_krylov_schur,
                         generalized_davidson, lanczos_eigs, lobpcg,
                         power_method, rtr, tracemin)
    from ..eigen import factory as efct
    from ..galeri import laplace2d
    from . import distmatrix as D
    from . import driver as drv

    a = laplace2d(8, 2 * n_devices, dtype=np.float64)
    dm = D.distribute(a, n_devices, fmt="ell")
    mesh = mesh or drv.make_mesh(n_devices)
    common = dict(mesh=mesh, tol=tol, maxiter=maxiter)

    def bks(**kw):
        return drv.dist_eigsolve(block_krylov_schur, dm, 2, mesh=mesh,
                                 tol=tol, **kw)

    runners = {
        "lobpcg": lambda: drv.dist_eigsolve(lobpcg, dm, 2, which="LM",
                                            **common),
        "davidson": lambda: drv.dist_eigsolve(block_davidson, dm, 2,
                                              which="LA", **common),
        "gen_davidson": lambda: drv.dist_eigsolve(
            generalized_davidson, dm, 2, which="LR", **common),
        "tracemin": lambda: drv.dist_eigsolve(tracemin, dm, 2, **common),
        "rtr": lambda: drv.dist_eigsolve(rtr, dm, 2, **common),
        "bks": bks,
        "lanczos": lambda: drv.dist_eigsolve(lanczos_eigs, dm, 2,
                                             mesh=mesh, which="LM"),
        "power": lambda: drv.dist_eigsolve(power_method, dm, 1, mesh=mesh,
                                           tol=tol, maxiter=maxiter),
        # mass-aware kinds again as PENCILS (M = the same SPD matrix →
        # eigenvalues 1; exercises the dist mass plumbing)
        "lobpcg+M": lambda: drv.dist_eigsolve(
            lobpcg, dm, 2, which="LM", mass_matrix=dm, **common),
        "davidson+M": lambda: drv.dist_eigsolve(
            block_davidson, dm, 2, which="LA", mass_matrix=dm, **common),
        "gen_davidson+M": lambda: drv.dist_eigsolve(
            generalized_davidson, dm, 2, which="LR", mass_matrix=dm,
            **common),
        "tracemin+M": lambda: drv.dist_eigsolve(
            tracemin, dm, 2, mass_matrix=dm, **common),
        "rtr+M": lambda: drv.dist_eigsolve(rtr, dm, 2, mass_matrix=dm,
                                           **common),
        "bks+M": lambda: bks(mass_matrix=dm, m_solve_iters=20),
    }
    missing = set(efct.ALIASES.values()) - {
        k.split("+")[0] for k in runners}
    if missing:
        raise RuntimeError(
            f"eigen kinds with no distributed coverage: {sorted(missing)}"
            " — add runners in parallel/solve_kinds.py")

    results, failures = {}, {}
    for kind, run in sorted(runners.items()):
        try:
            res = run()
            # lanczos_eigs returns (theta, vecs); the rest a result object
            ev = np.asarray(res[0] if isinstance(res, tuple)
                            else res.eigenvalues)
            if not np.all(np.isfinite(ev)):
                raise AssertionError(f"non-finite eigenvalues {ev}")
            results[kind] = res
        except Exception as e:  # noqa: BLE001 — gate reports ALL failures
            failures[kind] = f"{type(e).__name__}: {e}"
    if failures:
        lines = "\n".join(f"  {k}: {v[:300]}" for k, v in
                          sorted(failures.items()))
        raise RuntimeError(
            f"{len(failures)} distributed eigensolver kind(s) FAILED on "
            f"the {n_devices}-device mesh:\n{lines}")
    return results
