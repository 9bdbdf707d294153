#!/usr/bin/env python3
"""Smoke run of the solver core on the GPU, at Laplace3D 256^3 (16.7M rows).

    python chip_smoke.py             # one card: phases a-d
    python chip_smoke.py --chips 4   # four cards: the distributed phase e

Prints one JSON line per check (phase, card name and power limit, device
kind, compile / host-setup / steady seconds, iterations, error and its
tolerance), then the card line as nvidia-smi reports it, and as its last
line ``{"ok": true, "device": {...}}``. A failed check ends the run with a
nonzero exit and no ``ok`` line. There is no CPU path: without a GPU the
script exits at once.

Every answer is checked against a plain reference that does not use the
code under test: scipy.sparse CSR products of the host matrices Galeri
built, and numpy for the orthogonality checks.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback

import numpy as np

N = 256            # Laplace3D grid edge: 16.7M rows, a common per-GPU HPCG grid
ELASTICITY = (64, 64, 48)   # Q1 elasticity3d nodes: 590k dofs, 48M nnz
# Galeri's default recirc2d coefficients (convection-dominated). ILU(0)
# applied by fixed Jacobi sweeps on the triangular factors leaves
# GMRES(30) stagnating near 3e-4 relative residual at 256² and 512² (f32
# and f64 alike) and near 1.5e-3 at 1024² (3030 iterations on an H100),
# so the check asks for 5e-3.
RECIRC_DIFF = 1e-5
RECIRC_RTOL = 5e-3


class Report:
    """Prints one JSON line per check, tagged with the card and device."""

    def __init__(self, card: str, kind: str):
        self.card, self.kind = card, kind

    def __call__(self, phase: str, **fields) -> dict:
        line = {"phase": phase, "card": self.card, "device_kind": self.kind}
        line.update(fields)
        print(json.dumps(line), flush=True)
        return line


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def nvidia_smi() -> str:
    """`name, power.limit` of every card, read by a child that stays off
    JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def run_timed(fn, *args):
    """(compile_s, steady_s, out): compile ``fn`` for ``args`` ahead of
    time, run it once to warm up and once more timed."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    t_compile = time.perf_counter() - t0
    jax.block_until_ready(compiled(*args))
    t0 = time.perf_counter()
    out = jax.block_until_ready(compiled(*args))
    return t_compile, time.perf_counter() - t0, out


def rel_max(got: np.ndarray, want: np.ndarray) -> float:
    """Relative max-norm error."""
    scale = float(np.max(np.abs(want))) or 1.0
    return float(np.max(np.abs(np.asarray(got, np.float64) - want))) / scale


def true_rel_residual(a_sp, x: np.ndarray, b: np.ndarray) -> float:
    """‖b − A x‖ / ‖b‖ from the scipy CSR product, in f64."""
    x = np.asarray(x, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(b - a_sp @ x) / np.linalg.norm(b))


def padded(v: np.ndarray, n_pad: int, dtype) -> np.ndarray:
    out = np.zeros((n_pad,) + v.shape[1:], dtype)
    out[: v.shape[0]] = v
    return out


def scipy_csr(a):
    """CsrHost -> scipy CSR sharing its arrays."""
    import scipy.sparse as sp

    return sp.csr_matrix((a.vals, a.cols, a.row_ptr), shape=a.shape)


# ---------------------------------------------------------------------------
# a. SpMV parity, every format
# ---------------------------------------------------------------------------

TOL_SPMV = {"float32": 1e-6, "float64": 1e-13, "bfloat16": 1e-2}


def spmv_cases(n: int = N, el=ELASTICITY):
    """(name, host CSR, builder(dtype) -> device matrix, data dtypes)."""
    import jax.numpy as jnp

    from trilinos_tpu.galeri import brick3d, laplace3d
    from trilinos_tpu.galeri.fem import elasticity3d
    from trilinos_tpu.ops import csr_to_bdia, csr_to_bsr, csr_to_ell

    lap = laplace3d(n, n, n)
    yield ("stencil7", lap,
           lambda dt: laplace3d(n, n, n, dtype=dt, fmt="stencil"),
           (np.float32, np.float64))
    yield ("stencil27", brick3d(n, n, n),
           lambda dt: brick3d(n, n, n, dtype=dt, fmt="stencil"),
           (np.float32, np.float64))
    yield ("dia", lap, lambda dt: laplace3d(n, n, n, dtype=dt, fmt="dia"),
           (np.float32, np.float64, jnp.bfloat16))
    yield ("ell", lap, lambda dt: csr_to_ell(lap, dtype=dt),
           (np.float32, np.float64))
    yield ("bsr", lap, lambda dt: csr_to_bsr(lap, 2, dtype=dt),
           (np.float32, np.float64))
    el_csr = elasticity3d(*el, e_mod=1.0)
    yield ("bdia_b3", el_csr, lambda dt: csr_to_bdia(el_csr, 3, dtype=dt),
           (np.float32, np.float64))


def phase_spmv(report, n: int = N, el=ELASTICITY, seed: int = 0):
    """Forward and transpose, nrhs 1 and 4, against scipy CSR."""
    import jax.numpy as jnp

    from trilinos_tpu.ops import spmv

    for name, csr, build, dtypes in spmv_cases(n, el):
        a_sp = scipy_csr(csr)
        rows = csr.shape[0]
        # f32-representable inputs: one reference serves every dtype
        x4 = np.random.default_rng(seed).standard_normal(
            (rows, 4)).astype(np.float32).astype(np.float64)
        want = {False: a_sp @ x4, True: a_sp.T @ x4}
        for dt in dtypes:
            t0 = time.perf_counter()
            dev = build(dt)
            setup = time.perf_counter() - t0
            data_dt = np.dtype(dt).name
            vec_dt = np.float64 if data_dt == "float64" else np.float32
            tol = TOL_SPMV[data_dt]
            for transpose in (False, True):
                for k in (1, 4):
                    xk = x4[:, 0] if k == 1 else x4
                    x = jnp.asarray(padded(xk, dev.n_rows_pad, vec_dt))
                    comp, steady, y = run_timed(
                        lambda m, v, t=transpose: spmv(m, v, transpose=t),
                        dev, x)
                    ref = want[transpose][:, 0] if k == 1 else \
                        want[transpose]
                    err = rel_max(np.asarray(y)[:rows], ref)
                    report("a.spmv", format=name, dtype=data_dt,
                           transpose=transpose, nrhs=k, rows=rows,
                           compile_s=comp, setup_s=setup, steady_s=steady,
                           err=err, tol=tol)
                    check(err <= tol, f"spmv {name} {data_dt} T={transpose} "
                          f"k={k}: err {err:.3e} > {tol:.0e}")
                    setup = 0.0


# ---------------------------------------------------------------------------
# b. flagship: structured-AMG-preconditioned CG
# ---------------------------------------------------------------------------

def phase_flagship(report, n: int = N):
    """SaAmg structured hierarchy + certified CG: f32 to 1e-5, then the
    Belos tolerance 1e-8 in f64."""
    import jax.numpy as jnp

    from __graft_entry__ import flagship_solve
    from trilinos_tpu.galeri import laplace3d

    a_sp = scipy_csr(laplace3d(n, n, n))
    rows = a_sp.shape[0]
    b_host = np.random.default_rng(1).standard_normal(rows)
    for dt, rtol in ((np.float32, 1e-5), (np.float64, 1e-8)):
        t0 = time.perf_counter()
        solve, op, state = flagship_solve(n, dt, rtol, maxiter=100)
        setup = time.perf_counter() - t0
        report("b.amg_setup", dtype=np.dtype(dt).name, grid=n,
               setup_s=setup)
        b = jnp.asarray(padded(b_host.astype(dt), op.n_rows_pad, dt))
        comp, steady, res = run_timed(solve, b, state)
        true = true_rel_residual(a_sp, np.asarray(res.x)[:rows],
                                 np.asarray(b)[:rows])
        report("b.amg_cg", dtype=np.dtype(dt).name, grid=n,
               compile_s=comp, setup_s=setup, steady_s=steady,
               iters=int(res.iters), converged=bool(res.converged),
               err=true, tol=1.1 * rtol)
        check(bool(res.converged), f"flagship {dt}: not converged")
        check(true <= 1.1 * rtol,
              f"flagship {dt}: true residual {true:.3e} > 1.1*{rtol}")


# ---------------------------------------------------------------------------
# c. parameter-driven factory path
# ---------------------------------------------------------------------------

def arnoldi_ortho_err(op, prec, b, m: int) -> float:
    """‖VᵀV − I‖_max of an m-step Arnoldi basis built with the solvers'
    own CGS2 + CholQR2 routines on the preconditioned operator, Gram taken
    in f64."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from trilinos_tpu.parallel.comm import SerialComm
    from trilinos_tpu.solvers.ortho import cgs2_project, cholqr2

    comm = SerialComm()

    @jax.jit
    def basis(b):
        # unfilled columns stay zero, so every step projects against the
        # full (m+1)-column basis, as the solvers do
        v0 = cholqr2(comm, b[:, None])[0]
        vs = jnp.zeros((b.shape[0], m + 1), b.dtype).at[:, :1].set(v0)

        def step(j, vs):
            w = op(prec(lax.dynamic_index_in_dim(vs, j, 1, False)))
            w2, _ = cgs2_project(comm, vs, w[:, None])
            return lax.dynamic_update_slice_in_dim(
                vs, cholqr2(comm, w2)[0], j + 1, 1)

        v64 = lax.fori_loop(0, m, step, vs).astype(jnp.float64)
        return v64.T @ v64

    g = np.asarray(basis(b))
    return float(np.max(np.abs(g - np.eye(m + 1))))


def phase_factory(report, n2: int = 1024, n3: int = 128, m: int = 30):
    """``solvers.build`` + Block GMRES (CGS2) in f32: RILUK on recirc2d,
    CHEBYSHEV on stored-DIA Laplace3D."""
    import jax
    import jax.numpy as jnp

    from trilinos_tpu.galeri import laplace3d, recirc2d
    from trilinos_tpu.ops import choose_format, spmv
    from trilinos_tpu.solvers import LinearProblem, build

    cases = (
        ("recirc2d_riluk", lambda: recirc2d(n2, n2, diff=RECIRC_DIFF,
                                            dtype=np.float32),
         "RILUK", {}, RECIRC_RTOL),
        ("laplace3d_dia_chebyshev",
         lambda: laplace3d(n3, n3, n3, dtype=np.float32), "CHEBYSHEV",
         {"chebyshev: degree": 4}, 1e-5),
    )
    for name, make, pname, pparams, rtol in cases:
        t0 = time.perf_counter()
        a = make()
        dev = choose_format(a)
        mgr, prec = build({
            "Linear Solver Type": "Block GMRES",
            "Solver Types": {"Block GMRES": {
                "Num Blocks": m, "Orthogonalization": "CGS2",
                "Convergence Tolerance": rtol, "Maximum Restarts": 100}},
            "Preconditioner Type": pname,
            "Preconditioner Types": {pname: pparams},
        }, a_csr=a)
        setup = time.perf_counter() - t0
        rows = a.shape[0]
        b_host = np.random.default_rng(2).standard_normal(rows).astype(
            np.float32)
        b = jnp.asarray(padded(b_host, dev.n_rows_pad, np.float32))

        def solve():
            # the manager runs eagerly (it prints a summary); its solver
            # loop is compiled inside, so the first call pays compilation
            t0 = time.perf_counter()
            res = mgr.solve(LinearProblem(lambda v: spmv(dev, v), b,
                                          right_prec=prec))
            jax.block_until_ready(res.x)
            return time.perf_counter() - t0, res

        first, _ = solve()
        steady, res = solve()
        comp = first - steady
        true = true_rel_residual(scipy_csr(a), np.asarray(res.x)[:rows],
                                 b_host)
        ortho = arnoldi_ortho_err(lambda v: spmv(dev, v), prec, b, m)
        report("c.factory", case=name, rows=rows, compile_s=comp,
               setup_s=setup, steady_s=steady, iters=int(res.iters),
               converged=bool(res.converged), err=true, tol=1.1 * rtol,
               ortho_err=ortho, ortho_tol=1e-5)
        check(bool(res.converged), f"factory {name}: not converged")
        check(true <= 1.1 * rtol,
              f"factory {name}: true residual {true:.3e} > 1.1*{rtol}")
        check(ortho <= 1e-5, f"factory {name}: ‖VᵀV−I‖ {ortho:.3e} > 1e-5")


# ---------------------------------------------------------------------------
# d. the former hand-written kernel paths, now XLA
# ---------------------------------------------------------------------------

def phase_former_kernels(report, n: int = N, panel_rows: int = 2 ** 21):
    import jax.numpy as jnp

    from trilinos_tpu.galeri import laplace3d
    from trilinos_tpu.ops import spmv
    from trilinos_tpu.parallel.comm import SerialComm
    from trilinos_tpu.precond import SaAmg, create, fused_stencil_chebyshev
    from trilinos_tpu.solvers import gmres, sstep_gmres
    from trilinos_tpu.solvers.ortho import cholqr2
    from trilinos_tpu.solvers.sstep_gmres import estimate_opnorm, ritz_shifts

    op = laplace3d(n, n, n, dtype=np.float32, fmt="stencil")
    a_host = laplace3d(n, n, n, dtype=np.float32)
    a_sp = scipy_csr(a_host)
    rows = op.n_rows
    rng = np.random.default_rng(3)
    b_host = rng.standard_normal(rows).astype(np.float32)
    b = jnp.asarray(padded(b_host, op.n_rows_pad, np.float32))

    # Chebyshev polynomial on the stencil vs the Chebyshev class (stored
    # DIA) with the same bounds: the 7-point Laplacian's D⁻¹A ≤ 2
    degree, lmax = 3, 2.0
    t0 = time.perf_counter()
    fused = fused_stencil_chebyshev(op, degree=degree, lmax=lmax)
    cls = create("CHEBYSHEV", a_host, {
        "chebyshev: degree": degree, "chebyshev: max eigenvalue": lmax,
        "chebyshev: min eigenvalue": lmax / 30.0}).compute()
    setup = time.perf_counter() - t0
    comp, steady, y = run_timed(fused, b)
    want = np.asarray(cls.apply(b), np.float64)[:rows]
    err = rel_max(np.asarray(y)[:rows], want)
    report("d.chebyshev", degree=degree, compile_s=comp, setup_s=setup,
           steady_s=steady, err=err, tol=1e-5)
    check(err <= 1e-5, f"chebyshev: err {err:.3e} > 1e-5")

    # s-step GMRES (s = 4) against GMRES on the same system, right-
    # preconditioned by SaAmg with the polynomial smoother on the fine
    # level. The preconditioned spectrum is clustered, so the monomial
    # basis [w, Aw, A²w, A³w] is nearly dependent and its f32 CholQR
    # broke down (NaN) at 256³ on the card; the Newton basis with
    # Leja-ordered Ritz shifts is the standard fix.
    rtol = 1e-5
    t0 = time.perf_counter()
    amg = SaAmg(op, {"dtype": np.float32,
                     "smoother: type": "chebyshev"}).compute()

    def op_m(v):
        return spmv(op, amg.apply(v))

    sigma = estimate_opnorm(op_m, op.n_rows_pad, np.float32)
    shifts = ritz_shifts(op_m, b, 4)
    setup = time.perf_counter() - t0
    for name, solver in (
            ("sstep_gmres", lambda b, st: sstep_gmres(
                lambda v: spmv(op, v), b, s=4, t_blocks=8, rtol=rtol,
                sigma=sigma, shifts=shifts,
                prec=lambda v: amg.apply_state(st, v))),
            ("gmres", lambda b, st: gmres(
                lambda v: spmv(op, v), b, restart=32, maxiter=640,
                rtol=rtol, prec=lambda v: amg.apply_state(st, v)))):
        comp, steady, res = run_timed(solver, b, amg.state())
        true = true_rel_residual(a_sp, np.asarray(res.x)[:rows], b_host)
        report("d.krylov_amg_chebyshev", solver=name, compile_s=comp,
               setup_s=setup, steady_s=steady, iters=int(res.iters),
               converged=bool(res.converged), err=true, tol=1.1 * rtol)
        check(bool(res.converged) and true <= 1.1 * rtol,
              f"{name}: converged={bool(res.converged)} true {true:.3e}")
        setup = 0.0

    # CholQR2 on a tall panel
    w = jnp.asarray(rng.standard_normal((panel_rows, 8)), jnp.float32)
    comp, steady, (q, _, _) = run_timed(
        lambda w: cholqr2(SerialComm(), w), w)
    q64 = np.asarray(q, np.float64)
    err = float(np.max(np.abs(q64.T @ q64 - np.eye(8))))
    report("d.cholqr2", rows=panel_rows, cols=8, compile_s=comp,
           steady_s=steady, err=err, tol=1e-5)
    check(err <= 1e-5, f"cholqr2: ‖QᵀQ−I‖ {err:.3e} > 1e-5")


# ---------------------------------------------------------------------------
# e. distributed solves on four cards
# ---------------------------------------------------------------------------

def phase_distributed(report, n: int = N, n_dev: int = 4):
    """z-slab-sharded solves over make_mesh(n_dev), each against the same
    solve on one card in the same process."""
    import jax.numpy as jnp

    from __graft_entry__ import flagship_solve
    from trilinos_tpu.galeri import laplace3d
    from trilinos_tpu.ops import spmv
    from trilinos_tpu.parallel import driver as drv
    from trilinos_tpu.parallel.distmatrix import distribute_stencil
    from trilinos_tpu.solvers import cg, cg_pipeline, sstep_gmres
    from trilinos_tpu.solvers.sstep_gmres import estimate_opnorm

    mesh = drv.make_mesh(n_dev)
    check(mesh.devices.size == n_dev
          and len({d.id for d in mesh.devices.flat}) == n_dev,
          f"mesh spans {mesh.devices.size} devices, want {n_dev}")
    rtol = 1e-5
    t0 = time.perf_counter()
    op = laplace3d(n, n, n, dtype=np.float32, fmt="stencil")
    a_host = laplace3d(n, n, n, dtype=np.float32)
    ds = distribute_stencil(op, n_dev)
    rows = op.n_rows
    b_host = np.random.default_rng(4).standard_normal(rows).astype(
        np.float32)
    b1 = jnp.asarray(padded(b_host, op.n_rows_pad, np.float32))
    bg = jnp.asarray(ds.row_map.to_padded(b_host))
    dinv = np.ones(op.n_rows_pad, np.float32)
    dinv[:rows] = 1.0 / a_host.diagonal()
    dinv = jnp.asarray(dinv)
    jacobi = drv.dist_jacobi(a_host, ds.row_map)
    amg_dist = drv.dist_amg_structured(op, n_dev, dtype=np.float32)
    amg_single, _, amg_state = flagship_solve(n, np.float32, rtol,
                                              maxiter=100)
    sigma = estimate_opnorm(lambda v: spmv(op, v), op.n_rows_pad,
                            np.float32)
    setup = time.perf_counter() - t0
    cases = (
        ("cg_pipeline_jacobi",
         lambda b: drv.dist_solve(cg_pipeline, ds, b, mesh=mesh,
                                  prec=jacobi, rtol=rtol, maxiter=3000),
         lambda b, d: cg_pipeline(lambda v: spmv(op, v), b,
                                  prec=lambda v: d * v, rtol=rtol,
                                  maxiter=3000),
         (b1, dinv)),
        ("amg_structured_cg",
         lambda b: drv.dist_solve(cg, ds, b, mesh=mesh, prec=amg_dist,
                                  rtol=rtol, maxiter=100),
         amg_single, (b1, amg_state)),
        # fixed work: three restart cycles of GMRES(32)
        ("sstep_gmres_fused",
         lambda b: drv.dist_sstep_gmres(op, b, mesh=mesh, s=4, t_blocks=8,
                                        max_restarts=3, rtol=rtol,
                                        sigma=sigma, basis="fused"),
         lambda b: sstep_gmres(op, b, s=4, t_blocks=8, max_restarts=3,
                               rtol=rtol, sigma=sigma),
         (b1,)),
    )
    for name, dist, single, single_args in cases:
        comp_d, steady_d, res_d = run_timed(dist, bg)
        comp_s, steady_s, res_s = run_timed(single, *single_args)
        devs = res_d.x.sharding.device_set
        report("e.sharding", case=name, sharding=str(res_d.x.sharding),
               devices=len(devs))
        check(len(devs) == n_dev, f"{name}: result on {len(devs)} devices")
        x_d = ds.row_map.from_padded(np.asarray(res_d.x)).astype(np.float64)
        x_s = np.asarray(res_s.x, np.float64)[:rows]
        diff = float(np.linalg.norm(x_d - x_s) / np.linalg.norm(x_s))
        it_d, it_s = int(res_d.iters), int(res_s.iters)
        report("e.distributed", case=name, devices=n_dev, setup_s=setup,
               compile_s=comp_d, steady_s=steady_d, iters=it_d,
               single_compile_s=comp_s, single_steady_s=steady_s,
               single_iters=it_s, err=diff, tol=1e-4)
        check(abs(it_d - it_s) <= 1, f"{name}: iters {it_d} vs {it_s}")
        check(diff <= 1e-4, f"{name}: solution rel diff {diff:.3e} > 1e-4")
        setup = 0.0


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="4 runs only the distributed phase, on four cards")
    args = ap.parse_args(argv)
    try:
        import jax
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devices[0].platform})",
              file=sys.stderr)
        return 1
    if len(devices) < args.chips:
        print(f"chip_smoke: --chips {args.chips} but JAX found "
              f"{len(devices)} device(s)", file=sys.stderr)
        return 1
    try:
        from trilinos_tpu.utils.compile_cache import enable_compile_cache
    except ImportError as e:
        print(f"chip_smoke: the repository is not here ({e})",
              file=sys.stderr)
        return 2
    jax.config.update("jax_enable_x64", True)
    enable_compile_cache()
    card = nvidia_smi()
    report = Report(card.splitlines()[0], devices[0].device_kind)
    phases = ([phase_distributed] if args.chips == 4 else
              [phase_spmv, phase_flagship, phase_factory,
               phase_former_kernels])
    try:
        for phase in phases:
            t0 = time.perf_counter()
            phase(report)
            report(phase.__name__, wall_s=time.perf_counter() - t0)
    except Exception:  # every failure fails the run, with its traceback
        traceback.print_exc()
        return 1
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
