"""Performance harness — runs on the GPU, one process.

    python bench.py

Prints ONE JSON line: the headline stored-matrix SpMV effective-bandwidth
metric (the analogue of the reference's SpMV roofline table,
packages/kokkos-kernels/perf_test/sparse/KokkosSparse_spmv.cpp:278, and of
the CG per-kernel timer harness,
packages/tpetra/core/test/PerformanceCGSolve/cg_solve_file.hpp:135-140),
with every other cell under "extra". The line names the platform, device
kind, device count, and the card's name and power limit. Without a GPU
the harness exits nonzero; a cell that fails fails the run.

Measurement methodology:
  * every kernel is timed inside ONE in-graph fori_loop of ``reps``
    applies (an optimization_barrier per rep keeps XLA from folding the
    chain), min of 3 calls after a warm-up call, reporting total/reps;
  * the copy ceiling is a plain XLA scale-copy of a 256³ f32 vector
    (read + write) timed the same way;
  * solver timing uses FRESH right-hand sides per call, generated ON
    DEVICE from a PRNG-key jit argument; matrices and the AMG hierarchy
    (SaAmg.state()) are jit arguments.

vs_baseline = achieved_GB/s / (0.70 × copy GB/s), i.e. ≥1.0 meets the
target (BASELINE.md: SpMV ≥70% of STREAM roofline). Every metric is
recorded in the value±tolerance perf archive (utils/perf_archive.py, the
Teuchos_XMLPerfTestArchive analogue), keyed by device kind.
"""
import json
import os
import sys
import time
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

ARCHIVE = os.environ.get("TT_PERF_ARCHIVE", "PERF_ARCHIVE.json")


def timed(fn, args, x, reps, repeats=3):
    """min-of-repeats of an in-graph reps-chain; returns seconds/rep."""
    @partial(jax.jit, static_argnums=0)
    def chain(reps_, *a):
        def body(i, v):
            return lax.optimization_barrier(fn(*a[:-1], v) * (1.0 / 7.0))
        return lax.fori_loop(0, reps_, body, a[-1])

    jax.block_until_ready(chain(reps, *args, x))  # compile + warm up
    best = 1e9
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(chain(reps, *args, x))
        best = min(best, time.perf_counter() - t0)
    return best / reps


def measure_copy(reps=300):
    """Read+write ceiling: a plain XLA scale-copy of a 256³ f32 vector."""
    n = 256 ** 3
    x = jnp.asarray(np.random.default_rng(0).standard_normal(n),
                    dtype=jnp.float32)
    dt = timed(lambda v: v, (), x, reps)
    return 2 * n * 4 / dt / 1e9


def bench_spmv(nx=256, ny=256, nz=256, dtype=np.float32, reps=150):
    """Stored-DIA SpMV (general-format headline)."""
    from trilinos_tpu.galeri import laplace3d
    from trilinos_tpu.ops import matvec as mv

    a = laplace3d(nx, ny, nz, dtype=dtype, fmt="dia")
    n = a.n_rows_pad
    x = jnp.asarray(np.random.default_rng(0).standard_normal(n),
                    dtype=dtype)
    dt = timed(lambda m, v: mv.spmv(m, v), (a,), x, reps)
    itemsize = np.dtype(dtype).itemsize
    useful = (a.data.shape[0] + 2) * n * itemsize
    return useful / dt / 1e9, a.nnz / dt, dt


def bench_spmv_bf16(nx=256, ny=256, nz=256, reps=300):
    """bf16 diagonal storage (f32 accumulate): ~halves the data stream."""
    from trilinos_tpu.galeri import laplace3d
    from trilinos_tpu.ops import matvec as mv

    a = laplace3d(nx, ny, nz, dtype=jnp.bfloat16, fmt="dia")
    n = a.n_rows_pad
    x = jnp.asarray(np.random.default_rng(0).standard_normal(n),
                    dtype=jnp.float32)
    dt = timed(lambda m, v: mv.spmv(m, v), (a,), x, reps)
    return a.nnz / dt, dt


def bench_stencil_op(nx=256, ny=256, nz=256, reps=300):
    """Matrix-free stencil operator: nnz/s."""
    from trilinos_tpu.galeri import laplace3d
    from trilinos_tpu.ops import matvec as mv

    op = laplace3d(nx, ny, nz, dtype=np.float32, fmt="stencil")
    n = op.n_rows_pad
    x = jnp.asarray(np.random.default_rng(0).standard_normal(n),
                    dtype=jnp.float32)
    dt = timed(lambda v: mv.spmv(op, v), (), x, reps)
    return op.nnz / dt, dt


def bench_spmm(nx=256, ny=256, nz=256, k=4, reps=100):
    """Multivector DIA SpMM (KokkosSparse_spmv.hpp:156 analogue)."""
    from trilinos_tpu.galeri import laplace3d
    from trilinos_tpu.ops import matvec as mv

    a = laplace3d(nx, ny, nz, dtype=np.float32, fmt="dia")
    xk = jnp.asarray(
        np.random.default_rng(2).standard_normal((a.n_rows_pad, k)),
        dtype=jnp.float32)
    dt = timed(lambda m, v: mv.spmv(m, v), (a,), xk, reps)
    agg = (a.data.shape[0] + 2 * k) * a.n_rows_pad * 4
    return agg / dt / 1e9, a.nnz * k / dt, dt


def bench_bdia(nx=1024, ny=512, reps=300):
    """Block-stencil (BDIA) apply on Q1 elasticity (b=2, 9 block
    offsets) on the interleaved vector (``bdia_spmm``;
    KokkosSparse_spmv_bsrmatrix_impl.hpp is the reference analogue)."""
    from trilinos_tpu.galeri import elasticity2d
    from trilinos_tpu.ops import csr_to_bdia
    from trilinos_tpu.ops import matvec as mv

    a = csr_to_bdia(elasticity2d(nx, ny, e_mod=1.0, dtype=np.float32), 2,
                    dtype=np.float32)
    x = jnp.asarray(
        np.random.default_rng(5).standard_normal(a.n_rows_pad),
        dtype=jnp.float32)
    dt = timed(lambda m, v: mv.spmv(m, v), (a,), x, reps)
    nd, b = len(a.offsets), a.block_size
    stored = (nd * b * b + 2 * b) * a.nbr_pad * 4
    return stored / dt / 1e9, a.nnz / dt, dt


def bench_cheb_poly(nx=256, ny=256, nz=256, degree=4, reps=150):
    """Degree-d Chebyshev sweep as one recurrence chain
    (ops/stencil.py ``stencil_poly_xla``). Reports the effective
    per-sweep nnz rate (degree * nnz / t)
    (Ifpack2_Details_ChebyshevKernel is the reference sweep)."""
    from trilinos_tpu.galeri import laplace3d
    from trilinos_tpu.ops.stencil import chebyshev_stages, stencil_poly_xla

    op = laplace3d(nx, ny, nz, dtype=np.float32, fmt="stencil")
    stages = chebyshev_stages(1.9, 0.06, degree, 1 / 6.0)
    n = op.n_rows_pad
    x = jnp.asarray(np.random.default_rng(6).standard_normal(n),
                    dtype=jnp.float32)
    dt = timed(lambda v: stencil_poly_xla(op, stages, v), (), x, reps)
    return degree * op.nnz / dt, dt


def bench_powers(nx=256, ny=256, nz=256, s=4, reps=150):
    """Matrix-powers basis u_1..u_s (the CA-GMRES basis generator,
    Belos_Tpetra_GmresSstep.hpp:305). Reports effective nnz rate
    s*nnz/t."""
    from trilinos_tpu.galeri import laplace3d
    from trilinos_tpu.ops.stencil import monomial_stages, stencil_powers_xla

    op = laplace3d(nx, ny, nz, dtype=np.float32, fmt="stencil")
    n = op.n_rows_pad
    x = jnp.asarray(np.random.default_rng(7).standard_normal(n),
                    dtype=jnp.float32)
    # sigma ~ ||A|| keeps the rep-chain feedback from overflowing
    stages = monomial_stages(s, sigma=12.0)
    dt = timed(lambda v: stencil_powers_xla(op, stages, v)[-1], (), x,
               reps)
    return s * op.nnz / dt, dt


def _device_rhs(npad, n):
    """Fresh on-device RHS from a PRNG key (fresh per timed call, zero
    host→device traffic)."""
    def mk(key):
        return jnp.where(jnp.arange(npad) < n,
                         jax.random.normal(key, (npad,), jnp.float32),
                         0.0)
    return mk


def _timed_solve(run, n_timed=3):
    """min over n_timed fresh keys of run(key), after a warm-up call;
    returns (last_result, best_seconds)."""
    jax.block_until_ready(run(jax.random.PRNGKey(0)))
    best = 1e9
    for i in range(n_timed):
        t0 = time.perf_counter()
        r = jax.block_until_ready(run(jax.random.PRNGKey(i + 1)))
        best = min(best, time.perf_counter() - t0)
    return r, best


def _timed_solve_chain(run_raw, extra_args=(), n_chain=8, n_timed=3):
    """Chain ``n_chain`` independent solves (fresh keys each → no
    result-caching/folding) inside ONE jitted lax.scan and report
    total/n_chain — the same big-reps rule the kernel benches follow,
    for solves short enough that per-call dispatch would dominate.
    Returns ((iters, max_resnorm) of the last chained solve,
    seconds/solve)."""
    @jax.jit
    def chain(keys, *extra):
        def body(carry, key):
            r = run_raw(key, *extra)
            return carry, (jnp.max(r.resnorm), r.iters)
        _, (rn, its) = lax.scan(body, 0, keys)
        return rn[-1], its[-1]

    keys = jax.random.split(jax.random.PRNGKey(0), n_chain)
    jax.block_until_ready(chain(keys, *extra_args))  # compile + warm up
    best = 1e9
    for i in range(n_timed):
        keys = jax.random.split(jax.random.PRNGKey(i + 1), n_chain)
        t0 = time.perf_counter()
        rn, its = jax.block_until_ready(chain(keys, *extra_args))
        best = min(best, time.perf_counter() - t0)
    return (int(its), float(rn)), best / n_chain


def bench_bdia_solve(nx=64, ny=64, nz=48, iters=400):
    """BDIA solve path on 3-D Q1 elasticity (27 block offsets, b=3): CG
    over the interleaved-vector apply — the block-matrix solve benchmark
    (Tpetra BlockCrs + Belos CG; Galeri_Elasticity3DProblem is the
    reference generator). Fresh RHS per timed call; reports
    iterations/s."""
    from trilinos_tpu.galeri import elasticity3d
    from trilinos_tpu.ops import csr_to_bdia
    from trilinos_tpu.ops import matvec as mv
    from trilinos_tpu.solvers import cg

    a = csr_to_bdia(elasticity3d(nx, ny, nz, e_mod=1.0,
                                 dtype=np.float32), 3, dtype=np.float32)
    mk = _device_rhs(a.n_rows_pad, a.n_rows_pad)
    run = jax.jit(lambda key: cg(lambda v: mv.spmv(a, v), mk(key),
                                 rtol=0.0, maxiter=iters))
    r, best = _timed_solve(run)
    per_it = best / max(int(r.iters), 1)
    return 1.0 / per_it, per_it


def bench_amg_pcg(nx=64, ny=64, nz=64, rtol=1e-5):
    """End-to-end AMG-preconditioned CG time-to-solution on Laplace3D:
    structured-aggregation hierarchy — matrix-free stencil fine level,
    reshape transfers, exact boundary-classified Galerkin DIA coarse
    levels (the KokkosSparse_pcg.cpp / MueLu-preconditioned-solve
    analogue). Returns (iters, solve_seconds) — fresh RHS per timed
    call."""
    from trilinos_tpu.galeri import laplace3d
    from trilinos_tpu.ops import matvec as mv
    from trilinos_tpu.precond import SaAmg
    from trilinos_tpu.solvers import cg

    op = laplace3d(nx, ny, nz, dtype=np.float32, fmt="stencil")
    m = SaAmg(op, {"dtype": np.float32}).compute()
    n, npad = op.n_rows, op.n_rows_pad
    mk = _device_rhs(npad, n)
    st = m.state()  # hierarchy as jit ARGUMENT (not baked constants)
    (iters, _), per_solve = _timed_solve_chain(
        lambda key, ss: cg(lambda v: mv.spmv(op, v), mk(key),
                           prec=lambda v: m.apply_state(ss, v), rtol=rtol,
                           maxiter=200),
        extra_args=(st,))
    return iters, per_solve


def bench_elasticity_amg(nx=32, ny=32, nz=24, rtol=1e-5):
    """Block-structured null-space AMG on 3-D Q1 elasticity (73k dofs):
    rigid-body-mode SA with gather-free BDIA levels
    (precond/block_amg.py; MueLu-on-elasticity analogue). Returns
    (iters, solve_seconds)."""
    from trilinos_tpu.galeri.fem import elasticity3d, rigid_body_modes
    from trilinos_tpu.ops import matvec as mv
    from trilinos_tpu.precond.block_amg import BlockStructuredAmg
    from trilinos_tpu.solvers import cg

    a = elasticity3d(nx, ny, nz, e_mod=1.0, dtype=np.float32)
    ns = rigid_body_modes(nx, ny, nz)
    m = BlockStructuredAmg(a, node_dims=(nx, ny, nz), nullspace=ns,
                           n_equations=3,
                           params={"dtype": np.float32,
                                   "coarse: max size": 3000}).compute()
    dev = m.levels[0]["a"]
    n, npad = a.shape[0], m.levels[0]["n_f"]
    mk = _device_rhs(npad, n)
    (iters, _), per_solve = _timed_solve_chain(
        lambda key: cg(lambda v: mv.spmv(dev, v), mk(key), prec=m,
                       rtol=rtol, maxiter=100))
    return iters, per_solve


def bench_ortho(n=2 * 1024 * 1024, k=8, reps=100):
    """Block orthogonalization throughput: CGS2 projection + CholQR2
    (belos_orthomanager_tpetra_benchmark.cpp analogue)."""
    from trilinos_tpu.parallel.comm import SerialComm
    from trilinos_tpu.solvers.ortho import cgs2_project, cholqr2

    comm = SerialComm()
    rng = np.random.default_rng(3)
    v = jnp.asarray(np.linalg.qr(rng.standard_normal((n, k)))[0],
                    dtype=jnp.float32)

    def step(basis, w):
        w2, _ = cgs2_project(comm, basis, w)
        q, _, _ = cholqr2(comm, w2)
        return q

    w0 = jnp.asarray(rng.standard_normal((n, k)), dtype=jnp.float32)
    dt = timed(lambda basis, w: step(basis, w), (v,), w0, reps)
    # CGS2: 4 GEMM passes (2 proj x (VtW + update)) + CholQR2 ~ 2 passes
    gb = (4 + 2) * n * k * 4 / 1e9
    return gb / dt, dt


def bench_cg(nx=128, ny=128, nz=128, iters=1000):
    """CG time per iteration over `iters` fixed iterations with FRESH
    right-hand sides per timed call."""
    from trilinos_tpu.galeri import laplace3d
    from trilinos_tpu.ops import matvec as mv
    from trilinos_tpu.solvers import cg_single_reduce

    op = laplace3d(nx, ny, nz, dtype=np.float32, fmt="stencil")
    n, npad = op.n_rows, op.n_rows_pad
    mk = _device_rhs(npad, n)
    run = jax.jit(lambda key: cg_single_reduce(
        lambda v: mv.spmv(op, v), mk(key), rtol=0.0, maxiter=iters))
    r, best = _timed_solve(run)
    per_it = best / max(int(r.iters), 1)
    return 1.0 / per_it, per_it


def bench_gmres(nx=128, ny=128, nz=128, restart=30, iters=120,
                basis_dtype=None):
    """GMRES(30) time per iteration (CGS2 ortho) on the Laplace3D
    stencil — the Belos BlockGmres hot loop (BelosBlockGmresIter.hpp:659:
    op apply + projectAndNormalize + Givens per step). Fixed iteration
    count (rtol=0) with fresh RHS per timed call, like bench_cg.
    ``basis_dtype=jnp.bfloat16`` measures the inexact-Krylov narrow
    basis storage (halved basis HBM traffic)."""
    from trilinos_tpu.galeri import laplace3d
    from trilinos_tpu.ops import matvec as mv
    from trilinos_tpu.solvers import gmres

    op = laplace3d(nx, ny, nz, dtype=np.float32, fmt="stencil")
    n, npad = op.n_rows, op.n_rows_pad
    mk = _device_rhs(npad, n)
    run = jax.jit(lambda key: gmres(
        lambda v: mv.spmv(op, v), mk(key), rtol=0.0, restart=restart,
        maxiter=iters, basis_dtype=basis_dtype))
    r, best = _timed_solve(run)
    per_it = best / max(int(r.iters), 1)
    return 1.0 / per_it, per_it


def bench_sstep_gmres(nx=128, ny=128, nz=128, s=4, t_blocks=8,
                      restarts=4, basis_dtype=None):
    """CA (s-step) GMRES per-basis-vector rate: the block
    orthogonalization costs 4 reductions per s vectors (the
    Belos_Tpetra_GmresSstep design goal, Belos_Tpetra_GmresSstep.hpp:305).
    Fixed work (rtol=0), fresh device RHS; sigma is the Laplace3D
    operator-norm scale (estimate_opnorm cannot run with a traced
    RHS)."""
    from trilinos_tpu.galeri import laplace3d
    from trilinos_tpu.solvers import sstep_gmres

    op = laplace3d(nx, ny, nz, dtype=np.float32, fmt="stencil")
    n, npad = op.n_rows, op.n_rows_pad
    mk = _device_rhs(npad, n)
    run = jax.jit(lambda key: sstep_gmres(
        op, mk(key), s=s, t_blocks=t_blocks, max_restarts=restarts,
        rtol=0.0, sigma=12.0, basis_dtype=basis_dtype))
    r, best = _timed_solve(run)
    per_it = best / max(int(r.iters), 1)
    return 1.0 / per_it, per_it


def card() -> str:
    """`name, power.limit` of the first card."""
    from chip_smoke import nvidia_smi

    return nvidia_smi().splitlines()[0]


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX found {dev.platform}")
    from trilinos_tpu.utils.compile_cache import enable_compile_cache
    from trilinos_tpu.utils.perf_archive import PerfArchive

    enable_compile_cache()
    card_line = card()
    copy = measure_copy()
    gbps, nnz_s, t_apply = bench_spmv()
    st_nnz_s, st_t = bench_stencil_op()
    bf_nnz_s, bf_t = bench_spmv_bf16()
    mm_gbps, mm_nnz_s, mm_t = bench_spmm()
    bd_gbps, bd_nnz_s, bd_t = bench_bdia()
    cf_nnz_s, cf_t = bench_cheb_poly()
    pw_nnz_s, pw_t = bench_powers()
    bds_iters_s, bds_it_t = bench_bdia_solve()
    ortho_gbps, ortho_t = bench_ortho()
    cg_iters_s, cg_it_t = bench_cg()
    gm_iters_s, gm_it_t = bench_gmres()
    gmb_iters_s, gmb_it_t = bench_gmres(basis_dtype=jnp.bfloat16)
    ca_iters_s, ca_it_t = bench_sstep_gmres()
    cab_iters_s, cab_it_t = bench_sstep_gmres(basis_dtype=jnp.bfloat16)
    amg_iters, amg_t = bench_amg_pcg()
    el_iters, el_t = bench_elasticity_amg()
    target = 0.70 * copy

    arch = PerfArchive(ARCHIVE, machine=dev.device_kind)
    statuses = {}
    for name, val in [("spmv_gbps", gbps),
                      ("stencil_gnnz", st_nnz_s / 1e9),
                      ("spmm_gbps", mm_gbps),
                      ("bdia_gbps", bd_gbps),
                      ("cheb4_poly_gnnz", cf_nnz_s / 1e9),
                      ("powers4_gnnz", pw_nnz_s / 1e9),
                      ("bdia_cg_iters_per_s", bds_iters_s),
                      ("ortho_gbps", ortho_gbps),
                      ("cg_iters_per_s", cg_iters_s),
                      ("gmres_iters_per_s", gm_iters_s),
                      ("gmres_bf16_iters_per_s", gmb_iters_s),
                      ("sstep_gmres_iters_per_s", ca_iters_s),
                      ("sstep_gmres_bf16_iters_per_s", cab_iters_s),
                      ("amg_pcg_solves_per_s", 1.0 / amg_t),
                      ("elasticity_amg_solves_per_s", 1.0 / el_t),
                      ("copy_gbps", copy)]:
        r = arch.check(name, val, tol=1.20, higher_is_better=True)
        statuses[name] = r.status

    print(json.dumps({
        "metric": "spmv_effective_bandwidth",
        "value": gbps,
        "unit": "GB/s",
        "vs_baseline": gbps / target,
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "card": card_line,
        "extra": {
            "copy_gbps": copy,
            "spmv_nnz_per_s_G": nnz_s / 1e9,
            "spmv_apply_ms": t_apply * 1e3,
            "stencil_op_nnz_per_s_G": st_nnz_s / 1e9,
            "stencil_op_apply_ms": st_t * 1e3,
            "spmv_bf16_nnz_per_s_G": bf_nnz_s / 1e9,
            "spmv_bf16_apply_ms": bf_t * 1e3,
            "spmm_k4_gbps": mm_gbps,
            "spmm_k4_nnz_per_s_G": mm_nnz_s / 1e9,
            "spmm_k4_apply_ms": mm_t * 1e3,
            "bdia_elasticity_gbps": bd_gbps,
            "bdia_nnz_per_s_G": bd_nnz_s / 1e9,
            "bdia_apply_ms": bd_t * 1e3,
            "cheb4_poly_nnz_per_s_G": cf_nnz_s / 1e9,
            "cheb4_poly_sweep_ms": cf_t * 1e3,
            "powers4_nnz_per_s_G": pw_nnz_s / 1e9,
            "powers4_block_ms": pw_t * 1e3,
            "bdia_cg_iters_per_s": bds_iters_s,
            "bdia_cg_iter_ms": bds_it_t * 1e3,
            "ortho_gbps": ortho_gbps,
            "ortho_ms": ortho_t * 1e3,
            "cg_iters_per_s": cg_iters_s,
            "cg_iter_ms": cg_it_t * 1e3,
            "gmres_iters_per_s": gm_iters_s,
            "gmres_iter_ms": gm_it_t * 1e3,
            "gmres_bf16_iters_per_s": gmb_iters_s,
            "gmres_bf16_iter_ms": gmb_it_t * 1e3,
            "sstep_gmres_iters_per_s": ca_iters_s,
            "sstep_gmres_iter_ms": ca_it_t * 1e3,
            "sstep_gmres_bf16_iters_per_s": cab_iters_s,
            "sstep_gmres_bf16_iter_ms": cab_it_t * 1e3,
            "amg_pcg_iters_64^3": amg_iters,
            "amg_pcg_solve_ms": amg_t * 1e3,
            "elasticity_amg_iters_73k": el_iters,
            "elasticity_amg_solve_ms": el_t * 1e3,
            "perf_archive": statuses,
            "timing": "in-graph rep chains, min of 3 after warm-up; "
                      "fresh on-device RHS per solve",
            "problem": "Laplace3D 256^3 (SpMV/SpMM k=4), 128^3 (CG), f32",
        },
    }))


if __name__ == "__main__":
    main()
