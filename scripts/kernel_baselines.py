"""Plain-XLA baselines of the paths that once had hand-written kernels,
beside a large plain copy, on the GPU.

    python scripts/kernel_baselines.py

One process. Prints one JSON line per measurement: the card's name and
power limit, device kind, the time per apply (in-graph rep chain, min of
3 after a warm-up; bench.py's ``timed``), the bytes the operation must
move (computed from shapes), and ``copy_bound_ms`` = those bytes at the
measured copy rate. ``ratio`` = time / copy-bound time; a path whose
ratio stays above 1.25 is a candidate for a kernel (ROADMAP). Also times
the small Cholesky inside CholQR2 against jnp.linalg.
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from bench import _device_rhs, _timed_solve, card, measure_copy, timed

N = 256
F32 = 4


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"kernel_baselines.py measures the GPU; JAX found "
                 f"{dev.platform}")
    from trilinos_tpu.galeri import brick3d, laplace3d
    from trilinos_tpu.galeri.fem import elasticity3d
    from trilinos_tpu.ops import csr_to_bdia, matvec as mv
    from trilinos_tpu.ops.stencil import (chebyshev_stages, monomial_stages,
                                          stencil_poly_xla,
                                          stencil_powers_xla)
    from trilinos_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    card_line = card()
    copy_gbps = measure_copy()
    n = N ** 3
    rng = np.random.default_rng(0)

    def emit(name, seconds, nbytes, **extra):
        bound = nbytes / (copy_gbps * 1e9)
        print(json.dumps(dict(
            name=name, card=card_line, device_kind=dev.device_kind,
            ms=seconds * 1e3, bytes=nbytes, copy_gbps=copy_gbps,
            copy_bound_ms=bound * 1e3, ratio=seconds / bound, **extra)),
            flush=True)

    emit("copy_256^3_f32", 2 * n * F32 / (copy_gbps * 1e9), 2 * n * F32)
    x = jnp.asarray(rng.standard_normal(n), jnp.float32)
    x4 = jnp.asarray(rng.standard_normal((n, 4)), jnp.float32)

    # matrix-free stencils: ideal traffic is read x + write y
    for name, op in (("stencil7", laplace3d(N, N, N, np.float32,
                                            "stencil")),
                     ("stencil27", brick3d(N, N, N, np.float32,
                                           "stencil"))):
        emit(f"{name}_spmv", timed(lambda v: mv.spmv(op, v), (), x, 100),
             2 * n * F32)
        emit(f"{name}_spmm_k4", timed(lambda v: mv.spmv(op, v), (), x4,
                                      50), 2 * 4 * n * F32)

    # stored DIA: diagonals + read x + write y
    a = laplace3d(N, N, N, np.float32, "dia")
    nd = len(a.offsets)
    emit("dia_spmv_f32", timed(lambda m, v: mv.spmv(m, v), (a,), x, 100),
         (nd + 2) * n * F32)
    emit("dia_spmm_k4_f32", timed(lambda m, v: mv.spmv(m, v), (a,), x4,
                                  50), (nd + 2 * 4) * n * F32)
    a16 = laplace3d(N, N, N, jnp.bfloat16, "dia")
    emit("dia_spmv_bf16", timed(lambda m, v: mv.spmv(m, v), (a16,), x, 100),
         nd * n * 2 + 2 * n * F32)

    # polynomial / matrix powers: the single-pass ideal vs d passes
    op = laplace3d(N, N, N, np.float32, "stencil")
    cheb = chebyshev_stages(1.9, 0.06, 4, 1 / 6.0)
    emit("cheb4_poly", timed(lambda v: stencil_poly_xla(op, cheb, v), (),
                             x, 50), 2 * n * F32,
         unfused_bytes=4 * 2 * n * F32)
    powers = monomial_stages(4, sigma=12.0)
    emit("powers4_basis",
         timed(lambda v: stencil_powers_xla(op, powers, v)[-1], (), x, 50),
         (1 + 4) * n * F32, unfused_bytes=4 * 2 * n * F32)

    # plain CG iteration on the stencil (what the fused-iteration kernel
    # competed with): ~14 vector passes unfused, ~7 when fully fused
    from trilinos_tpu.solvers import cg, cg_single_reduce

    mk = _device_rhs(op.n_rows_pad, op.n_rows)
    for name, solver in (("cg", cg), ("cg_single_reduce",
                                      cg_single_reduce)):
        run = jax.jit(lambda key, s=solver: s(
            lambda v: mv.spmv(op, v), mk(key), rtol=0.0, maxiter=200))
        r, best = _timed_solve(run)
        emit(f"{name}_iter_256^3", best / int(r.iters), 14 * n * F32,
             fused_ideal_bytes=7 * n * F32)

    # BDIA on Q1 elasticity3d, b = 3: single applies and whole CG solves
    el = csr_to_bdia(elasticity3d(64, 64, 48, e_mod=1.0,
                                  dtype=np.float32), 3, dtype=np.float32)
    nb = el.nbr_pad * 3
    bdia_bytes = (len(el.offsets) * 9 + 2 * 3) * el.nbr_pad * F32
    xe = jnp.asarray(rng.standard_normal(nb), jnp.float32)
    emit("bdia_b3_spmv",
         timed(lambda m, v: mv.spmv(m, v), (el,), xe, 100), bdia_bytes)
    mk_e = _device_rhs(nb, nb)
    run = jax.jit(lambda key: cg(lambda v: mv.spmv(el, v), mk_e(key),
                                 rtol=0.0, maxiter=200))
    r, best = _timed_solve(run)
    emit("bdia_b3_cg_iter", best / int(r.iters), bdia_bytes + 12 * nb * F32)

    # CholQR2 on a 2M x k panel: the shipped small Cholesky + inverse
    # (unrolled up to smalldense.UNROLL_MAX) vs jnp.linalg.cholesky +
    # triangular_solve at every k
    from jax import lax

    import trilinos_tpu.solvers.ortho as ortho
    from trilinos_tpu.parallel.comm import SerialComm

    def linalg_chol_inv(g):
        l = jnp.linalg.cholesky(g)
        k = g.shape[0]
        return l, lax.linalg.triangular_solve(
            l, jnp.eye(k, dtype=g.dtype), left_side=True, lower=True)

    shipped = ortho.chol_inv_small
    rows = 2 ** 21
    for k in (8, 16, 32):
        w = jnp.asarray(rng.standard_normal((rows, k)), jnp.float32)
        for name, fn in (("shipped", shipped), ("linalg", linalg_chol_inv)):
            ortho.chol_inv_small = fn
            t = timed(lambda v: ortho.cholqr2(SerialComm(), v)[0], (), w, 50)
            emit(f"cholqr2_k{k}_{name}", t, 2 * 3 * rows * k * F32)
        ortho.chol_inv_small = shipped


if __name__ == "__main__":
    t0 = time.perf_counter()
    main()
    print(json.dumps({"wall_s": time.perf_counter() - t0}))
