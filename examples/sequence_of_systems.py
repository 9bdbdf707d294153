"""A sequence of related systems: graph reuse + preconditioner
recompute + Krylov recycling, together.

Runs on whatever JAX backend is active (the GPU if available, else CPU):
    python examples/sequence_of_systems.py

The time-dependent / nonlinear outer-loop workflow the reference serves
with resumeFill + Ifpack2's initialize/compute split + Belos GCRODR
(Tpetra_CrsMatrix_decl.hpp:2897; Ifpack2_Preconditioner.hpp:81-97;
BelosGCRODRSolMgr.hpp): the matrix VALUES change every step, the
sparsity never does. Three amortizations compose:

  1. the packed device format is REFILLED in place (one vectorized
     gather per float leaf — zero repacking/replanning),
  2. the ILU(0) preconditioner recomputes numerics on the frozen
     pattern (initialize once, compute per step),
  3. GCRODR carries its recycle space across the sequence, so later
     solves start with the slow modes already deflated — here with the
     preconditioner composed through the new prec= mode.
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
if os.environ.get("JAX_PLATFORMS") == "cpu":
    import jax

    jax.config.update("jax_platforms", "cpu")
import numpy as np
import jax.numpy as jnp

from trilinos_tpu.galeri import laplace2d
from trilinos_tpu.ops import matvec as S
from trilinos_tpu import precond
from trilinos_tpu.ops.formats import CsrHost, csr_to_dia
from trilinos_tpu.solvers.gcrodr import gcrodr

n_side = 48
a0 = laplace2d(n_side, n_side, dtype=np.float32)
n = a0.shape[0]
rng = np.random.default_rng(0)
b = np.zeros(n, np.float32)
b[:n] = rng.standard_normal(n)

rec = None
ilu = None
for step in range(4):
    # values drift each step (a reaction term growing with step),
    # sparsity unchanged — the resumeFill situation
    vals = a0.vals + (0.25 * step) * (a0.cols == np.repeat(
        np.arange(n), a0.row_lengths())).astype(np.float32)
    a = CsrHost(a0.row_ptr, a0.cols, vals, a0.shape)

    t0 = time.perf_counter()
    dev = csr_to_dia(a)  # same pattern -> same plan shape every step
    if ilu is None:
        ilu = precond.create("RILUK", a).compute()     # initialize+compute
    else:
        ilu = ilu.recompute(a)                         # numerics only
    bp = np.zeros(dev.n_rows_pad, np.float32)
    bp[:n] = b
    # rtol 1e-5: attainable in f32 for kappa ~ 1e3 (docs/PRECISION.md)
    res, rec = gcrodr(lambda x: S.spmv(dev, x), jnp.asarray(bp),
                      num_blocks=30, recycle_dim=8, rtol=1e-5,
                      prec=ilu, recycle=rec)
    dt = time.perf_counter() - t0
    rel = float(res.resnorm) / np.linalg.norm(b)
    print(f"step {step}: iters={int(res.iters):3d} true_rel={rel:.2e} "
          f"converged={bool(res.converged)} "
          f"recycle={'reused' if step else 'built'} wall={dt:.2f}s")
