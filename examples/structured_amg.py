"""Structured-aggregation AMG: matrix-free multigrid at 16.7M rows.

The MueLu-class V-cycle built accelerator-first (precond/amg.py +
precond/structured.py): the fine level is the matrix-free StencilOp,
transfers are reshape pair-sums/duplications + one stencil apply, and
every coarse level is the EXACT Galerkin operator in boundary-classified
form stored as a gather-free DIA matrix. Setup is all-host and
independent of the grid size (probe-grid extraction).

Runs on whatever JAX backend is active (the GPU if available, else CPU —
use a small size on CPU):
    python examples/structured_amg.py [n]
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import numpy as np
import jax
import jax.numpy as jnp

from trilinos_tpu.galeri import laplace3d
from trilinos_tpu.ops import spmv
from trilinos_tpu.precond import SaAmg
from trilinos_tpu.solvers import cg

n_side = int(sys.argv[1]) if len(sys.argv) > 1 else (
    64 if jax.default_backend() != "cpu" else 32)
op = laplace3d(n_side, n_side, n_side, dtype=np.float32, fmt="stencil")
print(f"Laplace3D {n_side}^3: {op.n_rows:,} rows (matrix-free)")

t0 = time.time()
m = SaAmg(op, {"dtype": np.float32}).compute()
print(f"hierarchy: {m.n_levels()} levels, setup {time.time()-t0:.1f}s "
      f"(all host — probe-extracted exact Galerkin coarse operators)")

n, npad = op.n_rows, op.n_rows_pad
b = np.zeros(npad, np.float32)
b[:n] = np.random.default_rng(0).standard_normal(n)

# the hierarchy's device arrays ride as jit ARGUMENTS (state/apply_state)
# so big levels never bake into the executable as constants
st = m.state()
run = jax.jit(lambda bb, ss: cg(lambda v: spmv(op, v), bb,
                                prec=lambda v: m.apply_state(ss, v),
                                rtol=1e-5, maxiter=100))
t0 = time.time()
res = run(jnp.asarray(b), st)
print(f"AMG-PCG: {int(res.iters)} iterations, converged="
      f"{bool(res.converged)}, wall {time.time()-t0:.2f}s "
      f"(includes compile + RHS transfer)")
