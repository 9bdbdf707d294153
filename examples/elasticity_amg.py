"""Rigid-body-mode AMG for 3-D elasticity (block-structured hierarchy).

The MueLu-on-elasticity workflow accelerator-first (precond/block_amg.py):
structured node aggregation, batched-QR tentative blocks applied by
strided interleave (zero gathers), exact host-Galerkin BDIA levels.

Runs on whatever JAX backend is active (the GPU if available, else CPU —
use small sizes on CPU):
    python examples/elasticity_amg.py [nx ny nz]
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import numpy as np
import jax
import jax.numpy as jnp

from trilinos_tpu.galeri.fem import elasticity3d, rigid_body_modes
from trilinos_tpu.ops import spmv
from trilinos_tpu.precond import BlockStructuredAmg
from trilinos_tpu.solvers import cg

if len(sys.argv) > 3:
    nx, ny, nz = (int(a) for a in sys.argv[1:4])
elif jax.default_backend() != "cpu":
    nx, ny, nz = 32, 32, 24
else:
    nx, ny, nz = 12, 12, 8

t0 = time.time()
a = elasticity3d(nx, ny, nz, e_mod=1.0, dtype=np.float32)
ns = rigid_body_modes(nx, ny, nz)
print(f"Q1 elasticity {nx}x{ny}x{nz} nodes: {a.shape[0]:,} dofs, "
      f"assembled {time.time()-t0:.1f}s")

t0 = time.time()
m = BlockStructuredAmg(a, node_dims=(nx, ny, nz), nullspace=ns,
                       n_equations=3,
                       params={"dtype": np.float32,
                               "coarse: max size": 3000}).compute()
print(f"hierarchy: {m.n_levels()} levels (6 rigid-body modes per "
      f"aggregate), setup {time.time()-t0:.1f}s")

dev = m.levels[0]["a"]          # the fine BDIA operator
n, npad = a.shape[0], m.levels[0]["n_f"]
b = np.zeros(npad, np.float32)
b[:n] = np.random.default_rng(0).standard_normal(n)

run = jax.jit(lambda bb, st: cg(lambda v: spmv(dev, v), bb,
                                prec=lambda v: m.apply_state(st, v),
                                rtol=1e-5, maxiter=200))
t0 = time.time()
res = run(jnp.asarray(b), m.state())
print(f"AMG-CG: {int(res.iters)} iterations, converged="
      f"{bool(res.converged)}, wall {time.time()-t0:.2f}s "
      f"(includes compile)")
res0 = cg(lambda v: spmv(dev, v), jnp.asarray(b), rtol=1e-5,
          maxiter=5000)
print(f"plain CG for comparison: {int(res0.iters)} iterations")
