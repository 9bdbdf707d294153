"""Distributed AMG-preconditioned CG on a virtual (or real) device mesh.

Run on CPU with a virtual 8-device mesh:
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/distributed_amg.py

Demonstrates the round-2 distributed preconditioning stack: the SA-AMG
hierarchy is built on host (MueLu Hierarchy::Setup analogue), every level
is row-sharded with halo plans (rectangular plans for P/R), and the whole
V-cycle + CG solve compiles to ONE program over the mesh.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=4")

import numpy as np
import jax

if jax.default_backend() == "cpu":
    jax.config.update("jax_enable_x64", True)  # f64 tolerances on CPU
import jax.numpy as jnp

from trilinos_tpu.galeri import laplace3d
from trilinos_tpu.parallel import distmatrix as D
from trilinos_tpu.parallel import driver as drv
from trilinos_tpu.solvers import cg


def main():
    n_shards = min(len(jax.devices()), 4)
    a = laplace3d(16, 16, 8)
    dm = D.distribute(a, n_shards)
    mesh = drv.make_mesh(n_shards)
    print(f"Laplace3D 16x16x8 over {n_shards} shards "
          f"(mode={dm.plan.mode})")

    b = np.random.default_rng(0).standard_normal(a.shape[0])
    bg = jnp.asarray(dm.row_map.to_padded(b))

    # each variant is one jitted shard_map program; first compile takes
    # a minute or two on CPU — enable the persistent cache to amortize
    jax.config.update("jax_compilation_cache_dir", "/tmp/tt-jax-cache")
    for name, prec in [
        ("Jacobi", drv.dist_jacobi(a, dm.row_map)),
        ("SA-AMG", drv.dist_amg(a, dm.row_map, coarse_max=64)),
    ]:
        kw = dict(prec=prec) if prec is not None else {}
        res = drv.dist_solve(cg, dm, bg, mesh=mesh, rtol=1e-8,
                             maxiter=500, **kw)
        x = dm.row_map.from_padded(np.asarray(res.x))
        rel = np.linalg.norm(b - a.to_dense() @ x) / np.linalg.norm(b)
        print(f"  {name:22s} iters={int(res.iters):4d} "
              f"true_rel={rel:.2e} converged={bool(res.converged.all())}")


if __name__ == "__main__":
    main()
