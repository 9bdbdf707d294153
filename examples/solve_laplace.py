"""Quickstart: Galeri problem -> pack -> preconditioned solve.

Runs on whatever JAX backend is active (the GPU if available, else CPU):
    python examples/solve_laplace.py
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import numpy as np
import jax.numpy as jnp

from trilinos_tpu.galeri import laplace3d
from trilinos_tpu.ops import choose_format, spmv
from trilinos_tpu import precond
from trilinos_tpu.solvers import LinearProblem, create_solver

a = laplace3d(32, 32, 32, dtype=np.float32)
dev = choose_format(a)                      # DIA (stencil fast path)
n, npad = a.shape[0], dev.n_rows_pad
b = np.zeros(npad, np.float32)
b[:n] = np.random.default_rng(0).standard_normal(n)

cheb = precond.Chebyshev(a, {"chebyshev: degree": 4,
                             "dtype": np.float32}).compute()
mgr = create_solver("CG", {"Convergence Tolerance": 1e-5,
                           "Verbosity": 16})  # FINAL_SUMMARY
res = mgr.solve(LinearProblem(lambda v: spmv(dev, v), jnp.asarray(b),
                              left_prec=cheb))
print(f"iters={int(res.iters)} resnorm={float(res.resnorm):.3e} "
      f"converged={bool(res.converged)}")
