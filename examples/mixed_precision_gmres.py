"""Mixed-precision Krylov: bf16 basis storage + compensated reductions.

Runs on whatever JAX backend is active (the GPU if available, else CPU):
    python examples/mixed_precision_gmres.py

Demonstrates the two precision directions the framework offers on an
f32 chip (docs/PRECISION.md):
  * NARROWER storage where precision is not the constraint — the
    Arnoldi basis is the HBM bottleneck of GMRES, so
    ``basis_dtype=jnp.bfloat16`` halves its traffic (the projection
    GEMMs read bf16 with f32 accumulation). Restarts
    are true-residual-gated, so the narrow-basis solver behaves as
    iterative refinement and every convergence claim stays certified.
  * WIDER arithmetic where it is — ``compensated=True`` runs the
    norms driving the Givens recurrence and the convergence decision
    in double-single (Dot2) precision (~eps instead of log(n)*eps).

Also shows the FGMRES pattern for tight tolerances: a full-precision
flexible outer loop corrects a cheap bf16-basis inner solver.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
if os.environ.get("JAX_PLATFORMS") == "cpu":
    import jax

    jax.config.update("jax_platforms", "cpu")
import numpy as np
import jax.numpy as jnp

from trilinos_tpu.galeri import laplace3d
from trilinos_tpu.ops import choose_format, spmv
from trilinos_tpu.solvers import fgmres, gmres

a = laplace3d(24, 24, 24, dtype=np.float32)
dev = choose_format(a)
n, npad = a.shape[0], dev.n_rows_pad
b = np.zeros(npad, np.float32)
b[:n] = np.random.default_rng(0).standard_normal(n)
bj = jnp.asarray(b)
op = lambda x: spmv(dev, x)


def report(tag, res):
    rel = float(res.resnorm) / np.linalg.norm(b[:n])
    print(f"[{tag:>22}] iters={int(res.iters):4d} "
          f"true_rel={rel:.2e} converged={bool(res.converged)}")


# 1. f32 baseline at a medium tolerance
report("f32 basis", gmres(op, bj, restart=30, rtol=1e-4, maxiter=600))

# 2. same request with the basis stored bf16: more (1.6x cheaper)
#    iterations, same certified result
report("bf16 basis", gmres(op, bj, restart=30, rtol=1e-4, maxiter=600,
                           basis_dtype=jnp.bfloat16))

# 3. an unattainable request reports honestly instead of spinning
report("bf16 @1e-12 (honest)", gmres(op, bj, restart=30, rtol=1e-12,
                                     maxiter=600,
                                     basis_dtype=jnp.bfloat16))

# 4. tight tolerance via the FGMRES pattern: f32 outer corrects the
#    bf16-basis inner solver's inexact directions
inner = lambda v: gmres(op, v, restart=15, maxiter=15, rtol=0.0,
                        basis_dtype=jnp.bfloat16).x
report("fgmres + bf16 inner", fgmres(op, bj, prec=inner, restart=20,
                                     rtol=1e-5, maxiter=400))

# 5. compensated (double-single) norms: the opposite direction —
#    ~eps-accurate reductions for trustworthy residuals/coefficients
report("f32 + compensated", gmres(op, bj, restart=30, rtol=1e-4,
                                  maxiter=600, compensated=True))
