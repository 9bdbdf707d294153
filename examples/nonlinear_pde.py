"""Nonlinear PDE end-to-end: steady Bratu solve, continuation in
lambda, and a transient march — the NOX/LOCA/Tempus surface on one
problem.

    -Lap(u) = lam * exp(u)  on the unit square (Bratu-Gelfand),
homogeneous Dirichlet; discretized as F(u) = A u - h^2 lam exp(u) with
the h^2-scaled 5-point Laplacian A (keeping the residual O(1) so f32
tolerances are meaningful). The fold is at lam* ~ 6.81; pseudo-
arclength continuation tracks the branch toward it (the LOCA showcase,
packages/nox/test-loca examples). The transient form
    u_t = lam exp(u) - (1/h^2) A u
is marched with the adaptive implicit integrator and settles onto the
steady branch.

Run: PYTHONPATH=. python examples/nonlinear_pde.py   (CPU or GPU)
"""
import os
import sys

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.abspath(__file__)), ".."))
if os.environ.get("JAX_PLATFORMS") == "cpu":
    import jax

    jax.config.update("jax_platforms", "cpu")
import numpy as np

import jax.numpy as jnp

from trilinos_tpu.galeri import laplace2d
from trilinos_tpu.nonlinear import (continuation, integrate_adaptive,
                                    newton_krylov)
from trilinos_tpu.ops import formats as F
from trilinos_tpu.ops import matvec as S

NX = 24
a = laplace2d(NX, NX)                      # h^2-scaled 5-point Laplacian
dev = F.csr_to_dia(a)
n, npad = a.shape[0], dev.n_rows_pad
h2 = 1.0 / (NX + 1) ** 2
mask = np.zeros(npad, np.float32)
mask[:n] = 1.0
mask_j = jnp.asarray(mask)


def residual(u, lam):
    """F(u) = A u - h^2 lam exp(u) (zero on padding rows)."""
    return mask_j * (S.spmv(dev, u)
                     - h2 * lam * jnp.exp(u) * mask_j)


u0 = jnp.zeros(npad)

# --- steady solve at lam = 1 (f32: atol near the residual noise floor)
res = newton_krylov(lambda u: residual(u, 1.0), u0, rtol=0.0, atol=3e-6)
print(f"[newton] lam=1: converged={bool(res.converged)} "
      f"iters={int(res.iters)} |F|={float(res.fnorm):.2e} "
      f"max(u)={float(jnp.max(res.x)):.4f}")

# --- pseudo-arclength continuation toward the fold ---------------------
path = continuation(residual, res.x, p0=1.0, p_final=6.5, dp0=0.5,
                    arclength=True, max_steps=40,
                    newton_rtol=0.0, newton_atol=1e-5)
lams = path.params
print(f"[loca] {len(lams)} continuation points, "
      f"{path.steps_failed} rejected; max lambda reached "
      f"{lams.max():.3f} (the Bratu fold is at ~6.81); "
      f"max(u) grew to {float(jnp.max(path.xs[-1])):.3f}")

# --- transient: ignition transient at lam = 1 --------------------------
rhs = lambda t, u: mask_j * (1.0 * jnp.exp(u) * mask_j
                             - S.spmv(dev, u) / h2)
tr = integrate_adaptive(rhs, u0, 0.0, 1.0, 0.02, order=2, rtol=1e-5,
                        newton_atol=1e-5)
print(f"[tempus] adaptive march: {tr.steps} steps "
      f"({tr.rejected} rejected), {tr.newton_iters} Newton iters, "
      f"max(u(T))={float(jnp.max(tr.u)):.4f}")
drift = float(jnp.linalg.norm(tr.u - res.x))
print(f"[check] ||u(T=1) - u_steady|| = {drift:.2e} (transient settling "
      f"onto the steady branch)")
assert bool(res.converged) and drift < 1e-2
