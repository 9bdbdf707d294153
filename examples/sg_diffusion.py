"""Stochastic diffusion end-to-end: KL random field -> stochastic
Galerkin solve -> solution moments, cross-checked against non-intrusive
sampling (the Stokhos workflow, e.g. stokhos/example/linear2d_diffusion*).

Problem: -(a(x, xi) u')' = 1 on (0,1), u(0)=u(1)=0, with the lognormal-
free affine field a = a_mean + sum_k g_k(x) xi_k from a truncated KL of
an exponential-covariance process (uniform germs keep a > 0).

Shape of the computation: the PC coefficient field is ONE (n, P)
block; each KL mode's stiffness matrix SpMMs all P columns at once and
the stochastic coupling is a (P,P) GEMM — the whole SG apply is a single
fused XLA program.
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

from trilinos_tpu import uq
from trilinos_tpu.ops import choose_format
from trilinos_tpu.ops.formats import CsrHost
from trilinos_tpu.solvers import cg


def stiffness_1d(edge_coeff: np.ndarray, nx: int) -> CsrHost:
    h = 1.0 / (nx + 1)
    lo, hi = edge_coeff[:-1], edge_coeff[1:]
    rows = np.repeat(np.arange(nx), 3)
    cols = (rows.reshape(-1, 3) + np.array([-1, 0, 1])).ravel()
    vals = np.stack([-lo, (lo + hi), -hi], axis=1).ravel() / h / h
    keep = (cols >= 0) & (cols < nx)
    return CsrHost.from_coo(rows[keep], cols[keep], vals[keep], (nx, nx))


def main(nx=64, d=4, p=3, corr_len=0.6, sigma=0.25):
    # --- KL field at the staggered edge midpoints --------------------
    h = 1.0 / (nx + 1)
    xe = np.linspace(h / 2, 1 - h / 2, nx + 1) * 2.0 - 1.0  # to [-1,1]
    mean, modes = uq.exponential_kl(d, xe[:, None], corr_len=corr_len,
                                    sigma=sigma, mean=1.0)

    # --- affine operator PCE: A0 from the mean, A_k per KL mode ------
    mats = [stiffness_1d(np.full(nx + 1, mean), nx)]
    mats += [stiffness_1d(modes[:, k], nx) for k in range(d)]

    basis = uq.TotalOrderBasis.make([uq.legendre_basis(p)] * d, p)
    sg = uq.SGOperator.from_affine([choose_format(m) for m in mats], basis)
    print(f"n={nx} d={d} p={p}: P={basis.size} PC terms, "
          f"{len(mats)} operator blocks")

    npad = choose_format(mats[0]).n_rows_pad
    b = jnp.zeros((npad, basis.size)).at[:nx, 0].set(1.0)
    dinv = jnp.asarray(np.concatenate(
        [1.0 / mats[0].diagonal(), np.ones(npad - nx)]))
    prec = uq.mean_based_prec(lambda u: dinv[:, None] * u, basis)
    # f32 attainable residual ~ kappa(A) * eps ~ 1e-4 relative here; the
    # certification is honest about it (tests run this in f64 to 1e-10)
    u, res = uq.sg_solve(cg, sg, b, prec=prec, rtol=1e-4, maxiter=4000)
    u = np.asarray(u)[:nx]
    print(f"SG solve: converged={bool(res.converged)} "
          f"iters={int(res.iters)}")

    mean_sg, std_sg = u[:, 0], np.sqrt((u[:, 1:] ** 2).sum(axis=1))
    mid = nx // 2
    print(f"u(mid): mean={mean_sg[mid]:.6f}  std={std_sg[mid]:.6f}")

    # --- cross-check: sparse-grid NISP sampling ----------------------
    quad = uq.smolyak_quadrature(basis.bases, p + 1)
    dense = [m.to_dense() for m in mats]

    def det_solve(xi):
        return np.linalg.solve(
            dense[0] + sum(x * ak for x, ak in zip(xi, dense[1:])),
            np.ones(nx))

    sols = np.stack([det_solve(pt) for pt in quad.points])
    mean_ref = quad.weights @ sols
    std_ref = np.sqrt(np.maximum(quad.weights @ sols ** 2 - mean_ref ** 2,
                                 0.0))
    print(f"NISP ({len(quad.weights)} sparse-grid solves): "
          f"mean={mean_ref[mid]:.6f}  std={std_ref[mid]:.6f}")
    em = np.abs(mean_sg - mean_ref).max() / np.abs(mean_ref).max()
    es = np.abs(std_sg - std_ref).max() / std_ref.max()
    print(f"rel err: mean={em:.2e}  std={es:.2e}")
    assert em < 1e-3 and es < 5e-2, (em, es)
    print("OK")


if __name__ == "__main__":
    main()
