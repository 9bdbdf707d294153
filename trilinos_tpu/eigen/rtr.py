"""RTR — Riemannian Trust-Region eigensolver (symmetric, smallest).

JAX analogue of Anasazi::RTRSolMgr / IRTR
(packages/anasazi/src/AnasaziRTRSolMgr.hpp, AnasaziRTRBase.hpp,
AnasaziIRTR.hpp): minimize f(X) = trace(XᵀAX) over the (generalized)
Grassmann manifold {X : XᵀMX = I} with a trust-region outer iteration
whose model subproblem is solved by truncated CG (Steihaug–Toint) in the
tangent space {η : (MX)ᵀη = 0}, Hess[η] = P(Aη − Mη·(XᵀAX)), where P is
the Euclidean-orthogonal projector onto the tangent space,
P(v) = v − MX·(XᵀM²X)⁻¹·(MX)ᵀv. With M = I this degenerates exactly to
the standard Grassmann geometry (P = I − XXᵀ). The reference's RTRBase
supports the same B-operator through its Eigenproblem (setM,
AnasaziBasicEigenproblem.hpp:60).

Structure: the whole tCG inner solve is ONE jitted lax.while_loop (fixed
shapes, no host round-trips per inner step); the outer loop (retraction
via (M-)CholQR2, ρ-ratio trust-region update) runs on host with a
handful of jitted device calls per iteration. Converges to the ``nev``
smallest eigenpairs — the RTR sweet spot the reference documents
(strong preconditioner-free convergence for well-separated smallest
eigenvalues).
"""
from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.smalldense import chol_solve_small
from ..parallel.comm import Comm, SerialComm
from ..solvers.base import Operator, hi_precision
from ..solvers.ortho import cholqr2
from .krylov_schur import EigsResult, _mcholqr2


@hi_precision
def rtr(op: Operator, n: int, nev: int, *, block: int | None = None,
        tol: float = 1e-8, maxiter: int = 100, max_inner: int | None = None,
        v0: jax.Array | None = None, comm: Comm | None = None,
        dtype=jnp.float64, m=None) -> EigsResult:
    """``nev`` smallest eigenpairs of a symmetric operator via RTR.

    ``m``: optional SPD mass operator → GENERALIZED pencil A x = λ M x.
    Iterates are kept M-orthonormal (retraction = M-metric CholQR2), the
    Rayleigh-Ritz block XᵀAX is then the projected pencil, and the tCG
    model Hessian uses the pencil residual Aη − Mη·Θ with the
    M-weighted tangent projector. No M-solve is needed.
    """
    comm = comm or SerialComm()
    p = block or nev
    max_inner = max_inner or max(4 * p, 40)
    mass = m
    rng = np.random.default_rng(17)
    if v0 is None:
        v0 = jnp.asarray(rng.standard_normal((n, p)), dtype=dtype)

    def small_chol_solve(gram, rhs):
        """(p×p SPD) gram⁻¹ rhs via Cholesky, floor scaled by the Gram's
        own magnitude (trace/k) — an absolute eps floor would dominate
        when ‖M‖ is small (FE mass diagonals scale like h²)."""
        eps = jnp.finfo(rhs.dtype).eps
        k = gram.shape[0]
        return chol_solve_small(
            (gram + gram.T) / 2
            + (10 * eps) * (jnp.trace(gram) / k)
            * jnp.eye(k, dtype=gram.dtype), rhs)

    def make_proj(x, mx, gram_mm):
        """Euclidean-orthogonal projector onto {η : (MX)ᵀη = 0}.
        gram_mm = (MX)ᵀ(MX); with M = I (mass=None) mx is x, gram ≈ I
        and this is the standard P = I − XXᵀ."""
        def proj(v):
            c = comm.psum(mx.T @ v)
            return v - mx @ small_chol_solve(gram_mm, c)
        return proj

    @jax.jit
    def rayleigh(x, mx):
        ax = op(x)
        mmat = comm.psum(x.T @ ax)
        mmat = (mmat + mmat.T) / 2
        gram_mm = comm.psum(mx.T @ mx)
        proj = make_proj(x, mx, gram_mm)
        g = proj(ax - mx @ mmat)  # projected pencil residual
        gn = jnp.sqrt(comm.psum(jnp.sum(g * g)))
        return ax, mmat, gram_mm, g, gn

    @jax.jit
    def tcg(x, mx, gram_mm, mmat, g, delta):
        """Truncated CG for Hess[η] = −g, trust radius ``delta``.

        Returns (eta, heta, stop_code). Standard Steihaug: negative
        curvature or boundary hit → move to the boundary along the
        current direction; otherwise run to the inner tolerance
        (superlinear θ=1 stopping rule of AnasaziIRTR.hpp)."""
        gnorm0 = jnp.sqrt(comm.psum(jnp.sum(g * g)))
        kappa, theta = 0.1, 1.0
        stop_tol = gnorm0 * jnp.minimum(kappa, gnorm0 ** theta)
        proj = make_proj(x, mx, gram_mm)

        def hess(eta):
            heta = op(eta) - (mass(eta) if mass is not None
                              else eta) @ mmat
            return proj(heta)

        def boundary_step(eta, d, dd, ed):
            ee = comm.psum(jnp.sum(eta * eta))
            disc = jnp.sqrt(jnp.maximum(ed * ed + dd * (delta ** 2 - ee),
                                        0.0))
            return jnp.where(dd > 0, (-ed + disc) / jnp.where(dd > 0, dd, 1),
                             0.0)

        def cond(st):
            _, _, r, _, rr, it, code = st
            return jnp.logical_and(it < max_inner,
                                   jnp.logical_and(code == 0,
                                                   jnp.sqrt(rr) > stop_tol))

        def body(st):
            eta, heta, r, d, rr, it, code = st
            hd = hess(d)
            dhd = comm.psum(jnp.sum(d * hd))
            dd = comm.psum(jnp.sum(d * d))
            ed = comm.psum(jnp.sum(eta * d))
            alpha = rr / jnp.where(dhd != 0, dhd, 1.0)
            eta_try = eta + alpha * d
            ee_try = comm.psum(jnp.sum(eta_try * eta_try))
            neg_curv = dhd <= 0
            past_boundary = ee_try >= delta ** 2
            tau = boundary_step(eta, d, dd, ed)
            hit = jnp.logical_or(neg_curv, past_boundary)
            eta_new = jnp.where(hit, eta + tau * d, eta_try)
            heta_new = jnp.where(hit, heta + tau * hd, heta + alpha * hd)
            r_new = r + alpha * hd  # residual of H eta = -g
            rr_new = comm.psum(jnp.sum(r_new * r_new))
            beta = rr_new / jnp.where(rr != 0, rr, 1.0)
            d_new = -r_new + beta * d
            code_new = jnp.where(hit, jnp.where(neg_curv, 1, 2),
                                 0).astype(jnp.int32)
            return (eta_new, heta_new, r_new, d_new, rr_new, it + 1,
                    code_new)

        z = jnp.zeros_like(g)
        r0 = g
        rr0 = comm.psum(jnp.sum(r0 * r0))
        st = (z, z, r0, -g, rr0, jnp.int32(0), jnp.int32(0))
        eta, heta, _, _, _, it, code = lax.while_loop(cond, body, st)
        return eta, heta, it, code

    @jax.jit
    def retract(x, eta):
        w = x + eta
        if mass is None:
            q, _, _ = cholqr2(comm, w)
            return q, q
        return _mcholqr2(comm, mass, w)

    @jax.jit
    def model_decrease(g, eta, heta):
        return -(comm.psum(jnp.sum(g * eta))
                 + 0.5 * comm.psum(jnp.sum(eta * heta)))

    x, mx = retract(v0.astype(dtype), jnp.zeros_like(v0, dtype=dtype))
    # initial trust radius = the ACTUAL ‖X‖_F: an M-orthonormal block has
    # Euclidean column norms ~ 1/√‖M‖ (√p only when M = I), and the tCG
    # steps live in that Euclidean scale — a fixed √p radius strangles
    # the steps whenever ‖M‖ ≪ 1 (h²-scaled FE mass matrices)
    delta = float(np.sqrt(comm.psum(jnp.sum(x * x))))
    delta_bar = 10 * delta
    rho_prime = 0.1

    theta = resn = None
    converged = False
    iters = 0
    ax, mmat, gram_mm, g, gn = rayleigh(x, mx)
    f_cur = float(np.trace(np.asarray(mmat)))

    for it in range(maxiter):
        iters = it + 1
        # convergence: per-column pencil Ritz residuals
        mm = np.asarray(mmat)
        w, z = np.linalg.eigh((mm + mm.T) / 2)
        theta = w[:nev]
        xa = np.asarray(x) @ z
        ra = np.asarray(ax) @ z - np.asarray(mx) @ z * w[None, :]
        resn = np.linalg.norm(ra[:, :nev], axis=0)
        scale = np.maximum(np.abs(theta), 1.0)
        converged = bool((resn <= tol * scale).all())
        if converged:
            break
        eta, heta, in_it, code = tcg(x, mx, gram_mm, mmat, g,
                                     jnp.asarray(delta, dtype))
        x_try, mx_try = retract(x, eta)
        ax_t, mmat_t, gram_t, g_t, gn_t = rayleigh(x_try, mx_try)
        f_try = float(np.trace(np.asarray(mmat_t)))
        mdec = float(model_decrease(g, eta, heta))
        # rho regularization (AnasaziRTRBase's fx-vs-model guard, same
        # cure as Manopt's rho_regularization): near convergence both
        # f_cur - f_try and the model decrease fall to fp noise and the
        # raw ratio rejects good steps forever
        reg = 1e3 * np.finfo(np.float64).eps * max(1.0, abs(f_cur))
        rho = (f_cur - f_try + reg) / (max(mdec, 0.0) + reg)
        if rho < 0.25:
            delta = delta / 4
        elif rho > 0.75 and int(code) in (1, 2):
            delta = min(2 * delta, delta_bar)
        if rho > rho_prime:
            x, mx, ax, mmat, gram_mm, g, gn, f_cur = (
                x_try, mx_try, ax_t, mmat_t, gram_t, g_t, gn_t, f_try)

    # final Ritz extraction
    mm = np.asarray(mmat)
    w, z = np.linalg.eigh((mm + mm.T) / 2)
    xa = np.asarray(x) @ z
    ra = np.asarray(ax) @ z - np.asarray(mx) @ z * w[None, :]
    return EigsResult(
        eigenvalues=w[:nev], eigenvectors=xa[:, :nev],
        resnorms=np.linalg.norm(ra[:, :nev], axis=0), iters=iters,
        converged=converged)
