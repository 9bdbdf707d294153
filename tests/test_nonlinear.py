"""Nonlinear solver tests (NOX/LOCA analogue).

Mirrors the reference's NOX test pattern (packages/nox/test/epetra/
1Dfem/ and LOCA continuation tests): solve a discretized nonlinear PDE
(here the 2-D Bratu problem, the canonical NOX/LOCA example) to a tight
residual, exercise line search from a poor start, and trace a
continuation branch in the Bratu parameter.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from trilinos_tpu.galeri import laplace2d
from trilinos_tpu.nonlinear import (anderson, continuation, newton_krylov,
                                    newton_trust_region)
from trilinos_tpu.ops import formats as F
from trilinos_tpu.ops import matvec as S


def bratu_residual(nx=24, ny=24, lam=4.0):
    """F(u) = A u - lam * h^2 * exp(u) on the unit square (zero BC).

    A is the Galeri Laplace2D 5-point matrix (scaled by 1/h^2 implicitly:
    the stencil [4,-1,-1,-1,-1] is h^2*Laplacian), so the balancing
    source term carries h^2."""
    a = laplace2d(nx, ny)
    dev = F.csr_to_dia(a)
    n = a.shape[0]
    npad = dev.n_rows_pad
    h2 = 1.0 / ((nx + 1) * (ny + 1))
    mask = np.zeros(npad)
    mask[:n] = 1.0
    mask = jnp.asarray(mask)

    def f(u, lam_v=lam):
        return S.spmv(dev, u) - lam_v * h2 * mask * jnp.exp(u)

    return f, n, npad, a.to_dense(), h2, mask


class TestNewtonKrylov:
    @pytest.mark.parametrize("forcing", ["type1", "type2", 1e-6])
    def test_bratu(self, forcing):
        f, n, npad, dense, h2, _ = bratu_residual(lam=4.0)
        res = newton_krylov(f, jnp.zeros(npad), rtol=0.0, atol=1e-10,
                            forcing=forcing)
        assert bool(res.converged)
        u = np.asarray(res.x)[:n]
        rr = dense @ u - 4.0 * h2 * np.exp(u)
        assert np.linalg.norm(rr) <= 1e-9
        assert u.min() > 0  # Bratu lower branch is positive
        assert int(res.iters) <= 12

    @pytest.mark.parametrize("linesearch", ["backtrack", "polynomial"])
    def test_linesearch_globalizes_arctan(self, linesearch):
        """Canonical damping test (NOX Backtrack/Polynomial pattern):
        F(x) = arctan(x) from x0 in [2, 5] — the FULL Newton step
        diverges (|x - arctan(x)(1+x^2)| grows), while any damped
        search converges globally (J = diag(1/(1+x^2)) > 0 keeps the
        Newton direction a descent direction everywhere)."""
        rng = np.random.default_rng(7)
        x0 = jnp.asarray(rng.uniform(2.0, 5.0, 256))
        f = lambda x: jnp.arctan(x)
        full = newton_krylov(f, x0, rtol=0.0, atol=1e-10, maxiter=12,
                             linesearch="full")
        assert not bool(full.converged)  # the classic divergence
        res = newton_krylov(f, x0, rtol=0.0, atol=1e-10, maxiter=60,
                            linesearch=linesearch)
        assert bool(res.converged)
        np.testing.assert_allclose(np.asarray(res.x), 0.0, atol=1e-9)

    def test_jvp_operator_is_exact(self):
        """JFNK operator == analytic Jacobian action (no FD error)."""
        from trilinos_tpu.nonlinear import make_jvp_operator
        f, n, npad, dense, h2, mask = bratu_residual(lam=3.0)
        rng = np.random.default_rng(0)
        u = jnp.asarray(rng.standard_normal(npad) * np.asarray(mask))
        v = jnp.asarray(rng.standard_normal(npad))
        got = np.asarray(make_jvp_operator(f, u)(v))
        jac = dense - np.diag(3.0 * h2 * np.exp(np.asarray(u)[:n]))
        want = jac @ np.asarray(v)[:n]
        np.testing.assert_allclose(got[:n], want, rtol=1e-10, atol=1e-12)


class TestAnderson:
    def test_linear_contraction_beats_picard(self):
        """g(x) = B x + c with rho(B) ~ 0.9: Anderson(5) converges far
        faster than damped Picard (NOX AndersonAcceleration doc claim)."""
        rng = np.random.default_rng(1)
        n = 40
        q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        B = q @ np.diag(np.linspace(0.1, 0.9, n)) @ q.T
        c = rng.standard_normal(n)
        g = lambda x: jnp.asarray(B) @ x + jnp.asarray(c)
        res = anderson(g, jnp.zeros(n), m=5, rtol=1e-10, maxiter=200)
        assert bool(res.converged)
        x_star = np.linalg.solve(np.eye(n) - B, c)
        np.testing.assert_allclose(np.asarray(res.x), x_star, rtol=1e-6)
        # plain Picard contracts at 0.9/iter: ~218 iters to 1e-10;
        # Anderson must do it in far fewer
        assert int(res.iters) < 80

    def test_bratu_picard_accelerated(self):
        """Standard Bratu Picard map u <- A^{-1}(lam h^2 e^u): a strong
        contraction at lam=2; Anderson cuts its iteration count."""
        f, n, npad, dense, h2, mask = bratu_residual(lam=2.0)
        ainv = jnp.asarray(np.linalg.inv(dense))
        g = lambda u: ainv @ (2.0 * h2 * jnp.exp(u))
        res = anderson(g, jnp.zeros(n), m=4, rtol=0.0, atol=1e-12,
                       maxiter=100)
        assert bool(res.converged)
        u = np.asarray(res.x)
        rr = dense @ u - 2.0 * h2 * np.exp(u)
        assert np.linalg.norm(rr) <= 1e-10
        # plain Picard for comparison
        pic = anderson(g, jnp.zeros(n), m=0, beta=1.0, rtol=0.0,
                       atol=1e-12, maxiter=100)
        assert int(res.iters) <= int(pic.iters)


class TestTrustRegion:
    def test_bratu(self):
        f, n, npad, dense, h2, _ = bratu_residual(lam=4.0)
        res = newton_trust_region(f, jnp.zeros(npad), rtol=0.0,
                                  atol=1e-9)
        assert bool(res.converged)
        u = np.asarray(res.x)[:n]
        rr = dense @ u - 4.0 * h2 * np.exp(u)
        assert np.linalg.norm(rr) <= 1e-8

    def test_rosenbrock_residual(self):
        """Small stiff system from a bad start — the dogleg must steer
        via the Cauchy direction (NOX TrustRegionBased test pattern)."""
        def f(z):
            return jnp.stack([10.0 * (z[1] - z[0] ** 2), 1.0 - z[0]])

        res = newton_trust_region(f, jnp.asarray([-1.2, 1.0]),
                                  rtol=0.0, atol=1e-12, maxiter=100,
                                  inner_restart=2)
        assert bool(res.converged)
        np.testing.assert_allclose(np.asarray(res.x), [1.0, 1.0],
                                   atol=1e-8)


class TestContinuation:
    def test_bratu_natural(self):
        """Trace the Bratu lower branch 0 -> 5; ||u||_inf grows
        monotonically with lambda (LOCA Stepper natural continuation)."""
        f, n, npad, dense, h2, mask = bratu_residual()

        def fp(u, lam):
            return f(u, lam)

        out = continuation(fp, jnp.zeros(npad), p0=0.0, p_final=5.0,
                           dp0=1.0, max_steps=40, newton_atol=1e-10)
        assert out.params[-1] == pytest.approx(5.0, abs=1e-12)
        peaks = [float(jnp.max(x)) for x in out.xs]
        assert all(b >= a - 1e-12 for a, b in zip(peaks, peaks[1:]))
        assert (out.fnorms[1:] <= 1e-8).all()

    def test_bratu_arclength(self):
        """Pseudo-arclength on the same branch reaches the same state
        (bordered JFNK corrector, LOCA ArcLengthGroup analogue)."""
        f, n, npad, dense, h2, mask = bratu_residual()

        def fp(u, lam):
            return f(u, lam)

        nat = continuation(fp, jnp.zeros(npad), p0=0.0, p_final=3.0,
                           dp0=0.5, max_steps=40, newton_atol=1e-10)
        arc = continuation(fp, jnp.zeros(npad), p0=0.0, p_final=3.0,
                           dp0=0.5, max_steps=60, newton_atol=1e-10,
                           arclength=True)
        assert arc.params[-1] >= 2.5  # made real progress along lambda
        # compare the states at the closest parameter values
        ia = int(np.argmin(np.abs(arc.params - nat.params[-1])))
        ref = np.asarray(nat.xs[-1])[:n]
        got = np.asarray(arc.xs[ia])[:n]
        lam_gap = abs(arc.params[ia] - nat.params[-1])
        if lam_gap < 0.26:
            assert np.linalg.norm(got - ref) <= 0.2 * max(
                np.linalg.norm(ref), 1e-12) + 0.3 * lam_gap
