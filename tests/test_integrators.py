"""Time integrator tests (Tempus analogue).

Mirrors the reference's Tempus stepper test pattern
(packages/tempus/test/BackwardEuler/, test/BDF2/, test/Trapezoidal/:
march the SinCos / CDR model, check the error against the analytic
solution, and verify the temporal order of accuracy from a dt-refinement
slope). Here the models are the scalar/vector SinCos ODE and the
method-of-lines heat equation on the Galeri Laplace2D operator.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from trilinos_tpu.galeri import laplace2d
from trilinos_tpu.nonlinear import (backward_euler, bdf2,
                                    integrate_adaptive, rk4, sdirk2,
                                    trapezoidal)
from trilinos_tpu.ops import formats as F
from trilinos_tpu.ops import matvec as S


def sincos_rhs(t, u):
    """u' = [u1, -u0]; exact u = [sin(t+phi), cos(t+phi)]."""
    return jnp.stack([u[1], -u[0]])


def sincos_exact(t):
    return np.array([np.sin(t), np.cos(t)])


def order_of(stepper, dts, t1=1.0, **kw):
    """Observed temporal order from a two-point dt refinement
    (the slope Tempus computes in its convergence tests)."""
    errs = []
    for dt in dts:
        res = stepper(sincos_rhs, jnp.asarray([0.0, 1.0]), 0.0, t1, dt,
                      **kw)
        errs.append(np.linalg.norm(np.asarray(res.u) - sincos_exact(t1)))
    return np.log(errs[0] / errs[1]) / np.log(dts[0] / dts[1]), errs


class TestOrders:
    def test_backward_euler_first_order(self):
        p, errs = order_of(backward_euler, [0.1, 0.05])
        assert 0.85 <= p <= 1.2, (p, errs)

    def test_trapezoidal_second_order(self):
        p, errs = order_of(trapezoidal, [0.1, 0.05])
        assert 1.8 <= p <= 2.2, (p, errs)

    def test_bdf2_second_order(self):
        p, errs = order_of(bdf2, [0.1, 0.05])
        assert 1.7 <= p <= 2.3, (p, errs)

    def test_rk4_fourth_order(self):
        p, errs = order_of(rk4, [0.2, 0.1])
        assert 3.7 <= p <= 4.3, (p, errs)
        assert errs[1] < 1e-6

    def test_sdirk2_second_order(self):
        p, errs = order_of(sdirk2, [0.1, 0.05])
        assert 1.7 <= p <= 2.3, (p, errs)


class TestStiffHeat:
    """Method-of-lines heat equation u' = -(1/h^2) A u: stiff, so the
    implicit steppers take dt far beyond the explicit stability limit
    (Tempus's CDR/VanDerPol stiff coverage plays this role)."""

    def setup_method(self):
        nx = ny = 12
        a = laplace2d(nx, ny)
        self.n = a.shape[0]
        dev = F.csr_to_dia(a)
        npad = dev.n_rows_pad
        inv_h2 = float((nx + 1) * (ny + 1))
        mask = np.zeros(npad)
        mask[:self.n] = 1.0
        mask_j = jnp.asarray(mask)
        self.rhs = lambda t, u: -inv_h2 * mask_j * S.spmv(
            dev, u)
        # smallest eigenvalue of (1/h^2) A -> slowest decay rate
        h2lam = 4 * (np.sin(np.pi / (2 * (nx + 1))) ** 2
                     + np.sin(np.pi / (2 * (ny + 1))) ** 2)
        self.lam_min = inv_h2 * h2lam
        u0 = np.zeros(npad)
        u0[:self.n] = 1.0
        self.u0 = jnp.asarray(u0)
        # explicit stability limit dt < 2/lam_max ~ 2 h^2/8
        self.dt_stable = 2.0 / (inv_h2 * 8.0)

    def test_backward_euler_beyond_explicit_limit(self):
        dt = 50 * self.dt_stable
        res = backward_euler(self.rhs, self.u0, 0.0, 40 * dt, dt)
        u = np.asarray(res.u)[:self.n]
        assert np.all(np.isfinite(u))
        # decayed: slowest mode shrinks like (1+dt*lam)^-steps
        assert np.linalg.norm(u) < np.linalg.norm(
            np.asarray(self.u0)) * 0.9
        assert res.newton_iters >= res.steps  # implicit solves happened

    def test_trapezoidal_matches_exact_mode_decay(self):
        """Project the lowest Laplacian mode; trapezoidal decay factor
        must match (1-z/2)/(1+z/2), z = dt*lam, to discretization
        accuracy."""
        nx = ny = 12
        x = np.arange(1, nx + 1) / (nx + 1)
        mode2d = np.outer(np.sin(np.pi * x), np.sin(np.pi * x)).ravel()
        u0 = np.zeros_like(np.asarray(self.u0))
        u0[:self.n] = mode2d
        dt = 1e-3
        nsteps = 20
        res = trapezoidal(self.rhs, jnp.asarray(u0), 0.0, nsteps * dt,
                          dt, rtol=1e-12, atol=1e-13)
        z = dt * self.lam_min
        expected = ((1 - z / 2) / (1 + z / 2)) ** nsteps
        got = (np.asarray(res.u)[:self.n] @ mode2d) / (mode2d @ mode2d)
        assert abs(got - expected) < 1e-5 * expected


class TestLStability:
    def test_sdirk2_damps_where_trapezoidal_rings(self):
        """Scalar stiff decay u' = -lam u with dt*lam = 100: trapezoidal's
        amplification (1-z/2)/(1+z/2) -> -1 (sign-flipping ringing);
        SDIRK2's L-stability sends it to 0. One step exposes both."""
        lam = 1000.0
        dt = 0.1
        rhs = lambda t, u: -lam * u
        u0 = jnp.asarray([1.0])
        r_tr = trapezoidal(rhs, u0, 0.0, dt, dt, rtol=1e-10, atol=1e-12)
        r_sd = sdirk2(rhs, u0, 0.0, dt, dt, rtol=1e-10, atol=1e-12)
        z = dt * lam
        assert float(r_tr.u[0]) < -0.9      # ~ -(1 - 4/z) ringing
        assert abs(float(r_sd.u[0])) < 0.06  # damped toward 0
        # exact one-step amplification R(-z) = (1 - z(1-2g))/(1+gz)^2
        g = 1 - 1 / np.sqrt(2)
        rz = (1 - z * (1 - 2 * g)) / (1 + g * z) ** 2
        assert abs(float(r_sd.u[0]) - rz) < 5e-3


class TestAdaptive:
    def test_tolerance_tracking_order2(self):
        """Trapezoidal + AB2-Milne estimate on SinCos: the global error
        lands near the requested tolerance band and t1 is hit exactly."""
        res = integrate_adaptive(sincos_rhs, jnp.asarray([0.0, 1.0]),
                                 0.0, 5.0, 0.5, order=2, rtol=1e-5,
                                 atol=1e-8)
        err = np.linalg.norm(np.asarray(res.u) - sincos_exact(5.0))
        assert abs(res.t - 5.0) < 1e-9
        # local control rtol=1e-5 over ~170 f32 steps: global error
        # accumulates to the 1e-3 class; assert the band, not magic
        assert err < 2e-3, (err, res.steps, res.rejected)
        assert res.steps > 10

    def test_controller_shrinks_then_grows(self):
        """u' = -u + sharp gaussian forcing at t=1: the controller must
        refine through the pulse and re-expand after (dt history spans
        >= 8x), with at least one rejection at the pulse."""
        def rhs(t, u):
            return -u + 50.0 * jnp.exp(-((t - 1.0) / 0.02) ** 2)
        res = integrate_adaptive(rhs, jnp.asarray([1.0]), 0.0, 2.0, 0.4,
                                 order=1, rtol=1e-4, atol=1e-7,
                                 save_every=1)
        dts = np.diff(res.ts)
        assert dts.min() < 0.02          # refined into the pulse
        assert dts.max() / dts.min() >= 8.0
        assert res.rejected >= 1

    def test_order1_stiff_decay(self):
        lam = 500.0
        rhs = lambda t, u: -lam * u
        res = integrate_adaptive(rhs, jnp.asarray([1.0]), 0.0, 1.0,
                                 0.2, order=1, rtol=1e-3, atol=1e-8)
        assert abs(float(res.u[0]) - np.exp(-lam)) < 1e-3

    def test_bad_order_rejected(self):
        with pytest.raises(ValueError):
            integrate_adaptive(sincos_rhs, jnp.asarray([0.0, 1.0]),
                               0.0, 1.0, 0.1, order=3)


class TestPlumbing:
    def test_save_every_trajectory(self):
        res = backward_euler(sincos_rhs, jnp.asarray([0.0, 1.0]),
                             0.0, 1.0, 0.1, save_every=2)
        assert res.ts is not None and len(res.ts) == 1 + 5
        assert len(res.us) == len(res.ts)
        assert np.allclose(np.asarray(res.us[-1]), np.asarray(res.u))

    def test_nonlinear_rhs_bdf2(self):
        """Logistic u' = u(1-u): nonlinear residual exercises JFNK inside
        the stepper; compare against the closed form."""
        rhs = lambda t, u: u * (1.0 - u)
        res = bdf2(rhs, jnp.asarray([0.1]), 0.0, 2.0, 0.02)
        exact = 0.1 * np.exp(2.0) / (1 - 0.1 + 0.1 * np.exp(2.0))
        assert abs(float(res.u[0]) - exact) < 2e-4

    def test_bad_theta_rejected(self):
        from trilinos_tpu.nonlinear import theta_method
        with pytest.raises(ValueError):
            theta_method(sincos_rhs, jnp.asarray([0.0, 1.0]),
                         0.0, 1.0, 0.1, theta=0.0)
