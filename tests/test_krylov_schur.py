"""Krylov-Schur eigensolver with thick restarts
(reference: packages/anasazi/src/AnasaziBlockKrylovSchurSolMgr.hpp)."""
import numpy as np
import pytest

import jax.numpy as jnp

from trilinos_tpu.galeri import laplace2d, laplace3d, recirc2d
from trilinos_tpu.ops import formats as F
from trilinos_tpu.ops import matvec as S
from trilinos_tpu.eigen.krylov_schur import block_krylov_schur


def op_of(a):
    dev = F.csr_to_ell(a)
    n = a.shape[0]
    npad = dev.n_rows_pad

    def op(v):
        shape = (npad,) if v.ndim == 1 else (npad, v.shape[1])
        vp = jnp.zeros(shape, v.dtype).at[:n].set(v)
        return S.spmv(dev, vp)[:n]

    return op, n


class TestKrylovSchur:
    def test_laplace2d_multiplicity_needs_blocks(self):
        """Laplace2D 16x16 has a DOUBLE top-2 eigenvalue: block size 2
        captures it — the raison d'etre of BLOCK Krylov-Schur."""
        a = laplace2d(16, 16)
        op, n = op_of(a)
        res = block_krylov_schur(op, n, nev=4, m=32, nb=2, which="LM",
                                 tol=1e-9, symmetric=True)
        assert res.converged
        dense_w = np.linalg.eigvalsh(a.to_dense())
        want = np.sort(dense_w)[-4:][::-1]
        np.testing.assert_allclose(np.sort(res.eigenvalues.real)[::-1],
                                   want, rtol=1e-8)
        # eigenvector residuals
        ad = a.to_dense()
        for j in range(4):
            x = res.eigenvectors[:, j].real
            lam = res.eigenvalues[j].real
            assert np.linalg.norm(ad @ x - lam * x) <= 1e-7 * abs(lam)

    def test_laplace2d_extremal_symmetric(self):
        a = laplace2d(16, 12)  # rectangular grid: simple spectrum
        op, n = op_of(a)
        res = block_krylov_schur(op, n, nev=4, m=30, which="LM",
                                 tol=1e-9, symmetric=True)
        assert res.converged
        dense_w = np.linalg.eigvalsh(a.to_dense())
        want = np.sort(dense_w)[-4:][::-1]
        np.testing.assert_allclose(np.sort(res.eigenvalues.real)[::-1],
                                   want, rtol=1e-8)

    def test_restarts_exercised_laplace3d(self):
        """Small m forces several thick restarts; still converges."""
        a = laplace3d(8, 8, 8)  # cubic symmetry -> multiplicities: nb=2
        op, n = op_of(a)
        res = block_krylov_schur(op, n, nev=3, m=12, nb=2, which="LM",
                                 tol=1e-9, symmetric=True, max_restarts=60)
        assert res.converged
        assert res.iters > 12, "no restart happened"
        dense_w = np.linalg.eigvalsh(a.to_dense())
        want = np.sort(dense_w)[-3:][::-1]
        np.testing.assert_allclose(np.sort(res.eigenvalues.real)[::-1],
                                   want, rtol=1e-8)

    def test_nonsymmetric_recirc2d(self):
        """General (nonsymmetric) path: real Schur + ordered restart."""
        a = recirc2d(10, 10, diff=1e-1)
        op, n = op_of(a)
        res = block_krylov_schur(op, n, nev=4, m=24, which="LM",
                                 tol=1e-8, max_restarts=80)
        assert res.converged
        dense_w = np.linalg.eigvals(a.to_dense())
        want = dense_w[np.argsort(-np.abs(dense_w))[:4]]
        got = res.eigenvalues[np.argsort(-np.abs(res.eigenvalues))]
        np.testing.assert_allclose(np.sort(np.abs(got)),
                                   np.sort(np.abs(want)), rtol=1e-7)

    def test_smallest_real(self):
        a = laplace2d(12, 12)
        op, n = op_of(a)
        res = block_krylov_schur(op, n, nev=2, m=40, which="SR",
                                 tol=1e-8, symmetric=True, max_restarts=80)
        dense_w = np.linalg.eigvalsh(a.to_dense())
        np.testing.assert_allclose(np.sort(res.eigenvalues.real),
                                   dense_w[:2], rtol=1e-6)


class TestBlockDavidson:
    def test_smallest_with_jacobi_prec(self):
        from trilinos_tpu.eigen.davidson import block_davidson

        a = laplace2d(16, 12)
        op, n = op_of(a)
        d = a.diagonal()
        dinv = jnp.asarray(1.0 / d)
        prec = lambda r: dinv[:, None] * r
        res = block_davidson(op, n, nev=3, nb=3, prec=prec, which="SA",
                             tol=1e-9, maxiter=300)
        assert res.converged, res.resnorms
        dense_w = np.linalg.eigvalsh(a.to_dense())
        np.testing.assert_allclose(np.sort(res.eigenvalues),
                                   dense_w[:3], rtol=1e-8)
        ad = a.to_dense()
        for j in range(3):
            x = res.eigenvectors[:, j]
            lam = res.eigenvalues[j]
            assert np.linalg.norm(ad @ x - lam * x) <= 1e-7

    def test_largest_multiplicity(self):
        from trilinos_tpu.eigen.davidson import block_davidson

        a = laplace2d(16, 16)  # double top eigenvalue
        op, n = op_of(a)
        res = block_davidson(op, n, nev=3, nb=3, which="LA",
                             tol=1e-8, maxiter=400)
        assert res.converged
        dense_w = np.linalg.eigvalsh(a.to_dense())
        np.testing.assert_allclose(np.sort(res.eigenvalues)[::-1],
                                   np.sort(dense_w)[-3:][::-1], rtol=1e-7)

    def test_restart_exercised(self):
        from trilinos_tpu.eigen.davidson import block_davidson

        a = laplace2d(14, 10)
        op, n = op_of(a)
        res = block_davidson(op, n, nev=2, nb=2, smax=8, which="SA",
                             tol=1e-8, maxiter=400)
        assert res.converged
        assert res.iters > 4  # space of 8 with nb=2 fills in 3 steps
        dense_w = np.linalg.eigvalsh(a.to_dense())
        np.testing.assert_allclose(np.sort(res.eigenvalues),
                                   dense_w[:2], rtol=1e-7)


class TestTraceMin:
    def test_smallest_laplace2d(self):
        from trilinos_tpu.eigen import tracemin

        a = laplace2d(14, 10)
        op, n = op_of(a)
        res = tracemin(op, n, nev=3, inner_iters=25, tol=1e-9,
                       maxiter=200)
        assert res.converged, res.resnorms
        dense_w = np.linalg.eigvalsh(a.to_dense())
        np.testing.assert_allclose(np.sort(res.eigenvalues),
                                   dense_w[:3], rtol=1e-7)
        ad = a.to_dense()
        for j in range(3):
            x = res.eigenvectors[:, j]
            lam = res.eigenvalues[j]
            assert np.linalg.norm(ad @ x - lam * x) <= 1e-6


class TestGeneralizedDavidson:
    def test_nonsymmetric_lm(self):
        from trilinos_tpu.eigen.gen_davidson import generalized_davidson

        a = recirc2d(10, 10, diff=1e-1)
        op, n = op_of(a)
        res = generalized_davidson(op, n, nev=4, nb=4, which="LM",
                                   tol=1e-8, maxiter=200)
        assert res.converged, res.resnorms
        dense_w = np.linalg.eigvals(a.to_dense())
        want = np.sort(np.abs(dense_w))[-4:]
        got = np.sort(np.abs(res.eigenvalues))[-4:]
        np.testing.assert_allclose(got, want, rtol=1e-6)

    def test_smallest_real_with_prec(self):
        from trilinos_tpu.eigen.gen_davidson import generalized_davidson

        a = recirc2d(8, 8, diff=5e-1)
        op, n = op_of(a)
        d = a.diagonal()
        dinv = jnp.asarray(1.0 / d)
        prec = lambda r: dinv[:, None] * r
        res = generalized_davidson(op, n, nev=2, nb=2, which="SR",
                                   prec=prec, tol=1e-8, maxiter=300)
        assert res.converged
        dense_w = np.linalg.eigvals(a.to_dense())
        want = np.sort(dense_w.real)[:2]
        got = np.sort(res.eigenvalues.real)[:2]
        np.testing.assert_allclose(got, want, rtol=1e-6)

    def test_restart_exercised(self):
        from trilinos_tpu.eigen.gen_davidson import generalized_davidson

        a = recirc2d(10, 10, diff=1e-1)
        op, n = op_of(a)
        res = generalized_davidson(op, n, nev=2, nb=2, smax=8, which="LM",
                                   tol=1e-8, maxiter=300)
        assert res.converged
        assert res.iters > 4


class TestRtr:
    def test_smallest_laplace2d(self):
        from trilinos_tpu.eigen.rtr import rtr

        a = laplace2d(14, 11)
        op, n = op_of(a)
        res = rtr(op, n, nev=3, block=5, tol=1e-9, maxiter=200)
        assert res.converged, res.resnorms
        dense_w = np.linalg.eigvalsh(a.to_dense())
        np.testing.assert_allclose(np.sort(res.eigenvalues),
                                   dense_w[:3], rtol=1e-7)
        ad = a.to_dense()
        for j in range(3):
            x = res.eigenvectors[:, j]
            lam = res.eigenvalues[j]
            assert np.linalg.norm(ad @ x - lam * x) <= 1e-6

    def test_trust_region_shrinks_on_bad_model(self):
        """Solver must survive tiny initial radius (forces rho updates)."""
        from trilinos_tpu.eigen.rtr import rtr

        a = laplace2d(10, 10)
        op, n = op_of(a)
        res = rtr(op, n, nev=2, block=3, tol=1e-8, maxiter=300)
        assert res.converged
        dense_w = np.linalg.eigvalsh(a.to_dense())
        np.testing.assert_allclose(np.sort(res.eigenvalues),
                                   dense_w[:2], rtol=1e-6)


class TestShiftInvert:
    """Anasazi shift-and-invert mode: interior eigenvalues via a
    matrix-free inner Krylov solve (eigen/spectral.py)."""

    def test_interior_eigs_laplace2d(self):
        import numpy as np

        import jax.numpy as jnp

        from trilinos_tpu.eigen import eigs_near
        from trilinos_tpu.galeri import laplace2d
        from trilinos_tpu.ops import choose_format, spmv

        nx = 12
        a = laplace2d(nx, nx)
        dev = choose_format(a)
        n, npad = a.shape[0], dev.n_rows_pad
        dense = a.to_dense()
        lams = np.linalg.eigvalsh(dense)
        sigma = 3.0  # interior of [~0.13, ~7.9]
        v0 = np.zeros(npad)
        v0[:n] = np.random.default_rng(0).standard_normal(n)
        lam, vecs = eigs_near(lambda v: spmv(dev, v), sigma, 4,
                              jnp.asarray(v0), m=60)
        want = lams[np.argsort(np.abs(lams - sigma))[:4]]
        got = np.sort(np.asarray(lam))
        np.testing.assert_allclose(got, np.sort(want), atol=1e-7)
        # residual check on the nearest pair
        x = np.asarray(vecs[:, 0])[:n]
        l0 = float(lam[0])
        r = dense @ x - l0 * x
        assert np.linalg.norm(r) < 1e-6 * max(abs(l0), 1.0)
