"""The five driver BASELINE configs (BASELINE.md), scaled to test size.

1. Galeri Laplace2D 100², unprec CG rtol 1e-8, single host
2. Laplace3D BSR, Jacobi-GMRES(30), SpMM nrhs=4
3. MatrixMarket/HB suite, block-GMRES + ILU(0) + DGKS
4. Row-partitioned Laplace3D across hosts: halo-overlap SpMV + pipelined CG
5. block-GMRES nrhs=16 + CGS2 on a stencil matrix over a mesh
"""
import numpy as np
import pytest

import jax.numpy as jnp

from trilinos_tpu.galeri import laplace2d, laplace3d
from trilinos_tpu.ops import formats as F
import trilinos_tpu.ops.matvec as S
from trilinos_tpu.parallel import distmatrix as D, driver as drv
from trilinos_tpu import precond
from trilinos_tpu.solvers import block_gmres, cg, cg_pipeline, gmres


def rel_res(b, dense, x, n):
    bb, xx = np.asarray(b)[:n], np.asarray(x)[:n]
    return np.linalg.norm(bb - dense @ xx, axis=0) / np.linalg.norm(bb, axis=0)


def test_config1_laplace2d_100_cg():
    a = laplace2d(100, 100)
    dev = F.csr_to_dia(a)
    n = 10000
    b = np.zeros(dev.n_rows_pad)
    b[:n] = np.random.default_rng(0).standard_normal(n)
    res = cg(lambda x: S.spmv(dev, x), jnp.asarray(b), rtol=1e-8)
    assert bool(res.converged)
    # spot-check the true residual on a subsample (dense 10k² is heavy)
    x = np.asarray(res.x)[:n]
    r = b[:n].copy()
    rows = np.repeat(np.arange(n), a.row_lengths())
    np.subtract.at(r, rows, a.vals * x[a.cols])
    assert np.linalg.norm(r) <= 1.2e-8 * np.linalg.norm(b[:n])


def test_config2_laplace3d_bsr_jacobi_gmres_spmm():
    a = laplace3d(8, 8, 8)  # 64^3 scaled to 8^3 for CI; structure identical
    bsr = F.csr_to_bsr(a, block_size=4)
    n = a.shape[0]
    npad = bsr.n_brows_pad * bsr.block_size
    rng = np.random.default_rng(1)
    b = np.zeros((npad, 4))
    b[:n] = rng.standard_normal((n, 4))
    op = lambda x: S.spmv(bsr, x)  # BSR SpMM path
    m = precond.Relaxation(a).compute()

    def prec(v):
        out = m(v[: m.dinv.shape[0]])
        pad = npad - out.shape[0]
        widths = ((0, pad),) + ((0, 0),) * (out.ndim - 1)
        return jnp.pad(out, widths)

    res = gmres(op, jnp.asarray(b), prec=prec, restart=30, rtol=1e-8,
                maxiter=600)
    assert (rel_res(b, a.to_dense(), res.x, n) <= 1e-7).all()


def test_config3_hb_suite_block_gmres_ilu_dgks():
    import os

    p = "/root/reference/packages/belos/epetra/example/GCRODR/sherman5.hb"
    if not os.path.exists(p):
        pytest.skip("reference HB matrix unavailable")
    from trilinos_tpu.io import read_hb

    a = read_hb(p)
    dev = F.csr_to_ell(a)
    n, npad = a.shape[0], dev.n_rows_pad
    rng = np.random.default_rng(2)
    b = np.zeros((npad, 2))
    b[:n] = rng.standard_normal((n, 2))
    ilu = precond.Ilu0(a, {"fact: sweeps": 20}).compute()
    res = block_gmres(lambda x: S.spmv(dev, x), jnp.asarray(b),
                      prec=ilu, num_blocks=60, max_restarts=20, rtol=1e-8,
                      ortho="DGKS")
    assert (rel_res(b, a.to_dense(), res.x, n) <= 1e-6).all()


def test_config4_dist_laplace3d_pipelined_cg():
    a = laplace3d(12, 12, 12)  # 128^3 scaled down; same comm structure
    dm = D.distribute(a, 2)  # "2 hosts"
    assert dm.plan.mode == "ppermute"  # halo rides neighbor permutes
    mesh = drv.make_mesh(2)
    n = a.shape[0]
    b = np.random.default_rng(3).standard_normal(n)
    bg = jnp.asarray(dm.row_map.to_padded(b))
    res = drv.dist_solve(cg_pipeline, dm, bg, mesh=mesh, rtol=1e-8)
    x = dm.row_map.from_padded(np.asarray(res.x))
    assert (np.linalg.norm(b - a.to_dense() @ x)
            <= 1.1e-8 * np.linalg.norm(b))


def test_config5_dist_block_gmres_nrhs16_cgs2():
    a = laplace3d(10, 10, 8)
    dm = D.distribute(a, 4)
    mesh = drv.make_mesh(4)
    n = a.shape[0]
    rng = np.random.default_rng(4)
    b = rng.standard_normal((n, 16))
    bg = jnp.asarray(dm.row_map.to_padded(b))
    res = drv.dist_solve(block_gmres, dm, bg, mesh=mesh, num_blocks=25,
                         max_restarts=10, rtol=1e-8, ortho="CGS2")
    x = dm.row_map.from_padded(np.asarray(res.x))
    rel = (np.linalg.norm(b - a.to_dense() @ x, axis=0)
           / np.linalg.norm(b, axis=0))
    assert (rel <= 1e-7).all()
    assert bool(np.asarray(res.converged).all())
