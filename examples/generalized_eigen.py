"""Generalized eigenproblems K x = λ M x from an FE discretization.

The Laplace eigenproblem −Δu = λ u on the unit square (u|∂Ω = 0),
discretized with P1 triangles (fem/assembly.py), produces the pencil
(K, M) of stiffness and CONSISTENT mass matrices — the canonical
Anasazi generalized problem (AnasaziBasicEigenproblem.hpp setM). Every
symmetric eigensolver kind here honors the mass operator:

  LOBPCG       — mass-Gram Rayleigh-Ritz              (lobpcg.py)
  TraceMin     — AZ = MY inner solves                 (tracemin.py)
  Krylov-Schur — M-inner-product Lanczos on M⁻¹K      (krylov_schur.py)
  Davidson     — M-orthonormal search space           (davidson.py)
  Gen.Davidson — M-orthonormal + sorted real Schur    (gen_davidson.py)
  RTR          — M-orthonormal Grassmann trust region (rtr.py)

Exact eigenvalues of the continuous problem: π²(p² + q²), p,q ≥ 1 —
the discrete values converge to them from above as the mesh refines.

Run: python examples/generalized_eigen.py
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np
import scipy.sparse as sp

import jax
import jax.numpy as jnp

jax.config.update("jax_enable_x64", True)

from trilinos_tpu.eigen import EigenProblem, create_eigensolver
from trilinos_tpu.fem.assembly import mass_matrix, stiffness_matrix
from trilinos_tpu.fem.mesh import structured_tri_mesh
from trilinos_tpu.ops import formats as F
from trilinos_tpu.ops import matvec as S


def build_pencil(nn=13):
    mesh = structured_tri_mesh(nn, nn)
    k, _, xy = stiffness_matrix(mesh)
    m, _, _ = mass_matrix(mesh)
    interior = np.nonzero(
        (xy[:, 0] > 1e-12) & (xy[:, 0] < 1 - 1e-12)
        & (xy[:, 1] > 1e-12) & (xy[:, 1] < 1 - 1e-12))[0]
    k_sp = sp.csr_matrix((k.vals, k.cols, k.row_ptr), shape=k.shape)
    m_sp = sp.csr_matrix((m.vals, m.cols, m.row_ptr), shape=m.shape)
    k_i = k_sp[np.ix_(interior, interior)].tocsr()
    m_i = m_sp[np.ix_(interior, interior)].tocsr()
    return (F.CsrHost(k_i.indptr.astype(np.int64), k_i.indices, k_i.data,
                      k_i.shape),
            F.CsrHost(m_i.indptr.astype(np.int64), m_i.indices, m_i.data,
                      m_i.shape))


def padded_zero_ops(ka, ma):
    """Device operators with the identity padding ZEROED so the pad
    subspace is (K=0, M=0)-invariant (no spurious λ=1 pencil branch)."""
    import dataclasses

    n = ka.shape[0]
    kd, md = F.csr_to_ell(ka), F.csr_to_ell(ma)
    mask = (jnp.arange(kd.n_rows_pad) < n)[:, None]
    kd = dataclasses.replace(kd, vals=kd.vals * mask.astype(kd.vals.dtype))
    md = dataclasses.replace(md, vals=md.vals * mask.astype(md.vals.dtype))
    return (lambda x: S.spmv(kd, x)), (lambda x: S.spmv(md, x)), \
        n, kd.n_rows_pad


def main():
    ka, ma = build_pencil()
    op, mop, n, npad = padded_zero_ops(ka, ma)
    nev = 4
    exact = np.sort([np.pi ** 2 * (p * p + q * q)
                     for p in range(1, 4) for q in range(1, 4)])[:nev]
    rng = np.random.default_rng(0)
    v0 = np.zeros((npad, nev))
    v0[:n] = rng.standard_normal((n, nev))
    print(f"pencil: n={n}  continuous eigenvalues ≈ {np.round(exact, 2)}")
    for name in ("LOBPCG", "TraceMin", "Block Krylov Schur",
                 "Block Davidson", "Generalized Davidson", "RTR"):
        mgr = create_eigensolver(name, {"Which": "SM", "Block Size": nev,
                                        "Convergence Tolerance": 1e-8,
                                        "Maximum Iterations": 300})
        prob = EigenProblem(op=op, n=npad, nev=nev, m=mop, v0=v0)
        res = mgr.solve(prob)
        vals = np.sort(np.real(np.asarray(res.eigenvalues)))[:nev]
        conv = getattr(res, "converged",  # LOBPCG's EigenResult has no
                       None)              # flag; resnorms tell the story
        print(f"{name:22s} λ = {np.round(vals, 4)}  "
              f"iters={int(np.asarray(res.iters))}  "
              f"max-resnorm={float(np.max(np.asarray(res.resnorms))):.2e}"
              + (f"  converged={conv}" if conv is not None else ""))


if __name__ == "__main__":
    main()
