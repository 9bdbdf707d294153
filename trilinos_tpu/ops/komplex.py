"""Complex linear systems via equivalent real 2x2 forms.

JAX analogue of the Komplex package
(packages/komplex/src/Komplex_LinearProblem.h): a complex system
(Ar + i·Ai)(xr + i·xi) = (br + i·bi) is solved as the real 2n system

    [ Ar  −Ai ] [xr]   [br]
    [ Ai   Ar ] [xi] = [bi]

(the K1 formulation). XLA has no complex-sparse fast path, so this is the
idiomatic route for complex solves.
"""
from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from .formats import CsrHost


def complex_to_real_csr(ar: CsrHost, ai: CsrHost) -> CsrHost:
    """Build the 2n×2n equivalent real form from Re/Im parts."""
    if ar.shape != ai.shape:
        raise ValueError("Re/Im shape mismatch")
    n = ar.shape[0]
    rr = np.repeat(np.arange(n, dtype=np.int64), ar.row_lengths())
    ri = np.repeat(np.arange(n, dtype=np.int64), ai.row_lengths())
    # blocks: Ar (top-left), −Ai (top-right), Ai (bottom-left), Ar (bottom-right)
    rows = np.concatenate([rr, ri, ri + n, rr + n])
    cols = np.concatenate([ar.cols.astype(np.int64),
                           ai.cols.astype(np.int64) + n,
                           ai.cols.astype(np.int64),
                           ar.cols.astype(np.int64) + n])
    vals = np.concatenate([ar.vals, -ai.vals, ai.vals, ar.vals])
    return CsrHost.from_coo(rows, cols, vals, (2 * n, 2 * n),
                            sum_duplicates=True)


def complex_matrix_to_real(a_complex) -> CsrHost:
    """From a complex dense/CsrHost-with-complex-vals input."""
    if isinstance(a_complex, CsrHost):
        rows = np.repeat(np.arange(a_complex.shape[0], dtype=np.int64),
                         a_complex.row_lengths())
        ar = CsrHost.from_coo(rows, a_complex.cols,
                              np.real(a_complex.vals), a_complex.shape)
        ai = CsrHost.from_coo(rows, a_complex.cols,
                              np.imag(a_complex.vals), a_complex.shape)
        return complex_to_real_csr(ar, ai)
    dense = np.asarray(a_complex)
    return complex_to_real_csr(CsrHost.from_dense(np.real(dense)),
                               CsrHost.from_dense(np.imag(dense)))


def complex_vec_to_real(z, n_pad: int | None = None):
    """[Re(z); Im(z)] with optional per-half padding."""
    z = np.asarray(z)
    n = z.shape[0]
    half = n_pad if n_pad is not None else n
    shape = (2 * half,) + z.shape[1:]
    out = np.zeros(shape, dtype=np.real(z).dtype)
    out[:n] = np.real(z)
    out[half:half + n] = np.imag(z)
    return jnp.asarray(out)


def real_vec_to_complex(x, n: int, n_pad: int | None = None):
    x = np.asarray(x)
    half = n_pad if n_pad is not None else n
    return x[:n] + 1j * x[half:half + n]


def solve_complex(a, b, params=None, comm=None):
    """End-to-end complex solve — the ``Komplex_LinearProblem`` driver
    (packages/komplex/src/Komplex_LinearProblem.h: build the equivalent
    real form, hand it to AztecOO, extract the complex solution; here the
    solver×preconditioner pair comes from the Stratimikos-style
    ``factory.build`` ParameterList).

    ``a``: complex dense array, CsrHost with complex values, or an
    ``(ar, ai)`` CsrHost pair. ``b``: complex vector. ``params`` uses the
    ``build`` layout, e.g.::

        {"Linear Solver Type": "GMRES",
         "Solver Types": {"GMRES": {"Convergence Tolerance": 1e-10}},
         "Preconditioner Type": "ILUT"}

    Returns ``(z, result)``: the complex solution and the real-form
    SolveResult (resnorm is measured on the equivalent real system;
    ‖r_real‖₂ = ‖r_complex‖₂, so tolerances carry over exactly).
    """
    from . import choose_format, spmv
    from ..solvers.factory import build
    from ..solvers.linear_problem import LinearProblem

    if isinstance(a, tuple):
        erf = complex_to_real_csr(*a)
    else:
        erf = complex_matrix_to_real(a)
    n = erf.shape[0] // 2
    b = np.asarray(b)
    if b.shape[0] != n:
        raise ValueError(f"rhs length {b.shape[0]} != matrix order {n}")

    mgr, prec = build(params or {"Linear Solver Type": "GMRES"}, a_csr=erf,
                      comm=comm)
    dev = choose_format(erf)
    npad = dev.n_rows_pad
    b_real = np.zeros(npad, dtype=erf.vals.dtype)
    b_real[: 2 * n] = np.asarray(complex_vec_to_real(b))
    problem = LinearProblem(op=lambda x: spmv(dev, x),
                            b=jnp.asarray(b_real), right_prec=prec)
    res = mgr.solve(problem)
    return real_vec_to_complex(np.asarray(res.x), n), res
