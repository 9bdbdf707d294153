"""Matrix filters — views/transforms used to build preconditioners.

JAX analogue of Ifpack2's filter family
(packages/ifpack2/src/Ifpack2_LocalFilter_decl.hpp — drop off-process
entries; Ifpack2_DiagonalFilter_decl.hpp, Ifpack2_DropFilter_decl.hpp,
Ifpack2_SparsityFilter_decl.hpp, Ifpack2_SingletonFilter_decl.hpp,
Ifpack2_ReorderFilter_decl.hpp) and of Ifpack's condition estimation
(packages/ifpack/src/Ifpack_Condest.h).

All filters are host CSR → host CSR transforms applied at preconditioner
setup time (the reference's filters are lazy views; with one-shot setup
an eager copy is simpler and equally fast).
"""
from __future__ import annotations

import numpy as np

from .formats import CsrHost


def local_filter(a: CsrHost, lo: int, hi: int) -> CsrHost:
    """Rows lo..hi restricted to columns lo..hi, renumbered from 0
    (Ifpack2::LocalFilter — the basis of process-local preconditioners)."""
    rows = np.repeat(np.arange(a.shape[0], dtype=np.int64),
                     a.row_lengths())
    cols = a.cols.astype(np.int64)
    keep = (rows >= lo) & (rows < hi) & (cols >= lo) & (cols < hi)
    return CsrHost.from_coo(rows[keep] - lo, cols[keep] - lo, a.vals[keep],
                            (hi - lo, hi - lo), sum_duplicates=False)


def diagonal_filter(a: CsrHost, absolute_threshold: float = 0.0,
                    relative_threshold: float = 1.0) -> CsrHost:
    """Perturb the diagonal: d ← relative·d + sign(d)·absolute
    (Ifpack2::DiagonalFilter — stabilizes incomplete factorizations)."""
    rows = np.repeat(np.arange(a.shape[0], dtype=np.int64),
                     a.row_lengths())
    vals = a.vals.copy()
    on_diag = rows == a.cols
    d = vals[on_diag]
    vals[on_diag] = (relative_threshold * d
                     + np.where(d >= 0, 1.0, -1.0) * absolute_threshold)
    return CsrHost.from_coo(rows, a.cols, vals, a.shape,
                            sum_duplicates=False)


def drop_filter(a: CsrHost, drop_tol: float) -> CsrHost:
    """Drop off-diagonal entries with |a_ij| < drop_tol
    (Ifpack2::DropFilter)."""
    rows = np.repeat(np.arange(a.shape[0], dtype=np.int64),
                     a.row_lengths())
    keep = (rows == a.cols) | (np.abs(a.vals) >= drop_tol)
    return CsrHost.from_coo(rows[keep], a.cols[keep], a.vals[keep], a.shape,
                            sum_duplicates=False)


def sparsity_filter(a: CsrHost, max_entries_per_row: int,
                    max_bandwidth: int | None = None) -> CsrHost:
    """Keep only the largest max_entries_per_row off-diagonals per row,
    optionally within a bandwidth (Ifpack2::SparsityFilter)."""
    out_r, out_c, out_v = [], [], []
    for i in range(a.shape[0]):
        c, v = a.row(i)
        if max_bandwidth is not None:
            sel = np.abs(c - i) <= max_bandwidth
            c, v = c[sel], v[sel]
        diag = c == i
        offc, offv = c[~diag], v[~diag]
        if len(offv) > max_entries_per_row:
            keep = np.argsort(-np.abs(offv))[:max_entries_per_row]
            offc, offv = offc[keep], offv[keep]
        out_r.append(np.full(len(offc) + diag.sum(), i))
        out_c.append(np.concatenate([offc, c[diag]]))
        out_v.append(np.concatenate([offv, v[diag]]))
    return CsrHost.from_coo(np.concatenate(out_r), np.concatenate(out_c),
                            np.concatenate(out_v), a.shape,
                            sum_duplicates=False)


def singleton_filter(a: CsrHost) -> tuple[CsrHost, np.ndarray]:
    """Remove rows with a single entry (Dirichlet rows), returning the
    reduced matrix and the kept-row index array
    (Ifpack2::SingletonFilter)."""
    lens = a.row_lengths()
    keep_rows = np.nonzero(lens > 1)[0]
    renum = -np.ones(a.shape[0], dtype=np.int64)
    renum[keep_rows] = np.arange(len(keep_rows))
    rows = np.repeat(np.arange(a.shape[0], dtype=np.int64), lens)
    cols = a.cols.astype(np.int64)
    keep = (renum[rows] >= 0) & (renum[cols] >= 0)
    m = len(keep_rows)
    return (CsrHost.from_coo(renum[rows[keep]], renum[cols[keep]],
                             a.vals[keep], (m, m), sum_duplicates=False),
            keep_rows)


def reorder_filter(a: CsrHost, perm: np.ndarray) -> CsrHost:
    """Symmetric permutation view (Ifpack2::ReorderFilter)."""
    from ..parallel.partition import permute_csr

    return permute_csr(a, perm)


def condest(prec, n_pad: int, method: str = "cheap", iters: int = 10,
            seed: int = 0) -> float:
    """Condition-number proxy of a preconditioner/operator apply
    (Ifpack_Condest.h): 'cheap' = ‖M⁻¹ 1‖_inf (the reference's default),
    'power' = power-method estimate of ‖M⁻¹‖₂, 'lanczos' = two-sided
    λmax/λmin from extreme Ritz values (the AztecOO AZ_*_condnum
    companion estimate, az_aztec_defs.h:266-272 — valid for SPD
    applies)."""
    import jax.numpy as jnp

    if method == "lanczos":
        from ..eigen import arnoldi

        rng = np.random.default_rng(seed)
        v0 = jnp.asarray(rng.standard_normal(n_pad))
        m = min(max(4 * iters, 40), n_pad - 1)
        # ONE factorization yields both extreme Ritz values
        _, h = arnoldi(prec, v0, m)
        t = (h[:m, :] + h[:m, :].T) / 2
        theta = jnp.linalg.eigvalsh(t)
        return float(theta[-1] / jnp.maximum(theta[0], 1e-300))
    if method == "cheap":
        ones = jnp.ones(n_pad)
        return float(jnp.max(jnp.abs(prec(ones))))
    if method == "power":
        rng = np.random.default_rng(seed)
        v = jnp.asarray(rng.standard_normal(n_pad))
        v = v / jnp.linalg.norm(v)
        lam = 1.0
        for _ in range(iters):
            w = prec(v)
            lam = float(jnp.linalg.norm(w))
            v = w / max(lam, 1e-300)
        return lam
    raise ValueError(f"unknown condest method {method!r}")
