"""Compensated (double-single / float-float) reductions for f32 solves.

SURVEY hard part #5: Belos' tolerance machinery assumes f64
(BelosDGKSOrthoManager.hpp:99-107 — blk_tol/sing_tol are f64-calibrated);
an f32 solve (bf16/f32 storage to halve memory traffic) has no f64
accumulator. This module supplies f64-grade accuracy for the reductions
that dominate Krylov rounding error —
dot products and norms — as error-free-transformation arithmetic:

  * ``two_sum``  — Knuth's exact addition: a+b = s + e with e exact;
  * ``two_prod`` — Dekker's exact product via operand splitting (no fma
    primitive needed): a·b = p + e exactly;
  * ``comp_sum`` — float-float pairwise tree reduction: log2(n) vectorized
    sweeps combining (hi, lo) partials with renormalization — maps to
    pure elementwise ops, no sequential scan;
  * ``comp_dot`` — the Ogita-Rump-Oishi Dot2: two_prod per element, then
    the compensated tree sum of products AND product errors. Result
    accurate to ~eps_f32 (final rounding) instead of the ~log2(n)·eps to
    n·eps of a plain reduction — effectively a double-precision
    accumulator carried in two f32 words.

Cost: ~10 elementwise flops/element extra — bandwidth-bound dots barely
notice. Distributed use: psum hi and lo separately
(both are f32 leaves; one fused reduction) then renormalize — see
``Comm``-taking helpers at the bottom.
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp


def _split_const(dtype) -> float:
    # Dekker splitter 2^ceil(p/2)+1: f32 (p=24) -> 2^12+1; f64 -> 2^27+1.
    # Keyed on the exact dtype, NOT itemsize (complex64 shares itemsize 8
    # with f64 and would silently pick the wrong splitter); complex needs
    # conjugated products these transforms do not implement, and
    # bf16/f16 have no EFT value here — fail loudly for all of them.
    dt = jnp.dtype(dtype)
    if dt == jnp.dtype(jnp.float32):
        return 4097.0
    if dt == jnp.dtype(jnp.float64):
        return 134217729.0
    raise TypeError(
        f"compensated (double-single) reductions support real f32/f64 "
        f"only, got {dt}")


def two_sum(a, b):
    """Knuth TwoSum: s = fl(a+b), e exact error; a+b == s+e."""
    s = a + b
    v = s - a
    e = (a - (s - v)) + (b - v)
    return s, e


def fast_two_sum(a, b):
    """Dekker's FastTwoSum (requires |a| >= |b| or a == 0)."""
    s = a + b
    e = b - (s - a)
    return s, e


def two_prod(a, b):
    """Dekker TwoProd: p = fl(a*b), e exact error; a*b == p+e."""
    p = a * b
    c = _split_const(p.dtype) * a
    a_hi = c - (c - a)
    a_lo = a - a_hi
    c = _split_const(p.dtype) * b
    b_hi = c - (c - b)
    b_lo = b - b_hi
    e = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, e


def _renorm(hi, lo):
    s = hi + lo
    return s, lo - (s - hi)


def comp_sum(x, axis: int = 0):
    """Float-float tree sum along ``axis``: returns (hi, lo) with
    hi+lo ≈ the exact sum rounded twice. log2(n) vectorized halving
    sweeps; n need not be a power of two (odd tails carried). The first
    sweep runs without a lo array (it is identically zero), halving the
    dominant-memory-traffic pass."""
    x = jnp.moveaxis(x, axis, 0)
    n = x.shape[0]
    if n == 1:
        return x[0], jnp.zeros_like(x[0])
    half = n // 2
    hi, lo = two_sum(x[:half], x[half:2 * half])
    if n % 2:
        t_hi, t_lo = two_sum(hi[:1], x[-1:])
        hi = jnp.concatenate([t_hi, hi[1:]])
        lo = jnp.concatenate([t_lo + lo[:1], lo[1:]])
    while hi.shape[0] > 1:
        n = hi.shape[0]
        half = n // 2
        a_hi, a_lo = hi[:half], lo[:half]
        b_hi, b_lo = hi[half:2 * half], lo[half:2 * half]
        s, e = two_sum(a_hi, b_hi)
        lo2 = e + (a_lo + b_lo)
        s, lo2 = _renorm(s, lo2)
        if n % 2:
            t_hi, t_lo = two_sum(s[:1], hi[-1:])
            s = jnp.concatenate([t_hi, s[1:]])
            lo2 = jnp.concatenate([t_lo + lo[-1:] + lo2[:1], lo2[1:]])
        hi, lo = s, lo2
    return hi[0], lo[0]


def comp_dot(x, y, axis: int = 0):
    """Dot2 (Ogita-Rump-Oishi): compensated xᵀy along ``axis``. Returns
    (hi, lo); ``hi + lo`` carries ~2×-precision accuracy.

    The per-element product errors are O(eps·|p_i|); summing them with a
    PLAIN reduction rounds each at O(eps²·|p|) — below the result's own
    final rounding — so only the product-sum pays the compensated tree."""
    p, e = two_prod(x, y)
    hi, lo = comp_sum(p, axis)
    e_sum = jnp.sum(e, axis=axis)
    s, t = two_sum(hi, e_sum)
    return _renorm(s, t + lo)


def comp_local_dot(x, y):
    """Columnwise compensated dot: (n,)→(2,) or (n,k)→(2,k) stacking
    [hi, lo] — shaped for ONE fused psum of both words."""
    hi, lo = comp_dot(x, y, axis=0)
    return jnp.stack([hi, lo])


def psum_ff(comm, hl):
    """Reduce stacked (2, ...) [hi, lo] partials across shards and
    collapse: one psum (both words ride together), then renormalize.
    Cross-shard accumulation of hi happens in the collective (f32 tree
    over P terms — P is small), lo corrections are summed exactly
    enough at P ≤ 64."""
    s = comm.psum(hl)
    hi, lo = _renorm(s[0], s[1])
    return hi + lo


def comp_dot_global(comm, x, y):
    """Global compensated columnwise dot (the lclDot+reduceAll split of
    Tpetra::MultiVector::dot with a double-single accumulator)."""
    return psum_ff(comm, comp_local_dot(x, y))


def comp_norm2(comm, x):
    return jnp.sqrt(comp_dot_global(comm, x, x))
