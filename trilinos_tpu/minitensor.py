"""Small-tensor math for constitutive models (the MiniTensor analogue).

Reference: packages/minitensor/src — MiniTensor_LinearAlgebra.h (norms,
inverse, det/trace/invariants, exp/log, svd, polar decompositions,
eig_sym, cholesky, solve, cond), MiniTensor_Mechanics.h (vol/dev,
push-forward/pull-back, Piola transforms, ellipticity checks),
MiniTensor_Tensor4.h (4th-order identities, C:E contraction).
MiniTensor_Solvers.h (small Newton/TR solvers) is covered by the
framework's ``nonlinear``/``optim`` packages and is not duplicated here.

Accelerator-first design: the reference's Tensor<T, N> is a single small matrix
manipulated in scalar C++ loops at one integration point. Here EVERY
function is batched over arbitrary leading axes — a (ne, q, d, d) array
of deformation gradients goes through ``polar_left`` as a handful of
fused XLA ops over all elements x quadrature points at once — and every
function is jit/vmap/grad-composable, so constitutive models written
with this module drop straight into the fem assembly and the autodiff
Jacobians of ``nonlinear``. Dense contractions pin
``precision="highest"`` (a TF32 default on the GPU loses ~3 digits, which a
3x3 inverse amplifies).

Closed-form 2x2/3x3 kernels are used where XLA's batched LAPACK-style
ops would serialize (det, inverse, symmetric eigenvalues); jnp.linalg
(eigh/svd/cholesky/solve) backs the rest — all batched natively.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp
from jax.scipy.linalg import expm as _expm


def _einsum(spec, *ops):
    return jnp.einsum(spec, *ops, precision="highest")


# ---------------------------------------------------------------- basics

def identity(dim, dtype=jnp.float32):
    return jnp.eye(dim, dtype=dtype)


def transpose(a):
    return jnp.swapaxes(a, -1, -2)


def sym(a):
    return 0.5 * (a + transpose(a))


def skew(a):
    return 0.5 * (a - transpose(a))


def trace(a):
    return jnp.trace(a, axis1=-2, axis2=-1)


def dot(a, b):
    """Single contraction a_ij b_jk (matrix product), batched."""
    return _einsum("...ij,...jk->...ik", a, b)


def dotdot(a, b):
    """Double contraction a_ij b_ij, batched."""
    return _einsum("...ij,...ij->...", a, b)


def dyad(u, v):
    """Outer product u_i v_j, batched."""
    return _einsum("...i,...j->...ij", u, v)


def norm(a):
    """Frobenius norm (MiniTensor_LinearAlgebra.h:56)."""
    return jnp.sqrt(dotdot(a, a))


def norm_1(a):
    """Max column sum (MiniTensor_LinearAlgebra.h:65)."""
    return jnp.max(jnp.sum(jnp.abs(a), axis=-2), axis=-1)


def norm_infinity(a):
    """Max row sum (MiniTensor_LinearAlgebra.h:74)."""
    return jnp.max(jnp.sum(jnp.abs(a), axis=-1), axis=-1)


def det(a):
    """Closed-form 1x1/2x2/3x3 determinant (batched); general fallback."""
    d = a.shape[-1]
    if d == 1:
        return a[..., 0, 0]
    if d == 2:
        return a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    if d == 3:
        return (a[..., 0, 0] * (a[..., 1, 1] * a[..., 2, 2]
                                - a[..., 1, 2] * a[..., 2, 1])
                - a[..., 0, 1] * (a[..., 1, 0] * a[..., 2, 2]
                                  - a[..., 1, 2] * a[..., 2, 0])
                + a[..., 0, 2] * (a[..., 1, 0] * a[..., 2, 1]
                                  - a[..., 1, 1] * a[..., 2, 0]))
    return jnp.linalg.det(a)


def inverse(a):
    """Closed-form adjugate inverse for 1x1/2x2/3x3 (the reference's
    inverse_fast23, MiniTensor_LinearAlgebra.h:94); LU fallback."""
    d = a.shape[-1]
    if d == 1:
        return 1.0 / a
    if d == 2:
        adj = jnp.stack([
            jnp.stack([a[..., 1, 1], -a[..., 0, 1]], axis=-1),
            jnp.stack([-a[..., 1, 0], a[..., 0, 0]], axis=-1),
        ], axis=-2)
        return adj / det(a)[..., None, None]
    if d == 3:
        c = jnp.stack([jnp.cross(a[..., 1, :], a[..., 2, :]),
                       jnp.cross(a[..., 2, :], a[..., 0, :]),
                       jnp.cross(a[..., 0, :], a[..., 1, :])], axis=-1)
        return c / det(a)[..., None, None]
    return jnp.linalg.inv(a)


def solve(a, b):
    """A x = b for small dense A (MiniTensor_LinearAlgebra.h:557)."""
    if b.ndim == a.ndim - 1:
        return _einsum("...ij,...j->...i", inverse(a), b)
    return dot(inverse(a), b)


def cholesky(a):
    return jnp.linalg.cholesky(a)


# ------------------------------------------------------------ invariants

def I1(a):
    """First invariant tr(A) (MiniTensor_LinearAlgebra.h:162)."""
    return trace(a)


def I2(a):
    """Second invariant 0.5(tr(A)^2 - tr(A^2))."""
    return 0.5 * (trace(a) ** 2 - trace(dot(a, a)))


def I3(a):
    """Third invariant det(A)."""
    return det(a)


def vol(a):
    """Volumetric part tr(A)/dim * I (MiniTensor_Mechanics.h:57)."""
    d = a.shape[-1]
    return (trace(a) / d)[..., None, None] * jnp.eye(d, dtype=a.dtype)


def dev(a):
    """Deviatoric part A - vol(A) (MiniTensor_Mechanics.h:67)."""
    return a - vol(a)


# ---------------------------------------------------- spectral / factors

def eig_sym(a):
    """Eigen-decomposition of a symmetric tensor: (eigenvalues ascending,
    eigenvectors as columns). Batched jnp.linalg.eigh
    (MiniTensor_LinearAlgebra.h:489)."""
    return jnp.linalg.eigh(a)


def eigvals_sym(a):
    """Closed-form symmetric eigenvalues (ascending) for 2x2/3x3 — the
    trigonometric method; jit-cheap for hot constitutive loops where the
    full eigh basis is not needed."""
    d = a.shape[-1]
    if d == 2:
        m = 0.5 * trace(a)
        r = jnp.sqrt(jnp.maximum(
            (0.5 * (a[..., 0, 0] - a[..., 1, 1])) ** 2
            + a[..., 0, 1] ** 2, 0.0))
        return jnp.stack([m - r, m + r], axis=-1)
    if d == 3:
        q = trace(a) / 3.0
        b = a - q[..., None, None] * jnp.eye(3, dtype=a.dtype)
        p = jnp.sqrt(jnp.maximum(dotdot(b, b) / 6.0, 0.0))
        safe_p = jnp.where(p > 0, p, 1.0)
        r = det(b) / (2.0 * safe_p ** 3)
        phi = jnp.arccos(jnp.clip(r, -1.0, 1.0)) / 3.0
        two_pi_3 = 2.0 * np.pi / 3.0
        e0 = q + 2.0 * p * jnp.cos(phi + 2.0 * two_pi_3)
        e1 = q + 2.0 * p * jnp.cos(phi + two_pi_3)
        e2 = q + 2.0 * p * jnp.cos(phi)
        lo = jnp.minimum(e0, e1)
        hi = jnp.maximum(e0, e1)
        ev = jnp.stack([lo, hi, e2], axis=-1)
        return jnp.where(p[..., None] > 0,
                         jnp.sort(ev, axis=-1),
                         jnp.broadcast_to(q[..., None], ev.shape))
    return jnp.linalg.eigvalsh(a)


def _spectral_apply(f, a):
    w, v = eig_sym(a)
    return _einsum("...ik,...k,...jk->...ij", v, f(w), v)


def exp_sym(a):
    """exp of a symmetric tensor via its spectrum."""
    return _spectral_apply(jnp.exp, a)


def log_sym(a):
    """log of an SPD tensor via its spectrum
    (MiniTensor_LinearAlgebra.h:254 log_eig_sym)."""
    return _spectral_apply(jnp.log, a)


def sqrt_sym(a):
    return _spectral_apply(jnp.sqrt, a)


def exp(a):
    """General matrix exponential (Pade + scaling-squaring;
    MiniTensor_LinearAlgebra.h:208 exp_pade)."""
    return _expm(a)


def exp_skew_symmetric(r):
    """Rodrigues closed form for 3x3 skew r
    (MiniTensor_LinearAlgebra.h:324); general expm otherwise."""
    if r.shape[-1] != 3:
        return _expm(r)
    w = jnp.stack([r[..., 2, 1], r[..., 0, 2], r[..., 1, 0]], axis=-1)
    th = jnp.sqrt(jnp.sum(w * w, axis=-1))
    safe = jnp.where(th > 0, th, 1.0)
    s = jnp.where(th > 0, jnp.sin(th) / safe, 1.0)[..., None, None]
    c = jnp.where(th > 0, (1 - jnp.cos(th)) / safe ** 2,
                  0.5)[..., None, None]
    return jnp.eye(3, dtype=r.dtype) + s * r + c * dot(r, r)


def svd(a):
    return jnp.linalg.svd(a, full_matrices=False)


def polar_rotation(a):
    """R from A = R U via SVD (MiniTensor_LinearAlgebra.h:388)."""
    u, _, vt = svd(a)
    return dot(u, vt)


def polar_right(a):
    """(R, U) with A = R U, U SPD (MiniTensor_LinearAlgebra.h:408)."""
    u, s, vt = svd(a)
    r = dot(u, vt)
    stretch = _einsum("...ki,...k,...kj->...ij", vt, s, vt)
    return r, stretch


def polar_left(a):
    """(V, R) with A = V R, V SPD (MiniTensor_LinearAlgebra.h:398)."""
    u, s, vt = svd(a)
    r = dot(u, vt)
    stretch = _einsum("...ik,...k,...jk->...ij", u, s, u)
    return stretch, r


def polar_left_logV(f):
    """(V, R, log V) — the Hencky-strain workhorse
    (MiniTensor_LinearAlgebra.h:437)."""
    u, s, vt = svd(f)
    r = dot(u, vt)
    v = _einsum("...ik,...k,...jk->...ij", u, s, u)
    logv = _einsum("...ik,...k,...jk->...ij", u, jnp.log(s), u)
    return v, r, logv


def log_rotation(r):
    """Skew log of a rotation (angle-axis; MiniTensor:264 +
    log_rotation_pi :274 for angles near pi, where skew(R) ~ 0 and the
    axis must come from the symmetric part instead)."""
    cos_th = jnp.clip(0.5 * (trace(r) - 1.0), -1.0, 1.0)
    th = jnp.arccos(cos_th)
    sk = skew(r)
    sin_ok = jnp.abs(jnp.sin(th)) > 1e-4
    safe = jnp.where(sin_ok, jnp.sin(th), 1.0)
    # theta ~ 0: th/sin(th) -> 1, generic form stays correct
    scale = jnp.where(sin_ok, th / safe, 1.0)
    generic = scale[..., None, None] * sk
    if r.shape[-1] != 3:
        return generic
    pi_case = jnp.logical_and(~sin_ok, cos_th < 0.0)
    # near pi: axis^2 from diag((R + I)/2); signs fixed so that
    # sign(v_i v_j) matches the off-diagonal symmetric part, anchored
    # on the largest component (branch-free batched form)
    b = 0.5 * (r + jnp.eye(3, dtype=r.dtype))
    v2 = jnp.clip(jnp.diagonal(b, axis1=-2, axis2=-1), 0.0, None)
    k = jnp.argmax(v2, axis=-1)
    vmag = jnp.sqrt(v2)
    # row k of the symmetric part gives v_k * v_j -> sign of v_j
    bsym = 0.5 * (b + transpose(b))
    k_idx = jnp.broadcast_to(k[..., None, None], k.shape + (1, 3))
    bk = jnp.take_along_axis(bsym, k_idx, axis=-2)[..., 0, :]
    sign = jnp.where(bk < 0, -1.0, 1.0)
    # anchor component positive
    anchor = jnp.take_along_axis(sign, k[..., None], axis=-1)
    v = sign * anchor * vmag
    v = v / jnp.maximum(
        jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-30)
    w = th[..., None] * v
    z = jnp.zeros_like(w[..., 0])
    pi_log = jnp.stack([
        jnp.stack([z, -w[..., 2], w[..., 1]], axis=-1),
        jnp.stack([w[..., 2], z, -w[..., 0]], axis=-1),
        jnp.stack([-w[..., 1], w[..., 0], z], axis=-1)], axis=-2)
    return jnp.where(pi_case[..., None, None], pi_log, generic)


def cond(a):
    """2-norm condition number via singular values
    (MiniTensor_LinearAlgebra.h:571)."""
    s = jnp.linalg.svd(a, compute_uv=False)
    return s[..., 0] / s[..., -1]


def inv_cond(a):
    return 1.0 / cond(a)


# ------------------------------------------------------------- mechanics

def push_forward_covariant(f, a):
    """F^-T a  (vector) or F^-T A F^-1 (tensor)
    (MiniTensor_Mechanics.h:77,117)."""
    fit = transpose(inverse(f))
    if a.ndim == f.ndim - 1:
        return _einsum("...ij,...j->...i", fit, a)
    return dot(dot(fit, a), inverse(f))


def pull_back_covariant(f, a):
    """F^T a (vector) or F^T A F (tensor)."""
    if a.ndim == f.ndim - 1:
        return _einsum("...ji,...j->...i", f, a)
    return dot(dot(transpose(f), a), f)


def push_forward_contravariant(f, a):
    """F a (vector) or F A F^T (tensor)."""
    if a.ndim == f.ndim - 1:
        return _einsum("...ij,...j->...i", f, a)
    return dot(dot(f, a), transpose(f))


def pull_back_contravariant(f, a):
    """F^-1 a (vector) or F^-1 A F^-T (tensor)."""
    fi = inverse(f)
    if a.ndim == f.ndim - 1:
        return _einsum("...ij,...j->...i", fi, a)
    return dot(dot(fi, a), transpose(fi))


def piola(f, sigma):
    """Piola transform: P = J sigma F^-T (tensor) / J F^-1 u (vector)
    (MiniTensor_Mechanics.h:157,178)."""
    j = det(f)[..., None, None] if sigma.ndim == f.ndim \
        else det(f)[..., None]
    if sigma.ndim == f.ndim - 1:
        return j * _einsum("...ij,...j->...i", inverse(f), sigma)
    return j * dot(sigma, transpose(inverse(f)))


def piola_inverse(f, p):
    """sigma = J^-1 P F^T (MiniTensor_Mechanics.h:167,189)."""
    j = det(f)
    if p.ndim == f.ndim - 1:
        return _einsum("...ij,...j->...i", f, p) / j[..., None]
    return dot(p, transpose(f)) / j[..., None, None]


def smallest_eigenvalue(a):
    """Min eigenvalue of a symmetric tensor (MiniTensor_Mechanics.h:197)."""
    return eigvals_sym(a)[..., 0]


# ---------------------------------------------------- 4th-order tensors

def identity_1(dim, dtype=jnp.float32):
    """II1_ijkl = delta_ik delta_jl (MiniTensor_Tensor4.h identity_1)."""
    e = np.eye(dim)
    return jnp.asarray(np.einsum("ik,jl->ijkl", e, e), dtype=dtype)


def identity_2(dim, dtype=jnp.float32):
    """II2_ijkl = delta_il delta_jk (the transposer)."""
    e = np.eye(dim)
    return jnp.asarray(np.einsum("il,jk->ijkl", e, e), dtype=dtype)


def identity_3(dim, dtype=jnp.float32):
    """II3_ijkl = delta_ij delta_kl."""
    e = np.eye(dim)
    return jnp.asarray(np.einsum("ij,kl->ijkl", e, e), dtype=dtype)


def identity_sym(dim, dtype=jnp.float32):
    """Symmetrizer 0.5(II1 + II2)."""
    return 0.5 * (identity_1(dim, dtype) + identity_2(dim, dtype))


def elasticity_tensor(lam, mu, dim, dtype=jnp.float32):
    """Isotropic C_ijkl = lam d_ij d_kl + mu (d_ik d_jl + d_il d_jk)."""
    return (lam * identity_3(dim, dtype)
            + 2.0 * mu * identity_sym(dim, dtype))


def dot42(c, e):
    """Double contraction (C : E)_ij = C_ijkl E_kl, batched on both."""
    return _einsum("...ijkl,...kl->...ij", c, e)


def odot(a, b):
    """Symmetrized dyad of 2nd-order tensors -> 4th order:
    0.5 (a_ik b_jl + a_il b_jk)."""
    t1 = _einsum("...ik,...jl->...ijkl", a, b)
    t2 = _einsum("...il,...jk->...ijkl", a, b)
    return 0.5 * (t1 + t2)


def acoustic_tensor(c, n):
    """Q_ik = C_ijkl n_j n_l (the ellipticity kernel,
    MiniTensor_Mechanics.h:210-220)."""
    return _einsum("...ijkl,...j,...l->...ik", c, n, n)


def _unit_directions(dim, n_samples):
    rng = np.random.default_rng(7)
    d = rng.standard_normal((n_samples, dim))
    if dim == 2:
        th = np.linspace(0, np.pi, n_samples, endpoint=False)
        d = np.stack([np.cos(th), np.sin(th)], axis=-1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return d


def _min_acoustic_eig(c):
    dim = c.shape[-1]
    dirs = jnp.asarray(_unit_directions(dim, 128), dtype=c.dtype)
    q = _einsum("...ijkl,nj,nl->...nik", c, dirs, dirs)
    return jnp.min(eigvals_sym(sym(q))[..., 0], axis=-1)


def check_strong_ellipticity(c, tol=0.0):
    """Sampled strong-ellipticity check: min over ~128 unit directions n
    of the smallest eigenvalue of the acoustic tensor Q(n). Exact for
    isotropic C (where the spectrum is {mu, mu, lam+2mu} independent of
    n); a dense directional sample replaces the reference's iterative
    minimization (MiniTensor_Mechanics.h:220) — branch-free and batched.
    Returns (is_elliptic, min_eigenvalue)."""
    m = _min_acoustic_eig(c)
    return m > tol, m
