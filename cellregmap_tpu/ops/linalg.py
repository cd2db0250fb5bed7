"""SPD linear algebra helpers and the f32 matmul-precision pin.

Every linear system in this framework is symmetric positive (semi)definite
(GLS normal equations, Woodbury capacitances, covariance Grams), so every
small solve goes through Cholesky, with a tiny ridge where the system may be
singular (collinear fixed effects).  The engine was first built for a
backend without an f64 LU; whether LU-based solves would serve better on a
GPU is open.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def full_f32_matmuls(fn):
    """Trace ``fn`` with every float32 dot at full float32 precision.

    A GPU runs float32 matrix products in TF32 (a 10-bit mantissa) unless a
    precision is asked for, while the engine's f32 stages (hybrid
    localization, the f32 screen) are designed for full float32.  The
    precision is pinned at trace time, inside the kernel, so the traced
    program carries it on each dot and no global setting is involved;
    float64 dots are computed in float64 either way.
    """
    @functools.wraps(fn)
    def traced(*args, **kwargs):
        with jax.default_matmul_precision("float32"):
            return fn(*args, **kwargs)

    return traced


def spd_chol(A: jax.Array) -> jax.Array:
    return jnp.linalg.cholesky(A)


def spd_solve(A: jax.Array, b: jax.Array) -> jax.Array:
    """Solve A x = b for SPD A via Cholesky."""
    L = jnp.linalg.cholesky(A)
    return jax.scipy.linalg.cho_solve((L, True), b)


def spd_solve_chol(L: jax.Array, b: jax.Array) -> jax.Array:
    """Solve with a precomputed Cholesky factor."""
    return jax.scipy.linalg.cho_solve((L, True), b)


def spd_logdet(A: jax.Array) -> jax.Array:
    """log det(A) for SPD A via Cholesky."""
    L = jnp.linalg.cholesky(A)
    return 2.0 * jnp.sum(jnp.log(jnp.diagonal(L, axis1=-2, axis2=-1)),
                         axis=-1)


def spd_solve_and_logdet(A: jax.Array, b: jax.Array):
    """(A^{-1} b, log det A) sharing one Cholesky."""
    L = jnp.linalg.cholesky(A)
    x = jax.scipy.linalg.cho_solve((L, True), b)
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(L, axis1=-2, axis2=-1)),
                           axis=-1)
    return x, logdet


def _ridge(A: jax.Array, rcond: float) -> jax.Array:
    """A + rcond * max|diag| * I — the minimal PD-ification of a PSD matrix.

    Keeps rank-deficient normal systems solvable (collinear fixed effects —
    e.g. the reference's M = [W, g, E0] with E0 spanning the intercept; the
    reference survives those via lstsq, _math.py:33-37).  On the well-posed
    path the relative perturbation is ~rcond — far below statistical
    tolerances.  Cholesky is preferred over an eigh-based pseudo-inverse:
    it is exact to f64 and cheap on tiny systems.
    """
    diag = jnp.diagonal(A, axis1=-2, axis2=-1)
    eps = rcond * jnp.maximum(jnp.max(jnp.abs(diag), axis=-1), 1.0)
    return A + eps[..., None, None] * jnp.eye(A.shape[-1], dtype=A.dtype)


def sym_pseudo_solve(A: jax.Array, b: jax.Array, rcond: float = 1e-12):
    """Robust solve of a symmetric PSD system (ridge + Cholesky)."""
    L = jnp.linalg.cholesky(_ridge(A, rcond))
    return jax.scipy.linalg.cho_solve((L, True), b)


def sym_pseudo_solve_and_logdet(A: jax.Array, b: jax.Array,
                                rcond: float = 1e-12):
    """(robust solve, logdet) of a symmetric PSD normal matrix."""
    L = jnp.linalg.cholesky(_ridge(A, rcond))
    x = jax.scipy.linalg.cho_solve((L, True), b)
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(L, axis1=-2, axis2=-1)),
                           axis=-1)
    return x, logdet


def sym_pseudo_logdet(A: jax.Array, rcond: float = 1e-12) -> jax.Array:
    L = jnp.linalg.cholesky(_ridge(A, rcond))
    return 2.0 * jnp.sum(jnp.log(jnp.diagonal(L, axis1=-2, axis2=-1)),
                         axis=-1)


def unrolled_chol_factor(A_rows, rcond: float = 1e-12):
    """Cholesky factor on component arrays (tiny static dimension).

    ``A_rows[i][j]`` (j <= i) are broadcast-compatible arrays holding the
    (i, j) entries of a batch of small SPD systems.  The factorization is
    unrolled over the static size, so every op is elementwise on large
    arrays and no tensor carries a tiny trailing (p, p) = (2, 2) axis pair
    (which tiled layouts pad many times over).

    A ridge of rcond * max(diag) keeps rank-deficient systems solvable
    (collinear fixed effects).  Returns the lower-triangular component
    factor L (list-of-lists).
    """
    m = len(A_rows)
    diag_max = A_rows[0][0]
    for i in range(1, m):
        diag_max = jnp.maximum(diag_max, A_rows[i][i])
    ridge = rcond * jnp.maximum(diag_max, 1.0)

    L = [[None] * m for _ in range(m)]
    for i in range(m):
        for j in range(i + 1):
            s = A_rows[i][j]
            if i == j:
                s = s + ridge
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][i] = jnp.sqrt(s)
            else:
                L[i][j] = s / L[j][j]
    return L


def unrolled_chol_solve(L, b):
    """Solve with a component factor from :func:`unrolled_chol_factor`."""
    m = len(L)
    # forward substitution L z = b
    z = [None] * m
    for i in range(m):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * z[k]
        z[i] = s / L[i][i]
    # back substitution L^T x = z
    x = [None] * m
    for i in reversed(range(m)):
        s = z[i]
        for k in range(i + 1, m):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return x


def unrolled_chol_logdet(L):
    return 2.0 * sum(jnp.log(L[i][i]) for i in range(len(L)))


def unrolled_chol_solve_logdet(A_rows, b, rcond: float = 1e-12):
    """(solve, logdet) of batched small SPD systems in component form."""
    L = unrolled_chol_factor(A_rows, rcond)
    return unrolled_chol_solve(L, b), unrolled_chol_logdet(L)


def sym_components_full(A_rows):
    """Expand lower-triangular component rows to full symmetric access:
    full[i][j] = A_rows[max(i,j)][min(i,j)]."""
    m = len(A_rows)
    return [[A_rows[max(i, j)][min(i, j)] for j in range(m)]
            for i in range(m)]


def sym_components_matvec(A_rows, x):
    """y = A x on symmetric lower components; x, y are component lists."""
    full = sym_components_full(A_rows)
    return [sum(full[i][k] * x[k] for k in range(len(x)))
            for i in range(len(A_rows))]


def batched_small_chol(A: jax.Array, rcond: float = 0.0) -> jax.Array:
    """Cholesky of a batch of SMALL SPD matrices.

    A right-looking in-place variant: m fori_loop steps of masked
    elementwise updates over the full batch — a few bandwidth passes total
    — compiled as one small loop body, instead of a batched library
    factorization of many tiny matrices.
    """
    m = A.shape[-1]
    idx = jnp.arange(m)
    if rcond:
        A = _ridge(A, rcond)

    def step(j, L):
        col = jax.lax.dynamic_index_in_dim(L, j, axis=L.ndim - 1,
                                           keepdims=False)   # (..., m)
        d = jnp.sqrt(jax.lax.dynamic_index_in_dim(
            col, j, axis=col.ndim - 1, keepdims=False))      # (...,)
        coln = jnp.where(idx >= j, col / d[..., None], 0.0)
        below = idx > j
        upd = coln[..., :, None] * coln[..., None, :] \
            * (below[:, None] & below[None, :])
        L = L - upd
        is_j = (idx == j)
        L = jnp.where(is_j[None, :], coln[..., :, None] * is_j[None, :], L)
        return L

    L = jax.lax.fori_loop(0, m, step, A)
    return L * (idx[:, None] >= idx[None, :])


def batched_small_cho_solve(L: jax.Array, B: jax.Array) -> jax.Array:
    """Solve A X = B from :func:`batched_small_chol`'s factor, batched.

    Forward/back substitution as fori_loops of masked row updates —
    same rationale as the factorization (native batched triangular solve
    expands into slow tile-padded passes).  ``B``: (..., m, k).
    """
    m = L.shape[-2]
    idx = jnp.arange(m)

    def fwd(j, Z):
        Lrow = jax.lax.dynamic_index_in_dim(L, j, axis=L.ndim - 2,
                                            keepdims=False)  # (..., m)
        diag = jax.lax.dynamic_index_in_dim(Lrow, j, axis=Lrow.ndim - 1,
                                            keepdims=True)   # (..., 1)
        Lrow = jnp.where(idx < j, Lrow, 0.0)
        acc = jnp.einsum("...m,...mk->...k", Lrow, Z)
        Brow = jax.lax.dynamic_index_in_dim(B, j, axis=B.ndim - 2,
                                            keepdims=False)  # (..., k)
        z = (Brow - acc) / diag
        return jnp.where((idx == j)[:, None], z[..., None, :], Z)

    Z = jax.lax.fori_loop(0, m, fwd, jnp.zeros_like(B))

    def bwd(t, X):
        j = m - 1 - t
        Lcol = jax.lax.dynamic_index_in_dim(L, j, axis=L.ndim - 1,
                                            keepdims=False)  # (..., m) col j
        diag = jax.lax.dynamic_index_in_dim(Lcol, j, axis=Lcol.ndim - 1,
                                            keepdims=True)
        Lcol = jnp.where(idx > j, Lcol, 0.0)             # L^T row j below
        acc = jnp.einsum("...m,...mk->...k", Lcol, X)
        Zrow = jax.lax.dynamic_index_in_dim(Z, j, axis=Z.ndim - 2,
                                            keepdims=False)
        x = (Zrow - acc) / diag
        return jnp.where((idx == j)[:, None], x[..., None, :], X)

    return jax.lax.fori_loop(0, m, bwd, jnp.zeros_like(B))


def safe_eigh(A: jax.Array):
    """eigh of a PSD matrix, NaN-safe on exactly-singular input.

    Some eigh implementations return NaN for exactly-singular inputs; a
    1e-12 diagonal shift (exact identity for eigenvectors, eigenvalues
    shifted back) avoids the degenerate case.
    """
    diag = jnp.diagonal(A, axis1=-2, axis2=-1)
    eps = 1e-12 * jnp.maximum(jnp.max(jnp.abs(diag), axis=-1), 1.0)
    shifted = A + eps[..., None, None] * jnp.eye(A.shape[-1], dtype=A.dtype)
    S, V = jnp.linalg.eigh(shifted)
    return S - eps[..., None], V
