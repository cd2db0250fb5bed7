"""Low-rank structured covariance algebra (JAX, jittable).

Batched replacement for the reference's rank-structured covariance layer
(/root/reference/cellregmap/_math.py:40-128: ``QSCov``, ``PMat``,
``ScoreStatistic``) and for numpy_sugar's ``economic_qs_linear``.

Design
------
The reference keeps every covariance as a half-factor and uses the eigen
identity

    (a Q S Q^T + b I)^{-1} v = (Q diag(1/(1+(a/b)S)) Q^T v + v - Q Q^T v) / b

(_math.py:58-76) to solve in O(n r).  We go one step further: all structured
ops are expressed as *inner products in a fixed orthonormal workspace basis*
plus explicit complement corrections, so downstream code (the LMM fitter, the
score statistic) never touches n-length vectors after a one-time rotation.
That turns the per-variant work into small, batched matmuls.

Zero eigenvalues are mathematically inert in every formula below (a direction
with S_i = 0 behaves exactly like the orthogonal complement), so rank padding
needs no masking: we clamp eigenvalues at >= 0 and keep static shapes.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def orthonormal_basis(F: jax.Array) -> jax.Array:
    """Orthonormal basis Z (n x R, R = min(n, m)) of span(F) for F (n x m).

    Extra columns beyond rank(F) are harmless: they receive zero eigenvalues
    in any Gram built on top of Z and are inert downstream.
    """
    q, _ = jnp.linalg.qr(F, mode="reduced")
    return q


def gram_eigh(G: jax.Array):
    """Eigendecomposition of a PSD Gram matrix with eigenvalues clamped >= 0.

    Returns ``(S, V)`` with ``G ~= V diag(S) V^T``; S ascending per jnp.eigh.
    Uses the shifted (NaN-safe on singular input) eigh from ops.linalg.
    """
    from .linalg import safe_eigh

    S, V = safe_eigh((G + G.T) / 2)
    return jnp.maximum(S, 0.0), V


def economic_qs_linear(G: jax.Array):
    """Economic eigendecomposition of ``G @ G.T`` from the factor ``G``.

    Equivalent of numpy_sugar's ``economic_qs_linear`` consumed at
    /root/reference/cellregmap/_cellregmap.py:17.  Returns ``(Q0, S0)`` with
    ``G G^T ~= Q0 diag(S0) Q0^T`` and R = min(n, m) columns; zero eigenvalues
    are kept (inert) so shapes stay static under jit.
    """
    n, m = G.shape
    if m <= n:
        S, V = gram_eigh(G.T @ G)
        # Columns with S ~ 0 are scaled garbage; zero them out together with S
        # so they are exactly inert.
        cutoff = jnp.finfo(G.dtype).eps * jnp.maximum(n, m) * jnp.max(S)
        ok = S > cutoff
        S0 = jnp.where(ok, S, 0.0)
        denom = jnp.where(ok, jnp.sqrt(jnp.where(ok, S, 1.0)), 1.0)
        Q0 = (G @ V) * jnp.where(ok, 1.0 / denom, 0.0)[None, :]
        return Q0, S0
    S, V = gram_eigh(G @ G.T)
    return V, S


def economic_qs(K: jax.Array):
    """Economic eigendecomposition of a dense symmetric PSD matrix.

    Equivalent of the reference's local copy (_math.py:204-235) and of
    numpy_sugar's ``economic_qs``.  Returns ``((Q0, Q1), S0)`` with the
    eigenvalue cutoff sqrt(eps) used by the reference.
    """
    S, Q = jnp.linalg.eigh((K + K.T) / 2)
    eps = jnp.sqrt(jnp.finfo(K.dtype).eps)
    # jit-unfriendly boolean split is fine here: this helper is a host-side
    # compatibility shim; the engine itself uses gram_eigh with static shapes.
    import numpy as np

    S_np = np.asarray(S)
    Q_np = np.asarray(Q)
    ok = S_np >= float(eps)
    return (Q_np[:, ok], Q_np[:, ~ok]), S_np[ok]


def kinv_quad(ut, vt, uv, v0, v1, S):
    """Quadratic form u^T (v0 Q S Q^T + v1 I)^{-1} v from rotated coords.

    Parameters
    ----------
    ut, vt:
        Rotated coordinates Q^T u (r x ...) and Q^T v (r x ...).
    uv:
        Full inner products u^T v (broadcastable to the output).
    v0, v1:
        Scalars of K = v0 Q S Q^T + v1 I.
    S:
        Eigenvalues (r,), zeros allowed (inert).

    Uses K^{-1} = (I - Q diag(omega) Q^T)/v1 with omega = v0 S/(v1 + v0 S).
    """
    omega = (v0 * S) / (v1 + v0 * S)
    corr = jnp.einsum("r...,r,r...->...", ut, omega, vt)
    return (uv - corr) / v1


class QSCov:
    """Represents ``a K + b I`` with K = Q0 diag(S0) Q0^T.

    API-compatible with the reference QSCov (_math.py:40-76); jittable.
    """

    def __init__(self, Q0, S0, a=1.0, b=1.0):
        self._Q0 = jnp.asarray(Q0)
        self._S0 = jnp.asarray(S0)
        self._a = a
        self._b = b

    def dot(self, v):
        Qv = self._Q0.T @ v
        return self._a * (self._Q0 @ (self._S0[:, None] * Qv if Qv.ndim == 2 else self._S0 * Qv)) + self._b * v

    def solve(self, v):
        R0 = 1.0 / (1.0 + (self._a / self._b) * self._S0)
        Qv = self._Q0.T @ v
        scaled = R0[:, None] * Qv if Qv.ndim == 2 else R0 * Qv
        return (self._Q0 @ scaled + v - self._Q0 @ Qv) / self._b

    def logdet(self):
        n = self._Q0.shape[0]
        r = self._S0.shape[0]
        return jnp.sum(jnp.log(self._a * self._S0 + self._b)) + (n - r) * jnp.log(
            jnp.asarray(self._b)
        )


class PMat:
    """P = K^{-1} - K^{-1} W (W^T K^{-1} W)^{-1} W^T K^{-1}, matrix-free.

    Mirrors the reference PMat (_math.py:79-93); the inner solve uses lstsq
    semantics (rcond-based) like the reference's ``rsolve``.
    """

    def __init__(self, qscov: QSCov, W):
        self._qscov = qscov
        self._W = jnp.asarray(W)
        self._KiW = qscov.solve(self._W)

    def dot(self, v):
        Kiv = self._qscov.solve(v)
        A = self._W.T @ self._KiW
        b = self._KiW.T @ v
        x = jnp.linalg.lstsq(A, b if b.ndim == 2 else b[:, None])[0]
        x = x if b.ndim == 2 else x[:, 0]
        return Kiv - self._KiW @ x


class ScoreStatistic:
    """Q = 1/2 y^T P (dK) P y with dK given by its half-factor sqrt_dK.

    Mirrors the reference ScoreStatistic (_math.py:102-128).
    """

    def __init__(self, P: PMat, K: QSCov, sqrt_dK):
        self._P = P
        self._K = K
        self._sqrt_dK = jnp.asarray(sqrt_dK)

    def statistic(self, y):
        Py = self._P.dot(y)
        t = self._sqrt_dK.T @ Py
        return jnp.sum(t * t) / 2

    def matrix_for_dist_weights(self):
        return self._sqrt_dK.T @ self._P.dot(self._sqrt_dK) / 2

    def distr_weights(self):
        w = jnp.linalg.eigvalsh(self.matrix_for_dist_weights())
        import numpy as np

        w = np.asarray(w)
        return w[w > 1e-16]
