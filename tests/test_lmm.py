"""Batched profiled LMM fitter vs the dense SciPy oracle."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
from numpy.testing import assert_allclose

from cellregmap_tpu import oracle
from cellregmap_tpu.models import lmm as L
from cellregmap_tpu.ops.lowrank import (
    economic_qs_linear,
    gram_eigh,
    orthonormal_basis,
)


@pytest.mark.parametrize("restricted", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_eig_vs_oracle(restricted, seed):
    rng = np.random.default_rng(seed)
    n, p, m = 40, 2, 5
    F = rng.normal(size=(n, m))
    X = rng.normal(size=(n, p))
    y = rng.normal(size=n) + X @ rng.normal(size=p)
    ref = oracle.fit_lmm_dense(y, X, F @ F.T, restricted)
    Q0, S0 = economic_qs_linear(jnp.asarray(F))
    data = L.eig_data(S0, Q0, jnp.asarray(X), jnp.asarray(y))
    fit = L.fit_delta_eig(data, n, restricted)
    assert_allclose(float(fit.lml), ref["lml"], rtol=1e-10)
    assert_allclose(float(fit.delta), ref["delta"], atol=1e-6)
    assert_allclose(np.asarray(fit.beta), ref["beta"], atol=1e-7)
    assert_allclose(float(fit.v0), ref["v0"], rtol=1e-5, atol=1e-9)
    assert_allclose(float(fit.v1), ref["v1"], rtol=1e-5, atol=1e-9)


def test_fit_eig_rank_padding_inert():
    """Padded zero eigenvalues must not change the fit."""
    rng = np.random.default_rng(3)
    n, p, m = 30, 2, 4
    F = rng.normal(size=(n, m))
    X = rng.normal(size=(n, p))
    y = rng.normal(size=n)
    Q0, S0 = economic_qs_linear(jnp.asarray(F))
    data = L.eig_data(S0, Q0, jnp.asarray(X), jnp.asarray(y))
    fit = L.fit_delta_eig(data, n, True)
    # pad with explicit zero modes from the orthogonal complement
    Zfull, _ = np.linalg.qr(np.concatenate([np.asarray(Q0),
                                            rng.normal(size=(n, 3))], axis=1))
    Qpad = jnp.asarray(Zfull)
    Spad = jnp.concatenate([S0, jnp.zeros(3)])
    data2 = L.eig_data(Spad, Qpad, jnp.asarray(X), jnp.asarray(y))
    fit2 = L.fit_delta_eig(data2, n, True)
    assert_allclose(float(fit.lml), float(fit2.lml), rtol=1e-12)
    assert_allclose(float(fit.delta), float(fit2.delta), atol=1e-9)


@pytest.mark.parametrize("rho", [0.0, 0.4, 1.0])
def test_fit_woodbury_matches_eig(rho):
    """Woodbury and eig backends agree on the same covariance."""
    rng = np.random.default_rng(4)
    n, C, pM, k = 45, 3, 5, 6
    E0 = rng.normal(size=(n, C))
    g = rng.normal(size=n)
    A = g[:, None] * E0
    hK = rng.normal(size=(n, k)) / np.sqrt(k)
    from cellregmap_tpu.api import get_L_values

    Ls = get_L_values(hK, E0)
    X = np.concatenate([np.ones((n, 1)), rng.normal(size=(n, pM - 1))], axis=1)
    y = rng.normal(size=n)
    KE = sum(Li @ Li.T for Li in Ls)
    Sigma = rho * A @ A.T + (1 - rho) * KE
    ref = oracle.fit_lmm_dense(y, X, Sigma, True)

    F = np.concatenate(Ls, axis=1)
    Zk = np.asarray(orthonormal_basis(jnp.asarray(F)))
    Gk = np.zeros((Zk.shape[1],) * 2)
    for Li in Ls:
        Fb = Zk.T @ Li
        Gk += Fb @ Fb.T
    Lam, Vk = gram_eigh(jnp.asarray(Gk))
    U_T = lambda M: np.asarray(Vk).T @ (Zk.T @ M)
    data = L.WoodburyData(
        Lam=jnp.asarray(Lam), Ua=jnp.asarray(U_T(A)),
        Ux=jnp.asarray(U_T(X)), uy=jnp.asarray(U_T(y)),
        Aa=jnp.asarray(A.T @ A), Ax=jnp.asarray(A.T @ X),
        ay=jnp.asarray(A.T @ y), xx=jnp.asarray(X.T @ X),
        xy=jnp.asarray(X.T @ y), yy=jnp.asarray(y @ y),
        rho=jnp.asarray(float(rho)),
    )
    fit = L.fit_delta_woodbury(data, n, True)
    assert_allclose(float(fit.lml), ref["lml"], rtol=1e-10)
    assert_allclose(np.asarray(fit.beta), ref["beta"], atol=1e-6)


def test_fast_scan_vs_fixed_delta_refits():
    rng = np.random.default_rng(5)
    n, p, m, S = 50, 2, 6, 8
    F = rng.normal(size=(n, m))
    W = np.concatenate([np.ones((n, 1)), rng.normal(size=(n, p - 1))], axis=1)
    y = rng.normal(size=n)
    G = rng.normal(size=(n, S))
    delta = 0.37
    Sigma = F @ F.T
    S_full, Q = np.linalg.eigh(Sigma)
    S_full = np.maximum(S_full, 0)

    lml_ref, beta_ref = [], []
    for i in range(S):
        X = np.concatenate([W, G[:, [i]]], axis=1)
        lml, beta, _ = oracle.lmm_lml_components(
            delta, S_full, Q.T @ X, Q.T @ y, False
        )
        lml_ref.append(lml)
        beta_ref.append(beta[-1])

    Q0, S0 = economic_qs_linear(jnp.asarray(F))
    Q0n, S0n = np.asarray(Q0), np.asarray(S0)
    Wt = Q0n.T @ W
    yt = Q0n.T @ y
    Gt = Q0n.T @ G
    res = L.fast_scan(
        delta, jnp.asarray(S0n), jnp.asarray(Wt), jnp.asarray(yt),
        jnp.asarray(W.T @ W - Wt.T @ Wt), jnp.asarray(W.T @ y - Wt.T @ yt),
        jnp.asarray(y @ y - yt @ yt), jnp.asarray(Gt),
        jnp.asarray(W.T @ G - Wt.T @ Gt), jnp.asarray(G.T @ y - Gt.T @ yt),
        jnp.asarray((G * G).sum(0) - (Gt * Gt).sum(0)), n,
    )
    assert_allclose(np.asarray(res.lml), lml_ref, rtol=1e-10)
    assert_allclose(np.asarray(res.effsizes_g), beta_ref, atol=1e-9)


def test_reml_derivatives_vs_finite_differences():
    rng = np.random.default_rng(9)
    n, p, m = 45, 2, 6
    F = rng.normal(size=(n, m))
    X = np.concatenate([np.ones((n, 1)), rng.normal(size=(n, p - 1))], axis=1)
    y = rng.normal(size=n)
    Q0, S0 = economic_qs_linear(jnp.asarray(F))
    data = L.eig_data(S0, Q0, jnp.asarray(X), jnp.asarray(y))
    for delta in (0.05, 0.3, 0.7, 0.95):
        lp, lpp = L.delta_derivatives(jnp.asarray(delta), data, n)
        h = 1e-6
        f = lambda dd: float(L.lml_at_delta_eig(jnp.asarray(dd), data, n,
                                                True)[0])
        fd1 = (f(delta + h) - f(delta - h)) / (2 * h)
        fd2 = (f(delta + h) - 2 * f(delta) + f(delta - h)) / h**2
        assert_allclose(float(lp), fd1, rtol=2e-5, atol=1e-8)
        assert_allclose(float(lpp), fd2, rtol=2e-3, atol=1e-4)


def test_ml_derivatives_vs_finite_differences():
    rng = np.random.default_rng(10)
    n, p, m = 45, 2, 6
    F = rng.normal(size=(n, m))
    X = np.concatenate([np.ones((n, 1)), rng.normal(size=(n, p - 1))], axis=1)
    y = rng.normal(size=n)
    Q0, S0 = economic_qs_linear(jnp.asarray(F))
    data = L.eig_data(S0, Q0, jnp.asarray(X), jnp.asarray(y))
    for delta in (0.05, 0.3, 0.7, 0.95):
        lp, lpp = L.delta_derivatives(jnp.asarray(delta), data, n,
                                      restricted=False)
        h = 1e-6
        f = lambda dd: float(L.lml_at_delta_eig(jnp.asarray(dd), data, n,
                                                False)[0])
        fd1 = (f(delta + h) - f(delta - h)) / (2 * h)
        fd2 = (f(delta + h) - 2 * f(delta) + f(delta - h)) / h**2
        assert_allclose(float(lp), fd1, rtol=2e-5, atol=1e-8)
        assert_allclose(float(lpp), fd2, rtol=2e-3, atol=1e-4)


@pytest.mark.parametrize("restricted", [False, True])
def test_fit_eig_settles_on_derivative_root(restricted):
    """The fitted delta is a root of the analytic derivative (the Newton
    polish), not merely a golden-section point inside the objective's
    rounding noise: the fit is reproducible under a permutation of the
    samples, which only changes summation order."""
    rng = np.random.default_rng(12)
    n, p, m = 3000, 2, 40
    F = rng.normal(size=(n, m)) / np.sqrt(m)
    X = np.concatenate([np.ones((n, 1)), rng.normal(size=(n, p - 1))], axis=1)
    y = F @ rng.normal(size=m) + rng.normal(size=n)
    deltas = []
    for idx in (np.arange(n), rng.permutation(n)):
        Q0, S0 = economic_qs_linear(jnp.asarray(F[idx]))
        data = L.eig_data(S0, Q0, jnp.asarray(X[idx]), jnp.asarray(y[idx]))
        fit = L.fit_delta_eig(data, n, restricted)
        lp, lpp = L.delta_derivatives(fit.delta, data, n, restricted)
        assert float(lpp) < 0
        assert abs(float(lp)) < 1e-6 * abs(float(lpp))
        deltas.append(float(fit.delta))
    assert abs(deltas[0] - deltas[1]) < 1e-12 * deltas[0]
