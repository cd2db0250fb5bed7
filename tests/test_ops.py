"""Structured-op vs dense-oracle equivalence (pattern of reference
test/test_math.py: every matrix-free op checked against its naive dense
formula)."""
import numpy as np
import jax.numpy as jnp
import pytest
from numpy.testing import assert_allclose

from cellregmap_tpu.ops.lowrank import (
    QSCov,
    PMat,
    ScoreStatistic,
    economic_qs_linear,
    gram_eigh,
    orthonormal_basis,
)
from cellregmap_tpu.ops.hadamard import get_L_values, hadamard_factor_tensor
from cellregmap_tpu import oracle


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def test_economic_qs_linear_reconstructs(rng):
    for n, m in [(20, 5), (5, 20), (16, 16)]:
        F = rng.normal(size=(n, m))
        Q0, S0 = economic_qs_linear(jnp.asarray(F))
        K = np.asarray(Q0) @ np.diag(np.asarray(S0)) @ np.asarray(Q0).T
        assert_allclose(K, F @ F.T, atol=1e-10)


def test_qscov_dot_solve_vs_dense(rng):
    n, m = 15, 4
    F = rng.normal(size=(n, m))
    K = F @ F.T
    Q0, S0 = economic_qs_linear(jnp.asarray(F))
    a, b = 0.2, 0.3
    qscov = QSCov(Q0, S0, a, b)
    v = rng.normal(size=n)
    finalK = a * K + b * np.eye(n)
    assert_allclose(np.asarray(qscov.dot(jnp.asarray(v))), finalK @ v,
                    atol=1e-10)
    assert_allclose(np.asarray(qscov.solve(jnp.asarray(v))),
                    np.linalg.solve(finalK, v), atol=1e-10)
    # matrix rhs
    V = rng.normal(size=(n, 3))
    assert_allclose(np.asarray(qscov.solve(jnp.asarray(V))),
                    np.linalg.solve(finalK, V), atol=1e-10)
    assert_allclose(float(qscov.logdet()),
                    np.linalg.slogdet(finalK)[1], atol=1e-10)


def test_pmat_vs_dense(rng):
    n, m, p = 15, 4, 2
    F = rng.normal(size=(n, m))
    K = 0.5 * F @ F.T + 0.7 * np.eye(n)
    W = rng.normal(size=(n, p))
    Q0, S0 = economic_qs_linear(jnp.asarray(F))
    qscov = QSCov(Q0, S0, 0.5, 0.7)
    P = PMat(qscov, jnp.asarray(W))
    v = rng.normal(size=n)
    P_dense = oracle.P_matrix(W, K)
    assert_allclose(np.asarray(P.dot(jnp.asarray(v))), P_dense @ v, atol=1e-9)


def test_score_statistic_vs_dense(rng):
    n, m, p, C = 15, 4, 2, 3
    F = rng.normal(size=(n, m))
    K = 0.5 * F @ F.T + 0.7 * np.eye(n)
    W = rng.normal(size=(n, p))
    y = rng.normal(size=n)
    sq = rng.normal(size=(n, C))
    dK = sq @ sq.T
    Q0, S0 = economic_qs_linear(jnp.asarray(F))
    qscov = QSCov(Q0, S0, 0.5, 0.7)
    P = PMat(qscov, jnp.asarray(W))
    ss = ScoreStatistic(P, qscov, jnp.asarray(sq))
    assert_allclose(float(ss.statistic(jnp.asarray(y))),
                    oracle.score_statistic(y, W, K, dK), atol=1e-9)
    lam = np.sort(np.asarray(ss.distr_weights()))
    lam_ref = np.sort(oracle.score_statistic_distr_weights(W, K, dK))
    # the dense sqrtm path leaves O(1e-9) noise eigenvalues above the 1e-16
    # cutoff; compare the significant spectrum only
    lam = lam[lam > 1e-8 * lam.max()]
    lam_ref = lam_ref[lam_ref > 1e-8 * lam_ref.max()]
    assert_allclose(lam, lam_ref, rtol=1e-7)


def test_hadamard_identity(rng):
    """sum_i L_i L_i^T == (hK hK^T) (.) (E E^T)  (proof.md:17-29)."""
    n, k, C = 12, 5, 3
    hK = rng.normal(size=(n, k))
    E = rng.normal(size=(n, C))
    Ls = get_L_values(jnp.asarray(hK), jnp.asarray(E))
    got = sum(np.asarray(L) @ np.asarray(L).T for L in Ls)
    want = (hK @ hK.T) * (E @ E.T)
    assert_allclose(got, want, atol=1e-10)
    # tensor layout agrees
    T = np.asarray(hadamard_factor_tensor(jnp.asarray(hK), jnp.asarray(E)))
    got2 = sum(T[i] @ T[i].T for i in range(T.shape[0]))
    assert_allclose(got2, want, atol=1e-10)


def test_orthonormal_basis_and_gram(rng):
    n, m = 20, 6
    F = rng.normal(size=(n, m))
    Z = np.asarray(orthonormal_basis(jnp.asarray(F)))
    assert_allclose(Z.T @ Z, np.eye(Z.shape[1]), atol=1e-12)
    # span: F reconstructible from Z
    assert_allclose(Z @ (Z.T @ F), F, atol=1e-10)
    S, V = gram_eigh(jnp.asarray(Z.T @ F @ F.T @ Z))
    got = Z @ np.asarray(V) @ np.diag(np.asarray(S)) @ np.asarray(V).T @ Z.T
    assert_allclose(got, F @ F.T, atol=1e-9)


def test_gram_basis_high_condition(rng):
    """The Gram-route basis (engine._gram_basis) at kappa ~ 1e8: retained
    directions must represent the factor covariance to ~1e-9 relative, and
    an end-to-end null-context scan on the ill-conditioned stack must match
    the dense oracle (the sqrt(eps) rank-resolution limit is
    acceptable for the squared-spectrum use, but was untested)."""
    from cellregmap_tpu import engine

    n, m = 160, 12
    # singular values spanning 8 decades
    U, _ = np.linalg.qr(rng.normal(size=(n, m)))
    Vt, _ = np.linalg.qr(rng.normal(size=(m, m)))
    sv = np.logspace(0, -8, m)
    F = U @ np.diag(sv) @ Vt.T
    Z, T = engine._gram_basis(F)
    # orthonormal basis; represented covariance matches F F^T
    assert_allclose(Z.T @ Z, np.eye(Z.shape[1]), atol=1e-12)
    cov_err = np.linalg.norm(Z @ T @ T.T @ Z.T - F @ F.T) \
        / np.linalg.norm(F @ F.T)
    assert cov_err < 5e-9, cov_err

    # end-to-end: interaction scan on an ill-conditioned context stack
    # (contexts with 1e-4-scaled columns -> kappa ~ 1e8 in the Gram) vs
    # the dense oracle which never routes through the Gram basis
    n2, C = 120, 4
    E = rng.normal(size=(n2, C))
    E[:, 2:] *= 1e-4
    hK = rng.normal(size=(n2, 5)) / np.sqrt(5)
    from cellregmap_tpu.api import get_L_values as gl
    Ls = gl(hK, E)
    y = rng.normal(size=n2)
    W = np.ones((n2, 1))
    G = rng.choice([0.0, 1.0, 2.0], size=(n2, 3), p=[0.5, 0.4, 0.1])
    G = (G - G.mean(0)) / np.maximum(G.std(0), 1e-9)
    import cellregmap_tpu as crt
    pv, _ = crt.run_interaction(y, E, G, W=W, hK=hK)
    pv_dense, _ = oracle.scan_interaction_dense(y, W, E, Ls=Ls, G=G)
    assert_allclose(pv, pv_dense, atol=1e-8)


def test_batched_small_chol_and_solve():
    """fori-loop batched tiny-matrix Cholesky/solve vs numpy (the native
    batched path is slow on tiny matrices; ops/linalg.py)."""
    import numpy as np
    import jax.numpy as jnp
    from numpy.testing import assert_allclose
    from cellregmap_tpu.ops.linalg import (batched_small_chol,
                                           batched_small_cho_solve)

    rng = np.random.default_rng(3)
    for m, batch in ((1, 4), (5, 7), (12, 3)):
        F = rng.normal(size=(batch, m, m + 3))
        A = F @ np.swapaxes(F, -1, -2) + m * np.eye(m)
        B = rng.normal(size=(batch, m, 2))
        L = np.asarray(batched_small_chol(jnp.asarray(A)))
        assert_allclose(L, np.linalg.cholesky(A), rtol=1e-10, atol=1e-12)
        X = np.asarray(batched_small_cho_solve(jnp.asarray(L),
                                               jnp.asarray(B)))
        assert_allclose(X, np.linalg.solve(A, B), rtol=1e-9, atol=1e-11)


def test_blocked_kr_contract_matches_direct(monkeypatch):
    """The cell-axis-blocked Khatri-Rao path (used at large n to bound
    the contraction's temporaries) must equal the one-shot matmul."""
    import numpy as np
    import jax.numpy as jnp
    from numpy.testing import assert_allclose
    from cellregmap_tpu import engine

    rng = np.random.default_rng(5)
    n, K, p, S = 300, 7, 3, 5
    U = rng.normal(size=(n, K))
    V = rng.normal(size=(n, p))
    G = rng.normal(size=(n, S))
    direct = np.einsum("nk,np,ns->kps", U, V, G)

    out = np.asarray(engine._kr_contract(
        jnp.asarray(U), jnp.asarray(V), jnp.asarray(G)))
    assert_allclose(out, direct, rtol=1e-12)

    monkeypatch.setattr(engine, "_KR_BLOCK_ELEMS", 1.0)
    monkeypatch.setattr(engine, "_KR_MIN_BLOCK", 64)  # 300 -> 5 blocks + pad
    blocked = np.asarray(engine._kr_contract(
        jnp.asarray(U), jnp.asarray(V), jnp.asarray(G)))
    assert_allclose(blocked, direct, rtol=1e-12)
