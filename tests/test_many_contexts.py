"""C ~ 50 contexts (the upper end SURVEY 2.4 mentions).

Round 1 only exercised C <= 10; the per-context contractions, the (S, C, C)
weight-matrix host transfers, and the C x C eigenvalue path all scale with C
.
"""
import numpy as np
from numpy.testing import assert_allclose

import cellregmap_tpu as crt
from cellregmap_tpu import oracle


def _dataset(n=150, C=50, donors=6, S=6, seed=7):
    rng = np.random.default_rng(seed)
    E = rng.normal(size=(n, C)) / np.sqrt(C)
    W = np.ones((n, 1))
    donor_of = np.repeat(np.arange(donors), -(-n // donors))[:n]
    hK = np.zeros((n, donors))
    hK[np.arange(n), donor_of] = 1.0
    Ls = [np.asarray(L) for L in crt.get_L_values(hK, E)]
    G = rng.choice([0.0, 1.0, 2.0], size=(n, S), p=[0.49, 0.42, 0.09])
    G = (G - G.mean(0)) / G.std(0)
    y = (rng.normal(size=n) + 0.6 * E @ rng.normal(size=C)
         + 0.4 * hK @ rng.normal(size=donors)
         + 0.5 * G[:, 2] * E[:, 0] * np.sqrt(C))
    return y, W, E, G, Ls


def test_interaction_scan_c50_matches_dense():
    y, W, E, G, Ls = _dataset()
    crm = crt.CellRegMap(y=y, E=E, W=W, Ls=Ls)
    pv, info = crm.scan_interaction(G)
    pv_d, info_d = oracle.scan_interaction_dense(y, W, E, Ls=Ls, G=G)
    assert np.max(np.abs(pv - pv_d)) < 1e-8
    assert np.array_equal(info["rho1"], info_d["rho1"])
    assert pv.shape == (6,) and np.all((pv > 0) & (pv <= 1))


def test_betas_c50_finite_and_crosschecked():
    """Effect-size parity budget: the engine's betas
    match the independent dense oracle to <= 1e-6 on every variant — the
    measured agreement is ~1e-9 (see the sensitivity bound below), so 1e-6
    leaves two orders of margin for platform variation.
    """
    y, W, E, G, Ls = _dataset(S=3)
    crm = crt.CellRegMap(y=y, E=E, W=W, Ls=Ls)
    maf = np.full(3, 0.3)
    bg, bgxe = crm.predict_interaction(G, maf)
    assert np.isfinite(bg).all() and np.isfinite(bgxe).all()
    assert bgxe.shape == (len(y), 3)

    bgm = sum(np.asarray(L) @ np.asarray(L).T for L in Ls)
    norm = 1.0 / np.sqrt(2 * 0.3 * 0.7)
    n = len(y)
    for i in range(3):
        g = G[:, [i]]
        M = np.concatenate((W, g, E), axis=1)
        gE = g * E
        best = None
        for rho1 in np.linspace(0, 1, 11):
            Sigma = rho1 * (gE @ gE.T) + (1 - rho1) * bgm
            fit = oracle.fit_lmm_dense(y, M, Sigma, restricted=True)
            if best is None or fit["lml"] > best["lml"]:
                best = dict(fit, rho1=rho1, Sigma=Sigma)
        assert_allclose(bg[i], best["beta"][W.shape[1]], rtol=0, atol=1e-6)
        yadj = y - M @ best["beta"]
        cov = best["v0"] * best["Sigma"] + best["v1"] * np.eye(n)
        vv = np.linalg.solve(cov, yadj)
        bgxe_d = (best["v0"] * best["rho1"]
                  * (E @ (gE.T @ vv)).ravel() * norm)
        assert_allclose(bgxe[:, i], bgxe_d, rtol=0, atol=1e-6)


def test_betas_delta_sensitivity_bound():
    """Quantifies how much optimizer slack the 1e-6 betas budget absorbs:
    |d beta_g / d delta| at the optimum, times the engines' delta
    agreement (<= ~1e-7 measured between the zoom+vertex fitter and the
    xatol=1e-12 scipy search), stays well under the 1e-6 budget.  This is
    the derived bound."""
    y, W, E, G, Ls = _dataset(S=3)
    g = G[:, [0]]
    M = np.concatenate((W, g, E), axis=1)
    gE = g * E
    bgm = sum(np.asarray(L) @ np.asarray(L).T for L in Ls)
    best = None
    for rho1 in np.linspace(0, 1, 11):
        Sigma = rho1 * (gE @ gE.T) + (1 - rho1) * bgm
        fit = oracle.fit_lmm_dense(y, M, Sigma, restricted=True)
        if best is None or fit["lml"] > best["lml"]:
            best = dict(fit, rho1=rho1, Sigma=Sigma)

    from scipy.linalg import eigh

    S_full, Q = eigh((best["Sigma"] + best["Sigma"].T) / 2)
    S_full = np.maximum(S_full, 0.0)
    yt, Mt = Q.T @ y, Q.T @ M
    jcol = W.shape[1]

    def beta_at(delta):
        d = (1 - delta) * S_full + delta
        A = Mt.T @ (Mt / d[:, None])
        b = Mt.T @ (yt / d)
        return np.linalg.lstsq(A, b, rcond=None)[0][jcol]

    d0 = best["delta"]
    h = 1e-6 * max(d0, 1e-3)
    dbeta_ddelta = abs(beta_at(d0 + h) - beta_at(d0 - h)) / (2 * h)
    # engines agree on delta to ~1e-7 (zoom bracket ~1e-4 logit + parabolic
    # vertex); the induced betas slack must sit well inside the budget
    assert dbeta_ddelta * 1e-7 < 1e-6, dbeta_ddelta
