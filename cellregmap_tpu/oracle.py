"""Dense NumPy/SciPy reference implementations ("oracles").

These serve two purposes:

1. **Test oracles** — every structured/batched operation in the engine is
   checked against its naive dense formula here (the pattern of the
   reference's test/test_math.py).
2. **CPU baseline** — a faithful re-implementation of the reference's serial
   per-SNP pipeline (/root/reference/cellregmap/_cellregmap.py:317-440 and the
   glimix-core LMM it consumes), used by bench.py as the measured baseline
   since the reference publishes no numbers (SURVEY.md section 6) and the pip
   package is unavailable in this environment.

Everything here is intentionally *independent* of the JAX engine: plain
NumPy + SciPy, dense matrices, scalar scipy optimizers.
"""
from __future__ import annotations

import numpy as np
from numpy.linalg import eigh, eigvalsh, inv, lstsq, solve
from scipy.integrate import quad
from scipy.optimize import minimize_scalar
from scipy.stats import chi2, ncx2


# --------------------------------------------------------------------------
# Dense linear-mixed-model fit (oracle for glimix-core's LMM; consumed by the
# reference at _cellregmap.py:175,223,254,274,292,308,351).
# --------------------------------------------------------------------------
def lmm_lml_components(delta, S_full, Xt, yt, restricted):
    """Profiled log-marginal-likelihood at a given delta.

    Model: y ~ N(X beta, s * ((1-delta) K + delta I)) with K = Q S Q^T, in the
    eigenbasis of K (S_full padded with zeros to n).  beta and s are profiled
    out in closed form (GLS); REML uses the standard restricted likelihood
    with s = RSS/(n-p).
    """
    n = yt.shape[0]
    p = Xt.shape[1]
    d = (1 - delta) * S_full + delta
    w = 1.0 / d
    A = Xt.T @ (Xt * w[:, None])
    b = Xt.T @ (yt * w)
    beta = solve(A, b)
    rss = float(yt @ (yt * w) - b @ beta)
    logdet_d = float(np.sum(np.log(d)))
    if restricted:
        nu = n - p
        scale = rss / nu
        _, logdet_a = np.linalg.slogdet(A)
        _, logdet_xx = np.linalg.slogdet(Xt.T @ Xt)
        lml = -0.5 * (
            nu * np.log(2 * np.pi * scale) + logdet_d + logdet_a - logdet_xx + nu
        )
    else:
        scale = rss / n
        lml = -0.5 * (n * np.log(2 * np.pi * scale) + logdet_d + n)
    return lml, beta, scale


def fit_lmm_dense(y, X, Sigma, restricted):
    """Fit y ~ N(X beta, v0 Sigma + v1 I) maximizing (restricted) lml.

    Dense eigendecomposition + scipy bounded scalar search over logit(delta).
    Returns dict with lml, delta, v0, v1, beta, scale.

    Rank-deficient designs are reduced via economic SVD exactly like
    glimix-core's LMM does (it fits on tX = U S and maps beta back through
    V, the min-norm GLS solution) — without this, logdet(X^T D^{-1} X) of a
    singular normal matrix contaminates the REML objective by O(1) noise
    and the delta/rho argmaxes become numerically meaningless.
    """
    y = np.asarray(y, float).ravel()
    X = np.atleast_2d(np.asarray(X, float))
    U, sv, Vt = np.linalg.svd(X, full_matrices=False)
    keep = sv >= np.sqrt(np.finfo(float).eps)
    tX = U[:, keep] * sv[keep]
    S_full, Q = eigh((Sigma + Sigma.T) / 2)
    S_full = np.maximum(S_full, 0.0)
    yt = Q.T @ y
    Xt = Q.T @ tX

    def neg(logit):
        delta = 1.0 / (1.0 + np.exp(-logit))
        lml, _, _ = lmm_lml_components(delta, S_full, Xt, yt, restricted)
        return -lml

    grid = np.linspace(-18.0, 18.0, 64)
    vals = np.array([neg(g) for g in grid])
    k = int(np.argmin(vals))
    lo = grid[max(k - 1, 0)]
    hi = grid[min(k + 1, len(grid) - 1)]
    res = minimize_scalar(neg, bounds=(lo, hi), method="bounded",
                          options={"xatol": 1e-12})
    logit = float(res.x)
    delta = 1.0 / (1.0 + np.exp(-logit))
    lml, beta_t, scale = lmm_lml_components(delta, S_full, Xt, yt, restricted)
    beta = Vt[keep].T @ beta_t  # back to original coordinates (min-norm)
    return {
        "lml": float(lml),
        "delta": float(delta),
        "v0": float(scale * (1 - delta)),
        "v1": float(scale * delta),
        "beta": np.asarray(beta),
        "scale": float(scale),
    }


# --------------------------------------------------------------------------
# Dense score-test machinery (oracle for _math.py:96-201).
# --------------------------------------------------------------------------
def rsolve(a, b):
    """Robust solver (reference _math.py:33-37)."""
    return lstsq(a, b, rcond=None)[0]


def P_matrix(W, K):
    """P = K^{-1} - K^{-1} W (W^T K^{-1} W)^{-1} W^T K^{-1} (dense)."""
    KiW = solve(K, W)
    return inv(K) - KiW @ solve(W.T @ KiW, KiW.T)


def score_statistic(y, W, K, dK):
    """Q = 1/2 y^T P dK P y (dense)."""
    P = P_matrix(W, K)
    return y.T @ P @ dK @ P @ y / 2


def score_statistic_distr_weights(W, K, dK):
    """Nonzero eigenvalues of 1/2 sqrt(P) dK sqrt(P) (dense)."""
    from scipy.linalg import sqrtm

    P = P_matrix(W, K)
    sq = np.real(sqrtm(P))
    weights = eigvalsh(sq @ dK @ sq) / 2
    return weights[weights > 1e-16]


# --------------------------------------------------------------------------
# Mixture-of-chi2 tail probabilities.
# --------------------------------------------------------------------------
def liu_sf(q, lambdas, dofs=None, ncps=None, modified=True):
    """Liu-Tang-Zhang survival function approximation (oracle).

    With ``modified=True`` applies the Lee/Wu/Lin kurtosis-matched
    modification (chiscore.liu_sf equivalent; consumed by the reference at
    _math.py:169-180).  Returns ``(pv, dof_x, ncp_x, info)``.
    """
    lambdas = np.asarray(lambdas, float)
    r = lambdas.shape[0]
    dofs = np.ones(r) if dofs is None else np.asarray(dofs, float)
    ncps = np.zeros(r) if ncps is None else np.asarray(ncps, float)

    c1 = np.sum(lambdas * dofs) + np.sum(lambdas * ncps)
    c2 = np.sum(lambdas**2 * dofs) + 2 * np.sum(lambdas**2 * ncps)
    c3 = np.sum(lambdas**3 * dofs) + 3 * np.sum(lambdas**3 * ncps)
    c4 = np.sum(lambdas**4 * dofs) + 4 * np.sum(lambdas**4 * ncps)

    s1 = c3 / np.sqrt(c2) ** 3
    s2 = c4 / c2**2

    if s1**2 > s2:
        a = 1.0 / (s1 - np.sqrt(s1**2 - s2))
        ncp_x = s1 * a**3 - a**2
        dof_x = a**2 - 2 * ncp_x
    else:
        ncp_x = 0.0
        dof_x = 1.0 / s2 if modified else 1.0 / s1**2

    mu_q = c1
    sigma_q = np.sqrt(2 * c2)
    mu_x = dof_x + ncp_x
    sigma_x = np.sqrt(2 * (dof_x + 2 * ncp_x))

    t = (np.asarray(q, float) - mu_q) / sigma_q
    q_x = t * sigma_x + mu_x
    pv = ncx2.sf(q_x, dof_x, ncp_x) if ncp_x > 0 else chi2.sf(q_x, dof_x)
    info = {"mu_q": mu_q, "sigma_q": sigma_q, "dof_x": dof_x, "ncp_x": ncp_x}
    return pv, dof_x, ncp_x, info


def score_statistic_liu_params(q, weights):
    """Reference helper (_math.py:163-180): modified-Liu params + pv."""
    pv, dof_x, _, info = liu_sf(q, np.asarray(weights, float), modified=True)
    return {
        "pv": float(pv),
        "mu_q": info["mu_q"],
        "sigma_q": info["sigma_q"],
        "dof_x": dof_x,
    }


def imhof_sf(q, lambdas, epsabs=1e-13, epsrel=1e-11):
    """Pr(Q > q) for Q = sum_i lambda_i chi2_1 by Imhof (1961) inversion.

    An *exact* method independent of Davies' algorithm — used to validate
    the native C++ Davies implementation.  Caveats: the quadrature loses
    absolute accuracy in the far tail (pv < ~1e-7) and for very few distinct
    eigenvalues, where the integrand decays like u^{-r/2-1}; exactly
    reducible cases (all-equal eigenvalues -> scaled chi2) are therefore
    computed in closed form.
    """
    lambdas = np.asarray(lambdas, float)
    lambdas = lambdas[lambdas != 0.0]
    if lambdas.size == 0:
        return 1.0 if q <= 0 else 0.0
    if np.all(lambdas == lambdas[0]) and lambdas[0] > 0:
        return float(chi2.sf(q / lambdas[0], lambdas.size))

    def theta(u):
        return 0.5 * np.sum(np.arctan(lambdas * u)) - 0.5 * q * u

    def rho(u):
        return np.prod((1.0 + (lambdas * u) ** 2) ** 0.25)

    def integrand(u):
        if u == 0.0:
            # lim_{u->0} sin(theta)/(u rho) = theta'(0) = (sum(l) - q)/2
            return 0.5 * (np.sum(lambdas) - q)
        return np.sin(theta(u)) / (u * rho(u))

    # With few DISTINCT eigenvalues the integrand decays like u^{-r/2-1},
    # so the oscillatory quadrature legitimately reaches its subdivision
    # limit and scipy emits an IntegrationWarning; the returned value is
    # still far more accurate than the 1e-7 tolerances this oracle is
    # compared at (it cross-checks Davies, which is the primary method), so
    # the warning is bounded here rather than letting a noisy oracle leak
    # into every test run.
    import warnings
    from scipy.integrate import IntegrationWarning

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", IntegrationWarning)
        val, _ = quad(integrand, 0.0, np.inf, epsabs=epsabs, epsrel=epsrel,
                      limit=2000)
    return float(np.clip(0.5 + val / np.pi, 0.0, 1.0))


# --------------------------------------------------------------------------
# Reference-style serial pipeline (the measured CPU baseline).
# --------------------------------------------------------------------------
def scan_interaction_reference_style(y, W, E0, E1=None, Ls=None, hK=None,
                                     G=None, rho_grid=None, pvalue=None,
                                     timers=None):
    """Serial scan reproducing the reference's *computational pattern*.

    Mirrors the cost structure of _cellregmap.py:317-440 + glimix-core:
    economic QS of each rho's half-factor once (thin SVD), then per SNP a
    serial loop of 11 REML fits (scipy scalar search on the profiled
    rotated-basis objective, as glimix-core's Brent does), the QSCov/PMat
    matrix-free score pass, and a Davies p-value.  This is the honest
    baseline for bench.py: same asymptotics as the reference
    (O(n r) per objective evaluation after rotation), serial Python loop,
    host BLAS.
    """
    y = np.asarray(y, float).ravel()
    n = y.shape[0]
    W = np.ones((n, 1)) if W is None else np.asarray(W, float)
    E0 = np.asarray(E0, float)
    E1 = E0 if E1 is None else np.asarray(E1, float)
    G = np.asarray(G, float)

    if Ls is not None and len(Ls):
        rho_grid = np.linspace(0, 1, 11) if rho_grid is None else rho_grid
        bg_parts = [np.asarray(L, float) for L in Ls]
    elif hK is not None:
        rho_grid = np.linspace(0, 1, 11) if rho_grid is None else rho_grid
        bg_parts = [np.asarray(hK, float)]
    else:
        rho_grid = np.array([1.0])
        bg_parts = []

    # setup: one thin SVD per rho (the reference's __init__ hot spot,
    # _cellregmap.py:119-131)
    import time as _time

    _t0 = _time.perf_counter()
    QS = []
    for rho1 in rho_grid:
        hS = np.concatenate(
            [np.sqrt(rho1) * E1] + [np.sqrt(1 - rho1) * B for B in bg_parts],
            axis=1,
        )
        U, s, _ = np.linalg.svd(hS, full_matrices=False)
        QS.append((U, s**2))
    if timers is not None:
        timers["setup_s"] = _time.perf_counter() - _t0
    _t0 = _time.perf_counter()

    if pvalue is None:
        from .models.pvalues import davies_pvalue as pvalue

    pvals = []
    info = {"rho1": [], "e2": [], "g2": [], "eps2": []}
    for i in range(G.shape[1]):
        g = G[:, [i]]
        X = np.concatenate((W, g), axis=1)
        best = None
        for r_idx, rho1 in enumerate(rho_grid):
            Q0, S0 = QS[r_idx]
            # per-fit rotation (glimix rotates once per LMM instance)
            Xt = Q0.T @ X
            yt = Q0.T @ y
            from scipy.optimize import minimize_scalar

            Cxx = X.T @ X - Xt.T @ Xt
            cxy = X.T @ y - Xt.T @ yt
            cyy = y @ y - yt @ yt

            def neg(logit):
                delta = 1.0 / (1.0 + np.exp(-logit))
                d = (1 - delta) * S0 + delta
                w = 1.0 / d
                A = Xt.T @ (Xt * w[:, None]) + Cxx / delta
                b = Xt.T @ (yt * w) + cxy / delta
                beta = solve(A, b)
                rss = max(float(yt @ (yt * w) + cyy / delta - b @ beta),
                          1e-300)
                nu = n - X.shape[1]
                logdet_d = float(np.sum(np.log(d))) + (n - len(S0)) * np.log(
                    delta
                )
                _, la = np.linalg.slogdet(A)
                _, lxx = np.linalg.slogdet(X.T @ X)
                return 0.5 * (
                    nu * np.log(2 * np.pi * rss / nu) + logdet_d + la - lxx
                    + nu
                )

            grid = np.linspace(-18, 18, 64)
            vals = [neg(t) for t in grid]
            k = int(np.argmin(vals))
            res = minimize_scalar(
                neg, bounds=(grid[max(k - 1, 0)], grid[min(k + 1, 63)]),
                method="bounded", options={"xatol": 1e-10},
            )
            delta = 1.0 / (1.0 + np.exp(-res.x))
            d = (1 - delta) * S0 + delta
            w = 1.0 / d
            A = Xt.T @ (Xt * w[:, None]) + Cxx / delta
            b = Xt.T @ (yt * w) + cxy / delta
            beta = solve(A, b)
            rss = float(yt @ (yt * w) + cyy / delta - b @ beta)
            nu = n - X.shape[1]
            scale = rss / nu
            lml = -float(res.fun)
            if best is None or lml > best["lml"]:
                best = {
                    "lml": lml, "rho1": float(rho1), "r_idx": r_idx,
                    "v0": scale * (1 - delta), "v1": scale * delta,
                }

        Q0, S0 = QS[best["r_idx"]]
        v0, v1 = best["v0"], best["v1"]

        # matrix-free score pass (QSCov/PMat pattern, _math.py:40-128)
        R0 = 1.0 / (1.0 + (v0 / v1) * S0)

        def kinv(v):
            Qv = Q0.T @ v
            return (Q0 @ (R0[:, None] * Qv if Qv.ndim == 2 else R0 * Qv)
                    + v - Q0 @ Qv) / v1

        A_mat = g * E0
        Kiy = kinv(y)
        KiX = kinv(X)
        XKX = X.T @ KiX
        Py = Kiy - KiX @ solve(XKX, X.T @ Kiy)
        PA = kinv(A_mat) - KiX @ solve(XKX, X.T @ kinv(A_mat))
        Q_stat = float((A_mat.T @ Py) @ (A_mat.T @ Py)) / 2
        Wmat = A_mat.T @ PA / 2
        pvals.append(pvalue(Q_stat, weight_matrix=Wmat))
        info["rho1"].append(best["rho1"])
        info["e2"].append(v0 * best["rho1"])
        info["g2"].append(v0 * (1 - best["rho1"]))
        info["eps2"].append(v1)

    info = {k: np.asarray(v, float) for k, v in info.items()}
    if timers is not None:
        timers["scan_s"] = _time.perf_counter() - _t0
    return np.asarray(pvals, float), info


# --------------------------------------------------------------------------
# Dense serial CellRegMap pipeline (baseline / end-to-end oracle).
# --------------------------------------------------------------------------
def scan_interaction_dense(y, W, E0, E1=None, Ls=None, G=None, hK=None,
                           rho_grid=None, idx_E=None, idx_G=None,
                           pvalue=None):
    """Serial dense interaction scan mirroring _cellregmap.py:317-440.

    Per SNP: REML null fit over the rho1 grid (dense covariance, scipy scalar
    optimizer), dense P matrix, score statistic, mixture weights, exact tail.
    O(n^3) per fit — usable only for small test problems and as the
    measured CPU baseline.
    """
    y = np.asarray(y, float).ravel()
    n = y.shape[0]
    W = np.ones((n, 1)) if W is None else np.asarray(W, float)
    E0 = np.asarray(E0, float)
    E1 = E0 if E1 is None else np.asarray(E1, float)
    G = np.asarray(G, float)

    if Ls is not None and len(Ls):
        rho_grid = np.linspace(0, 1, 11) if rho_grid is None else rho_grid
        bg = sum(np.asarray(L) @ np.asarray(L).T for L in Ls)
    elif hK is not None:
        rho_grid = np.linspace(0, 1, 11) if rho_grid is None else rho_grid
        hK = np.asarray(hK, float)
        bg = hK @ hK.T
    else:
        rho_grid = np.array([1.0])
        bg = np.zeros((n, n))

    EE = E1 @ E1.T
    Sigmas = [r * EE + (1 - r) * bg for r in rho_grid]

    if pvalue is None:
        # Same exact tail method as the engine (the Davies ladder, itself
        # validated against closed forms in tests/test_pvalues.py) so that
        # engine-vs-oracle comparisons isolate the *pipeline* (fits, Q,
        # weights); imhof_sf loses absolute accuracy on few-weight spectra.
        from .models.pvalues import davies_pvalue

        pvalue = lambda q, lam: davies_pvalue(q, lambdas=lam)

    E0_test = E0 if idx_E is None else E0[idx_E, :]

    pvals, info = [], {"rho1": [], "e2": [], "g2": [], "eps2": []}
    qstats, lambda_list = [], []
    for i in range(G.shape[1]):
        g = G[:, [i]]
        X = np.concatenate((W, g), axis=1)
        best = None
        for r_idx, rho1 in enumerate(rho_grid):
            fit = fit_lmm_dense(y, X, Sigmas[r_idx], restricted=True)
            if best is None or fit["lml"] > best["lml"]:
                best = dict(fit, rho1=float(rho1), Sigma=Sigmas[r_idx])
        v0, v1 = best["v0"], best["v1"]
        K0 = v0 * best["Sigma"] + v1 * np.eye(n)
        gtest = g.ravel() if idx_G is None else g.ravel()[idx_G]
        A = gtest[:, None] * E0_test
        P = P_matrix(X, K0)
        Py = P @ y
        Q = float((A.T @ Py) @ (A.T @ Py)) / 2
        Wmat = A.T @ P @ A / 2
        lam = eigvalsh((Wmat + Wmat.T) / 2)
        lam_pos = lam[lam >= 0]
        lam_keep = lam[lam > (lam_pos.mean() / 1e5 if lam_pos.size else 0.0)]
        pvals.append(pvalue(Q, lam_keep))
        qstats.append(Q)
        lambda_list.append(lam_keep)
        info["rho1"].append(best["rho1"])
        info["e2"].append(v0 * best["rho1"])
        info["g2"].append(v0 * (1 - best["rho1"]))
        info["eps2"].append(v1)

    info = {k: np.asarray(v, float) for k, v in info.items()}
    info["Q"] = np.asarray(qstats, float)
    info["lambdas"] = lambda_list
    return np.asarray(pvals, float), info
