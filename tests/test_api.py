"""End-to-end API tests vs the dense serial oracle pipeline."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
from numpy.testing import assert_allclose

import cellregmap_tpu as crt
from cellregmap_tpu import engine, oracle
from cellregmap_tpu.models.pvalues import lrt_pvalues


def _dataset(seed=7, n=60, C=3, S=6, kinship=True, pW=1):
    rng = np.random.default_rng(seed)
    E = rng.normal(size=(n, C))
    W = np.concatenate([np.ones((n, 1)), rng.normal(size=(n, pW - 1))],
                       axis=1)
    G = rng.choice([0.0, 1.0, 2.0], size=(n, S), p=[0.49, 0.42, 0.09])
    G = (G - G.mean(0)) / G.std(0)
    hK = rng.normal(size=(n, 8)) / np.sqrt(8)
    Ls = [np.asarray(L) for L in crt.get_L_values(hK, E)] if kinship else None
    KE = sum(L @ L.T for L in Ls) if kinship else np.zeros((n, n))
    y = (
        0.5 * rng.normal(size=n)
        + 0.3 * E @ rng.normal(size=C)
        + np.linalg.cholesky(KE + 1e-8 * np.eye(n)) @ rng.normal(size=n)
        + 0.25 * G[:, 2] * E[:, 0]
    )
    return dict(y=y, W=W, E=E, G=G, hK=hK, Ls=Ls, KE=KE, rng=rng, n=n)


def test_scan_interaction_vs_oracle_kinship():
    d = _dataset()
    pv_ref, info_ref = oracle.scan_interaction_dense(
        d["y"], d["W"], d["E"], Ls=d["Ls"], G=d["G"]
    )
    crm = crt.CellRegMap(y=d["y"], E=d["E"], W=d["W"], Ls=d["Ls"])
    pv, info = crm.scan_interaction(d["G"])
    assert np.array_equal(info["rho1"], info_ref["rho1"])
    # Q is the most delta-sensitive statistic; 1e-7 relative reflects the
    # two optimizers' agreement on the REML optimum.
    assert_allclose(info["Q"], info_ref["Q"], rtol=1e-6)
    assert_allclose(pv, pv_ref, atol=5e-8)
    assert_allclose(info["e2"], info_ref["e2"], rtol=1e-4, atol=1e-8)
    assert_allclose(info["eps2"], info_ref["eps2"], rtol=1e-4, atol=1e-8)


def test_scan_interaction_e_only():
    d = _dataset(kinship=False, seed=9)
    pv_ref, info_ref = oracle.scan_interaction_dense(
        d["y"], d["W"], d["E"], G=d["G"]
    )
    crm = crt.CellRegMap(y=d["y"], E=d["E"], W=d["W"])
    pv, info = crm.scan_interaction(d["G"])
    assert_allclose(pv, pv_ref, atol=5e-8)


def test_scan_interaction_hk_mode():
    d = _dataset(seed=13)
    pv_ref, _ = oracle.scan_interaction_dense(
        d["y"], d["W"], d["E"], G=d["G"], hK=d["hK"]
    )
    crm = crt.CellRegMap(y=d["y"], E=d["E"], W=d["W"], hK=d["hK"])
    pv, _ = crm.scan_interaction(d["G"])
    assert_allclose(pv, pv_ref, atol=5e-8)


def test_scan_interaction_permutations():
    d = _dataset(seed=21, S=4)
    idx = np.random.default_rng(1).permutation(d["n"])
    crm = crt.CellRegMap(y=d["y"], E=d["E"], W=d["W"], Ls=d["Ls"])
    pv_e, _ = crm.scan_interaction(d["G"], idx_E=idx)
    pv_g, _ = crm.scan_interaction(d["G"], idx_G=idx)
    ref_e, _ = oracle.scan_interaction_dense(
        d["y"], d["W"], d["E"], Ls=d["Ls"], G=d["G"], idx_E=idx
    )
    ref_g, _ = oracle.scan_interaction_dense(
        d["y"], d["W"], d["E"], Ls=d["Ls"], G=d["G"], idx_G=idx
    )
    assert_allclose(pv_e, ref_e, atol=5e-8)
    assert_allclose(pv_g, ref_g, atol=5e-8)


def test_scan_association_vs_oracle():
    d = _dataset(seed=11, pW=2)
    y, W, E, G, hK = d["y"], d["W"], d["E"], d["G"], d["hK"]
    EE, bg = E @ E.T, hK @ hK.T
    rho_grid = np.linspace(0, 1, 11)
    best = None
    for r in rho_grid:
        fit = oracle.fit_lmm_dense(y, W, r * EE + (1 - r) * bg, False)
        if best is None or fit["lml"] > best[0]["lml"]:
            best = (fit, r)
    alt = [
        oracle.fit_lmm_dense(
            y, np.concatenate([W, G[:, [i]]], axis=1),
            best[1] * EE + (1 - best[1]) * bg, False
        )["lml"]
        for i in range(G.shape[1])
    ]
    pv_ref = lrt_pvalues(best[0]["lml"], alt)

    crm = crt.CellRegMap(y=y, E=E, W=W, hK=hK)
    pv, info = crm.scan_association(G)
    assert_allclose(pv, pv_ref, rtol=1e-6, atol=1e-12)
    assert_allclose(info["rho1"][0], best[1])

    # fast scan: null delta fixed; oracle refits scale/beta only
    fits, k = crm._fit_null_association()
    delta = float(fits.delta[k])
    Sigma = best[1] * EE + (1 - best[1]) * bg
    S_full, Q = np.linalg.eigh(Sigma)
    S_full = np.maximum(S_full, 0)
    alt_fast = [
        oracle.lmm_lml_components(
            delta, S_full, Q.T @ np.concatenate([W, G[:, [i]]], axis=1),
            Q.T @ y, False
        )[0]
        for i in range(G.shape[1])
    ]
    pv_fast_ref = lrt_pvalues(best[0]["lml"], alt_fast)
    pv_fast, _ = crm.scan_association_fast(G)
    assert_allclose(pv_fast, pv_fast_ref, rtol=1e-5, atol=1e-12)


def test_predict_interaction_vs_oracle():
    d = _dataset(seed=17, S=4)
    y, W, E, G, Ls, KE = d["y"], d["W"], d["E"], d["G"], d["Ls"], d["KE"]
    n = d["n"]
    mafs = np.full(G.shape[1], 0.3)
    norm = 1 / np.sqrt(2 * mafs * (1 - mafs))
    rho_grid = np.linspace(0, 1, 11)
    bg_ref, bgxe_ref = [], []
    for i in range(G.shape[1]):
        g = G[:, [i]]
        M = np.concatenate([W, g, E], axis=1)
        gE = g * E
        best = None
        for r in rho_grid:
            Sig = r * (gE @ gE.T) + (1 - r) * KE
            fit = oracle.fit_lmm_dense(y, M, Sig, True)
            if best is None or fit["lml"] > best[0]["lml"]:
                best = (fit, r, Sig)
        fitp, rp, Sigp = best
        yadj = y - M @ fitp["beta"]
        v = np.linalg.solve(fitp["v0"] * Sigp + fitp["v1"] * np.eye(n), yadj)
        bg_ref.append(fitp["beta"][W.shape[1]])
        bgxe_ref.append(fitp["v0"] * rp * (E @ (gE.T @ v)) * norm[i])
    crm = crt.CellRegMap(y=y, E=E, W=W, Ls=Ls)
    beta_g, beta_gxe = crm.predict_interaction(G, mafs)
    assert_allclose(beta_g, np.asarray(bg_ref), atol=1e-7)
    assert_allclose(beta_gxe, np.stack(bgxe_ref, 1), atol=1e-7)


def test_estimate_aggregate_environment():
    d = _dataset(seed=23, S=3)
    y, W, E, G, Ls, KE = d["y"], d["W"], d["E"], d["G"], d["Ls"], d["KE"]
    n = d["n"]
    crm = crt.CellRegMap(y=y, E=E, W=W, Ls=Ls)
    agg = crm.estimate_aggregate_environment(G[:, 0])
    assert agg.shape == (n, 1) or agg.shape == (n,)
    # oracle at the same rho choice (lml ridge makes argmax tie-sensitive;
    # compare conditioned on the engine's rho)
    M = np.concatenate([W, G[:, [0]], E], axis=1)
    fits = jax.device_get(
        engine.mean_fit_kernel(crm._ctx, jnp.asarray(M), n, True,
                               (-18.0, 18.0, 64, 60))
    )
    k = int(np.argmax(fits.lml))
    rho1 = float(np.asarray(crm._ctx.rho)[k])
    ref = oracle.fit_lmm_dense(y, M, rho1 * (E @ E.T) + (1 - rho1) * KE, True)
    gE = G[:, [0]] * E
    yadj = y - M @ ref["beta"]
    v = np.linalg.solve(
        ref["v0"] * (rho1 * (gE @ gE.T) + (1 - rho1) * KE)
        + ref["v1"] * np.eye(n),
        yadj,
    )
    agg_ref = E @ ((ref["v0"] * rho1) * (gE.T @ v))
    assert_allclose(np.ravel(agg), np.ravel(agg_ref), atol=1e-5)


def test_run_wrappers():
    d = _dataset(seed=29, S=3)
    pv, info = crt.run_interaction(
        y=d["y"], E=d["E"], G=d["G"], W=d["W"], hK=d["hK"]
    )
    assert pv.shape == (3,)
    assert np.all((pv > 0) & (pv <= 1))
    pv2, _ = crt.run_association(d["y"], d["W"], d["E"], d["G"], hK=d["hK"])
    pv3, _ = crt.run_association_fast(d["y"], d["W"], d["E"], d["G"],
                                      hK=d["hK"])
    assert np.all((pv2 > 0) & (pv2 <= 1))
    assert np.all((pv3 > 0) & (pv3 <= 1))
    bg, bgxe = crt.estimate_betas(d["y"], d["W"], d["E"], d["G"],
                                  maf=np.full(3, 0.3), hK=d["hK"])
    assert bg.shape == (3,)
    assert bgxe.shape == (d["n"], 3)


def test_association_newton_matches_golden():
    """The Newton-based slow-association refit (shared-GEMM grid + analytic
    ML derivatives) must reproduce the golden-section
    path's lmls and p-values."""
    for seed, pW in ((11, 2), (23, 1)):
        d = _dataset(seed=seed, pW=pW, S=8)
        crm = crt.CellRegMap(y=d["y"], E=d["E"], W=d["W"], hK=d["hK"])
        _, k = crm._fit_null_association()
        G = jnp.asarray(d["G"], crm._dtype)
        lml_new, beta_new = engine.association_refit_kernel(
            crm._ctx, G, k, crm._n)
        lml_old, beta_old = engine.association_refit_golden_kernel(
            crm._ctx, G, k, crm._n)
        assert_allclose(np.asarray(lml_new), np.asarray(lml_old),
                        rtol=0, atol=1e-8)
        assert_allclose(np.asarray(beta_new), np.asarray(beta_old),
                        rtol=1e-6, atol=1e-9)
        null_lml = float(crm._null_assoc[0].lml[k])
        pv_new = lrt_pvalues(null_lml, np.asarray(lml_new))
        pv_old = lrt_pvalues(null_lml, np.asarray(lml_old))
        assert_allclose(pv_new, pv_old, rtol=0, atol=1e-9)


def test_compute_maf():
    rng = np.random.default_rng(0)
    X = rng.integers(0, 3, size=(100, 10)).astype(float)
    maf = crt.compute_maf(X)
    assert np.all(maf <= 0.5)
    ref = np.minimum(X.mean(0) / 2, 1 - X.mean(0) / 2)
    assert_allclose(maf, ref)
    X[0, 0] = np.nan
    maf = crt.compute_maf(X)
    assert np.isfinite(maf).all()


def test_multigene_scan_matches_per_gene():
    d = _dataset(seed=41, S=4)
    rng = np.random.default_rng(5)
    Y = np.stack([d["y"], d["y"] + rng.normal(size=d["n"])], axis=1)
    pvs, info = crt.run_interaction_multigene(
        Y, d["E"], d["G"], W=d["W"], hK=d["hK"]
    )
    assert pvs.shape == (2, 4)
    # gene 1 standalone must match
    pv1, _ = crt.run_interaction(y=Y[:, 1], E=d["E"], G=d["G"], W=d["W"],
                                 hK=d["hK"])
    assert_allclose(pvs[1], pv1, atol=1e-9)


def test_multigene_tiling_and_padding():
    """5 genes through tiles of 2 (ragged last tile) must equal the
    per-gene loop exactly, including the info contract."""
    d = _dataset(seed=43, S=5)
    rng = np.random.default_rng(6)
    Y = d["y"][:, None] + 0.3 * rng.normal(size=(d["n"], 5))
    pvs, info = crt.run_interaction_multigene(
        Y, d["E"], d["G"], W=d["W"], hK=d["hK"], gene_batch=2
    )
    assert pvs.shape == (5, 5)
    assert info["rho1"].shape == (5, 5)
    crm = crt.CellRegMap(y=Y[:, 0], E=d["E"], W=d["W"],
                         Ls=crt.get_L_values(d["hK"], d["E"]))
    for j in range(5):
        pv_j, info_j = (crm if j == 0 else
                        crm.with_phenotype(Y[:, j])).scan_interaction(d["G"])
        assert_allclose(pvs[j], pv_j, atol=1e-9)
        assert_allclose(info["rho1"][j], info_j["rho1"], atol=0)


def test_association_fast_multigene_matches_per_gene():
    """Gene-batched fast association (ragged tiles) == the per-gene loop,
    p-values and info, at full precision."""
    d = _dataset(seed=51, S=5)
    rng = np.random.default_rng(8)
    Y = d["y"][:, None] + 0.3 * rng.normal(size=(d["n"], 3))
    pvs, info = crt.run_association_fast_multigene(
        Y, d["E"], d["G"], W=d["W"], hK=d["hK"], gene_batch=2
    )
    assert pvs.shape == (3, 5)
    assert info["rho1"].shape == (3,)
    for j in range(3):
        pv_j, info_j = crt.run_association_fast(
            y=Y[:, j], W=d["W"], E=d["E"], G=d["G"], hK=d["hK"])
        assert_allclose(pvs[j], pv_j, atol=1e-10)
        assert_allclose(info["rho1"][j], info_j["rho1"][0], atol=0)
        assert_allclose(info["eps2"][j], info_j["eps2"][0], rtol=1e-7)


def test_association_multigene_matches_per_gene():
    """Gene-batched slow association (Newton refit, ragged tiles) == the
    per-gene scan_association, p-values and info."""
    d = _dataset(seed=57, S=5)
    rng = np.random.default_rng(12)
    Y = d["y"][:, None] + 0.3 * rng.normal(size=(d["n"], 3))
    pvs, info = crt.run_association_multigene(
        Y, d["E"], d["G"], W=d["W"], hK=d["hK"], gene_batch=2
    )
    assert pvs.shape == (3, 5)
    assert info["rho1"].shape == (3,)
    for j in range(3):
        crm = crt.CellRegMap(y=Y[:, j], E=d["E"], W=d["W"], hK=d["hK"])
        pv_j, info_j = crm.scan_association(d["G"])
        assert_allclose(pvs[j], pv_j, rtol=1e-9, atol=1e-12)
        assert_allclose(info["rho1"][j], info_j["rho1"][0], atol=0)
        assert_allclose(info["eps2"][j], info_j["eps2"][0], rtol=1e-7)


def test_davies_info_has_no_placeholder_pvalues():
    d = _dataset(seed=47, S=3)
    crm = crt.CellRegMap(y=d["y"], E=d["E"], W=d["W"], Ls=d["Ls"])
    _, info = crm.scan_interaction(d["G"])  # default method is davies
    assert "pv_liu" not in info
    assert "pv_saddlepoint" not in info
    cfg = crt.ScanConfig(pvalue_method="liu")
    crm2 = crt.CellRegMap(y=d["y"], E=d["E"], W=d["W"], Ls=d["Ls"],
                          config=cfg)
    _, info2 = crm2.scan_interaction(d["G"])
    assert "pv_liu" in info2 and "pv_saddlepoint" in info2
    assert np.all((info2["pv_liu"] > 0) & (info2["pv_liu"] <= 1.0))


def test_auto_mode_refined_matches_davies_1e8():
    """auto mode's Davies refinement must agree with davies mode to 1e-8:
    the refined subset's mixture weights are host-recomputed from Wmat
    rather than taken from the ~1e-7-accurate device eigh."""
    d = _dataset(seed=53, S=8)
    # strong signal so several variants fall under the refinement threshold
    d["y"] = d["y"] + 1.5 * d["G"][:, 1] * d["E"][:, 0]
    cfg_auto = crt.ScanConfig(pvalue_method="auto", davies_threshold=0.5)
    cfg_dav = crt.ScanConfig(pvalue_method="davies")
    pv_auto, _ = crt.CellRegMap(y=d["y"], E=d["E"], W=d["W"], Ls=d["Ls"],
                                config=cfg_auto).scan_interaction(d["G"])
    pv_dav, _ = crt.CellRegMap(y=d["y"], E=d["E"], W=d["W"], Ls=d["Ls"],
                               config=cfg_dav).scan_interaction(d["G"])
    refined = pv_auto < 0.5
    assert refined.any()
    assert_allclose(pv_auto[refined], pv_dav[refined], atol=1e-8)
