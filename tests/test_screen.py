"""Two-pass screen -> confirm scan: discovery-set equality + f32 accuracy.

The screen mode is only admissible with (a) a proof that
the *confirmed* discovery set and its p-values match the full-f64 path
exactly, and (b) a measured screen-miss bound justifying the margin.  These
tests provide both at CPU-tractable shapes; chip_smoke.py measures the
screen error at the 10k-cell north-star shape on the GPU.
"""
import numpy as np
import pytest
from numpy.testing import assert_allclose

import cellregmap_tpu as crt


def _dataset(n=400, C=6, n_donors=40, S=96, seed=0, beta_gxe=0.6):
    rng = np.random.default_rng(seed)
    E = rng.normal(size=(n, C)) / np.sqrt(C)
    W = np.ones((n, 1))
    donor_of = np.repeat(np.arange(n_donors), -(-n // n_donors))[:n]
    hK = np.zeros((n, n_donors))
    hK[np.arange(n), donor_of] = 1.0
    Ls = crt.get_L_values(hK, E)
    maf = rng.uniform(0.2, 0.45, size=S)
    G = rng.binomial(2, maf[None, :].repeat(n_donors, 0))[donor_of, :]
    G = np.asarray(G, float)
    G = (G - G.mean(0)) / np.maximum(G.std(0), 1e-9)
    y = (rng.normal(size=n)
         + 0.5 * E @ rng.normal(size=C)
         + 0.4 * hK @ rng.normal(size=n_donors)
         + beta_gxe * G[:, 3] * E[:, 0] * np.sqrt(C))
    return y, W, E, Ls, G


@pytest.fixture(scope="module")
def data():
    return _dataset()


@pytest.fixture(scope="module")
def crm(data):
    y, W, E, Ls, G = data
    return crt.CellRegMap(y=y, E=E, W=W, Ls=Ls,
                          config=crt.ScanConfig(snp_batch=32))


def test_screen_confirms_exact_f64_pvalues(data, crm):
    """Every pair below the significance cutoff in the full-f64 scan must
    be (a) in the confirmed set and (b) reported with the identical
    f64 + Davies p-value."""
    y, W, E, Ls, G = data
    pv64, _ = crm.scan_interaction(G)
    significance = 1e-3  # generous: several hits on this sim
    pv_sc, info = crm.scan_interaction_screen(G, significance=significance,
                                              screen_margin=100.0)
    below = pv64 < significance
    assert below.any(), "simulation produced no hits; test is vacuous"
    # (a) no screen misses
    assert np.all(info["confirmed"][below]), (
        pv64[below], info["screen_pv"][below])
    # (b) confirmed p-values are the exact f64 + Davies values
    assert_allclose(pv_sc[below], pv64[below], rtol=1e-12, atol=0.0)
    # non-confirmed pairs carry the f32 screen approximation
    far = ~info["confirmed"]
    assert np.all(pv_sc[far] == info["screen_pv"][far])


def test_screen_f32_accuracy_bound(data, crm):
    """Measured screen-miss bound: max |log10(pv32/pv64)| across the scan
    must stay well inside the default 2-decade margin.  This is the
    CPU-shape instance of the calibration evidence; chip_smoke.py checks
    the north-star shape on the GPU."""
    y, W, E, Ls, G = data
    pv64, _ = crm.scan_interaction(G)
    _, info = crm.scan_interaction_screen(G, significance=1e-300)
    pv32 = info["screen_pv"]
    # compare against the f64 *saddlepoint* pv (same approximation family)
    import dataclasses
    crm_sp = crt.CellRegMap(y=y, E=E, W=W, Ls=Ls,
                            config=dataclasses.replace(
                                crm._cfg, pvalue_method="saddlepoint"))
    pv64_sp, _ = crm_sp.scan_interaction(G)
    # pv32 == 0 means f32 underflow (pv < ~1e-38): such pairs are ALWAYS
    # confirmed (0 < any threshold), so they cannot be screen misses
    ok = (np.isfinite(pv32) & (pv32 > 0) & np.isfinite(pv64_sp)
          & (pv64_sp > 1e-30))
    assert ok.sum() >= G.shape[1] * 0.9
    dlog = np.abs(np.log10(pv32[ok]) - np.log10(pv64_sp[ok]))
    assert dlog.max() < 0.5, dlog.max()  # default margin is 2.0 decades


def test_screen_multigene_matches_single_gene(data, crm):
    y, W, E, Ls, G = data
    rng = np.random.default_rng(7)
    n_genes = 3
    Y = y[:, None] + 0.3 * rng.normal(size=(y.shape[0], n_genes))
    Y[:, 1] = y
    pv_mg, info_mg = crm.scan_interaction_multigene_screen(
        Y, G, gene_batch=2, significance=1e-3)
    for g in range(n_genes):
        pv_sg, info_sg = crm.with_phenotype(Y[:, g]).scan_interaction_screen(
            G, significance=1e-3)
        # screen (f32) pvs: the gene-batched and single-gene programs fuse
        # differently, so agreement is at the f32 noise level (~1e-2
        # relative) — well inside the 2-decade screen margin
        assert_allclose(pv_mg[g], pv_sg, rtol=0.05, atol=1e-12)
        # confirmed pairs are bit-exact across drivers (same f64 kernel)
        both = info_mg["confirmed"][g] & info_sg["confirmed"]
        assert_allclose(pv_mg[g][both], pv_sg[both], rtol=1e-12)


def test_screen_full_rank_background_robust():
    """R ~ n regression (round 5): with a wide factor stack the complement
    Grams are ~0 and f32 cancellation noise, amplified by 1/delta ~ e18,
    used to pin 54% of screen fits at the bracket edge with 1000x-inflated
    Q (pv = 0).  The complement conditioning (noise-floor clamp +
    Cauchy-Schwarz clip, engine.interaction_batch) must keep every screen
    p-value finite and within the margin of the f64 answer."""
    rng = np.random.default_rng(3)
    n, C, n_donors, S = 400, 8, 50, 64
    E = rng.normal(size=(n, C)) / np.sqrt(C)
    W = np.ones((n, 1))
    donor_of = np.repeat(np.arange(n_donors), n // n_donors)[:n]
    hK = np.zeros((n, n_donors))
    hK[np.arange(n), donor_of] = 1.0
    Ls = crt.get_L_values(hK, E)   # width C*n_donors = 400 = n
    maf = rng.uniform(0.2, 0.45, size=S)
    G = rng.binomial(2, maf[None, :].repeat(n_donors, 0))[donor_of, :]
    G = np.asarray(G, float)
    G = (G - G.mean(0)) / np.maximum(G.std(0), 1e-9)
    y = (rng.normal(size=n) + 0.5 * E @ rng.normal(size=C)
         + 0.4 * hK @ rng.normal(size=n_donors))
    crm = crt.CellRegMap(y=y, E=E, W=W, Ls=Ls,
                         config=crt.ScanConfig(snp_batch=64))
    assert int(crm._ctx.S.shape[1]) >= n - C  # genuinely R ~ n
    _, info = crm.scan_interaction_screen(G, significance=1e-300)
    pv32 = info["screen_pv"]
    assert np.isfinite(pv32).all()
    assert (pv32 > 1e-300).all(), (pv32.min(), (pv32 <= 1e-300).sum())
    pv64, _ = crm.scan_interaction(G)
    ok = pv64 > 1e-30
    dlog = np.abs(np.log10(pv32[ok]) - np.log10(pv64[ok]))
    assert dlog.max() < 1.0, dlog.max()


def test_screen_validates_f32_base_config(data):
    y, W, E, Ls, G = data
    crm32 = crt.CellRegMap(y=y, E=E, W=W, Ls=Ls,
                           config=crt.ScanConfig(dtype="float32"))
    with pytest.raises(ValueError, match="float64"):
        crm32.scan_interaction_screen(G)
