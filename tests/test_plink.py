"""PLINK .bed reader: native decoder vs pure-NumPy fallback vs ground truth."""
import numpy as np
import pytest
from numpy.testing import assert_allclose

from cellregmap_tpu.utils import plink


@pytest.fixture
def fileset(tmp_path):
    rng = np.random.default_rng(0)
    n, m = 37, 23  # deliberately not multiples of 4
    G = rng.choice([0.0, 1.0, 2.0], size=(n, m), p=[0.5, 0.3, 0.2])
    G[3, 5] = np.nan
    G[36, 22] = np.nan
    prefix = str(tmp_path / "toy")
    plink.write_bed(prefix, G)
    return prefix, G


def test_roundtrip_full(fileset):
    prefix, G = fileset
    rd = plink.PlinkReader(prefix)
    assert rd.n_samples == G.shape[0]
    assert rd.n_variants == G.shape[1]
    got = rd.read()
    assert_allclose(got, G)
    # python fallback agrees with the native path
    py = plink._decode_python(prefix + ".bed", G.shape[0], 0, G.shape[1])
    assert_allclose(py, G)


def test_range_and_blocks(fileset):
    prefix, G = fileset
    rd = plink.PlinkReader(prefix)
    got = rd.read(5, 11)
    assert_allclose(got, G[:, 5:11])
    blocks = list(rd.iter_blocks(7))
    full = np.concatenate([b for b, _ in blocks], axis=1)
    assert_allclose(full, G)
    assert blocks[0][1] == slice(0, 7)


def test_metadata(fileset):
    prefix, G = fileset
    rd = plink.PlinkReader(prefix)
    assert rd.variants[0].snp_id == "snp0"
    assert rd.samples[0][1] == "iid0"


# ---------------------------------------------------------------------------
# Streaming checkpointed scan driver (plink_scan)
# ---------------------------------------------------------------------------
@pytest.fixture
def cohort(tmp_path):
    """Donor-level fileset (>=10k variants) + cell-level model data."""
    rng = np.random.default_rng(11)
    n_donors, n_cells, C, m = 50, 150, 3, 10_240
    maf = rng.uniform(0.05, 0.5, size=m)
    Gd = rng.binomial(2, maf[None, :].repeat(n_donors, 0)).astype(float)
    Gd[0, :8] = np.nan                      # some missing calls
    Gd[:, 17] = 0.0                         # a monomorphic variant
    prefix = str(tmp_path / "cohort")
    donor_ids = [f"donor{i}" for i in range(n_donors)]
    plink.write_bed(prefix, Gd, sample_ids=donor_ids)
    d2c = np.repeat(np.arange(n_donors), 3)
    E = rng.normal(size=(n_cells, C))
    hK = np.zeros((n_cells, n_donors))
    hK[np.arange(n_cells), d2c] = 1.0
    y = (rng.normal(size=n_cells) + 0.4 * E @ rng.normal(size=C)
         + 0.3 * hK @ rng.normal(size=n_donors))
    return dict(prefix=prefix, Gd=Gd, d2c=d2c, E=E, hK=hK, y=y,
                donor_ids=donor_ids, n_cells=n_cells)


def _make_crm(c):
    import cellregmap_tpu as crt

    cfg = crt.ScanConfig(pvalue_method="liu", snp_batch=256)
    Ls = crt.get_L_values(c["hK"], c["E"])
    return crt.CellRegMap(y=c["y"], E=c["E"], Ls=Ls, config=cfg)


def test_streaming_scan_matches_direct(cohort):
    from cellregmap_tpu.plink_scan import scan_interaction_plink

    crm = _make_crm(cohort)
    pv, info, vidx = scan_interaction_plink(
        crm, cohort["prefix"], donor_ids=np.asarray(
            cohort["donor_ids"])[cohort["d2c"]],
        block_size=4096, maf_min=0.01)
    # expected filter: NaN-aware MAF >= 0.01 and non-monomorphic
    Gd = cohort["Gd"]
    frq = np.nansum(Gd, axis=0) / (2 * np.sum(~np.isnan(Gd), axis=0))
    maf = np.minimum(frq, 1 - frq)
    mu = np.nanmean(Gd, axis=0)
    Gdi = np.where(np.isnan(Gd), mu[None, :], Gd)
    keep = (maf >= 0.01) & (Gdi.std(0) > 0) & np.isfinite(maf)
    assert 17 not in vidx
    assert np.array_equal(vidx, np.flatnonzero(keep))
    assert pv.shape == vidx.shape
    # direct in-memory scan of the first block's head must agree exactly
    head = vidx[vidx < 64]
    Gc = Gdi[cohort["d2c"]][:, head]
    Gc = (Gc - Gc.mean(0)) / Gc.std(0)
    pv_direct, _ = crm.scan_interaction(Gc)
    assert_allclose(pv[: head.size], pv_direct, atol=1e-12)


def test_multigene_cis_scan_matches_direct(cohort):
    from cellregmap_tpu.plink_scan import scan_interaction_multigene_plink

    crm = _make_crm(cohort)
    rng = np.random.default_rng(23)
    n_genes = 5
    Y = cohort["y"][:, None] + 0.3 * rng.normal(
        size=(cohort["n_cells"], n_genes))
    # overlapping cis windows over the head of the .bim
    starts = np.array([0, 10, 20, 30, 40])
    windows = np.stack([starts, starts + 24], axis=1)
    res = scan_interaction_multigene_plink(
        crm, cohort["prefix"], Y, windows,
        donor_ids=np.asarray(cohort["donor_ids"])[cohort["d2c"]],
        gene_batch=2, maf_min=0.01)

    # every result row is inside its gene's window and the monomorphic
    # variant 17 never appears
    assert res["pvalues"].shape == res["gene"].shape
    assert not np.any(res["variant_index"] == 17)
    for g in range(n_genes):
        sel = res["gene"] == g
        vi = res["variant_index"][sel]
        assert np.all((vi >= windows[g, 0]) & (vi < windows[g, 1]))

    # direct in-memory multigene scan on one gene's window must agree
    g = 2
    Gd = cohort["Gd"]
    frq = np.nansum(Gd, axis=0) / (2 * np.sum(~np.isnan(Gd), axis=0))
    maf = np.minimum(frq, 1 - frq)
    mu = np.nanmean(Gd, axis=0)
    Gdi = np.where(np.isnan(Gd), mu[None, :], Gd)
    keep = (maf >= 0.01) & (Gdi.std(0) > 0) & np.isfinite(maf)
    win_idx = np.flatnonzero(keep[windows[g, 0] : windows[g, 1]]) \
        + windows[g, 0]
    Gc = Gdi[cohort["d2c"]][:, win_idx]
    Gc = (Gc - Gc.mean(0)) / Gc.std(0)
    pv_direct, _ = crm.with_phenotype(Y[:, g]).scan_interaction(Gc)
    sel = res["gene"] == g
    assert np.array_equal(res["variant_index"][sel], win_idx)
    assert_allclose(res["pvalues"][sel], pv_direct, atol=1e-9)


def test_multigene_cis_scan_crash_resume(cohort, tmp_path):
    import cellregmap_tpu.api as api_mod
    from cellregmap_tpu.parallel.checkpoint import ScanCheckpoint
    from cellregmap_tpu.plink_scan import scan_interaction_multigene_plink

    crm = _make_crm(cohort)
    rng = np.random.default_rng(29)
    Y = cohort["y"][:, None] + 0.3 * rng.normal(size=(cohort["n_cells"], 4))
    windows = np.array([[0, 16], [8, 24], [16, 32], [24, 40]])
    dids = np.asarray(cohort["donor_ids"])[cohort["d2c"]]
    full = scan_interaction_multigene_plink(
        crm, cohort["prefix"], Y, windows, donor_ids=dids, gene_batch=2)

    ck = str(tmp_path / "ckmg")

    class Boom(RuntimeError):
        pass

    calls = {"n": 0}
    real = api_mod.CellRegMap.scan_interaction_multigene

    def crashing(self, *a, **kw):
        if calls["n"] >= 1:  # first tile completes + checkpoints
            raise Boom()
        calls["n"] += 1
        return real(self, *a, **kw)

    api_mod.CellRegMap.scan_interaction_multigene = crashing
    try:
        with pytest.raises(Boom):
            scan_interaction_multigene_plink(
                crm, cohort["prefix"], Y, windows, donor_ids=dids,
                gene_batch=2, checkpoint=ck)
    finally:
        api_mod.CellRegMap.scan_interaction_multigene = real
    state = ScanCheckpoint(ck).load()
    assert state is not None and state["cursor"] == 1

    resumed = scan_interaction_multigene_plink(
        crm, cohort["prefix"], Y, windows, donor_ids=dids,
        gene_batch=2, checkpoint=ck)
    for k in full:
        assert_allclose(resumed[k], full[k], rtol=1e-12)
    assert ScanCheckpoint(ck).load() is None


def test_streaming_scan_crash_resume(cohort, tmp_path):
    from cellregmap_tpu.plink_scan import scan_interaction_plink

    crm = _make_crm(cohort)
    ck = str(tmp_path / "ck")
    calls = []
    real = crm.scan_interaction

    def wrapped(G, **kw):
        calls.append(G.shape[1])
        if len(calls) == 3:
            raise RuntimeError("simulated crash")
        return real(G, **kw)

    crm.scan_interaction = wrapped
    with pytest.raises(RuntimeError):
        scan_interaction_plink(crm, cohort["prefix"],
                               donor_to_cell=cohort["d2c"],
                               block_size=2048, checkpoint=ck)
    n_before = len(calls)
    crm.scan_interaction = real
    pv, info, vidx = scan_interaction_plink(
        crm, cohort["prefix"], donor_to_cell=cohort["d2c"],
        block_size=2048, checkpoint=ck)
    # the rerun resumed after the 2 durable blocks (block 3 crashed before
    # its checkpoint): 5 total - 2 done = 3 blocks re-scanned
    pv_full, _, vidx_full = scan_interaction_plink(
        crm, cohort["prefix"], donor_to_cell=cohort["d2c"], block_size=2048)
    assert_allclose(pv, pv_full, atol=1e-12)
    assert np.array_equal(vidx, vidx_full)


def _expected_filter(cohort, maf_min=0.01):
    Gd = cohort["Gd"]
    frq = np.nansum(Gd, axis=0) / (2 * np.sum(~np.isnan(Gd), axis=0))
    maf = np.minimum(frq, 1 - frq)
    mu = np.nanmean(Gd, axis=0)
    Gdi = np.where(np.isnan(Gd), mu[None, :], Gd)
    keep = (maf >= maf_min) & (Gdi.std(0) > 0) & np.isfinite(maf)
    return Gdi, keep


def test_streaming_association_matches_direct(cohort):
    """Streaming fast + slow association over .bed == direct in-memory
    scans on the same decoded/filtered genotypes."""
    from cellregmap_tpu.plink_scan import scan_association_plink

    crm = _make_crm(cohort)
    dids = np.asarray(cohort["donor_ids"])[cohort["d2c"]]
    pv, info, vidx = scan_association_plink(
        crm, cohort["prefix"], donor_ids=dids, block_size=4096,
        maf_min=0.01, fast=True)
    Gdi, keep = _expected_filter(cohort)
    assert np.array_equal(vidx, np.flatnonzero(keep))
    assert pv.shape == vidx.shape
    head = vidx[vidx < 64]
    Gc = Gdi[cohort["d2c"]][:, head]
    Gc = (Gc - Gc.mean(0)) / Gc.std(0)
    pv_direct, _ = crm.scan_association_fast(Gc)
    assert_allclose(pv[: head.size], pv_direct, atol=1e-12)

    # slow (Newton refit) mode on a small subset
    pv_s, _, vidx_s = scan_association_plink(
        crm, cohort["prefix"], donor_ids=dids, block_size=4096,
        maf_min=0.01, fast=False)
    pv_sd, _ = crm.scan_association(Gc)
    assert_allclose(pv_s[: head.size], pv_sd, atol=1e-12)


def test_streaming_association_crash_resume(cohort, tmp_path):
    from cellregmap_tpu.parallel.checkpoint import ScanCheckpoint
    from cellregmap_tpu.plink_scan import scan_association_plink

    crm = _make_crm(cohort)
    ck = str(tmp_path / "cka")
    full = scan_association_plink(crm, cohort["prefix"],
                                  donor_to_cell=cohort["d2c"],
                                  block_size=2048)
    calls = []
    real = crm.scan_association_fast

    def wrapped(G, **kw):
        calls.append(G.shape[1])
        if len(calls) == 3:
            raise RuntimeError("simulated crash")
        return real(G, **kw)

    crm.scan_association_fast = wrapped
    with pytest.raises(RuntimeError):
        scan_association_plink(crm, cohort["prefix"],
                               donor_to_cell=cohort["d2c"],
                               block_size=2048, checkpoint=ck)
    crm.scan_association_fast = real
    state = ScanCheckpoint(ck).load()
    assert state is not None and state["cursor"] == 2
    pv, _, vidx = scan_association_plink(
        crm, cohort["prefix"], donor_to_cell=cohort["d2c"],
        block_size=2048, checkpoint=ck)
    assert_allclose(pv, full[0], atol=1e-12)
    assert np.array_equal(vidx, full[2])
    assert ScanCheckpoint(ck).load() is None


def test_streaming_betas_matches_direct(cohort, tmp_path):
    from cellregmap_tpu.parallel.checkpoint import ScanCheckpoint
    from cellregmap_tpu.plink_scan import estimate_betas_plink

    crm = _make_crm(cohort)
    dids = np.asarray(cohort["donor_ids"])[cohort["d2c"]]
    bg, bgxe, maf, vidx = estimate_betas_plink(
        crm, cohort["prefix"], donor_ids=dids, block_size=4096,
        maf_min=0.01)
    Gdi, keep = _expected_filter(cohort)
    assert np.array_equal(vidx, np.flatnonzero(keep))
    assert bg.shape == vidx.shape
    assert bgxe.shape == (cohort["n_cells"], vidx.shape[0])
    head = vidx[vidx < 64]
    Gc = Gdi[cohort["d2c"]][:, head]   # RAW genotypes (standardize=False)
    bg_d, bgxe_d = crm.predict_interaction(Gc, maf[: head.size])
    assert_allclose(bg[: head.size], bg_d, atol=1e-12)
    assert_allclose(bgxe[:, : head.size], bgxe_d, atol=1e-12)

    # crash -> resume
    ck = str(tmp_path / "ckb")
    calls = []
    real = crm.predict_interaction

    def wrapped(G, m, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("simulated crash")
        return real(G, m, **kw)

    crm.predict_interaction = wrapped
    with pytest.raises(RuntimeError):
        estimate_betas_plink(crm, cohort["prefix"], donor_ids=dids,
                             block_size=2048, maf_min=0.01, checkpoint=ck)
    crm.predict_interaction = real
    assert ScanCheckpoint(ck).load() is not None
    bg_r, bgxe_r, maf_r, vidx_r = estimate_betas_plink(
        crm, cohort["prefix"], donor_ids=dids, block_size=2048,
        maf_min=0.01, checkpoint=ck)
    bg_f, bgxe_f, _, vidx_f = estimate_betas_plink(
        crm, cohort["prefix"], donor_ids=dids, block_size=2048,
        maf_min=0.01)
    assert_allclose(bg_r, bg_f, atol=1e-12)
    assert_allclose(bgxe_r, bgxe_f, atol=1e-12)
    assert np.array_equal(vidx_r, vidx_f)


def test_streaming_screen_matches_direct(cohort):
    """Streaming screen -> confirm over .bed == direct in-memory screen on
    the same decoded/filtered genotypes; confirmed pairs carry exact f64
    p-values."""
    from cellregmap_tpu.plink_scan import scan_interaction_screen_plink

    crm = _make_crm(cohort)
    dids = np.asarray(cohort["donor_ids"])[cohort["d2c"]]
    pv, info, vidx = scan_interaction_screen_plink(
        crm, cohort["prefix"], donor_ids=dids, block_size=4096,
        maf_min=0.01, significance=1e-3)
    Gdi, keep = _expected_filter(cohort)
    assert np.array_equal(vidx, np.flatnonzero(keep))
    assert pv.shape == vidx.shape == info["confirmed"].shape
    # confirmed pairs: exact f64 davies values from the full-precision path
    head = vidx[vidx < 64]
    Gc = Gdi[cohort["d2c"]][:, head]
    Gc = (Gc - Gc.mean(0)) / Gc.std(0)
    pv_direct, info_direct = crm.scan_interaction_screen(
        Gc, significance=1e-3)
    # screen (f32) values across different batch shapes agree at the f32
    # noise level; confirmed pairs are exact
    assert_allclose(pv[: head.size], pv_direct, rtol=0.05, atol=1e-12)
    both = info["confirmed"][: head.size] & info_direct["confirmed"]
    assert_allclose(pv[: head.size][both], pv_direct[both], rtol=1e-12)


def test_plink_scan_cli_modes(cohort, tmp_path):
    """--mode association-fast and --mode betas produce sane outputs."""
    from cellregmap_tpu.plink_scan import main

    data = str(tmp_path / "data.npz")
    np.savez(data, y=cohort["y"], E=cohort["E"], hK=cohort["hK"],
             donor_to_cell=cohort["d2c"])
    out_a = str(tmp_path / "res_assoc.npz")
    rc = main(["--bed", cohort["prefix"], "--data", data, "--out", out_a,
               "--block-size", "4096", "--maf-min", "0.01",
               "--mode", "association-fast"])
    assert rc == 0
    with np.load(out_a) as z:
        assert z["pvalues"].shape[0] > 10_000
        assert np.all((z["pvalues"] > 0) & (z["pvalues"] <= 1))

    out_b = str(tmp_path / "res_betas.npz")
    rc = main(["--bed", cohort["prefix"], "--data", data, "--out", out_b,
               "--block-size", "4096", "--maf-min", "0.3",
               "--mode", "betas"])
    assert rc == 0
    with np.load(out_b) as z:
        assert z["beta_g"].shape == z["variant_index"].shape
        assert z["beta_gxe"].shape[0] == cohort["n_cells"]
        assert np.isfinite(z["beta_g"]).all()


def test_plink_scan_cli(cohort, tmp_path):
    from cellregmap_tpu.plink_scan import main

    data = str(tmp_path / "data.npz")
    np.savez(data, y=cohort["y"], E=cohort["E"], hK=cohort["hK"],
             donor_to_cell=cohort["d2c"])
    out = str(tmp_path / "res.npz")
    rc = main(["--bed", cohort["prefix"], "--data", data, "--out", out,
               "--block-size", "4096", "--maf-min", "0.01",
               "--pvalue-method", "liu",
               "--checkpoint", str(tmp_path / "ck2")])
    assert rc == 0
    with np.load(out) as z:
        assert z["pvalues"].shape[0] > 10_000
        assert np.all((z["pvalues"] > 0) & (z["pvalues"] <= 1))


def test_plink_scan_cli_multigene(cohort, tmp_path):
    """--data with Y + windows dispatches the gene-batched cis driver."""
    from cellregmap_tpu.plink_scan import main

    rng = np.random.default_rng(31)
    Y = cohort["y"][:, None] + 0.3 * rng.normal(size=(cohort["n_cells"], 3))
    windows = np.array([[0, 12], [6, 18], [12, 24]])
    data = str(tmp_path / "datam.npz")
    np.savez(data, Y=Y, windows=windows, E=cohort["E"], hK=cohort["hK"],
             donor_to_cell=cohort["d2c"])
    out = str(tmp_path / "resm.npz")
    rc = main(["--bed", cohort["prefix"], "--data", data, "--out", out,
               "--maf-min", "0.01", "--pvalue-method", "liu",
               "--gene-batch", "2"])
    assert rc == 0
    with np.load(out) as z:
        assert z["pvalues"].shape == z["gene"].shape
        assert set(np.unique(z["gene"])) <= {0, 1, 2}
        assert np.all((z["pvalues"] > 0) & (z["pvalues"] <= 1))
