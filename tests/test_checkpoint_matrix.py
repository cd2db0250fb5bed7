"""Crash -> resume coverage for EVERY scan path.

Round 4 covered interaction scans only; these tests close the durability
matrix: both association scans, both multigene association scans, and
predict_interaction.  Pattern follows tests/test_parallel.py:240-283 —
crash the device kernel mid-scan, assert a genuinely partial cursor was
persisted, resume, and match the clean result while re-running only the
remaining work.
"""
import numpy as np
import pytest
from numpy.testing import assert_allclose

import cellregmap_tpu as crt
from cellregmap_tpu import engine
from cellregmap_tpu.parallel.checkpoint import ScanCheckpoint


def _dataset(seed=31, n=50, C=3, S=12):
    rng = np.random.default_rng(seed)
    E = rng.normal(size=(n, C))
    W = np.ones((n, 1))
    hK = rng.normal(size=(n, 6)) / np.sqrt(6)
    Ls = [np.asarray(L) for L in crt.get_L_values(hK, E)]
    G = rng.choice([0.0, 1.0, 2.0], size=(n, S), p=[0.49, 0.42, 0.09])
    G = (G - G.mean(0)) / G.std(0)
    KE = sum(L @ L.T for L in Ls)
    y = (0.5 * rng.normal(size=n)
         + np.linalg.cholesky(KE + 1e-8 * np.eye(n)) @ rng.normal(size=n))
    return y, W, E, G, Ls


# name: (kernel attr to crash, scan lambda, crash after N kernel calls,
#        total kernel calls in a clean scan, checkpoint units).
# Single-gene paths checkpoint per variant batch (4 batches of 3 over 12
# snps); multigene paths checkpoint per GENE TILE (4 tiles x 4 variant
# batches = 16 kernel calls), so the crash must land after >= 1 full tile.
CASES = {
    "association": (
        "association_refit_kernel",
        lambda crm, Y, G, ck: crm.scan_association(G, checkpoint=ck),
        2, 4, 4,
    ),
    "association_fast": (
        "fast_scan_kernel",
        lambda crm, Y, G, ck: crm.scan_association_fast(G, checkpoint=ck),
        2, 4, 4,
    ),
    "association_multigene": (
        "association_refit_multigene_kernel",
        lambda crm, Y, G, ck: crm.scan_association_multigene(
            Y, G, gene_batch=1, checkpoint=ck),
        5, 16, 4,
    ),
    "association_fast_multigene": (
        "fast_scan_multigene_kernel",
        lambda crm, Y, G, ck: crm.scan_association_fast_multigene(
            Y, G, gene_batch=1, checkpoint=ck),
        5, 16, 4,
    ),
    "betas": (
        "predict_interaction_kernel",
        lambda crm, Y, G, ck: crm.predict_interaction(
            G, np.full(G.shape[1], 0.3), checkpoint=ck),
        2, 4, 4,
    ),
    # screen: batch = 2*snp_batch -> 2 screen batches over 12 snps;
    # significance=1e-300 keeps the confirm set empty so the counted
    # interaction_kernel calls are exactly the screen batches
    "screen": (
        "interaction_kernel",
        lambda crm, Y, G, ck: crm.scan_interaction_screen(
            G, significance=1e-300, checkpoint=ck),
        1, 2, 2,
    ),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_checkpoint_crash_resume(name, tmp_path, monkeypatch):
    kernel_name, scan, crash_after, total_calls, n_units = CASES[name]
    y, W, E, G, Ls = _dataset(seed=47)
    rng = np.random.default_rng(5)
    Y = y[:, None] + 0.3 * rng.normal(size=(y.shape[0], 4))
    cfg = crt.ScanConfig(snp_batch=3)
    crm = crt.CellRegMap(y=y, E=E, W=W, Ls=Ls, config=cfg)
    clean = scan(crm, Y, G, None)

    ck = str(tmp_path / "ckpt")

    class Boom(RuntimeError):
        pass

    calls = {"n": 0}
    orig = getattr(engine, kernel_name)

    def crashing(*a, **kw):
        if calls["n"] >= crash_after:
            raise Boom()
        calls["n"] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(engine, kernel_name, crashing)
    with pytest.raises(Boom):
        scan(crm, Y, G, ck)
    monkeypatch.setattr(engine, kernel_name, orig)

    state = ScanCheckpoint(ck).load()
    assert state is not None and 1 <= state["cursor"] < n_units, name

    resumed = {"n": 0}

    def counting(*a, **kw):
        resumed["n"] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(engine, kernel_name, counting)
    res = scan(crm, Y, G, ck)
    assert resumed["n"] < total_calls  # skipped completed units
    for a, b in zip(np.atleast_1d(clean[0]), np.atleast_1d(res[0])):
        assert_allclose(b, a, rtol=1e-12)
    assert ScanCheckpoint(ck).load() is None  # cleared when done


def test_checkpoint_rejects_changed_inputs(tmp_path, monkeypatch):
    """A checkpoint written for one (y, G) must NOT be spliced into a scan
    of different data with the same shapes."""
    y, W, E, G, Ls = _dataset(seed=53)
    cfg = crt.ScanConfig(snp_batch=3)
    crm = crt.CellRegMap(y=y, E=E, W=W, Ls=Ls, config=cfg)
    ck = str(tmp_path / "ckpt")

    class Boom(RuntimeError):
        pass

    calls = {"n": 0}
    orig = engine.association_refit_kernel

    def crashing(*a, **kw):
        if calls["n"] >= 1:
            raise Boom()
        calls["n"] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(engine, "association_refit_kernel", crashing)
    with pytest.raises(Boom):
        crm.scan_association(G, checkpoint=ck)
    monkeypatch.setattr(engine, "association_refit_kernel", orig)
    assert ScanCheckpoint(ck).load() is not None

    # different data, same shape: the stale cursor must be ignored
    G2 = np.ascontiguousarray(G[:, ::-1])
    resumed = {"n": 0}

    def counting(*a, **kw):
        resumed["n"] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(engine, "association_refit_kernel", counting)
    pv2, _ = crm.scan_association(G2, checkpoint=ck)
    assert resumed["n"] == 4  # full rerun, nothing spliced
    pv_clean, _ = crm.scan_association(G2)
    assert_allclose(pv2, pv_clean, rtol=1e-12)
