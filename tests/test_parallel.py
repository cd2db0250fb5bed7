"""Sharded scan == single-device scan on the 8-virtual-device CPU mesh."""
import numpy as np
import jax
import pytest
from numpy.testing import assert_allclose

import cellregmap_tpu as crt
from cellregmap_tpu.parallel import ShardedScanner, make_mesh


def _dataset(seed=31, n=50, C=3, S=11):
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


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs multiple devices")
def test_sharded_matches_single_device():
    y, W, E, G, Ls = _dataset()
    crm = crt.CellRegMap(y=y, E=E, W=W, Ls=Ls)
    pv_single, info_single = crm.scan_interaction(G)

    mesh = make_mesh()
    scanner = ShardedScanner(crm, mesh=mesh)
    pv_shard, info_shard = scanner.scan_interaction(G)
    # batch shapes differ between the two paths (device padding), so XLA
    # reduction orders differ; agreement is numerical, not bitwise
    assert_allclose(pv_shard, pv_single, atol=1e-7)
    assert_allclose(info_shard["Q"], info_single["Q"], rtol=1e-6)
    assert np.array_equal(info_shard["rho1"], info_single["rho1"])


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs multiple devices")
def test_sharded_multigene_matches_single_device():
    """Sharded gene-batched interaction scan (variants sharded, genes
    replicated) == the local multigene driver."""
    y, W, E, G, Ls = _dataset(seed=61, S=13)
    rng = np.random.default_rng(3)
    Y = y[:, None] + 0.3 * rng.normal(size=(y.shape[0], 3))
    crm = crt.CellRegMap(y=Y[:, 0], E=E, W=W, Ls=Ls,
                         config=crt.ScanConfig(snp_batch=8))
    pv_local, info_local = crm.scan_interaction_multigene(Y, G, gene_batch=2)

    scanner = ShardedScanner(crm, mesh=make_mesh())
    pv_shard, info_shard = scanner.scan_interaction_multigene(
        Y, G, gene_batch=2)
    assert pv_shard.shape == pv_local.shape == (3, 13)
    assert_allclose(pv_shard, pv_local, atol=1e-7)
    assert_allclose(info_shard["Q"], info_local["Q"], rtol=1e-6)
    assert np.array_equal(info_shard["rho1"], info_local["rho1"])


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs multiple devices")
def test_sharded_fast_scan_multigene_matches_local():
    """Sharded gene-batched fast association lmls == the local kernel."""
    import jax.numpy as jnp
    from cellregmap_tpu import engine
    from cellregmap_tpu.parallel.scan import sharded_fast_scan_multigene

    y, W, E, G, Ls = _dataset(seed=67, S=16)
    rng = np.random.default_rng(5)
    Y = y[:, None] + 0.3 * rng.normal(size=(y.shape[0], 2))
    crm = crt.CellRegMap(y=Y[:, 0], E=E, W=W, Ls=Ls)
    Z, Wm = crm._ctx.Z, crm._ctx.W
    Yt = jnp.asarray(Y, crm._dtype)
    ctx_g = crm._ctx._replace(
        y=Yt.T, Zy=(Z.T @ Yt).T, Wy=(Wm.T @ Yt).T,
        yy=jnp.sum(Yt * Yt, axis=0),
    )
    fits, k = engine.null_association_multigene_kernel(
        ctx_g, crm._n, restricted=False)
    rows = np.arange(2)
    delta = jnp.asarray(np.asarray(fits.delta)[rows, np.asarray(k)],
                        crm._dtype)
    Gj = jnp.asarray(G, crm._dtype)
    local = engine.fast_scan_multigene_kernel(ctx_g, Gj, k, delta, crm._n)
    shard = sharded_fast_scan_multigene(make_mesh(), ctx_g, Gj, k, delta,
                                        crm._n)
    assert_allclose(np.asarray(shard.lml), np.asarray(local.lml),
                    rtol=1e-10, atol=1e-8)
    assert_allclose(np.asarray(shard.effsizes_g),
                    np.asarray(local.effsizes_g), rtol=1e-8, atol=1e-10)


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs multiple devices")
def test_sharded_betas_matches_single_device():
    """Sharded effect-size estimation == the local predict_interaction."""
    y, W, E, G, Ls = _dataset(seed=73, S=11)
    crm = crt.CellRegMap(y=y, E=E, W=W, Ls=Ls)
    maf = np.full(11, 0.3)
    bg_local, bgxe_local = crm.predict_interaction(G, maf)

    scanner = ShardedScanner(crm, mesh=make_mesh())
    bg_shard, bgxe_shard = scanner.predict_interaction(G, maf)
    assert_allclose(bg_shard, bg_local, rtol=1e-9, atol=1e-12)
    assert_allclose(bgxe_shard, bgxe_local, rtol=1e-7, atol=1e-11)


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs multiple devices")
def test_sharded_assoc_fast_driver_matches_local():
    """ShardedScanner.scan_association_fast == the local driver."""
    y, W, E, G, Ls = _dataset(seed=83, S=13)
    crm = crt.CellRegMap(y=y, E=E, W=W, Ls=Ls)
    pv_local, info_local = crm.scan_association_fast(G)
    pv_shard, info_shard = ShardedScanner(
        crm, mesh=make_mesh()).scan_association_fast(G)
    assert_allclose(pv_shard, pv_local, rtol=1e-9, atol=1e-12)
    assert_allclose(info_shard["rho1"], info_local["rho1"], atol=0)


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs multiple devices")
def test_sharded_assoc_refit_driver_matches_local():
    """ShardedScanner.scan_association (Newton refit) == local driver
."""
    y, W, E, G, Ls = _dataset(seed=89, S=13)
    crm = crt.CellRegMap(y=y, E=E, W=W, Ls=Ls)
    pv_local, info_local = crm.scan_association(G)
    pv_shard, info_shard = ShardedScanner(
        crm, mesh=make_mesh()).scan_association(G)
    assert_allclose(pv_shard, pv_local, rtol=1e-9, atol=1e-12)
    assert_allclose(info_shard["rho1"], info_local["rho1"], atol=0)


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs multiple devices")
def test_sharded_assoc_multigene_drivers_match_local():
    """Sharded multigene association drivers (refit + fast) == local
."""
    y, W, E, G, Ls = _dataset(seed=97, S=13)
    rng = np.random.default_rng(11)
    Y = y[:, None] + 0.3 * rng.normal(size=(y.shape[0], 3))
    crm = crt.CellRegMap(y=Y[:, 0], E=E, W=W, Ls=Ls,
                         config=crt.ScanConfig(snp_batch=8))
    scanner = ShardedScanner(crm, mesh=make_mesh())

    pv_l, info_l = crm.scan_association_multigene(Y, G, gene_batch=2)
    pv_s, info_s = scanner.scan_association_multigene(Y, G, gene_batch=2)
    assert pv_s.shape == pv_l.shape == (3, 13)
    assert_allclose(pv_s, pv_l, rtol=1e-8, atol=1e-12)
    assert_allclose(info_s["rho1"], info_l["rho1"], atol=0)

    pv_lf, info_lf = crm.scan_association_fast_multigene(Y, G, gene_batch=2)
    pv_sf, info_sf = scanner.scan_association_fast_multigene(
        Y, G, gene_batch=2)
    assert_allclose(pv_sf, pv_lf, rtol=1e-8, atol=1e-12)
    assert_allclose(info_sf["rho1"], info_lf["rho1"], atol=0)


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs multiple devices")
def test_sharded_screen_matches_local():
    """Mesh-sharded screen -> confirm == local screen driver: identical
    confirmed sets with bit-exact confirmed p-values (round 5)."""
    y, W, E, G, Ls = _dataset(seed=103, S=16)
    crm = crt.CellRegMap(y=y, E=E, W=W, Ls=Ls,
                         config=crt.ScanConfig(snp_batch=8))
    pv_local, info_local = crm.scan_interaction_screen(G, significance=1e-3)
    scanner = ShardedScanner(crm, mesh=make_mesh())
    pv_shard, info_shard = scanner.scan_interaction_screen(
        G, significance=1e-3)
    # screen (f32) values across different shard shapes agree at f32 noise
    assert_allclose(pv_shard, pv_local, rtol=0.05, atol=1e-12)
    both = info_shard["confirmed"] & info_local["confirmed"]
    assert_allclose(pv_shard[both], pv_local[both], rtol=1e-12)


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs multiple devices")
def test_sharded_assoc_checkpoint_resume(tmp_path, monkeypatch):
    """Crash -> resume on the sharded association scan (checkpoint wiring
    through ShardedScanner)."""
    from cellregmap_tpu.parallel.checkpoint import ScanCheckpoint
    from cellregmap_tpu.parallel import scan as scan_mod

    y, W, E, G, Ls = _dataset(seed=101, S=16)
    crm = crt.CellRegMap(y=y, E=E, W=W, Ls=Ls,
                         config=crt.ScanConfig(snp_batch=1))
    mesh = make_mesh()
    pv_full, _ = ShardedScanner(crm, mesh=mesh).scan_association(G)

    ck = tmp_path / "ckpt"

    class Boom(RuntimeError):
        pass

    calls = {"n": 0}
    orig = scan_mod.engine.association_refit_batch

    def crashing(*a, **kw):
        if calls["n"] >= 1:
            raise Boom()
        calls["n"] += 1
        return orig(*a, **kw)

    # patch the traced function pre-jit: the sharded builder re-traces per
    # build, so the crash lands on the second batch's first trace... the
    # compiled fn is cached after the first build, so crash on the DRIVER
    # level instead: patch the builder.
    orig_builder = scan_mod.build_sharded_association_refit
    built = {}

    def crashing_builder(*a, **kw):
        built["fn"] = orig_builder(*a, **kw)

        def fn(ctx, gb):
            if calls["n"] >= 1:
                raise Boom()
            calls["n"] += 1
            return built["fn"](ctx, gb)

        return fn

    monkeypatch.setattr(scan_mod, "build_sharded_association_refit",
                        crashing_builder)
    scanner = ShardedScanner(crm, mesh=mesh, checkpoint=str(ck))
    with pytest.raises(Boom):
        scanner.scan_association(G)
    monkeypatch.setattr(scan_mod, "build_sharded_association_refit",
                        orig_builder)

    state = ScanCheckpoint(str(ck)).load()
    assert state is not None and state["cursor"] >= 1

    scanner2 = ShardedScanner(crm, mesh=mesh, checkpoint=str(ck))
    pv_resumed, _ = scanner2.scan_association(G)
    assert_allclose(pv_resumed, pv_full, rtol=1e-12)
    assert ScanCheckpoint(str(ck)).load() is None


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs multiple devices")
def test_sharded_fast_scan_matches_local():
    """Single-gene sharded closed-form association == the local kernel."""
    import jax.numpy as jnp
    from cellregmap_tpu import engine
    from cellregmap_tpu.parallel.scan import sharded_fast_scan

    y, W, E, G, Ls = _dataset(seed=79, S=16)
    crm = crt.CellRegMap(y=y, E=E, W=W, Ls=Ls)
    fits, k = crm._fit_null_association()
    delta = float(fits.delta[k])
    Gj = jnp.asarray(G, crm._dtype)
    local = engine.fast_scan_kernel(crm._ctx, Gj, k, delta, crm._n)
    shard = sharded_fast_scan(make_mesh(), crm._ctx, Gj, k, delta, crm._n)
    assert_allclose(np.asarray(shard.lml), np.asarray(local.lml),
                    rtol=1e-10, atol=1e-8)


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs multiple devices")
def test_sharded_checkpoint_resume_from_partial(tmp_path, monkeypatch):
    """Genuine partial resume: crash the sharded scan mid-way, assert a
    mid-scan cursor was persisted, then resume and match the clean result
    while re-running only the remaining batches."""
    y, W, E, G, Ls = _dataset(seed=37, S=16)
    crm = crt.CellRegMap(y=y, E=E, W=W, Ls=Ls,
                         config=crt.ScanConfig(snp_batch=1))
    mesh = make_mesh()
    pv_full, _ = ShardedScanner(crm, mesh=mesh).scan_interaction(G)

    from cellregmap_tpu.parallel.checkpoint import ScanCheckpoint

    ck = tmp_path / "ckpt"
    scanner = ShardedScanner(crm, mesh=mesh, checkpoint=str(ck))

    class Boom(RuntimeError):
        pass

    calls = {"n": 0}
    orig = ShardedScanner._kernel

    def crashing_kernel(self, *a, **kw):
        if calls["n"] >= 1:  # let exactly one batch complete + checkpoint
            raise Boom()
        calls["n"] += 1
        return orig(self, *a, **kw)

    monkeypatch.setattr(ShardedScanner, "_kernel", crashing_kernel)
    with pytest.raises(Boom):
        scanner.scan_interaction(G, checkpoint_every=1)
    monkeypatch.setattr(ShardedScanner, "_kernel", orig)

    state = ScanCheckpoint(str(ck)).load()
    assert state is not None and state["cursor"] >= 1  # mid-scan cursor
    n_batches_total = -(-G.shape[1] // (1 * mesh.devices.size))

    resumed = {"n": 0}

    def counting_kernel(self, *a, **kw):
        resumed["n"] += 1
        return orig(self, *a, **kw)

    monkeypatch.setattr(ShardedScanner, "_kernel", counting_kernel)
    scanner2 = ShardedScanner(crm, mesh=mesh, checkpoint=str(ck))
    pv_resumed, _ = scanner2.scan_interaction(G)
    assert resumed["n"] == n_batches_total - state["cursor"]  # skipped work
    assert_allclose(pv_resumed, pv_full, rtol=1e-12)
    assert ScanCheckpoint(str(ck)).load() is None  # cleared when done


def test_multigene_scan_checkpoint_resume(tmp_path, monkeypatch):
    """Gene-tile checkpoint/resume on scan_interaction_multigene: crash
    after one tile, resume, match the clean result while re-running only
    the remaining tiles."""
    y, W, E, G, Ls = _dataset(seed=71, S=6)
    rng = np.random.default_rng(9)
    Y = y[:, None] + 0.3 * rng.normal(size=(y.shape[0], 4))
    crm = crt.CellRegMap(y=Y[:, 0], E=E, W=W, Ls=Ls)
    pv_full, _ = crm.scan_interaction_multigene(Y, G, gene_batch=1)

    from cellregmap_tpu import engine
    from cellregmap_tpu.parallel.checkpoint import ScanCheckpoint

    ck = tmp_path / "ckpt"

    class Boom(RuntimeError):
        pass

    calls = {"n": 0}
    orig = engine.interaction_multigene_kernel

    def crashing_kernel(*a, **kw):
        if calls["n"] >= 2:  # two tiles complete, then crash
            raise Boom()
        calls["n"] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(engine, "interaction_multigene_kernel",
                        crashing_kernel)
    with pytest.raises(Boom):
        crm.scan_interaction_multigene(Y, G, gene_batch=1,
                                       checkpoint=str(ck))
    monkeypatch.setattr(engine, "interaction_multigene_kernel", orig)

    state = ScanCheckpoint(str(ck)).load()
    assert state is not None and 1 <= state["cursor"] < 4

    resumed = {"n": 0}

    def counting_kernel(*a, **kw):
        resumed["n"] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(engine, "interaction_multigene_kernel",
                        counting_kernel)
    pv_resumed, _ = crm.scan_interaction_multigene(Y, G, gene_batch=1,
                                                   checkpoint=str(ck))
    assert resumed["n"] == 4 - state["cursor"]
    assert_allclose(pv_resumed, pv_full, rtol=1e-12)
    assert ScanCheckpoint(str(ck)).load() is None


def test_single_device_scan_checkpoint_resume(tmp_path, monkeypatch):
    """Checkpoint/resume on the default CellRegMap.scan_interaction path."""
    y, W, E, G, Ls = _dataset(seed=41, S=12)
    cfg = crt.ScanConfig(snp_batch=3)
    crm = crt.CellRegMap(y=y, E=E, W=W, Ls=Ls, config=cfg)
    pv_full, info_full = crm.scan_interaction(G)

    from cellregmap_tpu import engine
    from cellregmap_tpu.parallel.checkpoint import ScanCheckpoint

    ck = tmp_path / "ckpt"

    class Boom(RuntimeError):
        pass

    calls = {"n": 0}
    orig = engine.interaction_kernel

    def crashing_kernel(*a, **kw):
        if calls["n"] >= 2:
            raise Boom()
        calls["n"] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(engine, "interaction_kernel", crashing_kernel)
    with pytest.raises(Boom):
        crm.scan_interaction(G, checkpoint=str(ck), checkpoint_every=1)
    monkeypatch.setattr(engine, "interaction_kernel", orig)

    state = ScanCheckpoint(str(ck)).load()
    assert state is not None and 1 <= state["cursor"] < 4  # genuinely partial

    resumed = {"n": 0}

    def counting_kernel(*a, **kw):
        resumed["n"] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(engine, "interaction_kernel", counting_kernel)
    pv_resumed, info_res = crm.scan_interaction(G, checkpoint=str(ck))
    assert resumed["n"] == 4 - state["cursor"]  # only remaining batches ran
    assert_allclose(pv_resumed, pv_full, rtol=1e-12)
    assert np.array_equal(info_res["rho1"], info_full["rho1"])
    assert ScanCheckpoint(str(ck)).load() is None
