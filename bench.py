"""Benchmark harness: north-star configs (BASELINE.json) on one device.

Prints JSON lines; the LAST complete line is the official record.  Every
printed line is the COMPACT summary (hard-capped well under 1500 characters,
see :func:`compact_summary` and tests/test_bench_output.py), so the record
survives a reader that keeps only the tail of stdout; the full result
detail is written to ``bench_out/bench_extended.json`` after every config.
The headline summary is printed immediately after the headline
measurement, and each additional north-star config re-prints the summary
as soon as it completes.  Every result names the device it ran on
(platform, device kind, device count).  A config that raises is recorded
as an error and the run exits non-zero.

Baseline: the reference publishes no numbers (SURVEY.md section 6) and the
pip package is unavailable here, so the baseline is measured live from
``oracle.scan_interaction_reference_style`` — a faithful serial
re-implementation of the reference's computational pattern (per-rho economic
QS setup, per-SNP serial loop of 11 REML fits via scipy scalar search,
matrix-free score pass, Davies p-value) running on host CPU/BLAS — on
BENCH_BASELINE_SNPS variants (0 skips it).

Timing: the scans end on the host (p-values come back as NumPy), and the
per-batch kernel timing forces a ``device_get`` of a result leaf.

Env knobs: BENCH_MODE=full|headline (default full; full is budget-gated so
it degrades to headline when time runs short), BENCH_BUDGET_S (wall budget
from process start for optional configs; default 555), BENCH_CELLS,
BENCH_CONTEXTS, BENCH_DONORS, BENCH_SNPS, BENCH_BATCH, BENCH_BASELINE_SNPS,
BENCH_PVALUE (davies|saddlepoint|liu), BENCH_SCALE (multiplies the
north-star config sizes; set <1 for CI smoke runs).
"""
import json
import os
import sys
import time

import numpy as np

F64_BYTES = 8

T_PROCESS_START = time.perf_counter()

EXTENDED_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "bench_out", "bench_extended.json")


def compact_summary(result):
    """One machine-parseable line, hard-capped under 1500 characters.

    A reader that keeps only the last 2000 characters of stdout and
    ``json.loads`` the final line loses the whole record to an oversized
    final line.  Per-config entries are compressed to
    ``[headline_rate, total_s]``; the full per-config detail lives in
    ``bench_out/bench_extended.json``.
    """
    s = {}
    for k in ("metric", "value", "unit", "vs_baseline",
              "vs_baseline_steady", "baseline_tests_per_sec",
              "baseline_steady_tests_per_sec",
              "pvalue_max_abs_diff_vs_reference_style", "device",
              "setup_s", "compile_s", "scan_s",
              "kernel_tests_per_sec", "null_fits_per_sec"):
        if k in result:
            s[k] = result[k]
    cfgs = {}
    for name, c in result.get("configs", {}).items():
        if not isinstance(c, dict):
            continue
        if "error" in c:
            cfgs[name] = "error"
        elif "skipped" in c:
            cfgs[name] = "skipped"
        else:
            rate = next((c[k] for k in (
                "tests_per_sec", "gene_variant_pairs_per_sec",
                "steady_variants_per_sec", "variants_per_sec") if k in c),
                None)
            cfgs[name] = [rate, c.get("total_s")]
    if cfgs:
        s["configs"] = cfgs
    if "total_bench_s" in result:
        s["total_bench_s"] = result["total_bench_s"]
    line = json.dumps(s, separators=(",", ":"))
    if len(line) > 1500:  # hard cap: shed detail, never the headline
        s.pop("configs", None)
        line = json.dumps(s, separators=(",", ":"))
    return line


def emit(result):
    """Print the compact summary line and persist the full result."""
    os.makedirs(os.path.dirname(EXTENDED_PATH), exist_ok=True)
    tmp = EXTENDED_PATH + ".tmp"
    with open(tmp, "w") as f:
        json.dump(result, f, indent=1)
    os.replace(tmp, EXTENDED_PATH)
    print(compact_summary(result), flush=True)


def env_int(name, default):
    return int(os.environ.get(name, default))


def env_float(name, default):
    return float(os.environ.get(name, default))


def make_dataset(n_cells, n_contexts, n_donors, n_snps, seed=0,
                 gxe_snp=7):
    import cellregmap_tpu as crt

    rng = np.random.default_rng(seed)
    E = rng.normal(size=(n_cells, n_contexts)) / np.sqrt(n_contexts)
    W = np.ones((n_cells, 1))
    donor_of = np.repeat(np.arange(n_donors),
                         -(-n_cells // n_donors))[:n_cells]
    hK = np.zeros((n_cells, n_donors))
    hK[np.arange(n_cells), donor_of] = 1.0
    Ls = [np.asarray(L) for L in crt.get_L_values(hK, E)]
    maf = rng.uniform(0.1, 0.45, size=n_snps)
    G = rng.binomial(2, maf[None, :].repeat(n_donors, 0))[donor_of, :]
    G = np.asarray(G, float)
    G = (G - G.mean(0)) / np.maximum(G.std(0), 1e-9)
    y = (
        rng.normal(size=n_cells)
        + 0.5 * E @ rng.normal(size=n_contexts)
        + 0.4 * hK @ rng.normal(size=n_donors)
        + 0.2 * G[:, gxe_snp] * E[:, 0] * np.sqrt(n_contexts)
    )
    return dict(y=y, W=W, E=E, Ls=Ls, G=G, maf=maf)


def _timed(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def interaction_metrics(crm, G, pvalue_method):
    """Scan timing (compile excluded) + per-batch kernel cost."""
    n_snps = G.shape[1]
    # warmup/compile on the first batch
    t0 = time.perf_counter()
    crm.scan_interaction(G[:, : min(crm._cfg.snp_batch, n_snps)])
    t_compile = time.perf_counter() - t0
    t0 = time.perf_counter()
    pv, info = crm.scan_interaction(G)
    t_scan = time.perf_counter() - t0
    return {
        "tests_per_sec": round(n_snps / t_scan, 2),
        "scan_s": round(t_scan, 3),
        "compile_plus_first_batch_s": round(t_compile, 2),
        "n_snps": n_snps,
        "pvalue_method": pvalue_method,
    }, pv, info


def roofline_estimate(n, C, R, nrho, S, t_kernel):
    """Arithmetic-intensity / bandwidth statement for one kernel batch.

    Minimum HBM traffic per batch (f64): read the genotype batch (n S),
    the Khatri-Rao intermediate written + read (2 n C S), the basis Z
    (n R), the per-rho eigenvectors V (nrho R^2, read at least twice: data
    rotations + score-factor rotation), the rotated per-rho families
    (~6 tensors of nrho R S, written + read), and the best-rho score factor
    (S R C, written + read).  FLOPs: the dominant matmul contractions
    (Khatri-Rao rotate 2 n R C S, data rotations 2 nrho R^2 S, score-factor
    rotation 2 nrho R^2 C S, score pass ~2 S R C(C + 3)).
    """
    bytes_min = F64_BYTES * (
        n * S + 2 * n * C * S + n * R + 2 * nrho * R * R
        + 12 * nrho * R * S + 2 * S * R * C
    )
    flops = (
        2 * n * R * C * S + 2 * nrho * R * R * S
        + 2 * nrho * R * R * C * S + 2 * S * R * C * (C + 3)
    )
    gbps = bytes_min / t_kernel / 1e9
    return {
        "kernel_s_per_batch": round(t_kernel, 4),
        "batch": S,
        "min_hbm_bytes_per_batch": int(bytes_min),
        "achieved_gbps_lower_bound": round(gbps, 1),
        "flops_per_batch": int(flops),
        "achieved_tflops": round(flops / t_kernel / 1e12, 2),
        "arithmetic_intensity_flop_per_byte": round(flops / bytes_min, 1),
    }


def main():
    mode = os.environ.get("BENCH_MODE", "full")
    n_cells = env_int("BENCH_CELLS", 2000)
    n_contexts = env_int("BENCH_CONTEXTS", 10)
    n_donors = env_int("BENCH_DONORS", 100)
    n_snps = env_int("BENCH_SNPS", 2048)
    batch = env_int("BENCH_BATCH", 512)
    # 2 snps keep a LIVE baseline + parity check cheap; 0 skips it
    baseline_snps = env_int("BENCH_BASELINE_SNPS", 2)
    pvalue_method = os.environ.get("BENCH_PVALUE", "davies")
    # the summary is re-emitted after every config, so a kill
    # mid-config loses only that config's row, never the record
    budget_s = env_float("BENCH_BUDGET_S", 555.0)
    scale = env_float("BENCH_SCALE", 1.0)

    import jax
    import jax.numpy as jnp

    import cellregmap_tpu as crt
    from cellregmap_tpu import engine, oracle
    from cellregmap_tpu.models import pvalues as pv_mod

    devices = jax.devices()
    device = {"platform": devices[0].platform,
              "kind": devices[0].device_kind, "count": len(devices)}
    _stage = lambda msg: print(f"# {msg} t={time.perf_counter() - T_PROCESS_START:.0f}s",
                               flush=True)

    # ---- headline config (2k cells) ----
    d = make_dataset(n_cells, n_contexts, n_donors, n_snps)
    _stage("dataset done")

    if baseline_snps > 0:
        base_timers = {}
        t0 = time.perf_counter()
        pv_base, _ = oracle.scan_interaction_reference_style(
            d["y"], d["W"], d["E"], Ls=d["Ls"], G=d["G"][:, :baseline_snps],
            timers=base_timers,
        )
        baseline_tps = baseline_snps / (time.perf_counter() - t0)
        # steady-vs-steady accounting: setup excluded
        # from BOTH sides (the engine reports setup_s/compile_s separately)
        baseline_steady_tps = baseline_snps / base_timers["scan_s"]
    else:
        pv_base = baseline_tps = baseline_steady_tps = None
    _stage("baseline done")

    cfg = crt.ScanConfig(snp_batch=batch, pvalue_method=pvalue_method)
    t0 = time.perf_counter()
    crm = crt.CellRegMap(y=d["y"], E=d["E"], W=d["W"], Ls=d["Ls"],
                         config=cfg)
    crm._ctx  # build the (lazy) factorization inside the timed setup
    t_setup = time.perf_counter() - t0
    _stage("setup done")
    head, pv, info = interaction_metrics(crm, d["G"], pvalue_method)
    _stage("headline scan done")

    max_abs_diff = (
        float(np.max(np.abs(pv[:baseline_snps] - pv_base)))
        if pv_base is not None else None
    )

    eff_batch = min(batch, crm._auto_batch_cap(), n_snps)
    result = {
        "metric": "interaction_tests_per_sec",
        "value": head["tests_per_sec"],
        "unit": "tests/s",
        "vs_baseline": (round(head["tests_per_sec"] / baseline_tps, 2)
                        if baseline_tps else None),
        # vs_baseline: live serial rate INCLUDING the reference's setup
        # (what a user experiences); vs_baseline_steady: scan-rate vs
        # scan-rate with setup excluded on both sides — the defensible
        # steady-state multiple
        "vs_baseline_steady": (round(head["tests_per_sec"]
                                     / baseline_steady_tps, 2)
                               if baseline_steady_tps else None),
        "baseline_tests_per_sec": (round(baseline_tps, 4)
                                   if baseline_tps else None),
        "baseline_steady_tests_per_sec": (round(baseline_steady_tps, 4)
                                          if baseline_steady_tps else None),
        "pvalue_max_abs_diff_vs_reference_style": max_abs_diff,
        "device": device,
        "config": {
            "n_cells": n_cells, "n_contexts": n_contexts,
            "n_donors": n_donors, "n_snps": n_snps, "batch": eff_batch,
            "pvalue_method": pvalue_method,
        },
        "setup_s": round(t_setup, 2),
        "compile_s": head["compile_plus_first_batch_s"],
        "scan_s": head["scan_s"],
    }
    # The headline record is safe from here on: a timeout on any later
    # stage leaves this as the last complete line.
    emit(result)

    def within_budget(reserve_s=30.0):
        return time.perf_counter() - T_PROCESS_START < budget_s - reserve_s

    # ---- per-batch device-kernel cost + roofline (device_get-forced) ----
    if within_budget():
        gb = jnp.asarray(d["G"][:, :eff_batch], crm._dtype)
        delta_cfg = (cfg.delta_logit_lo, cfg.delta_logit_hi,
                     cfg.n_delta_grid_interaction, cfg.n_golden_iters)
        out = engine.interaction_kernel(crm._ctx, gb, gb, n_cells,
                                        delta_cfg=delta_cfg)
        jax.device_get(jax.tree.leaves(out)[0])
        t0 = time.perf_counter()
        reps = 3
        for _ in range(reps):
            out = engine.interaction_kernel(crm._ctx, gb, gb, n_cells,
                                            delta_cfg=delta_cfg)
            jax.device_get(jax.tree.leaves(out)[0])
        t_kernel = (time.perf_counter() - t0) / reps
        t0 = time.perf_counter()
        pv_mod.davies_pvalue_batch(np.asarray(out["Q"]),
                                   np.asarray(out["lambdas"]),
                                   lim=cfg.davies_lim, acc=cfg.davies_acc)
        t_davies = time.perf_counter() - t0

        R = int(crm._ctx.S.shape[1])
        nrho = int(crm._ctx.S.shape[0])
        result["kernel_s_per_batch"] = round(t_kernel, 3)
        result["kernel_tests_per_sec"] = round(eff_batch / t_kernel, 1)
        result["davies_s_per_batch"] = round(t_davies, 3)
        # every variant runs nrho REML fits (grid + Newton); the kernel is
        # the only place fits happen: fits/sec = kernel tests/sec * nrho
        result["null_fits_per_sec"] = round(eff_batch * nrho / t_kernel, 1)
        result["roofline"] = roofline_estimate(
            n_cells, n_contexts, R, nrho, eff_batch, t_kernel)
        emit(result)

    # ---- north-star configs (BASELINE.json), budget-gated ----
    configs = {}
    result["configs"] = configs
    # realized/estimated cost ratio; a cold compile cache inflates every
    # config by its compile, so once one config overshoots its warm-cache
    # estimate, the remaining estimates are scaled up by the worst observed
    # ratio (capped) instead of starting configs that cannot finish within
    # the budget
    gate = {"infl": 1.0}
    failed = []

    def _try(name, fn, est_s=60.0):
        """Run a config if its (inflation-adjusted) cost fits the budget.

        ``est_s`` is the measured warm-cache cost; it is multiplied by the
        worst realized/estimated ratio seen so far this run.
        """
        elapsed = time.perf_counter() - T_PROCESS_START
        if mode != "full" or elapsed + est_s * gate["infl"] > budget_s:
            configs[name] = {"skipped": "time budget exhausted"
                             if mode == "full" else "headline mode"}
            emit(result)
            return
        print(f"# config {name} start t={elapsed:.0f}s", flush=True)
        try:
            t0 = time.perf_counter()
            configs[name] = fn()
            dt = time.perf_counter() - t0
            configs[name]["total_s"] = round(dt, 1)
            gate["infl"] = min(3.0, max(gate["infl"], dt / est_s))
        except Exception as e:  # record, run the rest, exit non-zero
            configs[name] = {"error": f"{type(e).__name__}: {e}"}
            failed.append(name)
        emit(result)

    sc = lambda v: max(64, int(v * scale))

    def _cells10k():
        dd = make_dataset(sc(10_000), 20, sc(125), sc(5120), seed=1)
        cc = crt.CellRegMap(y=dd["y"], E=dd["E"], W=dd["W"],
                            Ls=dd["Ls"], config=cfg)
        m, _, _ = interaction_metrics(cc, dd["G"], pvalue_method)
        m["n_cells"], m["n_contexts"], m["R"] = (
            sc(10_000), 20, int(cc._ctx.S.shape[1]))
        return m

    def _cells50k():
        # 200 donors (250 cells/donor) keeps the one-time host setup (Gram
        # basis of 50k x 2010 + 11 eighs of 2010^2) within the bench
        # budget; BASELINE.md allows extrapolating the 100k-pair row
        dd = make_dataset(sc(50_000), 10, sc(200), sc(512), seed=2)
        cc = crt.CellRegMap(y=dd["y"], E=dd["E"], W=dd["W"],
                            Ls=dd["Ls"], config=cfg)
        m, _, _ = interaction_metrics(cc, dd["G"], pvalue_method)
        m["n_cells"], m["R"] = sc(50_000), int(cc._ctx.S.shape[1])
        m["extrapolated_100k_pairs_hours"] = round(
            100_000 / m["tests_per_sec"] / 3600, 3)
        return m

    def _betas2k():
        # warm with the SAME batch shape as the measured run (a padded
        # warmup batch would leave the real shape compiling inside the
        # timed region); the warm call also builds + caches the
        # BetasContext, so the timed call is pure steady state
        nb = min(512, n_snps)
        bb = min(cfg.snp_batch, crm._auto_batch_cap("betas"), nb)
        t0 = time.perf_counter()
        crm.predict_interaction(d["G"][:, :bb], d["maf"][:bb])
        tc = time.perf_counter() - t0
        t0 = time.perf_counter()
        crm.predict_interaction(d["G"][:, :nb], d["maf"][:nb])
        dt = time.perf_counter() - t0
        return {"steady_variants_per_sec": round(nb / dt, 2),
                "variants_per_sec": round(nb / dt, 2),
                "setup_compile_plus_first_s": round(tc, 1)}

    def _multigene(nsn_target=512, ngenes=16, compare_loop=True):
        rng = np.random.default_rng(9)
        Y = d["y"][:, None] + 0.1 * rng.normal(size=(n_cells, ngenes))
        nsn = min(nsn_target, n_snps)
        Gm = d["G"][:, :nsn]
        t0 = time.perf_counter()
        crm.scan_interaction_multigene(Y, Gm, gene_batch=ngenes)
        tc = time.perf_counter() - t0
        t0 = time.perf_counter()
        crm.scan_interaction_multigene(Y, Gm, gene_batch=ngenes)
        dt = time.perf_counter() - t0
        r = {"gene_variant_pairs_per_sec": round(ngenes * nsn / dt, 1),
             "compile_plus_first_s": round(tc, 1),
             "n_genes": ngenes, "n_snps": nsn}
        if compare_loop:
            # per-gene loop on the SAME factorization; the single-gene
            # 512-shape kernel is already compiled by the headline scan,
            # so one pass is warm (the cis row skips this comparison —
            # its 128-snp single-gene shape would trigger a fresh compile
            # just to re-measure a speedup the 512 row already records)
            t0 = time.perf_counter()
            for j in range(ngenes):
                crm.with_phenotype(Y[:, j]).scan_interaction(Gm)
            dt_loop = time.perf_counter() - t0
            r["per_gene_loop_pairs_per_sec"] = round(
                ngenes * nsn / dt_loop, 1)
            r["speedup_vs_per_gene_loop"] = round(dt_loop / dt, 2)
        return r

    def _assoc_fast():
        t0 = time.perf_counter()
        crm.scan_association_fast(d["G"])
        tc = time.perf_counter() - t0
        # the warm fast scan is sub-second at 2k snps, so a single timing
        # is dispatch-noise-dominated; take the best of 3
        dt = min(_timed(lambda: crm.scan_association_fast(d["G"]))
                 for _ in range(3))
        r = {"tests_per_sec": round(n_snps / dt, 1),
             "compile_plus_first_s": round(tc, 1)}
        ns = min(512, n_snps)
        t0 = time.perf_counter()
        crm.scan_association(d["G"][:, :ns])
        r["refit_tests_per_sec_incl_compile"] = round(
            ns / (time.perf_counter() - t0), 1)
        return r

    def _screen2k():
        # two-pass screen -> confirm at genome-scan significance: the
        # screen runs every pair in f32, the f64 + Davies confirm re-tests
        # only sub-threshold pairs
        t0 = time.perf_counter()
        crm.scan_interaction_screen(d["G"], significance=5e-8)
        tc = time.perf_counter() - t0
        t0 = time.perf_counter()
        pv, inf = crm.scan_interaction_screen(d["G"], significance=5e-8)
        dt = time.perf_counter() - t0
        return {"tests_per_sec": round(n_snps / dt, 1),
                "compile_plus_first_s": round(tc, 1),
                "n_confirmed": int(inf["n_confirmed"]),
                "speedup_vs_exact_headline": round(
                    (n_snps / dt) / head["tests_per_sec"], 2)}

    def _screen_multigene(ngenes=16, nsn_target=2048):
        rng = np.random.default_rng(13)
        Y = d["y"][:, None] + 0.1 * rng.normal(size=(n_cells, ngenes))
        nsn = min(nsn_target, n_snps)
        Gm = d["G"][:, :nsn]
        t0 = time.perf_counter()
        crm.scan_interaction_multigene_screen(Y, Gm, gene_batch=ngenes,
                                              significance=5e-8)
        tc = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, inf = crm.scan_interaction_multigene_screen(
            Y, Gm, gene_batch=ngenes, significance=5e-8)
        dt = time.perf_counter() - t0
        return {"gene_variant_pairs_per_sec": round(ngenes * nsn / dt, 1),
                "compile_plus_first_s": round(tc, 1),
                "n_genes": ngenes, "n_snps": nsn,
                "n_confirmed": int(inf["n_confirmed"])}

    def _assoc_multigene():
        ngenes = 16
        rng = np.random.default_rng(11)
        Y = d["y"][:, None] + 0.1 * rng.normal(size=(n_cells, ngenes))
        t0 = time.perf_counter()
        crm.scan_association_fast_multigene(Y, d["G"], gene_batch=ngenes)
        tc = time.perf_counter() - t0
        t0 = time.perf_counter()
        crm.scan_association_fast_multigene(Y, d["G"], gene_batch=ngenes)
        dt = time.perf_counter() - t0
        return {"gene_variant_pairs_per_sec": round(ngenes * n_snps / dt, 1),
                "compile_plus_first_s": round(tc, 1),
                "n_genes": ngenes, "n_snps": n_snps}

    def _betas100k():
        dd = make_dataset(sc(100_000), 10, sc(200), 128, seed=3)
        t0 = time.perf_counter()
        cc = crt.CellRegMap(y=dd["y"], E=dd["E"], W=dd["W"],
                            Ls=dd["Ls"], config=cfg)
        t_set = time.perf_counter() - t0
        # first call: betas-context build (one-time host QR/eigh; cached on
        # the instance) + compile + first batch
        t0 = time.perf_counter()
        cc.predict_interaction(dd["G"], dd["maf"])
        tc = time.perf_counter() - t0
        # second call: pure steady state (cached context, warm compile)
        t0 = time.perf_counter()
        cc.predict_interaction(dd["G"], dd["maf"])
        dt = time.perf_counter() - t0
        return {"steady_variants_per_sec": round(128 / dt, 2),
                "variants_per_sec_incl_setup": round(128 / (tc + dt), 3),
                "null_setup_s": round(t_set, 1),
                "betas_setup_compile_plus_first_s": round(tc, 1),
                "n_cells": sc(100_000)}

    def _c50():
        dd = make_dataset(sc(2000), 50, sc(100), sc(1024), seed=4)
        cc = crt.CellRegMap(y=dd["y"], E=dd["E"], W=dd["W"],
                            Ls=dd["Ls"], config=cfg)
        m, _, _ = interaction_metrics(cc, dd["G"], pvalue_method)
        m["n_contexts"], m["R"] = 50, int(cc._ctx.S.shape[1])
        return m

    # North-star rows (BASELINE.md "Operative baseline") first, then the
    # compile-heavy extensions: a budget stop costs only the tail, and the
    # summary is re-printed after every config so a hard timeout loses just
    # one.  est_s are warm-cache cost estimates; the gate's inflation
    # factor absorbs cold-cache overshoot.  multigene_cis reuses
    # multigene_16's compiled canonical (gene_tile, snp_batch) shape
    # (variant axis padded up in scan_interaction_multigene), so its cost
    # is pure scan.
    _try("betas_2k", _betas2k, est_s=25)
    _try("assoc_fast_2k", _assoc_fast, est_s=15)
    _try("screen_2k", _screen2k, est_s=110)
    _try("cells10k_pairs5k", _cells10k, est_s=125)
    _try("multigene_16", _multigene, est_s=40)
    _try("multigene_cis_128",
         lambda: _multigene(nsn_target=128, compare_loop=False), est_s=10)
    _try("assoc_multigene_16", _assoc_multigene, est_s=20)
    _try("cells50k_pairs100k", _cells50k, est_s=75)
    _try("betas_100k_stretch", _betas100k, est_s=105)
    _try("contexts50", _c50, est_s=60)
    _try("screen_multigene_16", _screen_multigene, est_s=130)

    result["total_bench_s"] = round(time.perf_counter() - T_PROCESS_START, 1)
    emit(result)
    if failed:
        print(f"# failed configs: {', '.join(failed)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
