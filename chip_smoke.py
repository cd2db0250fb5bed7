"""Run the CellRegMap engine's main path once on an NVIDIA GPU and check it.

Drives the public API at the width of the north-star deployment
(BASELINE.json config 3, an endodiff-style cohort): 10,000 cells x 20
contexts x 125 donors with donor-indicator kinship, so the workspace basis
has R = 20 * (1 + 125) = 2,520 columns.  Data come from
``bench.make_dataset(..., seed=1)`` with 2,048 variants.  Phases:

1. device check: JAX must report a GPU (there is no CPU fallback) and the
   native Davies library must build and load;
2. the reference-style serial oracle on a 2k-cell dataset against the
   engine on the card (p-values within 1e-8, identical rho1);
3. the exact interaction scan (Davies tails) at full width: host setup,
   compile plus first batch, steady scan, peak device memory; the planted
   GxC variant must reach p < 1e-6;
4. the same public calls on JAX's CPU backend, in this process, for 64
   variants: interaction and fast-association p-values within 1e-8 with
   identical rho1, betas within 1e-6;
5. the f32 screen -> f64 confirm scan against an f64 saddlepoint scan:
   largest |log10 ratio| below the 2-decade screen margin, confirmed pairs
   equal to the exact scan.

``--chips 4`` runs only the multi-card path instead: the mesh-sharded
interaction scan over four cards against a one-card scan of the same
variants.  Any failed check exits non-zero.  The last line of a passing run
is one JSON object naming the device.

    python chip_smoke.py             # one card
    python chip_smoke.py --chips 4   # four cards, sharded scan only
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

T0 = time.perf_counter()

# north-star deployment (BASELINE.json config 3) and the 2k oracle dataset
FULL = dict(n_cells=10_000, n_contexts=20, n_donors=125, n_snps=2048,
            seed=1, batch=512, n_cpu=64, planted=7)
ORACLE = dict(n_cells=2000, n_contexts=10, n_donors=100, n_snps=8, seed=0,
              n_test=4)

PV_ATOL = 1e-8        # p-values against any f64 reference
BETA_ATOL = 1e-6      # effect sizes against the CPU backend
PLANTED_MAX = 1e-6    # the planted GxC variant must be this significant
SCREEN_MARGIN_DECADES = 2.0   # default screen_margin = 100
CONFIRM_ATOL = 1e-10  # confirm pass vs exact scan: same f64 path, other batch


class SmokeFailure(AssertionError):
    """A check of the smoke run failed."""


def log(phase, **fields):
    """One report line: ``[elapsed] phase key=value ...``."""
    parts = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{time.perf_counter() - T0:7.1f}s] {phase}: {parts}", flush=True)


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def max_abs_diff(name, got, want, atol):
    """Largest |got - want|; fails on shape mismatch, non-finite values or a
    difference above ``atol``."""
    got = np.asarray(got, float)
    want = np.asarray(want, float)
    check(got.shape == want.shape,
          f"{name}: shape {got.shape} != reference {want.shape}")
    check(bool(np.all(np.isfinite(got))), f"{name}: non-finite values")
    check(bool(np.all(np.isfinite(want))),
          f"{name}: non-finite reference values")
    d = float(np.max(np.abs(got - want))) if got.size else 0.0
    check(d <= atol, f"{name}: max |diff| {d:.3e} > {atol:.0e}")
    return d


def same_values(name, got, want):
    """Number of entries compared; fails unless ``got`` equals ``want``."""
    got = np.asarray(got)
    want = np.asarray(want)
    check(got.shape == want.shape,
          f"{name}: shape {got.shape} != reference {want.shape}")
    bad = np.flatnonzero(got != want)
    check(bad.size == 0,
          f"{name}: {bad.size} entries differ, first at {bad[:5].tolist()}")
    return int(got.size)


def log10_gap(pv, pv_ref):
    """(max, 99th percentile, count) of |log10 pv - log10 pv_ref| over the
    pairs where both are finite and positive."""
    pv = np.asarray(pv, float)
    pv_ref = np.asarray(pv_ref, float)
    ok = (np.isfinite(pv) & np.isfinite(pv_ref)
          & (pv > 1e-300) & (pv_ref > 1e-300))
    check(bool(ok.any()), "no comparable p-value pairs")
    gap = np.abs(np.log10(pv[ok]) - np.log10(pv_ref[ok]))
    return float(gap.max()), float(np.quantile(gap, 0.99)), int(ok.sum())


def result_line(devices):
    """The run's last line: the device as JAX reports it."""
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def card_line():
    """Name and power limit of each card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return "; ".join(ln.strip() for ln in out.stdout.splitlines()
                     if ln.strip())


def peak_bytes(device):
    """``peak_bytes_in_use`` of a device (None where the backend keeps no
    statistics)."""
    stats = device.memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def require_gpu(n_chips):
    """The GPU devices, or SmokeFailure: this run never falls back to the
    CPU."""
    import jax

    devices = jax.devices()
    check(devices[0].platform == "gpu",
          f"JAX found no GPU (default platform {devices[0].platform!r})")
    check(len(devices) >= n_chips,
          f"{n_chips} cards needed, JAX sees {len(devices)}")
    return devices


def _timed(fn):
    t = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t


def _dataset(spec):
    from bench import make_dataset

    return make_dataset(spec["n_cells"], spec["n_contexts"],
                        spec["n_donors"], spec["n_snps"], seed=spec["seed"])


def _scanner(d, batch, **cfg):
    import cellregmap_tpu as crt

    config = crt.ScanConfig(snp_batch=batch, **cfg)
    return crt.CellRegMap(y=d["y"], E=d["E"], W=d["W"], Ls=d["Ls"],
                          config=config)


# --------------------------------------------------------------------------
# Phases
# --------------------------------------------------------------------------
def phase_device(n_chips):
    """Device check, the card's name and power limit, and the native Davies
    library; returns (devices, card)."""
    devices = require_gpu(n_chips)
    card = card_line()
    from cellregmap_tpu.utils.native import get_qfc

    get_qfc()  # builds the library on first use; raises if it cannot
    log("device", platform=devices[0].platform,
        kind=repr(devices[0].device_kind), count=len(devices),
        card=repr(card))
    return devices, card


def phase_oracle(spec=ORACLE):
    """Engine vs the reference-style serial oracle on a small dataset."""
    from cellregmap_tpu import oracle

    d = _dataset(spec)
    G = d["G"][:, :spec["n_test"]]
    (pv_ref, info_ref), t_ref = _timed(
        lambda: oracle.scan_interaction_reference_style(
            d["y"], d["W"], d["E"], Ls=d["Ls"], G=G))
    (pv, info), t_eng = _timed(lambda: _scanner(d, 512).scan_interaction(G))
    diff = max_abs_diff("oracle p-values", pv, pv_ref, PV_ATOL)
    same_values("oracle rho1", info["rho1"], info_ref["rho1"])
    log("oracle", n_cells=spec["n_cells"], n_contexts=spec["n_contexts"],
        n_donors=spec["n_donors"], n_variants=G.shape[1],
        max_abs_pv_diff=f"{diff:.3e}", rho1_identical=True,
        oracle_s=f"{t_ref:.1f}", engine_incl_setup_compile_s=f"{t_eng:.1f}")


def phase_exact(d, spec, card, device):
    """Exact (Davies) interaction scan at full width; returns the scanner
    and its results."""
    crm = _scanner(d, spec["batch"])
    # the factorization is lazy: build it here so it is reported as setup
    _, t_setup = _timed(lambda: crm._ctx)
    batch = min(spec["batch"], crm._auto_batch_cap(), d["G"].shape[1])
    _, t_first = _timed(lambda: crm.scan_interaction(d["G"][:, :batch]))
    (pv, info), t_scan = _timed(lambda: crm.scan_interaction(d["G"]))
    n = d["G"].shape[1]
    check(pv.shape == (n,) and bool(np.all((pv >= 0) & (pv <= 1))),
          "exact scan: p-values outside [0, 1]")
    planted = float(pv[spec["planted"]])
    check(planted < PLANTED_MAX,
          f"planted variant p = {planted:.3e}, not below {PLANTED_MAX:.0e}")
    R = int(crm._ctx.S.shape[1])
    log("exact_scan", n_cells=d["y"].shape[0], n_contexts=d["E"].shape[1],
        R=R, n_variants=n, batch=batch, host_setup_s=f"{t_setup:.2f}",
        compile_plus_first_batch_s=f"{t_first:.2f}",
        steady_scan_s=f"{t_scan:.3f}", tests_per_s=f"{n / t_scan:.1f}",
        planted_pv=f"{planted:.3e}", peak_bytes_in_use=peak_bytes(device),
        card=repr(card))
    ma = _memory_analysis(crm, d["G"][:, :batch])
    if ma is not None:
        log("exact_scan_memory", **ma)
    return crm, pv, info


def _memory_analysis(crm, G_batch):
    """Compiled memory footprint of one exact-scan batch (None where the
    backend gives none)."""
    import jax.numpy as jnp

    from cellregmap_tpu import engine

    cfg = crm._cfg
    gb = jnp.asarray(G_batch, crm._dtype)
    delta_cfg = (cfg.delta_logit_lo, cfg.delta_logit_hi,
                 cfg.n_delta_grid_interaction, cfg.n_golden_iters)
    compiled = engine.interaction_kernel.lower(
        crm._ctx, gb, gb, crm._n, delta_cfg=delta_cfg, device_pvalues=False,
        localize_f32=cfg.hybrid_localization).compile()
    ma = compiled.memory_analysis()
    if ma is None:
        return None
    return {k: getattr(ma, k) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")
        if hasattr(ma, k)}


def phase_cpu_reference(d, spec, crm, pv_exact, info_exact):
    """The same public calls on JAX's CPU backend, compared per variant."""
    import jax

    k = spec["n_cpu"]
    G = d["G"][:, :k]
    maf = d["maf"][:k]
    # on the card: fast association of all variants, betas of the subset
    (pva, _), t_assoc = _timed(lambda: crm.scan_association_fast(d["G"]))
    (bg, bgxe), t_betas = _timed(lambda: crm.predict_interaction(G, maf))
    with jax.default_device(jax.devices("cpu")[0]):
        cpu = _scanner(d, spec["batch"])
        (pv_c, info_c), t_cpu = _timed(lambda: cpu.scan_interaction(G))
        pva_c, _ = cpu.scan_association_fast(G)
        bg_c, bgxe_c = cpu.predict_interaction(G, maf)
    d_int = max_abs_diff("interaction p-values vs CPU", pv_exact[:k], pv_c,
                         PV_ATOL)
    same_values("interaction rho1 vs CPU", info_exact["rho1"][:k],
                info_c["rho1"])
    d_assoc = max_abs_diff("association p-values vs CPU", pva[:k], pva_c,
                           PV_ATOL)
    d_bg = max_abs_diff("beta_G vs CPU", bg, bg_c, BETA_ATOL)
    d_bgxe = max_abs_diff("beta_GxC vs CPU", bgxe, bgxe_c, BETA_ATOL)
    log("cpu_reference", n_variants=k,
        interaction_max_abs_pv_diff=f"{d_int:.3e}", rho1_identical=True,
        association_max_abs_pv_diff=f"{d_assoc:.3e}",
        beta_g_max_abs_diff=f"{d_bg:.3e}",
        beta_gxc_max_abs_diff=f"{d_bgxe:.3e}",
        gpu_assoc_all_variants_incl_compile_s=f"{t_assoc:.2f}",
        gpu_betas_incl_setup_compile_s=f"{t_betas:.2f}",
        cpu_interaction_incl_setup_compile_s=f"{t_cpu:.1f}")


def phase_screen(d, crm, pv_exact, spec):
    """f32 screen -> f64 confirm against an f64 saddlepoint scan."""
    G = d["G"]
    (pv, info), t_screen = _timed(
        lambda: crm.scan_interaction_screen(G, significance=5e-8))
    # f64 scan with the screen's own tail approximation, sharing the
    # factorization, isolates the f32 error from the tail method's
    sp = crm._with_config(dataclasses.replace(
        crm._cfg, pvalue_method="saddlepoint"))
    pv_sp, _ = sp.scan_interaction(G)
    gmax, gq99, n_cmp = log10_gap(info["screen_pv"], pv_sp)
    check(gmax < SCREEN_MARGIN_DECADES,
          f"screen |dlog10| max {gmax:.3f} >= {SCREEN_MARGIN_DECADES}")
    conf = np.asarray(info["confirmed"])
    check(bool(conf[spec["planted"]]), "planted variant was not confirmed")
    d_conf = max_abs_diff("confirmed p-values vs exact scan", pv[conf],
                          pv_exact[conf], CONFIRM_ATOL)
    log("screen", n_variants=G.shape[1], n_compared=n_cmp,
        dlog10_max=f"{gmax:.3e}", dlog10_q99=f"{gq99:.3e}",
        n_confirmed=int(conf.sum()),
        confirmed_max_abs_diff=f"{d_conf:.3e}",
        screen_incl_compile_s=f"{t_screen:.2f}")


def phase_sharded(d, spec, devices, card, n_chips):
    """Mesh-sharded scan over ``n_chips`` cards vs a one-card scan."""
    from cellregmap_tpu.parallel import ShardedScanner, make_mesh

    crm = _scanner(d, spec["batch"])
    _, t_setup = _timed(lambda: crm._ctx)
    mesh = make_mesh(devices=devices[:n_chips])
    check(len({dv.id for dv in mesh.devices.flat}) == n_chips,
          "mesh does not span distinct cards")
    scanner = ShardedScanner(crm, mesh=mesh)
    G = d["G"]
    (pv_s, info_s), t_first = _timed(lambda: scanner.scan_interaction(G))
    (pv_s, info_s), t_sharded = _timed(lambda: scanner.scan_interaction(G))
    (pv_1, info_1), t_one_first = _timed(lambda: crm.scan_interaction(G))
    (pv_1, info_1), t_one = _timed(lambda: crm.scan_interaction(G))
    diff = max_abs_diff("sharded p-values vs one card", pv_s, pv_1, PV_ATOL)
    same_values("sharded rho1 vs one card", info_s["rho1"], info_1["rho1"])
    peaks = [peak_bytes(dv) for dv in devices[:n_chips]]
    if None not in peaks:
        # every card holds the replicated context plus its share of the
        # batch; a scan that ran on one card leaves the others far lower
        check(min(peaks) >= 0.5 * max(peaks),
              f"cards did unequal work: peak bytes {peaks}")
    log("sharded_scan", n_chips=n_chips, n_variants=G.shape[1],
        max_abs_pv_diff=f"{diff:.3e}", rho1_identical=True,
        host_setup_s=f"{t_setup:.2f}",
        sharded_compile_plus_first_s=f"{t_first:.2f}",
        sharded_steady_s=f"{t_sharded:.3f}",
        one_card_compile_plus_first_s=f"{t_one_first:.2f}",
        one_card_steady_s=f"{t_one:.3f}",
        peak_bytes_in_use_per_card=peaks, card=repr(card))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="4: run only the four-card sharded scan")
    args = ap.parse_args(argv)
    # the CPU comparison needs JAX's CPU backend beside the GPU one; this
    # takes effect when JAX has not started yet (a run as a script)
    platforms = os.environ.get("JAX_PLATFORMS", "")
    if platforms and "cpu" not in platforms.split(","):
        os.environ["JAX_PLATFORMS"] = platforms + ",cpu"
    try:
        devices, card = phase_device(args.chips)
        d = _dataset(FULL)
        log("dataset", n_cells=FULL["n_cells"],
            n_contexts=FULL["n_contexts"], n_donors=FULL["n_donors"],
            n_variants=FULL["n_snps"])
        if args.chips > 1:
            phase_sharded(d, FULL, devices, card, args.chips)
        else:
            phase_oracle()
            crm, pv, info = phase_exact(d, FULL, card, devices[0])
            phase_cpu_reference(d, FULL, crm, pv, info)
            phase_screen(d, crm, pv, FULL)
        log("done", peak_bytes_in_use=peak_bytes(devices[0]),
            card=repr(card))
    except SmokeFailure as e:
        print(f"FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
