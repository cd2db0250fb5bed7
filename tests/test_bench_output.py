"""A reader that keeps only the LAST 2000 characters of bench stdout and
json.loads the final line loses the whole record to an oversized final
line.  These tests pin the contract: every line bench.py prints is
parseable from a 2000-char tail, even with every north-star config fully
populated, and every line names the device it ran on.
"""
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import compact_summary, roofline_estimate  # noqa: E402


def _worst_case_result():
    """A fully-populated result: every config present with long float
    values, plus roofline/kernel detail (which must NOT reach the line)."""
    configs = {}
    for name in ("betas_2k", "assoc_fast_2k", "cells10k_pairs5k",
                 "contexts50", "cells50k_pairs100k", "multigene_16",
                 "multigene_cis_128", "assoc_multigene_16",
                 "betas_100k_stretch"):
        configs[name] = {
            "tests_per_sec": 1646.8123456789,
            "gene_variant_pairs_per_sec": 2675.4123456789,
            "steady_variants_per_sec": 69.5512345,
            "variants_per_sec": 69.5512345,
            "scan_s": 31.364123,
            "compile_plus_first_batch_s": 20.8312345,
            "n_snps": 5120,
            "pvalue_method": "davies",
            "n_cells": 100000,
            "n_contexts": 50,
            "R": 2520,
            "extrapolated_100k_pairs_hours": 0.40712345,
            "per_gene_loop_pairs_per_sec": 980.612345,
            "speedup_vs_per_gene_loop": 2.4712345,
            "total_s": 178.712345,
        }
    return {
        "metric": "interaction_tests_per_sec",
        "value": 1434.12345678,
        "unit": "tests/s",
        "vs_baseline": 36867.1234,
        "baseline_tests_per_sec": 0.03891234,
        "pvalue_max_abs_diff_vs_reference_style": 4.985281853997492e-09,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": 1},
        "config": {"n_cells": 2000, "n_contexts": 10, "n_donors": 100,
                   "n_snps": 2048, "batch": 512, "pvalue_method": "davies"},
        "setup_s": 4.62, "compile_s": 7.04,
        "scan_s": 1.435, "kernel_s_per_batch": 0.311,
        "kernel_tests_per_sec": 1646.8, "davies_s_per_batch": 0.058,
        "null_fits_per_sec": 18114.7,
        "roofline": {"kernel_s_per_batch": 0.3109, "batch": 512,
                     "min_hbm_bytes_per_batch": 996547520,
                     "achieved_gbps_lower_bound": 3.2,
                     "flops_per_batch": 147213721600,
                     "achieved_tflops": 0.47,
                     "arithmetic_intensity_flop_per_byte": 147.7},
        "configs": configs,
        "total_bench_s": 546.812345,
    }


def test_summary_under_cap():
    line = compact_summary(_worst_case_result())
    assert len(line) < 1500, len(line)
    parsed = json.loads(line)
    assert parsed["metric"] == "interaction_tests_per_sec"
    assert parsed["value"] == 1434.12345678
    assert len(parsed["configs"]) == 9
    # each config compresses to [rate, total_s]
    assert parsed["configs"]["cells10k_pairs5k"][0] == 1646.8123456789
    # the line names the device it was measured on
    assert parsed["device"] == {"platform": "gpu",
                                "kind": "NVIDIA H100 80GB HBM3", "count": 1}


def test_driver_tail_parse():
    """Simulate the driver: full stdout, keep the last 2000 chars, parse
    the final complete line."""
    result = _worst_case_result()
    lines = [compact_summary(result) for _ in range(4)]
    stdout = "\n".join(lines) + "\n"
    tail = stdout[-2000:]
    last = [ln for ln in tail.splitlines() if ln.strip()][-1]
    parsed = json.loads(last)
    assert parsed["total_bench_s"] == 546.812345


def test_skipped_and_error_rows_stay_compact():
    result = _worst_case_result()
    result["configs"]["betas_100k_stretch"] = {"skipped": "time budget"}
    result["configs"]["assoc_multigene_16"] = {"error": "RuntimeError: x" * 50}
    line = compact_summary(result)
    assert len(line) < 1500
    parsed = json.loads(line)
    assert parsed["configs"]["betas_100k_stretch"] == "skipped"
    assert parsed["configs"]["assoc_multigene_16"] == "error"


def test_roofline_has_no_device_peak():
    """The roofline record carries what the kernel achieved, computed from
    shapes; no peak rate of any device is assumed."""
    r = roofline_estimate(n=2000, C=10, R=1010, nrho=11, S=512,
                          t_kernel=0.5)
    assert r["min_hbm_bytes_per_batch"] > 0 and r["flops_per_batch"] > 0
    assert r["achieved_tflops"] == round(r["flops_per_batch"] / 0.5 / 1e12, 2)
    assert not any("peak" in k or "fraction" in k for k in r)
