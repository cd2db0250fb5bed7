"""Configuration for the cellregmap_tpu engine.

The reference (limix/CellRegMap) hard-codes its hyper-parameters inline:
rho-grid ``linspace(0, 1, 11)`` (/root/reference/cellregmap/_cellregmap.py:108,119),
eigenvalue cutoff 1e-16 (_math.py:128), p-value clipping (_cellregmap.py:467-469).
Here they live in one dataclass so scans are reproducible and tunable.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Tuple

# Build and compile caches of this checkout (listed in .gitignore): the XLA
# compilation cache (unless JAX_COMPILATION_CACHE_DIR is set) and the native
# host libraries built from cellregmap_tpu/native.
CACHE_ROOT = Path(__file__).resolve().parent.parent / ".cache"


@dataclasses.dataclass(frozen=True)
class ScanConfig:
    """Hyper-parameters of the scan engine.

    Attributes
    ----------
    n_rho:
        Number of points of the rho1 grid ``linspace(0, 1, n_rho)`` mixing the
        E1*E1^T context kernel with the K (x) E2*E2^T background
        (reference: _cellregmap.py:108,119).
    delta_logit_lo / delta_logit_hi / n_delta_grid:
        Coarse grid over logit(delta) for the profiled 1-D variance-ratio
        objective (delta = v1/(v0+v1)); replaces glimix-core's Brent search.
        The interaction kernel only needs basin-level localization from the
        grid (safeguarded Newton converges from the bracket), so this can
        be small; the association/betas kernels refine by golden section
        and want it finer.
    n_golden_iters:
        Fixed-iteration golden-section refinement steps after the grid
        argmax (association/betas kernels; the interaction kernel uses
        analytic-derivative Newton instead).  60 iterations shrink the
        bracket by ~3e-13, i.e. to machine precision in logit space.
    snp_batch:
        Number of variants processed per compiled device step. Static shape;
        the driver pads the final batch.
    pvalue_method:
        "davies"  - host-side exact Davies tail for every test (reference
                    parity path; chiscore/davies C path equivalent).
        "auto"    - device-side saddlepoint everywhere, exact Davies refinement
                    only where pv < davies_threshold.
        "saddlepoint" / "liu" - device-only approximations (no host sync).
    davies_threshold:
        Refinement threshold for pvalue_method="auto".
    davies_acc / davies_lim:
        Absolute accuracy target and integration-term limit of the Davies
        algorithm (reference's chiscore uses the SKAT defaults 1e-6/10'000;
        we default tighter since the C++ path is cheap).
    lambda_filter_ratio:
        Mixture-weight filter: keep eigenvalues > mean(positive)/ratio
        (SKAT / chiscore convention).
    dtype:
        "float64" (default; statistical parity) or "float32" (fast path for
        the large n-contractions; small-dimension solves stay float64).
    """

    n_rho: int = 11
    delta_logit_lo: float = -18.0
    delta_logit_hi: float = 18.0
    n_delta_grid: int = 256
    # interaction-scan grid: basin localization only (safeguarded Newton
    # converges from the bracket; K=64 vs K=256 agree to 1e-14 in delta)
    n_delta_grid_interaction: int = 64
    n_golden_iters: int = 60
    snp_batch: int = 256
    pvalue_method: str = "davies"
    davies_threshold: float = 1e-2
    davies_acc: float = 1e-8
    davies_lim: int = 20_000_000
    lambda_filter_ratio: float = 1e5
    dtype: str = "float64"
    # Hybrid precision: localize the REML optimum (coarse grid + first
    # Newton/zoom iterations) in f32 at full f32 precision, then converge
    # in f64 and keep all score/statistics math f64 (whether f32
    # localization pays where f64 is native, as on a GPU, is open).  The
    # interaction path restores full-f64 p-value equality
    # (tests/test_hybrid.py pins 1e-9); the betas path resolves each
    # per-rho optimum to the f32 noise floor, so rho argmaxes at ties
    # flatter than ~1e-4 lml may differ from a full-f64 run (the fits
    # themselves agree to ~1e-7).  Disable for exact-argmax audit runs.
    hybrid_localization: bool = True
    # p-value clipping used by lrt_pvalues (reference clips to
    # [epsilon.super_tiny, 1 - epsilon.tiny], _cellregmap.py:467-469).
    pv_clip_lo: float = 1e-300
    pv_clip_hi: float = 1.0 - 1.1e-16
    progress: bool = False
    # Observability (SURVEY 5.1/5.5): when True, scan methods time their
    # phases (device kernel, p-value ladder, ...) with
    # utils.trace.PhaseTimers, return them as info["timers"], and emit
    # structured log events on the "cellregmap_tpu" logger.
    trace: bool = False

    @property
    def rho_grid(self) -> Tuple[float, ...]:
        if self.n_rho == 1:
            return (1.0,)
        return tuple(i / (self.n_rho - 1) for i in range(self.n_rho))


DEFAULT_CONFIG = ScanConfig()
