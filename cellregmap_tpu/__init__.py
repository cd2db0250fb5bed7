"""cellregmap_tpu — CellRegMap in JAX: context-specific eQTL mapping.

A from-scratch JAX/XLA re-design of limix/CellRegMap (StructLMM-style
variance-component score tests for GxC interactions, LRT association tests,
and GLS effect-size decomposition): batched profiled LMM fits, one-shot
workspace-basis factorization, on-device p-value approximations with a
native (C++) Davies exact tail on host, and mesh-sharded scans.

Public surface mirrors the reference package
(cellregmap/__init__.py:1-20) plus the batched extensions.
"""
# Statistical parity requires float64; enable before any jax usage.
import os as _os

import jax as _jax

from ._config import CACHE_ROOT

_jax.config.update("jax_enable_x64", True)

# Persistent XLA compilation cache.  JAX itself honours
# JAX_COMPILATION_CACHE_DIR; without it, compiled kernels go to one fixed
# directory of this checkout, so every later process finds them.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", str(CACHE_ROOT / "xla"))

from ._config import ScanConfig, DEFAULT_CONFIG
from ._types import Term
from .api import (
    CellRegMap,
    run_association,
    run_association_fast,
    run_association_fast_multigene,
    run_association_multigene,
    run_interaction,
    run_interaction_multigene,
    run_interaction_screen,
    estimate_betas,
    get_L_values,
)
from .plink_scan import scan_interaction_plink
from .utils.maf import compute_maf
from .models.pvalues import (
    lrt_pvalues,
    davies_pvalue,
    liu_sf,
    saddlepoint_sf,
    score_statistic_liu_params,
    qmin,
)
from .sim import (
    Variances,
    Simulation,
    create_variances,
    sample_phenotype,
    sample_phenotype_gxe,
)

__version__ = "0.1.0"

__all__ = [
    "CellRegMap",
    "run_association",
    "run_association_fast",
    "run_association_fast_multigene",
    "run_association_multigene",
    "run_interaction",
    "run_interaction_multigene",
    "run_interaction_screen",
    "estimate_betas",
    "get_L_values",
    "scan_interaction_plink",
    "compute_maf",
    "lrt_pvalues",
    "davies_pvalue",
    "liu_sf",
    "saddlepoint_sf",
    "score_statistic_liu_params",
    "qmin",
    "ScanConfig",
    "DEFAULT_CONFIG",
    "Term",
    "Variances",
    "Simulation",
    "create_variances",
    "sample_phenotype",
    "sample_phenotype_gxe",
    "__version__",
]
