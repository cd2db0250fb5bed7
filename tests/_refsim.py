"""Test-time loader for the reference's own simulator.

For parity grounding the tests generate input
data by *executing* the reference's ``_simulate.py`` in place from
/root/reference (read-only; nothing is copied into this repo).  The only
missing dependency, ``numpy_sugar``, is satisfied with a minimal in-test
shim implementing the two consumed functions (``ddot``,
``linalg.economic_svd``) with their documented public semantics.

Tests using this loader skip cleanly when the reference checkout is absent
(e.g. external CI).
"""
from __future__ import annotations

import importlib.util
import os
import sys
import types

import numpy as np

_REF_DIR = "/root/reference/cellregmap"


def _install_numpy_sugar_shim():
    if "numpy_sugar" in sys.modules:
        return
    ns = types.ModuleType("numpy_sugar")
    ns_lin = types.ModuleType("numpy_sugar.linalg")

    def ddot(L, R=None, left=True):
        """Diagonal-matrix product: 1-D operand is a diagonal."""
        L = np.asarray(L)
        R = np.asarray(R)
        if L.ndim == 1:
            return L[:, None] * R
        return L * R[None, :] if R.ndim == 1 else L @ R

    def economic_svd(G, epsilon=np.sqrt(np.finfo(float).eps)):
        """Thin SVD keeping singular values >= sqrt(eps) (absolute)."""
        G = np.asarray(G, float)
        U, S, V = np.linalg.svd(G, full_matrices=False)
        ok = S >= epsilon
        return (U[:, ok], S[ok], V[ok, :])

    ns.ddot = ddot
    ns.epsilon = types.SimpleNamespace(
        tiny=np.finfo(float).tiny,
        small=np.finfo(float).eps,
        super_tiny=np.finfo(np.float64).tiny,
    )
    ns_lin.economic_svd = economic_svd
    ns.linalg = ns_lin
    sys.modules["numpy_sugar"] = ns
    sys.modules["numpy_sugar.linalg"] = ns_lin


def load_reference_simulate():
    """Import /root/reference/cellregmap/_simulate.py; None if unavailable."""
    if not os.path.isdir(_REF_DIR):
        return None
    key = "_cellregmap_reference_sim"
    if key in sys.modules:
        return sys.modules[key + "._simulate"]
    _install_numpy_sugar_shim()
    pkg = types.ModuleType(key)
    pkg.__path__ = [_REF_DIR]
    sys.modules[key] = pkg
    for mod in ("_types", "_simulate"):
        spec = importlib.util.spec_from_file_location(
            f"{key}.{mod}", os.path.join(_REF_DIR, f"{mod}.py"))
        m = importlib.util.module_from_spec(spec)
        sys.modules[f"{key}.{mod}"] = m
        spec.loader.exec_module(m)
    return sys.modules[key + "._simulate"]


def reference_gxe_dataset():
    """The dataset behind the reference's pinned predict_interaction test.

    Reproduces /root/reference/cellregmap/test/test_struct_lmm2.py:355-384:
    ``sample_phenotype_gxe`` with RandomState(0), 100 individuals x 2 cells,
    20 SNPs, 3 env groups, variances = create_variances(0.5, 0.5).
    """
    sim = load_reference_simulate()
    if sim is None:
        return None
    random = np.random.RandomState(0)
    v = sim.create_variances(0.5, 0.5)
    return sim.sample_phenotype_gxe(
        offset=0.3, n_individuals=100, n_snps=20, n_cells=2,
        n_env_groups=3, maf_min=0.05, maf_max=0.45,
        g_causals=[5, 6], gxe_causals=[10, 11], variances=v, random=random,
    )
