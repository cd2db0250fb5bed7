"""The f32 stages run every float32 dot at full float32 precision.

A GPU computes float32 matrix products in TF32 unless a precision is asked
for.  The engine pins the precision at trace time (ops.linalg
.full_f32_matmuls), so each float32 ``dot_general`` in the traced kernels
must carry ``Precision.HIGHEST``: the hybrid localization inside the exact
interaction kernel, the whole f32 screen kernel, the association refit and
the betas localization.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import cellregmap_tpu as crt
from cellregmap_tpu import engine
from cellregmap_tpu.ops.linalg import full_f32_matmuls

FULL = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)
DCFG = (-18.0, 18.0, 16, 20)


def _dots(jaxpr, out):
    """(operand dtypes, precision) of every dot_general, sub-jaxprs
    (jit, scan, fori_loop, cond, ...) included."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append((tuple(v.aval.dtype for v in eqn.invars),
                        eqn.params["precision"]))
        for val in eqn.params.values():
            for sub in val if isinstance(val, (list, tuple)) else (val,):
                if hasattr(sub, "consts") and hasattr(sub, "jaxpr"):
                    _dots(sub.jaxpr, out)
                elif hasattr(sub, "eqns"):
                    _dots(sub, out)
    return out


def _f32_precisions(fn, *args):
    dots = _dots(jax.make_jaxpr(fn)(*args).jaxpr, [])
    return [p for dts, p in dots if jnp.float32 in dts]


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    n, C, donors, S = 48, 3, 6, 8
    E = rng.normal(size=(n, C))
    hK = np.zeros((n, donors))
    hK[np.arange(n), np.arange(n) % donors] = 1.0
    Ls = crt.get_L_values(hK, E)
    y = rng.normal(size=n)
    W = np.ones((n, 1))
    G = jnp.asarray(rng.normal(size=(n, S)))
    ctx = engine.build_null_context(y, W, E, Ls=Ls)
    bctx = engine.build_betas_context(y, W, E, Ls)
    return n, ctx, bctx, G


def _kernels(problem):
    n, ctx, bctx, G = problem
    ctx32 = jax.tree.map(lambda a: a.astype(jnp.float32), ctx)
    G32 = G.astype(jnp.float32)
    norm = jnp.ones(G.shape[1])
    return {
        "hybrid_interaction": (
            lambda c, g: engine.interaction_kernel(
                c, g, g, n, delta_cfg=DCFG, localize_f32=True), ctx, G),
        "screen_interaction": (
            lambda c, g: engine.interaction_kernel(
                c, g, g, n, delta_cfg=DCFG, device_pvalues=True), ctx32, G32),
        "association_refit": (
            lambda c, g: engine.association_refit_kernel(
                c, g, 0, n, delta_cfg=DCFG, localize_f32=True), ctx, G),
        "betas_localization": (
            lambda c, g: engine.predict_interaction_kernel(
                c, g, norm, n, delta_cfg=DCFG, localize_f32=True), bctx, G),
    }


@pytest.mark.parametrize("kernel", ["hybrid_interaction",
                                    "screen_interaction",
                                    "association_refit",
                                    "betas_localization"])
def test_f32_dots_pinned_to_full_precision(problem, kernel):
    fn, *args = _kernels(problem)[kernel]
    precisions = _f32_precisions(fn, *args)
    assert precisions, f"{kernel}: no float32 dot traced"
    assert all(p == FULL for p in precisions), set(precisions)


def test_unpinned_kernel_leaves_precision_to_the_backend(problem):
    """Control: the same kernel traced without the pin carries no
    precision on its f32 dots, so the test above detects a missing pin."""
    n, ctx, _, G = problem
    raw = engine.interaction_batch.__wrapped__
    precisions = _f32_precisions(
        lambda c, g: raw(c, g, g, n, delta_cfg=DCFG, localize_f32=True),
        ctx, G)
    assert precisions and all(p is None for p in precisions)


def test_pin_is_scoped_to_the_traced_kernel():
    """The pin sets no global state: a dot traced outside it is unpinned."""
    x = jnp.ones((4, 4), jnp.float32)
    inside = _f32_precisions(full_f32_matmuls(lambda a: a @ a), x)
    outside = _f32_precisions(lambda a: a @ a, x)
    assert inside == [FULL] and outside == [None]


@pytest.mark.gpu
def test_pinned_f32_matmul_is_full_precision_on_gpu(gpu_devices):
    """On the card the pinned product matches float64 to float32 rounding
    (TF32 would be off by ~1e-3 relative)."""
    rng = np.random.default_rng(1)
    a = rng.normal(size=(512, 512))
    b = rng.normal(size=(512, 512))
    ref = a @ b
    got = jax.jit(full_f32_matmuls(lambda x, y: x @ y))(
        jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32))
    rel = np.max(np.abs(np.asarray(got, float) - ref)) / np.max(np.abs(ref))
    assert rel < 1e-5, rel
