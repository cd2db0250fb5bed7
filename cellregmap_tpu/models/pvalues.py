"""Mixture-of-chi-squared tail probabilities: the p-value ladder.

The reference's only native dependency is the C ``qfc`` routine inside
chiscore (Davies' exact method, consumed at _cellregmap.py:333,435 via
``davies_pvalue``) plus the pure-Python ``liu_sf`` (_math.py:169-180).

Design: three rungs.

1. **mod-Liu** (`liu_sf`) — 4-moment chi-squared match (Liu-Tang-Zhang with
   the Lee/Wu/Lin kurtosis modification).  Pure jnp, fully batched; runs on
   device alongside the score statistic.
2. **Kuonen saddlepoint** (`saddlepoint_sf`) — Lugannani-Rice tail with a
   fixed-iteration Newton solve of K'(t) = q.  Pure jnp, batched; much more
   accurate than Liu in the far tail.
3. **Davies exact** (`davies_pvalue`) — our own C++ implementation of
   Davies' algorithm (native/qfc.cc, loaded via ctypes), host-side, applied
   where exactness matters; falls back to a SciPy Imhof quadrature oracle and
   to mod-Liu exactly like chiscore/SKAT do when the algorithm fails (the
   library itself must build: a missing library raises).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.scipy.special import gammaincc, ndtr


# --------------------------------------------------------------------------
# Rung 1: modified Liu (device, batched)
# --------------------------------------------------------------------------
def liu_sf(q, lambdas, modified: bool = True):
    """Pr(Q > q), Q = sum_i lambda_i chi2_1, by Liu moment matching.

    jnp port of chiscore.liu_sf for the central, df=1 case used by the
    reference.  ``lambdas`` may contain zeros (inert padding).  Batched over
    leading axes: q (...,), lambdas (..., C).

    Returns (pv, dof_x, ncp_x, mu_q, sigma_q).
    """
    lam = jnp.asarray(lambdas)
    q = jnp.asarray(q)
    c1 = jnp.sum(lam, axis=-1)
    c2 = jnp.sum(lam**2, axis=-1)
    c3 = jnp.sum(lam**3, axis=-1)
    c4 = jnp.sum(lam**4, axis=-1)

    s1 = c3 / jnp.sqrt(c2) ** 3
    s2 = c4 / c2**2

    has_ncp = s1**2 > s2
    # branch 1: noncentral match
    a = 1.0 / (s1 - jnp.sqrt(jnp.maximum(s1**2 - s2, 0.0)))
    ncp_1 = s1 * a**3 - a**2
    dof_1 = a**2 - 2 * ncp_1
    # branch 2: central, kurtosis-matched (modified) or skewness (original)
    dof_2 = 1.0 / s2 if modified else 1.0 / s1**2

    ncp_x = jnp.where(has_ncp, ncp_1, 0.0)
    dof_x = jnp.where(has_ncp, dof_1, dof_2)

    mu_q = c1
    sigma_q = jnp.sqrt(2 * c2)
    mu_x = dof_x + ncp_x
    sigma_x = jnp.sqrt(2 * (dof_x + 2 * ncp_x))

    t = (q - mu_q) / sigma_q
    q_x = t * sigma_x + mu_x
    pv = _ncx2_sf(q_x, dof_x, ncp_x)
    return pv, dof_x, ncp_x, mu_q, sigma_q


def _chi2_sf(x, df):
    return gammaincc(df / 2.0, jnp.maximum(x, 0.0) / 2.0)


def _ncx2_sf(x, df, ncp, n_terms: int = 64):
    """Noncentral chi2 survival via Poisson-weighted central series (jnp).

    ncp = 0 reduces exactly to the central case.  64 terms cover the ncp
    magnitudes produced by Liu matching on score-test weight spectra.
    """
    central = _chi2_sf(x, df)
    k = jnp.arange(n_terms, dtype=x.dtype)
    halfn = ncp[..., None] / 2.0
    # Poisson(k; ncp/2) weights, log-space for stability; ncp=0 -> k=0 only.
    logw = -halfn + k * jnp.log(jnp.maximum(halfn, jnp.finfo(x.dtype).tiny)) - jax.scipy.special.gammaln(k + 1)
    w = jnp.exp(logw)
    w = jnp.where((halfn == 0) & (k == 0), 1.0, jnp.where(halfn == 0, 0.0, w))
    terms = _chi2_sf(x[..., None], df[..., None] + 2 * k)
    series = jnp.sum(w * terms, axis=-1)
    return jnp.where(ncp > 0, series, central)


# --------------------------------------------------------------------------
# Rung 2: Kuonen saddlepoint (device, batched)
# --------------------------------------------------------------------------
def saddlepoint_sf(q, lambdas, n_iters: int = 40):
    """Pr(Q > q) by the Lugannani-Rice / Kuonen saddlepoint approximation.

    K(t) = -1/2 sum log(1 - 2 t lambda_i); solve K'(t*) = q by bisection +
    Newton (fixed iterations, branch-free).  Valid for q != E[Q]; near the
    mean we return the Liu value (the saddlepoint w -> 0 singularity).
    """
    lam = jnp.asarray(lambdas)
    q = jnp.asarray(q)
    lmax = jnp.max(lam, axis=-1)
    mean = jnp.sum(lam, axis=-1)

    # t* in (-inf, 1/(2 lmax)); reparameterize t = hi - exp(u) with
    # hi = 1/(2 lmax).  K' is increasing in t; K'(t)->inf as t->hi.
    hi = 1.0 / (2.0 * lmax)

    def kp(t):
        return jnp.sum(lam / (1.0 - 2.0 * t[..., None] * lam), axis=-1)

    def kpp(t):
        return jnp.sum(
            2.0 * lam**2 / (1.0 - 2.0 * t[..., None] * lam) ** 2, axis=-1
        )

    # Bisection on t in (lo, hi): lo chosen far left so K'(lo) < q for the
    # q-below-mean case.
    span = jnp.maximum(mean, 1.0) / jnp.maximum(q, jnp.finfo(q.dtype).tiny)
    lo = -jnp.abs(hi) * 1e3 - span * 1e3 - 1e3
    hi_b = hi * (1.0 - 1e-12)

    def body(_, ab):
        a, b = ab
        mid = 0.5 * (a + b)
        below = kp(mid) < q
        return jnp.where(below, mid, a), jnp.where(below, b, mid)

    a, b = jax.lax.fori_loop(0, n_iters + 60, body, (lo, hi_b))
    t = 0.5 * (a + b)

    K = -0.5 * jnp.sum(jnp.log1p(-2.0 * t[..., None] * lam), axis=-1)
    w = jnp.sign(t) * jnp.sqrt(jnp.maximum(2.0 * (t * q - K), 0.0))
    v = t * jnp.sqrt(kpp(t))
    near_mean = jnp.abs(v) < 1e-8
    w_safe = jnp.where(near_mean, 1.0, w)
    v_safe = jnp.where(near_mean, 1.0, v)
    z = w_safe + jnp.log(v_safe / w_safe) / w_safe
    sp = 1.0 - ndtr(z)
    liu = liu_sf(q, lam)[0]
    return jnp.where(near_mean | (lmax <= 0), liu, sp)


# --------------------------------------------------------------------------
# Rung 3: Davies exact (host)
# --------------------------------------------------------------------------
def _davies_native(q, lambdas, lim, acc):
    """Call the native C++ Davies routine; returns (pv, ifault)."""
    from ..utils.native import get_qfc

    return get_qfc().davies(np.asarray(lambdas, float), float(q), int(lim),
                            float(acc))


def davies_pvalue(q, weight_matrix=None, lambdas=None, lim=20_000_000,
                  acc=1e-8, lambda_filter_ratio=1e5, return_info=False):
    """Pr(Q > q) with the chiscore/SKAT pipeline (host-side, exact).

    Mirrors the behavior of ``chiscore.davies_pvalue`` consumed at
    _cellregmap.py:435: symmetrize the C x C weight matrix, eigendecompose,
    filter eigenvalues > mean(positive)/1e5 (SKAT convention), run Davies'
    algorithm, and fall back to modified Liu when the algorithm fails or
    returns an out-of-range value.  We default to a tighter accuracy than
    chiscore's 1e-6 since the native path is cheap.
    """
    if lambdas is None:
        w = np.asarray(weight_matrix, float)
        w = (w + w.T) / 2
        lam = np.linalg.eigvalsh(w)
    else:
        lam = np.asarray(lambdas, float)
    lam_pos = lam[lam >= 0]
    thr = lam_pos.mean() / lambda_filter_ratio if lam_pos.size else 0.0
    lam = np.sort(lam[lam > thr])[::-1]

    info = {"is_converged": True, "method": "davies", "lambdas": lam}
    if lam.size == 0:
        pv = 1.0
        info["method"] = "degenerate"
        return (pv, info) if return_info else pv

    # Accuracy ladder: requested acc first; if the series needs too many
    # terms (few-weight spectra decay slowly, ifault 4), retry at the
    # reference's own operating accuracy (chiscore/SKAT run Davies at 1e-6),
    # then fall through to the Imhof quadrature for the exact value.
    pv = None
    zero_result = False
    for acc_try in ([acc] if acc >= 1e-6 else [acc, 1e-6]):
        pv_d, ifault = _davies_native(q, lam, lim, acc_try)
        if ifault == 0 and 0.0 < pv_d <= 1.0:
            pv = pv_d
            break
        zero_result = zero_result or (ifault == 0 and pv_d <= 0.0)
    # Deep-tail handling: Davies' acc target is ABSOLUTE, so a result below
    # ~1e4*acc carries large relative error (measured: pv ~ 1e-13 at
    # acc=1e-8 is ~50% off, tests/test_pvalues.py), and a result below the
    # achievable absolute resolution cancels to exactly 0.  First, if the
    # pass cancelled to 0, walk the accuracy down toward the ~1e-16 f64
    # floor to resolve the value at all.
    if pv is None and zero_result:
        for acc_try in (1e-12, 1e-14, 1e-16):
            if acc_try >= acc:
                continue
            pv_d, ifault = _davies_native(q, lam, lim, acc_try)
            if ifault == 0 and 0.0 < pv_d <= 1.0:
                pv = pv_d
                break
    # Then refine tail results with a descending-acc ladder (tail hits
    # only — a handful of extra calls per scan).  Finer-acc runs that flag
    # round-off (ifault 2) are accepted only when they agree with the
    # current estimate to within its own coarser error band: they can only
    # sharpen the value, never replace it with garbage.
    if pv is not None and pv < acc * 1e4:
        cur_acc = acc
        for acc_ref in (max(pv * 1e-1, 1e-15), max(pv * 1e-3, 1e-16)):
            if acc_ref >= cur_acc:
                continue
            pv_r, if_r = _davies_native(q, lam, lim, acc_ref)
            if not (0.0 < pv_r <= 1.0):
                break
            if if_r == 0 or (if_r == 2 and abs(pv_r - pv) <= 2 * cur_acc):
                pv = pv_r
                cur_acc = acc_ref
            else:
                break
    if pv is None:
        from ..oracle import imhof_sf

        try:
            pv = imhof_sf(float(q), lam)
            info["method"] = "imhof"
            if pv < 1e-12:
                # the quadrature's own absolute floor (~epsabs 1e-13):
                # below it the value is integration noise — prefer the
                # monotone mod-Liu tail instead
                pv = None
        except Exception as e:
            # quadrature failure is survivable (mod-Liu takes over below),
            # but never silently
            import logging

            logging.getLogger("cellregmap_tpu").warning(
                "Imhof fallback failed for q=%g (%s: %s); using mod-Liu",
                q, type(e).__name__, e)
            pv = None
    if pv is None or not (0.0 <= pv <= 1.0):
        pv = float(np.asarray(liu_sf(q, jnp.asarray(lam))[0]))
        info["method"] = "liu"
        info["is_converged"] = False
    if pv <= 0.0:
        pv = float(np.asarray(liu_sf(q, jnp.asarray(lam))[0]))
        info["method"] = "liu"
    return (float(pv), info) if return_info else float(pv)


def davies_pvalue_batch(qs, lambda_rows, lim=20_000_000, acc=1e-8,
                        lambda_filter_ratio=1e5, n_threads=0):
    """Batched host-side Davies over many (q, lambda-spectrum) problems.

    Runs the native threaded batch entry point.  ``lambda_rows`` is (S, C)
    with zero padding allowed.
    """
    from ..utils.native import get_qfc

    qs = np.asarray(qs, float)
    lam = np.asarray(lambda_rows, float)
    pv = get_qfc().davies_batch(lam, qs, lim, acc, lambda_filter_ratio,
                                n_threads)
    # deep-tail refinement (see davies_pvalue): results below ~1e4*acc
    # (including exact 0 from integral cancellation) carry large RELATIVE
    # error at the batch's absolute accuracy; re-run those few through the
    # scalar ladder, which scales acc to the result
    refine = np.nonzero((pv >= 0.0) & (pv < acc * 1e4))[0]
    for i in refine:
        pv[i] = davies_pvalue(qs[i], lambdas=lam[i], lim=lim, acc=acc,
                              lambda_filter_ratio=lambda_filter_ratio)
    return pv


def score_statistic_liu_params(q, weights):
    """Modified-Liu parameters + p-value (reference _math.py:163-180)."""
    pv, dof_x, ncp_x, mu_q, sigma_q = liu_sf(jnp.asarray(q),
                                             jnp.asarray(weights))
    return {
        "pv": float(pv),
        "mu_q": float(mu_q),
        "sigma_q": float(sigma_q),
        "dof_x": float(dof_x),
    }


def qmin(liu_params):
    """SKAT-O style per-rho quantile combination (reference _math.py:183-201)."""
    from scipy.stats import chi2 as _chi2

    n = len(liu_params)
    T = min(p["pv"] for p in liu_params)
    out = np.zeros(n)
    percentile = 1 - T
    for i in range(n):
        qv = _chi2.ppf(percentile, liu_params[i]["dof_x"])
        mu_q = liu_params[i]["mu_q"]
        sigma_q = liu_params[i]["sigma_q"]
        dof = liu_params[i]["dof_x"]
        out[i] = (qv - dof) / (2 * dof) ** 0.5 * sigma_q + mu_q
    return out


# --------------------------------------------------------------------------
# LRT p-values (reference _cellregmap.py:443-469)
# --------------------------------------------------------------------------
def lrt_pvalues(null_lml, alt_lmls, dof=1, clip_lo=1e-300,
                clip_hi=1.0 - 1.1e-16):
    """Likelihood-ratio-test p-values: chi2(dof).sf(2 (alt - null)), clipped."""
    from scipy.stats import chi2 as _chi2

    lrs = np.clip(
        -2 * np.asarray(null_lml, float) + 2 * np.asarray(alt_lmls, float),
        1e-300, np.inf
    )
    pv = _chi2(df=dof).sf(lrs)
    return np.clip(pv, clip_lo, clip_hi)
