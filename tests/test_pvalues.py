"""P-value ladder: Liu, saddlepoint, native Davies, exact cross-validation.

Exactness argument (three independent sources of truth):
1. closed-form chi-square reductions (all-equal eigenvalue mixtures),
2. a semi-exact 1-D integral for [b, a, a] spectra,
3. SciPy Imhof quadrature in its reliable regime (bulk, >=3 distinct
   eigenvalues).
The native C++ Davies implementation must agree with each to the requested
absolute accuracy.
"""
import numpy as np
import jax.numpy as jnp
import pytest
from numpy.testing import assert_allclose
from scipy.stats import chi2

from cellregmap_tpu import oracle
from cellregmap_tpu.models.pvalues import (
    davies_pvalue,
    davies_pvalue_batch,
    liu_sf,
    lrt_pvalues,
    saddlepoint_sf,
)
from cellregmap_tpu.utils.native import get_qfc


def _random_spectra(rng, n_cases, max_c=6):
    cases = []
    for _ in range(n_cases):
        c = rng.integers(1, max_c + 1)
        lam = np.abs(rng.normal(size=c)) * 10.0 ** rng.integers(-3, 2)
        mean = lam.sum()
        q = mean * 10.0 ** rng.uniform(-1.0, 1.2)
        cases.append((q, np.sort(lam)[::-1]))
    return cases


def _semi_exact_baa(q, b, a):
    """P(b X + a Y > q), X ~ chi2_1, Y ~ chi2_2 (so P(Y > t) = e^{-t/2})."""
    from scipy.integrate import quad

    def f(x):
        return chi2.pdf(x, 1) * (
            1.0 if b * x >= q else np.exp(-(q - b * x) / (2 * a))
        )

    cut = q / b
    v1, _ = quad(f, 0, cut, epsabs=1e-15, epsrel=1e-13, limit=500)
    v2 = chi2.sf(cut, 1)
    return v1 + v2


def test_liu_matches_oracle():
    rng = np.random.default_rng(0)
    for q, lam in _random_spectra(rng, 50):
        ref = oracle.liu_sf(q, lam)[0]
        got = float(liu_sf(jnp.asarray(q), jnp.asarray(lam))[0])
        assert_allclose(got, ref, rtol=1e-10, atol=1e-300)


def test_liu_golden_moments():
    """mu_q / sigma_q / dof golden values from reference test_math.py:76-83."""
    lam = np.array([4.55266277e-09, 3.46249449e-01])
    pv, dof_x, ncp_x, mu_q, sigma_q = liu_sf(jnp.asarray(0.4996101707),
                                             jnp.asarray(lam))
    assert_allclose(float(mu_q), 0.34624945394475326, rtol=1e-8)
    assert_allclose(float(sigma_q), 0.48967066729451103, rtol=1e-8)
    assert_allclose(float(dof_x), 1.0, rtol=1e-6)
    assert_allclose(float(pv), 0.22966744652848403, rtol=1e-6)


@pytest.mark.skipif(get_qfc() is None, reason="native qfc unavailable")
def test_davies_reducible_exact():
    """All-equal mixtures reduce to scaled chi2_C: closed-form truth across
    the full range including far tails."""
    lib = get_qfc()
    worst = 0.0
    for C in [1, 2, 3, 6]:
        for a in [0.001, 0.35, 7.0]:
            for fq in [0.05, 0.5, 1.0, 3.0, 8.0, 20.0, 40.0]:
                q = a * C * fq
                exact = chi2.sf(q / a, C)
                pv, ifault = lib.davies(np.full(C, a), q, 20_000_000, 1e-10)
                assert ifault == 0, (C, a, fq, ifault)
                worst = max(worst, abs(pv - exact))
    assert worst < 1e-9, worst


@pytest.mark.skipif(get_qfc() is None, reason="native qfc unavailable")
def test_davies_semi_exact_three_weights():
    """[b, a, a] spectra exercise the real series + aux convolution path."""
    lib = get_qfc()
    worst = 0.0
    for (b, a) in [(2.0, 0.5), (0.9, 0.3), (10.0, 0.01), (1.0, 0.9999)]:
        for fq in [0.05, 0.3, 1.0, 4.0, 12.0, 30.0]:
            q = (b + 2 * a) * fq
            exact = _semi_exact_baa(q, b, a)
            pv, ifault = lib.davies(np.array([b, a, a]), q, 20_000_000, 1e-9)
            assert ifault == 0, (b, a, fq, ifault)
            worst = max(worst, abs(pv - exact))
    assert worst < 5e-9, worst


@pytest.mark.skipif(get_qfc() is None, reason="native qfc unavailable")
def test_davies_extreme_tail_relative():
    """Genome-wide-significance battery: RELATIVE
    accuracy of the native Davies path in the p < 1e-10 regime, where the
    earlier absolute-tolerance pins are vacuous.

    Three legs:
    1. closed-form reducible mixtures down to p = 1e-30: relative error
       must be at machine level (measured ~1e-14);
    2. the [b, a, a] semi-exact integral down to p ~ 1e-12 (the quadrature
       oracle's own reliable floor);
    3. self-consistency: on random spectra, acc=1e-8 and acc=1e-13 runs
       must agree RELATIVELY in the tail — the truncation/aliasing bounds
       scale with the result, not the absolute target.
    """
    lib = get_qfc()
    # --- leg 1: scaled-chi2 closed form, far tail -----------------------
    worst = 0.0
    for C in [1, 2, 3, 6, 10]:
        for a in [0.02, 1.0, 7.0]:
            for target in [1e-10, 1e-12, 1e-16, 1e-22, 1e-30]:
                q = a * chi2.isf(target, C)
                pv, ifault = lib.davies(np.full(C, a), q, 20_000_000, 1e-10)
                assert ifault == 0, (C, a, target, ifault)
                worst = max(worst, abs(pv / target - 1.0))
    assert worst < 1e-10, worst

    # --- leg 2: [b, a, a] semi-exact, tail ------------------------------
    worst = 0.0
    for (b, a) in [(2.0, 0.5), (0.9, 0.3), (5.0, 0.05)]:
        for fq in [60.0, 110.0, 180.0]:
            q = (b + 2 * a) * fq
            exact = _semi_exact_baa(q, b, a)
            if not 1e-13 < exact < 1e-8:
                continue
            pv, ifault = lib.davies(np.array([b, a, a]), q, 20_000_000,
                                    1e-12)
            assert ifault == 0, (b, a, fq)
            worst = max(worst, abs(pv / exact - 1.0))
    assert worst < 1e-6, worst

    # --- leg 3: the PRODUCTION ladder (davies_pvalue, default acc=1e-8)
    # on random spectra in the operative genome-wide regime
    # p in [1e-14, 1e-10].  Davies' acc is ABSOLUTE, so the raw call is
    # ~50% off at p ~ 1e-13; davies_pvalue's deep-tail refinement re-runs
    # at an acc proportional to the result.  Truth = a raw acc=1e-13 run.
    # (Below the ~1e-15 f64 cancellation floor irreducible spectra degrade
    # to mod-Liu; reducible mixtures stay machine-exact to 1e-30, leg 1.)
    rng = np.random.default_rng(17)
    n_checked = 0
    worst = 0.0
    batch_q, batch_lam, batch_ref = [], [], []
    for _ in range(40):
        c = int(rng.integers(2, 7))
        lam = np.sort(np.abs(rng.normal(size=c)))[::-1] + 0.01
        # walk q up until the tail lands inside [1e-14, 1e-10]
        q = lam.sum() * 5.0
        pv8 = if8 = None
        for _step in range(200):
            pv8, if8 = lib.davies(lam, q, 20_000_000, 1e-8)
            if if8 != 0 or pv8 < 1e-14:
                break
            if pv8 < 1e-10:
                break
            q *= 1.15
        if if8 != 0 or not 0.0 <= pv8 < 1e-10:
            continue
        pv13, if13 = lib.davies(lam, q, 50_000_000, 1e-13)
        if if13 != 0 or not 0.0 < pv13:
            continue
        got = davies_pvalue(q, lambdas=lam, acc=1e-8)
        worst = max(worst, abs(got / pv13 - 1.0))
        n_checked += 1
        batch_q.append(q)
        batch_lam.append(lam)
        batch_ref.append(pv13)
    assert n_checked >= 20, n_checked
    # the acc=1e-13 comparator itself carries ~1e-13/pv relative
    # uncertainty (~7e-3 at pv ~ 1.4e-11), so 1e-2 is the resolvable bound;
    # without refinement the production ladder measured 0.497 here
    assert worst < 1e-2, worst

    # batch path refines its tail entries the same way
    C = max(len(l) for l in batch_lam)
    lam_rows = np.zeros((len(batch_q), C))
    for i, l in enumerate(batch_lam):
        lam_rows[i, : len(l)] = l
    got_b = davies_pvalue_batch(np.asarray(batch_q), lam_rows, acc=1e-8)
    rel_b = np.abs(got_b / np.asarray(batch_ref) - 1.0)
    assert rel_b.max() < 1e-2, rel_b.max()


@pytest.mark.skipif(get_qfc() is None, reason="native qfc unavailable")
def test_davies_vs_imhof_bulk():
    """Random spectra, Imhof's reliable regime (pv in [1e-6, 1-1e-6],
    >=3 distinct weights): agreement at the requested accuracy."""
    rng = np.random.default_rng(1)
    lib = get_qfc()
    worst = 0.0
    n_checked = 0
    for q, lam in _random_spectra(rng, 120):
        if len(np.unique(lam)) < 3:
            continue
        ref = oracle.imhof_sf(q, lam)
        if not (1e-6 < ref < 1 - 1e-6):
            continue
        pv, ifault = lib.davies(lam, q, 20_000_000, 1e-8)
        assert ifault == 0, (q, lam)
        worst = max(worst, abs(pv - ref))
        n_checked += 1
    assert n_checked > 30
    # 1e-6 sanity band: the quadrature oracle itself carries ~1e-7 error on
    # clustered spectra; the tight exactness claims are the closed-form tests
    assert worst < 1e-6, worst


@pytest.mark.skipif(get_qfc() is None, reason="native qfc unavailable")
def test_davies_batch_matches_single():
    rng = np.random.default_rng(2)
    cases = _random_spectra(rng, 48, max_c=4)
    C = 4
    lam_rows = np.zeros((len(cases), C))
    qs = np.zeros(len(cases))
    for i, (q, lam) in enumerate(cases):
        lam_rows[i, : len(lam)] = lam
        qs[i] = q
    got = davies_pvalue_batch(qs, lam_rows, acc=1e-8)
    for i, (q, lam) in enumerate(cases):
        ref = davies_pvalue(q, lambdas=lam, acc=1e-8)
        assert_allclose(got[i], ref, atol=1e-8)


def test_saddlepoint_accuracy():
    """Saddlepoint within ~10% relative of exact across the tail."""
    rng = np.random.default_rng(3)
    lib = get_qfc()
    for q, lam in _random_spectra(rng, 30):
        if lib is not None:
            ref, ifault = lib.davies(lam, q, 20_000_000, 1e-9)
            if ifault != 0:
                continue
        else:
            ref = oracle.imhof_sf(q, lam)
        if ref < 1e-12 or ref > 1 - 1e-12:
            continue
        sp = float(saddlepoint_sf(jnp.asarray(q), jnp.asarray(lam)))
        assert abs(sp - ref) <= 0.10 * max(ref, 1e-10) + 1e-10, \
            (q, lam, sp, ref)


def test_saddlepoint_far_tail_relative():
    """Unlike Liu, the saddlepoint keeps relative accuracy deep in the tail
    (this is why it is the device-side refinement rung)."""
    lam = np.array([1.0, 0.6, 0.3, 0.1])
    for fq in [5.0, 10.0, 20.0]:
        q = lam.sum() * fq
        ref = oracle.imhof_sf(q, lam)
        lib = get_qfc()
        if lib is not None:
            ref, ifault = lib.davies(lam, q, 20_000_000, 1e-12)
            assert ifault == 0
        if ref <= 0:
            continue
        sp = float(saddlepoint_sf(jnp.asarray(q), jnp.asarray(lam)))
        assert abs(np.log(sp) - np.log(ref)) < 0.1, (fq, sp, ref)


def test_davies_pvalue_weight_matrix_path():
    rng = np.random.default_rng(4)
    A = rng.normal(size=(5, 5))
    Wmat = A @ A.T / 10
    lam = np.linalg.eigvalsh(Wmat)
    q = lam.sum() * 0.8
    pv = davies_pvalue(q, weight_matrix=Wmat)
    ref = oracle.imhof_sf(q, lam[lam > 0])
    assert_allclose(pv, ref, atol=1e-7)


def test_lrt_pvalues():
    pv = lrt_pvalues(-10.0, np.array([-9.0, -10.0, -5.0]), dof=1)
    assert_allclose(pv[0], chi2.sf(2.0, 1), rtol=1e-12)
    assert pv[1] <= 1.0
    assert_allclose(pv[2], chi2.sf(10.0, 1), rtol=1e-12)
    # clipping
    pv = lrt_pvalues(0.0, np.array([1000.0]), dof=1)
    assert pv[0] >= 1e-300
