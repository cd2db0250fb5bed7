"""Batched profiled linear-mixed-model fitter (JAX, jittable, vmappable).

Batched replacement for glimix-core's ``LMM`` / ``FastScanner`` (consumed
by the reference at /root/reference/cellregmap/_cellregmap.py:175,223,254,
274,292,308,351).  The model is

    y ~ N(X beta, s * ((1 - delta) Sigma + delta I)),

with ``v0 = s (1 - delta)`` (coefficient of Sigma) and ``v1 = s delta``
(noise), matching glimix-core's conventions.  beta and s are profiled out in
closed form (GLS in the eigenbasis of Sigma), leaving a smooth 1-D objective
over delta that we maximize with a coarse logit-grid followed by a
fixed-iteration golden-section refinement (and, for the eig backend, a
Newton polish on the analytic derivative) — branch-free, static-shape, and
therefore vmappable over thousands of (variant, rho) problems in one XLA
program, instead of the reference's serial per-fit Brent searches.

Two covariance backends:

* **eig** — Sigma given by eigenvalues S plus rotated data.  Used by the
  interaction/association scans where Sigma(rho) is pre-factorized once.
* **woodbury** — Sigma(rho) = rho A A^T + (1-rho) U Lam U^T with a per-variant
  low-rank A (the g (.) E factor).  Used by ``estimate_betas``; avoids the
  reference's per-SNP x per-rho thin SVDs (_cellregmap.py:160-176) entirely
  via the Woodbury identity and the matrix determinant lemma.

Rank padding: zero eigenvalues are inert (a direction with S_i = 0 enters
every formula exactly like the orthogonal complement), so all shapes are
static and no masking is needed.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops.linalg import full_f32_matmuls

_INVPHI = 0.6180339887498949
_INVPHI2 = 0.3819660112501051



class FitResult(NamedTuple):
    lml: jax.Array
    delta: jax.Array
    beta: jax.Array
    scale: jax.Array
    v0: jax.Array
    v1: jax.Array
    rss: jax.Array


def _lml_from_normal_eqs(A, b, yDy, logdet_d, logdet_xx, n, p, restricted):
    """Shared tail: GLS solve + profiled scale + (restricted) lml.

    A is the symmetric PSD GLS normal matrix; ridge-Cholesky pseudo-solve
    for robustness to collinear fixed effects (the reference's lstsq
    semantics; see ops/linalg.py).
    """
    from ..ops.linalg import sym_pseudo_solve_and_logdet

    beta, logdet_a = sym_pseudo_solve_and_logdet(A, b)
    rss = jnp.maximum(yDy - b @ beta, jnp.finfo(b.dtype).tiny)
    if restricted:
        nu = n - p
        scale = rss / nu
        lml = -0.5 * (
            nu * jnp.log(2 * jnp.pi * scale)
            + logdet_d
            + logdet_a
            - logdet_xx
            + nu
        )
    else:
        scale = rss / n
        lml = -0.5 * (n * jnp.log(2 * jnp.pi * scale) + logdet_d + n)
    return lml, beta, scale, rss


# --------------------------------------------------------------------------
# eig backend
# --------------------------------------------------------------------------
class EigData(NamedTuple):
    """Per-problem data for the eig backend.

    S:    (r,) eigenvalues of Sigma (zeros = padding, inert).
    Xt:   (r, p) rotated covariates Q^T X.
    yt:   (r,) rotated phenotype Q^T y.
    Cxx:  (p, p) complement Gram X^T X - Xt^T Xt.
    cxy:  (p,)   complement X^T y - Xt^T yt.
    cyy:  ()     complement y^T y - yt^T yt.
    """

    S: jax.Array
    Xt: jax.Array
    yt: jax.Array
    Cxx: jax.Array
    cxy: jax.Array
    cyy: jax.Array


def eig_data(S, Q, X, y):
    """Build :class:`EigData` from an explicit basis Q (n x r)."""
    Xt = Q.T @ X
    yt = Q.T @ y
    return EigData(
        S=S,
        Xt=Xt,
        yt=yt,
        Cxx=X.T @ X - Xt.T @ Xt,
        cxy=X.T @ y - Xt.T @ yt,
        cyy=y @ y - yt @ yt,
    )


def lml_at_delta_eig(delta, data: EigData, n: int, restricted: bool,
                     logdet_xx=None):
    S, Xt, yt, Cxx, cxy, cyy = data
    r = S.shape[0]
    p = Xt.shape[1]
    d = (1 - delta) * S + delta
    w = 1.0 / d
    A = Xt.T @ (Xt * w[:, None]) + Cxx / delta
    b = Xt.T @ (yt * w) + cxy / delta
    yDy = jnp.sum(yt * yt * w) + cyy / delta
    logdet_d = jnp.sum(jnp.log(d)) + (n - r) * jnp.log(delta)
    if restricted and logdet_xx is None:
        # delta-independent; callers on the hot path precompute it once
        from ..ops.linalg import sym_pseudo_logdet

        logdet_xx = sym_pseudo_logdet(Xt.T @ Xt + Cxx)
    elif not restricted:
        logdet_xx = 0.0
    return _lml_from_normal_eqs(A, b, yDy, logdet_d, logdet_xx, n, p, restricted)


# --------------------------------------------------------------------------
# woodbury backend
# --------------------------------------------------------------------------
class WoodburyData(NamedTuple):
    """Per-problem data for Sigma(rho) = rho A A^T + (1-rho) U Lam U^T.

    Lam: (rB,) eigenvalues of the fixed background part (zeros inert).
    Ua:  (rB, C) U^T A.
    Ux:  (rB, p) U^T X.
    uy:  (rB,)   U^T y.
    Aa:  (C, C) A^T A;  Ax: (C, p) A^T X;  ay: (C,) A^T y.
    xx:  (p, p) X^T X;  xy: (p,) X^T y;  yy: () y^T y.
    rho: () mixing weight.
    """

    Lam: jax.Array
    Ua: jax.Array
    Ux: jax.Array
    uy: jax.Array
    Aa: jax.Array
    Ax: jax.Array
    ay: jax.Array
    xx: jax.Array
    xy: jax.Array
    yy: jax.Array
    rho: jax.Array


def lml_at_delta_woodbury(delta, data: WoodburyData, n: int, restricted: bool,
                          logdet_xx=None):
    Lam, Ua, Ux, uy, Aa, Ax, ay, xx, xy, yy, rho = data
    rB = Lam.shape[0]
    p = Ux.shape[1]
    C = Ua.shape[1]
    c = (1 - delta) * rho
    m = (1 - delta) * (1 - rho) * Lam + delta
    wm = 1.0 / m

    def minner(Pu, Pv, uv):
        """u^T M^{-1} v with M = U diag(m) U^T + delta (I - U U^T)."""
        return Pu.T @ (Pv * wm[:, None] if Pv.ndim == 2 else Pv * wm) + (
            uv - Pu.T @ Pv
        ) / delta

    H = minner(Ua, Ua, Aa)
    hX = minner(Ua, Ux, Ax)
    hy = minner(Ua, uy, ay)
    XmX = minner(Ux, Ux, xx)
    Xmy = minner(Ux, uy, xy)
    ymy = minner(uy, uy, yy)

    cap = jnp.eye(C, dtype=H.dtype) + c * H
    cap_chol = jnp.linalg.cholesky(cap)
    solve_cap = lambda B: jax.scipy.linalg.cho_solve((cap_chol, True), B)

    A = XmX - c * hX.T @ solve_cap(hX)
    b = Xmy - c * hX.T @ solve_cap(hy)
    yDy = ymy - c * hy @ solve_cap(hy)
    logdet_d = (
        jnp.sum(jnp.log(m))
        + (n - rB) * jnp.log(delta)
        + 2 * jnp.sum(jnp.log(jnp.diagonal(cap_chol)))
    )
    if restricted and logdet_xx is None:
        from ..ops.linalg import sym_pseudo_logdet

        logdet_xx = sym_pseudo_logdet(xx)
    elif not restricted:
        logdet_xx = 0.0
    return _lml_from_normal_eqs(A, b, yDy, logdet_d, logdet_xx, n, p, restricted)


# --------------------------------------------------------------------------
# Golden-section 1-D maximization over logit(delta)
# --------------------------------------------------------------------------
def _golden(lml_fn, a, b, n_iters):
    """Golden-section maximization of lml_fn(sigmoid(x)) on [a, b]."""
    h = b - a
    x1 = a + _INVPHI2 * h
    x2 = a + _INVPHI * h
    f1 = lml_fn(jax.nn.sigmoid(x1))
    f2 = lml_fn(jax.nn.sigmoid(x2))

    def body(_, st):
        a, b, x1, x2, f1, f2 = st
        left = f1 > f2
        a2 = jnp.where(left, a, x1)
        b2 = jnp.where(left, x2, b)
        h = b2 - a2
        x1n = jnp.where(left, a2 + _INVPHI2 * h, x2)
        x2n = jnp.where(left, x1, a2 + _INVPHI * h)
        xe = jnp.where(left, x1n, x2n)
        fe = lml_fn(jax.nn.sigmoid(xe))
        f1n = jnp.where(left, fe, f2)
        f2n = jnp.where(left, f1, fe)
        return a2, b2, x1n, x2n, f1n, f2n

    a, b, x1, x2, f1, f2 = jax.lax.fori_loop(
        0, n_iters, body, (a, b, x1, x2, f1, f2)
    )
    xbest = jnp.where(f1 > f2, x1, x2)
    return jax.nn.sigmoid(xbest)


def _fit_delta(lml_fn, lo, hi, n_grid, n_iters, dtype):
    """Maximize ``lml_fn(delta)`` over delta = sigmoid(logit) in [lo, hi].

    Coarse grid argmax -> golden-section refinement with a fixed iteration
    count (branch-free; jit/vmap friendly).
    """
    grid = jnp.linspace(lo, hi, n_grid, dtype=dtype)
    vals = jax.vmap(lambda x: lml_fn(jax.nn.sigmoid(x)))(grid)
    k = jnp.argmax(vals)
    a = grid[jnp.maximum(k - 1, 0)]
    b = grid[jnp.minimum(k + 1, n_grid - 1)]
    return _golden(lml_fn, a, b, n_iters)


def delta_derivatives(delta, data: EigData, n: int, restricted: bool = True):
    """(dL/d delta, d2L/d delta2) of the profiled objective.

    Analytic derivatives of the REML (``restricted``) or ML lml (as in
    :func:`lml_at_delta_eig`) with respect to delta — the safeguarded-Newton
    refinements evaluate these instead of bracketing with many objective
    evaluations.  Validated against finite differences in tests/test_lmm.py.

    Notation: d_r = (1-delta) S_r + delta (eigencomponent weights; the
    complement has d = delta), e_r = d d_r / d delta = 1 - S_r.
    """
    S, Xt, yt, Cxx, cxy, cyy = data
    r = S.shape[0]
    p = Xt.shape[1]

    d = (1 - delta) * S + delta
    e = 1.0 - S
    w1 = 1.0 / d
    we2 = e * w1 * w1
    we3 = e * e * w1 * w1 * w1
    i1, i2, i3 = 1.0 / delta, 1.0 / delta**2, 1.0 / delta**3

    def quad(w, ic):
        A = Xt.T @ (Xt * w[:, None]) + Cxx * ic
        b = Xt.T @ (yt * w) + cxy * ic
        q = jnp.sum(yt * yt * w) + cyy * ic
        return A, b, q

    A1, b1, q1 = quad(w1, i1)
    A2, b2, q2 = quad(we2, i2)
    A3, b3, q3 = quad(we3, i3)

    from ..ops.linalg import sym_pseudo_solve

    beta = sym_pseudo_solve(A1, b1)
    rss = jnp.maximum(q1 - b1 @ beta, jnp.finfo(yt.dtype).tiny)

    # A' = -A2, A'' = 2 A3, b' = -b2, b'' = 2 b3, q' = -q2, q'' = 2 q3
    beta_p = sym_pseudo_solve(A1, -b2 + A2 @ beta)
    rss_p = -q2 + 2 * (b2 @ beta) - beta @ (A2 @ beta)
    rss_pp = (2 * q3 - 4 * (b3 @ beta) + 2 * (b2 @ beta_p)
              - 2 * beta @ (A2 @ beta_p) + 2 * beta @ (A3 @ beta))

    ld_d_p = jnp.sum(e * w1) + (n - r) * i1
    ld_d_pp = -jnp.sum(e * e * w1 * w1) - (n - r) * i2

    u = rss_p / rss
    if not restricted:
        # ML objective: no logdet(A) trace terms
        L_p = -0.5 * (n * u + ld_d_p)
        L_pp = -0.5 * (n * (rss_pp / rss - u * u) + ld_d_pp)
        return L_p, L_pp

    nu = n - p
    T2 = sym_pseudo_solve(A1, A2)
    T3 = sym_pseudo_solve(A1, A3)
    tr_T2 = jnp.trace(T2)
    tr_T3 = jnp.trace(T3)
    tr_T2sq = jnp.sum(T2 * T2.T)

    L_p = -0.5 * (nu * u + ld_d_p - tr_T2)
    L_pp = -0.5 * (nu * (rss_pp / rss - u * u) + ld_d_pp
                   + 2 * tr_T3 - tr_T2sq)
    return L_p, L_pp


def fit_delta_eig_bracketed(data: EigData, n: int, restricted: bool,
                            lo_b, hi_b, n_iters, logdet_xx) -> FitResult:
    """Golden-section fit within a per-problem bracket (traced bounds).

    The scan engine computes the coarse delta grid as snp-shared batched
    GEMMs (engine.interaction_batch) and hands each (variant, rho) problem
    its bracket; this refines it without re-evaluating a grid per problem.
    """
    lml_only = lambda delta: lml_at_delta_eig(delta, data, n, restricted,
                                              logdet_xx)[0]
    delta = _golden(lml_only, lo_b, hi_b, n_iters)
    lml, beta, scale, rss = lml_at_delta_eig(delta, data, n, restricted,
                                             logdet_xx)
    return FitResult(
        lml=lml, delta=delta, beta=beta, scale=scale,
        v0=scale * (1 - delta), v1=scale * delta, rss=rss,
    )


def _newton_polish(deriv_fn, delta, lo, hi, n_steps=3, max_step=1e-2):
    """Safeguarded Newton steps in logit space from a golden-section optimum.

    Golden section stops where the objective's rounding noise hides its
    slope: at n ~ 1e4 cells that leaves delta uncertain at ~1e-8 relative,
    which moves an LRT p-value computed at this delta by ~1e-8 between
    two summation orders (two backends, or a permutation of the cells).
    Newton on the analytic derivative settles on the derivative's root
    instead.  A step is taken only where the objective is concave there,
    the step is small and finite; the iterate stays within [lo, hi].
    """
    def step(_, x):
        d = jax.nn.sigmoid(x)
        lp, lpp = deriv_fn(d)
        g = d * (1 - d)
        x_p = lp * g
        x_pp = lpp * g * g + lp * g * (1 - 2 * d)
        dx = -x_p / x_pp
        ok = (x_pp < 0) & (jnp.abs(dx) <= max_step) & jnp.isfinite(dx)
        return jnp.clip(jnp.where(ok, x + dx, x), lo, hi)

    x = jnp.log(delta) - jnp.log1p(-delta)
    return jax.nn.sigmoid(jax.lax.fori_loop(0, n_steps, step, x))


def fit_delta_eig(data: EigData, n: int, restricted: bool,
                  lo=-18.0, hi=18.0, n_grid=64, n_iters=60) -> FitResult:
    """Full profiled fit with the eig backend: grid, golden section, then
    a Newton polish on the analytic derivative."""
    dtype = data.yt.dtype
    if restricted:
        from ..ops.linalg import sym_pseudo_logdet

        ld_xx = sym_pseudo_logdet(data.Xt.T @ data.Xt + data.Cxx)
    else:
        ld_xx = 0.0
    lml_only = lambda delta: lml_at_delta_eig(delta, data, n, restricted,
                                              ld_xx)[0]
    delta = _fit_delta(lml_only, lo, hi, n_grid, n_iters, dtype)
    delta = _newton_polish(
        lambda d: delta_derivatives(d, data, n, restricted), delta, lo, hi)
    lml, beta, scale, rss = lml_at_delta_eig(delta, data, n, restricted,
                                             ld_xx)
    return FitResult(
        lml=lml, delta=delta, beta=beta, scale=scale,
        v0=scale * (1 - delta), v1=scale * delta, rss=rss,
    )


def lml_grid_woodbury(logits, data: WoodburyData, n: int, restricted: bool,
                      logdet_xx, rcond: float = 1e-12):
    """lml at a VECTOR of logit(delta) grid points, memory-safe.

    vmapping :func:`lml_at_delta_woodbury` over the grid materializes
    (K, rB, C) weighted factors — tens of GB under a variant x rho vmap.
    Here every rB-axis contraction is one (K, rB) @ (rB, q^2) GEMM over
    grid-independent pair products, so the K axis never multiplies rB.
    """
    Lam, Ua, Ux, uy, Aa, Ax, ay, xx, xy, yy, rho = data
    rB = Lam.shape[0]
    p = Ux.shape[1]
    C = Ua.shape[1]
    deltas = jax.nn.sigmoid(logits)                      # (K,)
    cvec = (1 - deltas) * rho
    m = (1 - deltas)[:, None] * ((1 - rho) * Lam)[None] \
        + deltas[:, None]                                # (K, rB)
    wm = 1.0 / m
    i1 = 1.0 / deltas

    # stacked columns [A | X | y]: pair products once, GEMM per grid point
    cols = jnp.concatenate([Ua, Ux, uy[:, None]], axis=1)    # (rB, q)
    q = C + p + 1
    P = cols[:, :, None] * cols[:, None, :]                  # (rB, q, q)
    Gfull = jnp.block([
        [Aa, Ax, ay[:, None]],
        [Ax.T, xx, xy[:, None]],
        [ay[None, :], xy[None, :], jnp.asarray(yy)[None, None]],
    ])                                                       # (q, q)
    Pq = P.reshape(rB, q * q)
    red = (wm @ Pq).reshape(-1, q, q)                        # (K, q, q)
    comp = Gfull[None] - jnp.sum(P, axis=0)[None]            # (1, q, q)
    Mi = red + comp * i1[:, None, None]                      # all minner blocks

    H = Mi[:, :C, :C]
    hX = Mi[:, :C, C : C + p]
    hy = Mi[:, :C, -1]
    XmX = Mi[:, C : C + p, C : C + p]
    Xmy = Mi[:, C : C + p, -1]
    ymy = Mi[:, -1, -1]

    cap = jnp.eye(C, dtype=Mi.dtype)[None] + cvec[:, None, None] * H
    cap_chol = jnp.linalg.cholesky(cap)
    sc = lambda B: jax.scipy.linalg.cho_solve((cap_chol, True), B)
    hX_s = sc(hX)                                            # (K, C, p)
    hy_s = sc(hy[..., None])[..., 0]                         # (K, C)
    A = XmX - cvec[:, None, None] * jnp.einsum("kcp,kcq->kpq", hX, hX_s)
    b = Xmy - cvec[:, None] * jnp.einsum("kcp,kc->kp", hX, hy_s)
    yDy = ymy - cvec * jnp.einsum("kc,kc->k", hy, hy_s)
    logdet_d = (
        jnp.sum(jnp.log(m), axis=-1)
        + (n - rB) * jnp.log(deltas)
        + 2 * jnp.sum(jnp.log(
            jnp.diagonal(cap_chol, axis1=-2, axis2=-1)), axis=-1)
    )

    from ..ops.linalg import sym_pseudo_solve_and_logdet

    beta, logdet_a = sym_pseudo_solve_and_logdet(A, b[..., None], rcond=rcond)
    beta = beta[..., 0]
    rss_raw = yDy - jnp.einsum("kp,kp->k", b, beta)
    rss = jnp.maximum(rss_raw, jnp.finfo(b.dtype).tiny)
    if b.dtype == jnp.float32:
        # f32 localization round: a numerically-collapsed residual clamped
        # at tiny would otherwise become a huge finite lml that wins the
        # argmax and steers the bracket to garbage;
        # mask such degenerate grid points out of the argmax instead.
        collapsed = rss_raw <= 8 * jnp.finfo(jnp.float32).tiny
    else:
        collapsed = None
    if restricted:
        nu = n - p
        lml = -0.5 * (nu * jnp.log(2 * jnp.pi * rss / nu) + logdet_d
                      + logdet_a - logdet_xx + nu)
    else:
        lml = -0.5 * (n * jnp.log(2 * jnp.pi * rss / n) + logdet_d + n)
    if collapsed is not None:
        lml = jnp.where(collapsed, -jnp.inf, lml)
    return lml


def _family_eval_batch(logits, rho, colsS, compS, Lam, C, n, restricted,
                       logdet_xxS, rcond, want_beta=False):
    """lml (and optionally beta/rss) at per-variant (logit, rho) points.

    ``logits``/``rho``: (S, L) paired points per variant.  ``colsS``:
    (S, rB, q) rotated columns [Ua | Ux | uy] per variant — independent of
    both rho and delta.  ``compS``: (S, q, q) complement Grams
    ``Gfull - cols^T cols``.

    Two-phase structure:

    1. The rB contraction runs as chunk-scanned batched GEMMs over weighted
       columns — the (S, chunk, rB, q) intermediate bounds memory (the
       (S, rB, q^2) pair-product tensor OOMed) —
       producing the (S, L, q, q) solve blocks, which ARE small enough to
       materialize.
    2. All small-matrix algebra (rank-C capacitance, normal equations)
       then runs ONCE over the full (S, L) batch as unrolled component
       Cholesky chains: elementwise ops on (S, L) arrays, no tiny (q, q)
       trailing axes, no batched triangular-solve launches per chunk.
    """
    S_, rB, q = colsS.shape
    L = logits.shape[1]
    p = q - C - 1
    dt = colsS.dtype

    # chunk size: keep the (S, chunk, rB, q) weighted-columns intermediate
    # around ~256 MB
    itemsize = 4 if dt == jnp.float32 else 8
    chunk = max(1, min(L, int(2.5e8 / max(S_ * rB * q * itemsize, 1))))
    Lpad = -(-L // chunk) * chunk
    pad = Lpad - L
    if pad:
        logits = jnp.concatenate(
            [logits, jnp.broadcast_to(logits[:, -1:], (S_, pad))], axis=1)
        rho = jnp.concatenate(
            [rho, jnp.broadcast_to(rho[:, -1:], (S_, pad))], axis=1)

    dl_all = jax.nn.sigmoid(logits)                      # (S, Lpad)
    cvec_all = (1 - dl_all) * rho
    i1_all = 1.0 / dl_all

    def mi_body(_, idx):
        dl = jax.lax.dynamic_slice_in_dim(dl_all, idx, chunk, axis=1)
        rh = jax.lax.dynamic_slice_in_dim(rho, idx, chunk, axis=1)
        m = (1 - dl)[..., None] * ((1 - rh)[..., None] * Lam) \
            + dl[..., None]                              # (S, c, rB)
        wm = 1.0 / m
        wc = colsS[:, None, :, :] * wm[..., None]        # (S, c, rB, q)
        Mi = jnp.einsum("scrm,srn->scmn", wc, colsS)
        return None, (Mi, jnp.sum(jnp.log(m), axis=-1))

    idxs = jnp.arange(0, Lpad, chunk)
    _, (Mi, logm) = jax.lax.scan(mi_body, None, idxs)
    # scan stacks leading: (nchunk, S, c, ...) -> (S, Lpad, ...)
    Mi = jnp.moveaxis(Mi, 0, 1).reshape(S_, Lpad, q, q)
    logm = jnp.moveaxis(logm, 0, 1).reshape(S_, Lpad)
    Mi = Mi + compS[:, None] * i1_all[..., None, None]

    cvec, i1, dl = cvec_all, i1_all, dl_all

    if want_beta:
        # beta extraction (only the final, nrho-point evaluation) uses the
        # Schur-complement matrix path
        lml, beta_c_mat, rss_raw = _family_blocks_matrix(
            Mi, logm, cvec, i1, dl, Lam, C, p, q, n, restricted,
            logdet_xxS, rcond, dt)
        rss = jnp.maximum(rss_raw, jnp.finfo(dt).tiny)
        return lml[:, :L], beta_c_mat[:, :L], rss[:, :L]

    # lml-only (the zoom rounds, the hot path): ONE batched Cholesky of
    # the bordered Gram
    #
    #   J = [[I + cvec H,  s hX,  s hy ],      s = sqrt(cvec)
    #        [s hX^T,      XmX,   Xmy  ],
    #        [s hy^T,      Xmy^T, ymy  ]]
    #
    # whose pivots give everything the lml needs with NO solves at all:
    # prod of the first C pivots^2 = det(cap), the next p
    # = det(XmX - cvec hX^T cap^{-1} hX) (the GLS normal matrix), and the
    # last pivot^2 = the GLS residual rss (the classic augmented-Gram
    # identity).  J = Mi * (w w^T) + diag([1]*C + [0]*(p+1)) with
    # w = [s..s, 1..1].  One native batched Cholesky replaces the previous
    # capacitance-chol + multi-RHS triangular solves + normal-matrix chol
    # (the solves dominated runtime); hand-rolled fori/unrolled
    # factorizations of the bordered Gram compiled very slowly.
    from ..ops.linalg import _ridge

    s_b = jnp.sqrt(cvec)
    w = jnp.concatenate([
        jnp.broadcast_to(s_b[..., None], s_b.shape + (C,)),
        jnp.ones(s_b.shape + (p + 1,), dt),
    ], axis=-1)                                          # (S, Lpad, q)
    diagC = jnp.concatenate([jnp.ones(C, dt), jnp.zeros(p + 1, dt)])
    J = Mi * (w[..., :, None] * w[..., None, :]) + jnp.diag(diagC)
    # no ridge in f32: the diagonal spans ~1 (cap block) to ~n (y Gram), so
    # a max-diag-relative ridge would perturb the cap block at the 1e-3
    # level; marginally non-PD f32 points produce NaN pivots and are
    # masked to -inf below instead
    JL = jnp.linalg.cholesky(J if dt == jnp.float32 else _ridge(J, rcond))
    pivots = jnp.diagonal(JL, axis1=-2, axis2=-1)        # (S, Lpad, q)
    logdet_cap = 2.0 * jnp.sum(jnp.log(pivots[..., :C]), axis=-1)
    logdet_a = 2.0 * jnp.sum(jnp.log(pivots[..., C:-1]), axis=-1)
    rss_raw = pivots[..., -1] ** 2
    rss = jnp.maximum(rss_raw, jnp.finfo(dt).tiny)
    logdet_d = logm + (n - rB) * jnp.log(dl) + logdet_cap
    if restricted:
        nu = n - p
        lml = -0.5 * (nu * jnp.log(2 * jnp.pi * rss / nu) + logdet_d
                      + logdet_a - logdet_xxS[:, None] + nu)
    else:
        lml = -0.5 * (n * jnp.log(2 * jnp.pi * rss / n) + logdet_d + n)
    if dt == jnp.float32:
        # mask collapsed residuals / non-finite values out of the argmax
        bad = (rss_raw <= 8 * jnp.finfo(jnp.float32).tiny) \
            | ~jnp.isfinite(lml)
        lml = jnp.where(bad, -jnp.inf, lml)
    return lml[:, :L]


def _family_blocks_matrix(Mi, logm, cvec, i1, dl, Lam, C, p, q, n,
                          restricted, logdet_xxS, rcond, dt):
    """Matrix-form phase 2 of :func:`_family_eval_batch` (large C/p)."""
    H = Mi[..., :C, :C]
    hX = Mi[..., :C, C : C + p]
    hy = Mi[..., :C, -1]
    XmX = Mi[..., C : C + p, C : C + p]
    Xmy = Mi[..., C : C + p, -1]
    ymy = Mi[..., -1, -1]

    from ..ops.linalg import _ridge

    cap = jnp.eye(C, dtype=dt) + cvec[..., None, None] * H
    if dt == jnp.float32:
        cap = cap + 1e-6 * jnp.eye(C, dtype=dt)
    cap_chol = jnp.linalg.cholesky(cap)
    rhs = jnp.concatenate([hX, hy[..., None]], axis=-1)
    sol = jax.scipy.linalg.cho_solve((cap_chol, True), rhs)
    hX_s = sol[..., :p]
    hy_s = sol[..., p]
    A = XmX - cvec[..., None, None] * jnp.einsum("skcp,skcq->skpq",
                                                 hX, hX_s)
    b = Xmy - cvec[..., None] * jnp.einsum("skcp,skc->skp", hX, hy_s)
    yDy = ymy - cvec * jnp.einsum("skc,skc->sk", hy, hy_s)
    logdet_d = logm + (n - Lam.shape[0]) * jnp.log(dl) \
        + 2 * jnp.sum(jnp.log(
            jnp.diagonal(cap_chol, axis1=-2, axis2=-1)), axis=-1)

    A_chol = jnp.linalg.cholesky(_ridge(A, rcond))
    beta = jax.scipy.linalg.cho_solve((A_chol, True), b[..., None])[..., 0]
    logdet_a = 2 * jnp.sum(jnp.log(
        jnp.diagonal(A_chol, axis1=-2, axis2=-1)), axis=-1)
    rss_raw = yDy - jnp.einsum("skp,skp->sk", b, beta)
    rss = jnp.maximum(rss_raw, jnp.finfo(dt).tiny)
    if restricted:
        nu = n - p
        lml = -0.5 * (nu * jnp.log(2 * jnp.pi * rss / nu) + logdet_d
                      + logdet_a - logdet_xxS[:, None] + nu)
    else:
        lml = -0.5 * (n * jnp.log(2 * jnp.pi * rss / n) + logdet_d + n)
    if dt == jnp.float32:
        bad = (rss_raw <= 8 * jnp.finfo(jnp.float32).tiny) \
            | ~jnp.isfinite(lml)
        lml = jnp.where(bad, -jnp.inf, lml)
    return lml, beta, rss_raw


def fit_delta_woodbury_family(colsS, GfullS, Lam, rho_vec, n: int,
                              restricted: bool, C: int,
                              lo=-18.0, hi=18.0, n_grid=16,
                              localize_f32: bool = False):
    """Profiled fits for a whole (variant x rho) family in one program,
    returning the per-variant BEST-rho fit.

    ``colsS`` = [Ua | Ux | uy] (S, rB, q) rotated columns per variant;
    ``GfullS`` (S, q, q) full-space Grams of [A | X | y].  Returns
    per-variant arrays (lml, delta, beta (S, p), scale, v0, v1, rho1).

    Replaces the per-(variant, rho) :func:`fit_delta_woodbury` vmap in the
    betas kernel: every zoom round evaluates all (variant, rho, grid)
    points in one chunk-scanned batched GEMM family and one bordered-Gram
    Cholesky.  With ``localize_f32`` the rho
    family is PRUNED after the all-rho f32 screen+zooms: the f64 tail
    rounds and the final fit run only on each variant's top-2 rho — the
    f64 solve work drops ~5x.
    A rho outside the f32 top-2 can only win at an lml tie below the f32
    noise floor (the documented hybrid-localization semantics;
    tests/test_hybrid.py); exact-argmax runs use localize_f32=False,
    which keeps every rho in f64.
    """
    dtype = colsS.dtype
    S_, rB, q = colsS.shape
    nrho = rho_vec.shape[0]
    p = q - C - 1
    compS = GfullS - jnp.einsum("srm,srn->smn", colsS, colsS)
    if restricted:
        from ..ops.linalg import sym_pseudo_logdet

        ld_xx = sym_pseudo_logdet(GfullS[:, C : C + p, C : C + p])
    else:
        ld_xx = jnp.zeros((S_,), dtype)

    use32 = bool(localize_f32) and dtype == jnp.float64
    if use32:
        cols32 = colsS.astype(jnp.float32)
        comp32 = compS.astype(jnp.float32)
        Lam32 = Lam.astype(jnp.float32)
        ld32 = ld_xx.astype(jnp.float32)

    def family_vals(logits3d, rho2d, f32_round):
        """logits3d (S, nr, K), rho2d (S, nr) -> (S, nr, K) lmls."""
        nr, K = logits3d.shape[1:]
        flat = logits3d.reshape(S_, nr * K)
        rho_flat = jnp.repeat(rho2d, K, axis=-1)
        if f32_round:
            v = _family_eval_batch(
                flat.astype(jnp.float32), rho_flat.astype(jnp.float32),
                cols32, comp32, Lam32, C, n, restricted, ld32, rcond=1e-6)
            return v.reshape(S_, nr, K).astype(dtype)
        v = _family_eval_batch(flat, rho_flat, colsS, compS, Lam, C, n,
                               restricted, ld_xx, rcond=1e-12)
        return v.reshape(S_, nr, K)

    K2 = 16
    t = jnp.linspace(0.0, 1.0, K2, dtype=dtype)
    # localization only needs to BRACKET the optimum, so the coarse grid
    # and early zoom rounds run in f32 (each with a +-2-cell noise
    # margin).  Once a problem's lml spread across its round grid falls
    # below the f32 noise floor, further f32 argmaxes are noise and would
    # random-walk the bracket off the optimum — such rows FREEZE their
    # bracket and leave the remaining shrinkage to the f64 tail rounds
    # (plus the parabolic vertex and the final full fit).  Hybrid-vs-f64
    # equality is pinned in tests/test_hybrid.py.  Each precision's round
    # runs under ONE fori_loop (the first iteration over the full [lo, hi]
    # range IS the coarse grid) so its chunk-scanned evaluator body is
    # traced and compiled once, not once per round.

    def zoom_round(state, rho2d, f32_round, pad):
        a, bb, _, _, _ = state
        logits = a[..., None] + (bb - a)[..., None] * t  # (S, nr, K2)
        vals = family_vals(logits, rho2d, f32_round)
        kz = jnp.argmax(vals, axis=-1)
        cell = (bb - a) / (K2 - 1)
        center = a + cell * kz
        a_new = jnp.maximum(center - pad * cell, a)
        bb_new = jnp.minimum(center + pad * cell, bb)
        if f32_round:
            finite = jnp.isfinite(vals)
            vmax = jnp.max(jnp.where(finite, vals, -jnp.inf), axis=-1)
            vmin = jnp.min(jnp.where(finite, vals, jnp.inf), axis=-1)
            noise = 64 * jnp.finfo(jnp.float32).eps \
                * jnp.maximum(jnp.abs(vmax), 1.0)
            freeze = (~jnp.any(finite, axis=-1)) \
                | ((vmax - vmin) < noise)
            a_new = jnp.where(freeze, a, a_new)
            bb_new = jnp.where(freeze, bb, bb_new)
        return a_new, bb_new, logits, vals, kz

    def init_state(nr):
        shape = (S_, nr)
        return (jnp.full(shape, lo, dtype), jnp.full(shape, hi, dtype),
                jnp.zeros(shape + (K2,), dtype),
                jnp.zeros(shape + (K2,), dtype),
                jnp.zeros(shape, jnp.argmax(t).dtype))

    if use32:
        # f32 screen + zooms over ALL rho under ONE fori (one evaluator
        # trace, compiled once), then prune to each variant's top-2 rho for
        # the f64 tail
        rho_all = jnp.broadcast_to(rho_vec[None], (S_, nrho))
        stA = jax.lax.fori_loop(
            0, 5, lambda _, s: zoom_round(s, rho_all, True, 2.0),
            init_state(nrho))
        aA, bbA, _, valsA, _ = stA
        k2 = min(2, nrho)
        _, top2 = jax.lax.top_k(jnp.max(valsA, axis=-1), k2)
        g2 = lambda x: jnp.take_along_axis(x, top2, axis=1)
        rho_sel = g2(rho_all)
        st = (g2(aA), g2(bbA)) + init_state(k2)[2:]
        n_f64 = 3
    else:
        rho_sel = jnp.broadcast_to(rho_vec[None], (S_, nrho))
        st = init_state(nrho)
        n_f64 = 5
    st = jax.lax.fori_loop(
        0, n_f64, lambda _, s: zoom_round(s, rho_sel, False, 1.0), st)
    _, _, logits, vals, kz = st
    km = jnp.clip(kz, 1, K2 - 2)
    h = logits[..., 1] - logits[..., 0]                  # (S, nr)
    take = lambda idx: jnp.take_along_axis(vals, idx[..., None],
                                           axis=-1)[..., 0]
    f0, f1, f2 = take(km - 1), take(km), take(km + 1)
    denom = f0 - 2 * f1 + f2
    step = jnp.where(denom < 0, 0.5 * h * (f0 - f2) / denom, 0.0)
    x_star = jnp.take_along_axis(logits, km[..., None], axis=-1)[..., 0] \
        + jnp.clip(step, -h, h)                          # (S, nr)

    lml, beta, rss = _family_eval_batch(
        x_star, rho_sel, colsS, compS,
        Lam, C, n, restricted, ld_xx, rcond=1e-12, want_beta=True)
    delta = jax.nn.sigmoid(x_star)
    nu = (n - p) if restricted else n
    scale = rss / nu

    k = jnp.argmax(lml, axis=-1)                         # (S,)
    sel = lambda a: jnp.take_along_axis(
        a, k.reshape((S_, 1) + (1,) * (a.ndim - 2)), axis=1)[:, 0]
    lml_b = sel(lml)
    delta_b = sel(delta)
    beta_b = sel(beta)
    scale_b = sel(scale)
    rho1 = sel(rho_sel)
    return (lml_b, delta_b, beta_b, scale_b,
            scale_b * (1 - delta_b), scale_b * delta_b, rho1)


@full_f32_matmuls
def fit_delta_woodbury(data: WoodburyData, n: int, restricted: bool,
                       lo=-18.0, hi=18.0, n_grid=64, n_iters=60,
                       localize_f32: bool = False) -> FitResult:
    """Full profiled fit with the woodbury backend.

    With ``localize_f32`` the coarse grid and the first zoom round run in
    float32 (full float32 precision) — localization only needs to *bracket*
    the optimum, not resolve it — then the bracket is re-expanded
    by an extra cell (margin against f32 lml noise) and the remaining zoom
    rounds plus the final evaluation run in f64.  Same hybrid-precision
    scheme as engine.interaction_batch; equality vs the full-f64 path is
    pinned in tests/test_hybrid.py.
    """
    dtype = data.uy.dtype
    if restricted:
        from ..ops.linalg import sym_pseudo_logdet

        ld_xx = sym_pseudo_logdet(data.xx)
    else:
        ld_xx = 0.0

    use32 = bool(localize_f32) and dtype == jnp.float64
    if use32:
        data32 = WoodburyData(*[jnp.asarray(a, jnp.float32) for a in data])
        ld32 = jnp.asarray(ld_xx, jnp.float32)

    def grid_vals(logits, f32_round):
        if f32_round:
            # f32 ridge at 1e-6 (1e-12 is below f32 eps); -inf-guard any
            # NaN from a marginally non-PD f32 Cholesky so argmax ignores it
            v = lml_grid_woodbury(logits.astype(jnp.float32), data32, n,
                                  restricted, ld32, rcond=1e-6)
            return jnp.where(jnp.isfinite(v), v,
                             -jnp.inf).astype(dtype)
        return lml_grid_woodbury(logits, data, n, restricted, ld_xx)

    # coarse grid via the memory-safe batched evaluator, then zoom rounds
    # (each one batched GEMM pass, vs 60 *sequential* golden evals) and a
    # free parabolic-vertex polish on the final grid
    grid = jnp.linspace(lo, hi, n_grid, dtype=dtype)
    vals = grid_vals(grid, use32)
    k = jnp.argmax(vals)
    # +-2 cells in hybrid mode: an f32-noise-shifted coarse argmax one cell
    # off would otherwise exclude the true optimum from every later round
    kpad = 2 if use32 else 1
    a = grid[jnp.maximum(k - kpad, 0)]
    bb = grid[jnp.minimum(k + kpad, n_grid - 1)]
    if use32:
        # if every f32 grid value is non-finite (pathological f32 failure),
        # keep the full [lo, hi] bracket so the later f64 rounds degrade to
        # a plain f64 search instead of silently pinning the low edge
        all_bad = jnp.all(~jnp.isfinite(vals))
        a = jnp.where(all_bad, grid[0], a)
        bb = jnp.where(all_bad, grid[-1], bb)

    K2 = 16
    t = jnp.linspace(0.0, 1.0, K2, dtype=dtype)
    logits, kz = grid, k
    # one extra round in hybrid mode: the f32 round's noise margin (pad=2)
    # costs one bracket halving, recovered here so the final-bracket width
    # (hence the parabolic vertex's accuracy) matches the full-f64 path
    n_rounds = 5 if use32 else 4
    for r in range(n_rounds):  # bracket shrinks ~7.5x per round
        f32_round = use32 and r == 0
        logits = a + (bb - a) * t
        vals = grid_vals(logits, f32_round)
        kz = jnp.argmax(vals)
        cell = (bb - a) / (K2 - 1)
        center = a + cell * kz
        # +-2 cells after an f32 round: near the optimum f32 lml noise can
        # shift the argmax by a cell, and a noise-shrunk bracket that
        # excludes the true optimum would clamp every later f64 round
        pad = 2.0 if f32_round else 1.0
        a_new = jnp.maximum(center - pad * cell, a)
        bb_new = jnp.minimum(center + pad * cell, bb)
        if f32_round:
            # all-non-finite f32 round: keep the incoming bracket (see above)
            all_bad = jnp.all(~jnp.isfinite(vals))
            a_new = jnp.where(all_bad, a, a_new)
            bb_new = jnp.where(all_bad, bb, bb_new)
        a, bb = a_new, bb_new
    km = jnp.clip(kz, 1, K2 - 2)
    h = logits[1] - logits[0]
    f0, f1, f2 = vals[km - 1], vals[km], vals[km + 1]
    denom = f0 - 2 * f1 + f2
    step = jnp.where(denom < 0, 0.5 * h * (f0 - f2) / denom, 0.0)
    x_star = logits[km] + jnp.clip(step, -h, h)
    delta = jax.nn.sigmoid(x_star)
    lml, beta, scale, rss = lml_at_delta_woodbury(delta, data, n, restricted,
                                                  ld_xx)
    return FitResult(
        lml=lml, delta=delta, beta=beta, scale=scale,
        v0=scale * (1 - delta), v1=scale * delta, rss=rss,
    )


# --------------------------------------------------------------------------
# Fast scanner (closed-form per-variant alternative lmls)
# --------------------------------------------------------------------------
class FastScanResult(NamedTuple):
    lml: jax.Array        # (S,) alternative ML lmls
    effsizes_g: jax.Array  # (S,) candidate effect sizes
    effsizes_W: jax.Array  # (S, p) covariate effect sizes
    scale: jax.Array       # (S,) profiled scales


def fast_scan(delta, S, Wt, yt, CWW, cWy, cyy, Gt, CWG, cGy, cGG,
              n: int) -> FastScanResult:
    """Closed-form alternative-model lmls for all candidates at once.

    Equivalent of glimix-core ``FastScanner.fast_scan`` (consumed at
    _cellregmap.py:308-309): the null's delta is held fixed; per candidate g
    the fixed effects [W g] and the scale are re-profiled via a rank-1
    update of the GLS normal equations.  Fully batched over the S candidates.

    Parameters
    ----------
    delta: null model's variance ratio.
    S: (r,) eigenvalues;  Wt: (r, p);  yt: (r,).
    CWW/cWy/cyy: complement Grams of (W, y).
    Gt: (r, S) rotated candidates; CWG: (p, S) complement W^T G - Wt^T Gt;
    cGy: (S,) complement G^T y - Gt^T yt;  cGG: (S,) complement diag Gram.
    """
    d = (1 - delta) * S + delta
    w = 1.0 / d
    A = Wt.T @ (Wt * w[:, None]) + CWW / delta        # (p, p)
    bw = Wt.T @ (yt * w) + cWy / delta                # (p,)
    yy_w = jnp.sum(yt * yt * w) + cyy / delta

    U = Wt.T @ (Gt * w[:, None]) + CWG / delta        # (p, S)
    cgg = jnp.sum(Gt * Gt * w[:, None], axis=0) + cGG / delta   # (S,)
    cgy = yt * w @ Gt + cGy / delta                   # (S,)

    from ..ops.linalg import sym_pseudo_solve

    Ai_b = sym_pseudo_solve(A, bw)                              # (p,)
    Ai_U = sym_pseudo_solve(A, U)                               # (p, S)

    schur = cgg - jnp.sum(U * Ai_U, axis=0)                     # (S,)
    resid = cgy - bw @ Ai_U                                      # (S,)
    beta_g = resid / schur
    beta_W = Ai_b[:, None] - Ai_U * beta_g[None, :]             # (p, S)
    rss = jnp.maximum(
        yy_w - bw @ Ai_b - resid * resid / schur,
        jnp.finfo(yt.dtype).tiny,
    )
    r = S.shape[0]
    logdet_d = jnp.sum(jnp.log(d)) + (n - r) * jnp.log(delta)
    scale = rss / n
    lml = -0.5 * (n * jnp.log(2 * jnp.pi * scale) + logdet_d + n)
    return FastScanResult(
        lml=lml, effsizes_g=beta_g, effsizes_W=beta_W.T, scale=scale
    )
