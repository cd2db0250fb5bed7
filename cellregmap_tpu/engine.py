"""Batched scan kernels: the compute core of cellregmap_tpu.

Design (see SURVEY.md section 7)
--------------------------------
The reference runs, per SNP, 11 serial REML fits plus an O(n r C) score pass
(/root/reference/cellregmap/_cellregmap.py:340-435).  Here the whole scan is
restructured around a single orthonormal *workspace basis* Z spanning every
covariance factor ([E1, L_1..L_C]):

* Sigma(rho) = Z Gz(rho) Z^T with Gz(rho) = rho Ge + (1-rho) Gk small
  (R x R); one batched eigh over the rho grid replaces 11 thin SVDs of
  n x m factors, and Q0(rho) = Z V(rho) is never materialized.
* Every n-length contraction (rotating y, W, G, and the Khatri-Rao tensor
  Z^T (g (.) E0) needed by the score statistic) happens once per variant
  batch as large matmuls, independent of rho.
* The per-variant work (11 profiled REML fits, the score statistic, the
  C x C mixture-weight eigenproblem, Liu/saddlepoint tails) is pure
  small-dimension algebra vmapped across the batch: one XLA program,
  no host round-trips.

Zero eigenvalues are inert in every formula (a direction with S_i = 0 acts
exactly like the orthogonal complement), so rank padding needs no masking
and all shapes are static.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp

from .models import lmm as lmm_mod
from .models import pvalues as pv_mod
from .ops.linalg import full_f32_matmuls, spd_solve, sym_pseudo_solve


# Cell-axis blocking of the Khatri-Rao contractions: bounds the size of
# each contraction's operands and temporaries (see _kr_contract; whether a
# GPU needs the blocking at all is open).  Module-level so tests can force
# the blocked path on small shapes.
_KR_BLOCK_ELEMS = 4.7e7
_KR_MIN_BLOCK = 1024


class NullContext(NamedTuple):
    """Precomputed per-dataset state for the interaction/association scans."""

    y: jax.Array        # (n,)
    W: jax.Array        # (n, p)
    E0: jax.Array       # (n, C)  score-part contexts (possibly row-permuted)
    Z: jax.Array        # (n, R)  workspace basis
    V: jax.Array        # (n_rho, R, R) eigenvectors of Gz(rho)
    S: jax.Array        # (n_rho, R) eigenvalues of Gz(rho), >= 0
    rho: jax.Array      # (n_rho,)
    Zy: jax.Array       # (R,)
    ZW: jax.Array       # (R, p)
    WW: jax.Array       # (p, p)
    Wy: jax.Array       # (p,)
    yy: jax.Array       # ()


def _gram_basis(F):
    """Orthonormal basis Z of range(F) plus T = Z^T F, via the Gram route.

    Replaces a host QR of the tall factor stack: LAPACK's dgeqrf runs at
    ~10 GFLOP/s on the 2-core bench host while dgemm/dsyrk run at >100
    (measured: QR of 100k x 2010 = 87 s; syrk + eigh + two GEMMs ~ 20 s).
    The small eigh of F^T F is rank-revealing — exactly rank-deficient
    stacks (block-structured contexts spanning the intercept) drop their
    null directions instead of destabilizing anything — and the CholQR
    polish restores eps-level orthonormality that the 1/sqrt(lam) scaling
    loses for small-eigenvalue directions.  Zero/dropped eigendirections
    are inert in every downstream formula (the engine's zero-eigenvalue
    padding convention), so the basis width may differ from QR's; all
    results are basis-invariant.

    Rank-resolution limit: squaring the spectrum halves the
    resolvable dynamic range — directions with singular value below
    ~sqrt(m * eps) * sigma_max fall under the Gram eigenvalue cut and are
    dropped, where backward-stable QR would have kept them (kappa ~ 1e8 is
    the practical boundary; regression-pinned on a kappa ~ 1e8 stack in
    tests/test_ops.py::test_gram_basis_high_condition).  Retained-basis
    covariance error at kappa 1e8-1e12 is ~1e-10 relative vs ~1e-15 for
    QR — acceptable for the squared-spectrum covariance use here.
    """
    import numpy as _np
    import scipy.linalg as _sla

    n, m = F.shape
    if m == 0:
        return _np.zeros((n, 0)), _np.zeros((0, 0))
    G = F.T @ F
    lam, V = _np.linalg.eigh(G)
    cut = (max(m, 1) * _np.finfo(float).eps * lam[-1]
           if lam.size and lam[-1] > 0 else 0.0)
    keep = lam > cut
    B = V[:, keep] / _np.sqrt(lam[keep])
    Z0 = F @ B                                   # ~orthonormal columns
    M = Z0.T @ Z0
    Lch = _np.linalg.cholesky(M)
    Linv = _sla.solve_triangular(Lch, _np.eye(Lch.shape[0]), lower=True)
    Z = Z0 @ Linv.T
    T = Linv @ (B.T @ G)                          # Z^T F, all small ops
    return Z, T


def build_null_context(y, W, E1, E0=None, Ls: Optional[Sequence] = None,
                       hK=None, rho_grid=None, dtype=jnp.float64):
    """Factorize the null covariance family once.

    Mirrors CellRegMap.__init__ (_cellregmap.py:63-131): three background
    modes — E-only (rho = [1.0]), E + K (hK given), E + K (.) EE^T (Ls
    given; Ls takes precedence, as in the reference).
    """
    import numpy as _np

    y_np = _np.asarray(jax.device_get(y), float).ravel()
    n = y_np.shape[0]
    W_np = (_np.ones((n, 1)) if W is None
            else _np.asarray(jax.device_get(W), float))
    if W_np.ndim == 1:
        W_np = W_np[:, None]
    E1_np = _np.asarray(jax.device_get(E1), float)
    E0_np = E1_np if E0 is None else _np.asarray(jax.device_get(E0), float)

    if Ls is not None and len(Ls) > 0:
        bg_np = [_np.asarray(jax.device_get(L), float) for L in Ls]
    elif hK is not None:
        bg_np = [_np.asarray(jax.device_get(hK), float)]
    else:
        bg_np = []

    if rho_grid is None:
        rho_grid = _np.linspace(0.0, 1.0, 11) if bg_np else _np.array([1.0])
    rho_np = _np.asarray(jax.device_get(rho_grid), float)

    # One-time basis construction on host LAPACK: full f64 accuracy and
    # robust to exactly rank-deficient factor stacks (everything per-batch
    # stays on device).  Everything here is pure NumPy with a single device
    # upload at the end, so setup costs no per-op dispatches or first-use
    # compiles.  The Gram-route basis (see :func:`_gram_basis`) gives the
    # rotations for free: T = Z^T F, so Ge/Gk are Gram blocks of T — no
    # extra n-length matmuls.
    F = _np.concatenate([E1_np] + bg_np, axis=1)
    Z_np, R_np = _gram_basis(F)
    C1 = E1_np.shape[1]
    Re = R_np[:, :C1]
    Ge = Re @ Re.T
    if bg_np:
        Rk = R_np[:, C1:]
        Gk = Rk @ Rk.T
    else:
        Gk = _np.zeros_like(Ge)

    Gz = rho_np[:, None, None] * Ge[None] \
        + (1 - rho_np)[:, None, None] * Gk[None]
    # The per-rho factorization runs once per dataset on host LAPACK (full
    # f64 accuracy, exact on singular inputs; whether a device eigh should
    # take over on a GPU is open).  The rho points run SERIALLY: LAPACK's
    # eigh is internally threaded over every core already, and
    # oversubscribing it with a thread pool thrashes the cache.
    eigs = [_np.linalg.eigh(g) for g in Gz]
    S = jnp.asarray(_np.maximum(_np.stack([e[0] for e in eigs]), 0.0), dtype)
    V = jnp.asarray(_np.stack([e[1] for e in eigs]), dtype)

    return NullContext(
        y=jnp.asarray(y_np, dtype), W=jnp.asarray(W_np, dtype),
        E0=jnp.asarray(E0_np, dtype), Z=jnp.asarray(Z_np, dtype),
        V=V, S=S, rho=jnp.asarray(rho_np, dtype),
        Zy=jnp.asarray(Z_np.T @ y_np, dtype),
        ZW=jnp.asarray(Z_np.T @ W_np, dtype),
        WW=jnp.asarray(W_np.T @ W_np, dtype),
        Wy=jnp.asarray(W_np.T @ y_np, dtype),
        yy=jnp.asarray(y_np @ y_np, dtype),
    )


# --------------------------------------------------------------------------
# Shared helpers
# --------------------------------------------------------------------------
def _kr_contract(U, V, G):
    """M[k, j, s] = sum_n U[n,k] V[n,j] G[n,s]  ->  (K, p, S).

    The Khatri-Rao contractions are each ONE (K, n) @ (n, p*S) matmul —
    a single large HLO dot instead of per-column matmuls (which
    multiplied compile time and serialized kernel launches).  At large n
    the cell axis is blocked with a lax.scan accumulator to bound the
    (n, p*S) Khatri-Rao operand and the matmul's temporaries.
    """
    n, K = U.shape
    p = V.shape[1]
    S = G.shape[1]
    kdim = max(K, p * S)
    nb = max(_KR_MIN_BLOCK, int(_KR_BLOCK_ELEMS / max(kdim, 1)))
    if nb >= n:
        KR = (V[:, :, None] * G[:, None, :]).reshape(n, p * S)
        return (U.T @ KR).reshape(K, p, S)

    npad = -(-n // nb) * nb
    pad = npad - n
    zp = lambda A: (jnp.concatenate(
        [A, jnp.zeros((pad,) + A.shape[1:], A.dtype)]) if pad else A)
    Up, Vp, Gp = zp(U), zp(V), zp(G)

    def body(acc, i):
        sl = lambda A: jax.lax.dynamic_slice_in_dim(A, i, nb, axis=0)
        KR = (sl(Vp)[:, :, None] * sl(Gp)[:, None, :]).reshape(nb, p * S)
        return acc + sl(Up).T @ KR, None

    acc0 = jnp.zeros((K, p * S), U.dtype)
    acc, _ = jax.lax.scan(body, acc0, jnp.arange(0, npad, nb))
    return acc.reshape(K, p, S)


def _khatri_rao_rotate(Z, E0, G):
    """T[c] = Z^T (E0[:, c] (.) G)  ->  (C, R, S); see :func:`_kr_contract`."""
    return _kr_contract(Z, E0, G).transpose(1, 0, 2)


def _e0_weighted_grams(E0, Gpow):
    """M[c, d, s] = sum_n E0[n,c] E0[n,d] Gpow[n,s]  ->  (C, C, S)."""
    return _kr_contract(E0, E0, Gpow)


def _cross_weighted_grams(U, V, G):
    """M[c, j, s] = sum_n U[n,c] V[n,j] G[n,s]  ->  (C, p, S)."""
    return _kr_contract(U, V, G)


def score_test_core(Sb, Xt, yt, At, XX, Xy, AX, ay, AtA, v0, v1):
    """Score statistic Q = 1/2 ||A^T P y||^2 and weight matrix 1/2 A^T P A.

    The engine's score pass (reference _math.py:102-128 semantics) for one
    problem: all quantities are given in the covariance eigenbasis (``Sb``
    eigenvalues; ``Xt``/``yt``/``At`` rotated) plus the full-space Grams
    (``XX``, ``Xy``, ``AX`` = A^T X, ``ay`` = A^T y, ``AtA``) that supply the
    orthogonal-complement contributions.  cov = v0 Sigma + v1 I.

    Used by :func:`interaction_batch` per variant, and directly by the
    reference-golden parity tests (tests/test_reference_parity.py) to pin
    the reference's exact constants through this engine path.
    """
    omega = (v0 * Sb) / (v1 + v0 * Sb)

    def kq(ut, vt, uv):
        """u^T K0^{-1} v = (u^T v - u^T Q diag(omega) Q^T v)/v1."""
        scaled = omega[:, None] * vt if vt.ndim == 2 else omega * vt
        return (uv - ut.T @ scaled) / v1

    XKX = kq(Xt, Xt, XX)
    XKy = kq(Xt, yt, Xy)
    AKX = kq(At, Xt, AX)
    AKy = kq(At, yt, ay)
    AKA = kq(At, At, AtA)

    B = sym_pseudo_solve(XKX, jnp.concatenate([XKy[:, None], AKX.T], axis=1))
    APy = AKy - AKX @ B[:, 0]
    APA = AKA - AKX @ B[:, 1:]
    Q = 0.5 * APy @ APy
    Wmat = 0.25 * (APA + APA.T)  # 1/2 A^T P A, symmetrized
    return Q, Wmat


def _fit_over_rho(ctx: NullContext, Xz, X_gram, X_y, n, restricted,
                  delta_cfg):
    """REML/ML fits over the rho grid for one problem; returns per-rho fits.

    Xz: (R, p) workspace-rotated covariates; X_gram: (p, p) full X^T X;
    X_y: (p,) full X^T y.
    """
    lo, hi, n_grid, n_iters = delta_cfg

    def one_rho(V, S):
        Xt = V.T @ Xz
        yt = V.T @ ctx.Zy
        data = lmm_mod.EigData(
            S=S, Xt=Xt, yt=yt,
            Cxx=X_gram - Xt.T @ Xt,
            cxy=X_y - Xt.T @ yt,
            cyy=ctx.yy - yt @ yt,
        )
        return lmm_mod.fit_delta_eig(data, n, restricted, lo, hi, n_grid,
                                     n_iters)

    return jax.vmap(one_rho)(ctx.V, ctx.S)


# --------------------------------------------------------------------------
# Interaction scan kernel
# --------------------------------------------------------------------------
@full_f32_matmuls
def interaction_batch(ctx: NullContext, G, G_score, n: int,
                      delta_cfg=(-18.0, 18.0, 64, 60), saddle_iters=40,
                      device_pvalues: bool = True,
                      profile_stage: str = "full",
                      newton_f32: int = 6, newton_f64: int = 3,
                      localize_f32: bool = True):
    """Score-test interaction scan for one variant batch (pure; see
    :func:`interaction_kernel` for the jitted entry).

    Per variant (vmapped): REML null fit over the rho grid with X = [W, g]
    (reference _cellregmap.py:345-357), then the score statistic
    Q = 1/2 ||(g (.) E0)^T P y||^2 and the C x C mixture-weight matrix
    1/2 A^T P A (reference _math.py:102-128) evaluated entirely from
    precomputed inner products, plus device-side Liu/saddlepoint tails.

    ``G_score`` carries the (possibly idx_G-permuted) genotypes used in the
    score part; the null fits always use ``G``.
    """
    Z, E0, y, W = ctx.Z, ctx.E0, ctx.y, ctx.W
    p = W.shape[1]

    # --- one-shot heavy contractions (rho-independent) ---
    ZG = Z.T @ G                                   # (R, S)
    T = _khatri_rao_rotate(Z, E0, G_score)         # (C, R, S)
    G2s = G_score * G_score
    AtA = _e0_weighted_grams(E0, G2s)              # (C, C, S)
    Ay = E0.T @ (G_score * y[:, None])             # (C, S)
    AW = _cross_weighted_grams(E0, W, G_score)     # (C, p, S)
    Ag = E0.T @ (G_score * G)                      # (C, S)  A^T g (unpermuted g)
    Wg = W.T @ G                                   # (p, S)
    gg = jnp.sum(G * G, axis=0)                    # (S,)
    gy = G.T @ y                                   # (S,)

    # --- per-rho rotations as batched matmuls (not inside the vmap) ---
    # V: (nrho, R, R); rotate once for all variants and rho values.  (The
    # score factor T is rotated only at each variant's best rho, after the
    # rho argmax — an all-rho (nrho, R, C, S) tensor is the scan's largest
    # allocation by far and OOMs large-n configs.)
    # per-rho rotations as a loop of plain (R, R) matmuls, so no f64 dot
    # holds temporaries for ALL of V at once (large-R configs OOMed when
    # the rho axis was one batched einsum).
    # The phenotype rotation is kept SEPARATE from the W/G rotation so the
    # gene-batched scan (vmap over y) shares all genotype rotations across
    # genes — only yt_all and the small y-Grams acquire a gene axis.
    WG_stack = jnp.concatenate([ctx.ZW, ZG], axis=1)    # (R, p+S)
    rot = jnp.stack([ctx.V[o].T @ WG_stack
                     for o in range(ctx.V.shape[0])])   # (nrho, R, p+S)
    Wt_all = rot[:, :, :p]                              # (nrho, R, p)
    Gt_all = rot[:, :, p:]                              # (nrho, R, S)
    yt_all = jnp.einsum("orq,r->oq", ctx.V, ctx.Zy)     # (nrho, R)

    lo, hi, n_grid, n_iters = delta_cfg

    # --- complement Grams: rho-independent (the V rotations are orthonormal,
    # so all Grams of rotated quantities equal their Z-basis Grams) ---
    CWW = ctx.WW - ctx.ZW.T @ ctx.ZW                   # (p, p)
    CWy = ctx.Wy - ctx.ZW.T @ ctx.Zy                   # (p,)
    Cyy = ctx.yy - ctx.Zy @ ctx.Zy                     # ()
    CWg = Wg - ctx.ZW.T @ ZG                           # (p, S)
    Cgy = gy - ZG.T @ ctx.Zy                           # (S,)
    Cgg = gg - jnp.sum(ZG * ZG, axis=0)                # (S,)

    # Complement conditioning: when the basis rank approaches n (wide
    # factor stacks, e.g. C=20 x 125 donors at n=2048), the true
    # complements are ~0 and the subtractions above return pure
    # cancellation noise at eps(ctx dtype) * magnitude — which the 1/delta
    # weights amplify by up to e^18 into spurious lml maxima at the low
    # bracket edge (measured: 54% of f32-screen variants collapse to
    # delta=sigmoid(-18) with 1000x-inflated Q).  The complement Gram of
    # [W, g, y] is PSD in exact arithmetic, so (a) clamp its diagonal to
    # the noise floor and (b) Cauchy-Schwarz-clip the cross terms against
    # the clamped diagonal — exact values are never altered beyond their
    # own noise level, in f64 as in f32.
    eps_c = 128 * jnp.finfo(ctx.y.dtype).eps
    dWW = jnp.diagonal(ctx.WW)
    dCWW = jnp.maximum(jnp.diagonal(CWW), eps_c * dWW)          # (p,)
    CWW = CWW - jnp.diag(jnp.diagonal(CWW)) + jnp.diag(dCWW)
    Cyy = jnp.maximum(Cyy, eps_c * ctx.yy)
    Cgg = jnp.maximum(Cgg, eps_c * gg)
    cwy_b = jnp.sqrt(dCWW * Cyy)                                # (p,)
    CWy = jnp.clip(CWy, -cwy_b, cwy_b)
    cwg_b = jnp.sqrt(dCWW[:, None] * Cgg[None, :])              # (p, S)
    CWg = jnp.clip(CWg, -cwg_b, cwg_b)
    cgy_b = jnp.sqrt(Cgg * Cyy)                                 # (S,)
    Cgy = jnp.clip(Cgy, -cgy_b, cgy_b)

    # --- normal-equation component tensors, per precision -----------------
    # Hybrid precision: localization runs in f32 (at full f32 precision,
    # see ops.linalg.full_f32_matmuls); only the *final* refinement and the
    # score statistic need f64.  Whether the f32 stage still pays off where
    # f64 is native is open.  The pipeline is:
    #   1. coarse delta grid + safeguarded Newton in f32  (localization)
    #   2. one f64 lml evaluation at the f32 optimum        (rho argmax;
    #      at an optimum the lml error is O(delta_err^2) ~ 1e-8, so the
    #      argmax over rho matches the full-f64 answer)
    #   3. f64 Newton iterations at the best rho only       (11x less f64)
    #   4. f64 score pass (unchanged)
    # Components (entries of the normal equations as separate arrays) keep
    # every op elementwise over the long R axis, with no tiny trailing
    # (R, p1) or (p1, p1) axes.
    R = ctx.S.shape[1]
    p1 = p + 1
    nu = n - p1
    f64 = ctx.y.dtype
    fast = jnp.float32 if (f64 == jnp.float64 and localize_f32) else f64
    # Statistics dtype for stages 2-3 (the per-variant lml/Newton/score
    # math): ALWAYS f64, even when the whole context is f32 (the screen
    # kernel).  The small-dimension REML normal equations cancel
    # catastrophically in f32 at C >= 20 (measured: 98% NaN Q at C=20,
    # R=1300) — while the HEAVY tensors (contractions, rotations, score
    # factors) stay in the context dtype and the f64 work is only the
    # per-variant reductions, so the f32 screen keeps its f32 matmuls.
    sd = jnp.float64

    from .ops.linalg import (unrolled_chol_factor, unrolled_chol_logdet,
                             unrolled_chol_solve, unrolled_chol_solve_logdet,
                             sym_components_full, sym_components_matvec,
                             sym_pseudo_logdet)

    yy_t = yt_all * yt_all                              # (nrho, R)
    Wy_c = [Wt_all[:, :, j] * yt_all for j in range(p)]
    WWt_c = [[Wt_all[:, :, i] * Wt_all[:, :, j] for j in range(i + 1)]
             for i in range(p)]
    GY_t = Gt_all * yt_all[:, :, None]                  # (nrho, R, S)
    G2_t = Gt_all * Gt_all
    GW_c = [Gt_all * Wt_all[:, :, j][:, :, None] for j in range(p)]
    CWg_sT = CWg.T                                      # (S, p)

    def _tset(dt):
        c = lambda a: a.astype(dt)
        return dict(
            S=c(ctx.S), e=c(1.0 - ctx.S), e2=c((1.0 - ctx.S) ** 2),
            yy=c(yy_t), Wy=[c(a) for a in Wy_c],
            WW=[[c(a) for a in row] for row in WWt_c],
            GY=c(GY_t), G2=c(G2_t), GW=[c(a) for a in GW_c],
            CWW=c(CWW), CWy=c(CWy), Cyy=c(Cyy),
            CWg=c(CWg_sT), Cgy=c(Cgy), Cgg=c(Cgg),
        )

    TS64 = _tset(f64)
    TS32 = _tset(fast) if fast != f64 else TS64

    def _ne_family(w, ic, TS, rs, ro):
        """Normal-equation components under eigen-weights ``w`` plus the
        complement's scalar weight ``ic`` (a power of 1/delta).

        ``ro(w, t)``/``rs(w, t)`` reduce the eigencomponent axis of
        snp-shared / per-snp tensors; the two call sites are the
        (variant, rho)-batched stage and the best-rho-gathered stage.
        """
        A = [[ro(w, TS["WW"][i][j]) + TS["CWW"][i, j] * ic
              for j in range(i + 1)] for i in range(p)]
        g_row = [rs(w, TS["GW"][j]) + _colvec(TS["CWg"][:, j], ic) * ic
                 for j in range(p)]
        g_row.append(rs(w, TS["G2"]) + _colvec(TS["Cgg"], ic) * ic)
        A.append(g_row)
        b = [ro(w, TS["Wy"][j]) + TS["CWy"][j] * ic for j in range(p)]
        b.append(rs(w, TS["GY"]) + _colvec(TS["Cgy"], ic) * ic)
        q = ro(w, TS["yy"]) + TS["Cyy"] * ic
        return A, b, q

    def _colvec(v, like):
        """Broadcast a per-variant vector (S,) against ``like``:
        (S, nrho)-shaped reductions need (S, 1), per-variant (S,) need (S,)."""
        return v[:, None] if like.ndim == 2 else v

    # --- stage 1a: coarse delta grid as snp-shared batched GEMMs (f32) ----
    # The GLS weights w = 1/((1-delta) S_rho + delta) depend only on
    # (rho, delta): one small (nrho, K, R) weight tensor serves every
    # variant; vmapping the grid per variant instead would materialize
    # O(S * nrho * K * R) intermediates (tens of GB at production sizes).
    TS = TS32
    deltas = jax.nn.sigmoid(jnp.linspace(lo, hi, n_grid)).astype(fast)
    d_grid = (1 - deltas)[None, :, None] * TS["S"][:, None, :] \
        + deltas[None, :, None]                         # (nrho, K, R)
    Wd = 1.0 / d_grid
    logdet_grid = jnp.sum(jnp.log(d_grid), axis=-1) \
        + (n - R) * jnp.log(deltas)[None, :]            # (nrho, K)
    inv_d = 1.0 / deltas                                # (K,)

    red_o = lambda t: jnp.einsum("okr,or->ok", Wd, t)[None]     # (1,nrho,K)
    red_s = lambda t: jnp.einsum("okr,ors->oks", Wd, t).transpose(2, 0, 1)

    A_rows = [[red_o(TS["WW"][i][j]) + TS["CWW"][i, j] * inv_d[None, None]
               for j in range(i + 1)] for i in range(p)]
    g_row = [red_s(TS["GW"][j])
             + TS["CWg"][:, j][:, None, None] * inv_d[None, None]
             for j in range(p)]
    g_row.append(red_s(TS["G2"]) + TS["Cgg"][:, None, None] * inv_d[None, None])
    A_rows.append(g_row)
    b_comp = [red_o(TS["Wy"][j]) + TS["CWy"][j] * inv_d[None, None]
              for j in range(p)]
    b_comp.append(red_s(TS["GY"]) + TS["Cgy"][:, None, None] * inv_d[None, None])
    yy_grid = red_o(TS["yy"]) + TS["Cyy"] * inv_d[None, None]   # (1,nrho,K)

    beta_c, logdet_a_grid = unrolled_chol_solve_logdet(A_rows, b_comp)
    rss_grid = yy_grid
    for j in range(p1):
        rss_grid = rss_grid - b_comp[j] * beta_c[j]
    # rss = q - sum(b beta) is a difference of positives whose inputs carry
    # ~eps(fast) relative error: below ~eps * q the value is cancellation
    # NOISE, not a residual.  At tiny delta the q terms blow up as 1/delta
    # and the noise forms a spurious lml maximum at the low bracket edge
    # (measured: delta -> sigmoid(-18), Q inflated 1000x, in the f32 screen
    # kernel at C=20).  Exclude noise-floor points from the argmax — a
    # relative guard, not the absolute-tiny one.
    rss_collapsed = rss_grid <= 128 * jnp.finfo(fast).eps * yy_grid
    rss_grid = jnp.maximum(rss_grid, jnp.finfo(fast).tiny)

    # logdet(X^T X) is delta-independent: compute once per variant (f64;
    # reused by the exact stages).
    def _ld_xx(wg_s, gg_s):
        XX = jnp.block([[ctx.WW, wg_s[:, None]],
                        [wg_s[None, :], gg_s[None, None]]])
        return sym_pseudo_logdet(XX)

    ld_xx = jax.vmap(_ld_xx, in_axes=(1, 0))(Wg, gg)    # (S,)

    lml_grid = -0.5 * (
        nu * jnp.log(2 * jnp.pi * rss_grid / nu)
        + logdet_grid[None]
        + logdet_a_grid
        - ld_xx.astype(fast)[:, None, None]
        + nu
    )                                                   # (S, nrho, K)
    lml_grid = jnp.where(rss_collapsed | ~jnp.isfinite(lml_grid),
                         -jnp.inf, lml_grid)
    # pathological all-non-finite rows fall back to the full bracket so the
    # f64 stages degrade to a plain search instead of pinning the low edge
    row_bad = jnp.all(~jnp.isfinite(lml_grid), axis=-1)  # (S, nrho)
    k_grid = jnp.argmax(lml_grid, axis=-1)              # (S, nrho)
    # bracket/delta state in the CONTEXT dtype: a stray f64 linspace here
    # would promote the stage-2/3 weight reductions to f64 even when the
    # whole kernel runs f32 (the screen path)
    logit_grid = jnp.linspace(lo, hi, n_grid).astype(f64)
    br_lo = jnp.where(row_bad, jnp.asarray(lo, f64),
                      logit_grid[jnp.maximum(k_grid - 1, 0)])
    br_hi = jnp.where(row_bad, jnp.asarray(hi, f64),
                      logit_grid[jnp.minimum(k_grid + 1, n_grid - 1)])

    if profile_stage == "grid":  # debug: timing bisection
        return {"br_lo": br_lo, "br_hi": br_hi, "T": T}

    # --- Newton machinery (precision- and stage-generic) -------------------
    def _derivs(delta, TS, rs, ro):
        """(dL/d delta, d2L/d delta2) of the restricted profiled objective
        (the math of models/lmm.delta_derivatives, in component form;
        validated against it in tests/test_lmm.py)."""
        # compute in the WIDER of (tensor, state) dtypes: stage 1b runs
        # f32 x f32, stage 3 runs f32-tensor x f64-state in f64 (the f32
        # screen context must not downcast the statistics stage, see sd)
        dt = jnp.result_type(TS["S"].dtype, delta.dtype)
        delta = delta.astype(dt)
        dx = delta[..., None]
        d = (1 - dx) * _bcast(TS["S"], delta) + dx
        w1 = 1.0 / d
        we2 = _bcast(TS["e"], delta) * w1 * w1
        we3 = _bcast(TS["e2"], delta) * w1 * w1 * w1
        i1 = 1.0 / delta
        i2 = i1 * i1
        i3 = i2 * i1

        A1, b1, q1 = _ne_family(w1, i1, TS, rs, ro)
        A2, b2, q2 = _ne_family(we2, i2, TS, rs, ro)
        A3, b3, q3 = _ne_family(we3, i3, TS, rs, ro)

        L1 = unrolled_chol_factor(A1)
        beta = unrolled_chol_solve(L1, b1)
        rss = q1 - sum(b1[j] * beta[j] for j in range(p1))
        rss = jnp.maximum(rss, jnp.finfo(dt).tiny)

        A2b = sym_components_matvec(A2, beta)
        A3b = sym_components_matvec(A3, beta)
        beta_p = unrolled_chol_solve(
            L1, [A2b[j] - b2[j] for j in range(p1)])
        A2bp = sym_components_matvec(A2, beta_p)
        rss_p = -q2 + 2 * sum(b2[j] * beta[j] for j in range(p1)) \
            - sum(beta[j] * A2b[j] for j in range(p1))
        rss_pp = (2 * q3
                  - 4 * sum(b3[j] * beta[j] for j in range(p1))
                  + 2 * sum(b2[j] * beta_p[j] for j in range(p1))
                  - 2 * sum(beta[j] * A2bp[j] for j in range(p1))
                  + 2 * sum(beta[j] * A3b[j] for j in range(p1)))

        ld_d_p = ro(w1, TS["e"]) + (n - R) * i1
        ld_d_pp = -ro(w1 * w1, TS["e2"]) - (n - R) * i2

        # trace terms via explicit A1^{-1} columns (p1 unit solves)
        ones = jnp.ones_like(q1)
        zeros = jnp.zeros_like(q1)
        A1inv = [unrolled_chol_solve(
            L1, [ones if i == kc else zeros for i in range(p1)])
            for kc in range(p1)]        # A1inv[kc][i] = (A1^{-1})_{i,kc}
        A2f = sym_components_full(A2)
        A3f = sym_components_full(A3)
        T2 = [[sum(A1inv[k][i] * A2f[k][j] for k in range(p1))
               for j in range(p1)] for i in range(p1)]
        tr_T2 = sum(T2[i][i] for i in range(p1))
        tr_T3 = sum(A1inv[k][i] * A3f[k][i]
                    for i in range(p1) for k in range(p1))
        tr_T2sq = sum(T2[i][j] * T2[j][i]
                      for i in range(p1) for j in range(p1))

        u = rss_p / rss
        L_p = -0.5 * (nu * u + ld_d_p - tr_T2)
        L_pp = -0.5 * (nu * (rss_pp / rss - u * u) + ld_d_pp
                       + 2 * tr_T3 - tr_T2sq)
        return L_p, L_pp

    def _bcast(t, delta):
        """Align a shared (nrho, R) tensor with (S, nrho[, ...]) deltas; the
        best-rho stage passes per-variant (S, R) tensors through as-is."""
        return t[None] if (t.ndim == 2 and delta.ndim == 2) else t

    def _newton_step(st, TS, rs, ro):
        x, lo_b, hi_b = st            # logits in the stage's state dtype
        delta = jax.nn.sigmoid(x)
        Lp, Lpp = _derivs(delta, TS, rs, ro)
        Lp = Lp.astype(x.dtype)
        Lpp = Lpp.astype(x.dtype)
        g_sig = delta * (1 - delta)
        Lx_p = Lp * g_sig
        Lx_pp = Lpp * g_sig * g_sig + Lp * g_sig * (1 - 2 * delta)
        lo2 = jnp.where(Lx_p > 0, x, lo_b)
        hi2 = jnp.where(Lx_p > 0, hi_b, x)
        x_newton = x - Lx_p / Lx_pp
        # inclusive bounds: at convergence x_newton == x == one bracket end;
        # an exclusive test would bounce the converged iterate to the
        # bracket midpoint
        ok = (Lx_pp < 0) & (x_newton >= lo2) & (x_newton <= hi2) \
            & jnp.isfinite(x_newton)
        x_new = jnp.where(ok, x_newton, 0.5 * (lo2 + hi2))
        return x_new, lo2, hi2

    # --- stage 1b: f32 Newton over all (variant, rho) problems ------------
    reduce_oo = lambda w, t: jnp.einsum("sor,or->so", w, t)
    reduce_os = lambda w, t: jnp.einsum("sor,ors->so", w, t)

    st = (0.5 * (br_lo + br_hi), br_lo, br_hi)
    st = jax.lax.fori_loop(
        0, newton_f32,
        lambda _, s: _newton_step(s, TS32, reduce_os, reduce_oo), st)
    x32, br32_lo, br32_hi = st
    # stage 2+ state in the statistics dtype (see sd above)
    x32 = x32.astype(sd)
    delta32 = jax.nn.sigmoid(x32)                       # (S, nrho)

    if profile_stage == "zoom":  # debug: timing bisection
        return {"delta_star": delta32, "T": T,
                "br_lo": br32_lo, "br_hi": br32_hi}

    # --- stage 2: one f64 lml evaluation at the f32 optimum ---------------
    # (component form of models/lmm.lml_at_delta_eig, restricted)
    d_star = (1 - delta32)[..., None] * ctx.S[None] + delta32[..., None]
    A1s, b1s, q1s = _ne_family(1.0 / d_star, 1.0 / delta32, TS64,
                               reduce_os, reduce_oo)
    L1s = unrolled_chol_factor(A1s)
    beta_s = unrolled_chol_solve(L1s, b1s)
    rss_s = q1s - sum(b1s[j] * beta_s[j] for j in range(p1))
    # the TENSORS carry eps(f64-var = ctx dtype) relative error even though
    # the weights are f64; below that floor the rss is noise (see stage 1)
    rss_bad = rss_s <= 128 * jnp.finfo(f64).eps * q1s
    rss_s = jnp.maximum(rss_s, jnp.finfo(sd).tiny)
    logdet_d_s = jnp.sum(jnp.log(d_star), axis=-1) \
        + (n - R) * jnp.log(delta32)
    lml_all = -0.5 * (
        nu * jnp.log(2 * jnp.pi * rss_s / nu) + logdet_d_s
        + unrolled_chol_logdet(L1s)
        - ld_xx[:, None] + nu
    )                                                   # (S, nrho)
    # noise-floor or NaN evaluations must not win the rho argmax
    lml_all = jnp.where(rss_bad | ~jnp.isfinite(lml_all), -jnp.inf,
                        lml_all)
    k_best = jnp.argmax(lml_all, axis=-1)               # (S,)
    if profile_stage == "stage2":  # debug: inspect the rho-selection stage
        return {"lml_all": lml_all, "delta32": delta32, "rss_s": rss_s,
                "q1s": q1s, "rss_bad": rss_bad, "k_best": k_best}

    # --- stage 3: f64 Newton at each variant's best rho only --------------
    O_k = jax.nn.one_hot(k_best, ctx.S.shape[0], dtype=f64)     # (S, nrho)

    # rotate the score factor T at the best rho only, as a masked
    # accumulation over the (static, small) rho grid.  This does nrho x
    # more matmul FLOPs than gathering each variant's V[k] and batch-
    # multiplying, but each rotation here is a FAT (R, R) @ (R, C*S) GEMM,
    # whereas the gathered form's (chunk, R, R) @ (chunk, R, C) batched
    # matmuls have an N dimension of only C ~ 10 (which form is faster on
    # a GPU is open).
    # The all-rho tensor (nrho, R, C, S) is never materialized either way.
    nrho_s = ctx.S.shape[0]
    At_all = jnp.zeros((T.shape[2], T.shape[1], T.shape[0]), f64)  # (S, R, C)
    for o in range(nrho_s):
        To = jnp.einsum("rq,crs->sqc", ctx.V[o], T)             # (S, R, C)
        At_all = At_all + O_k[:, o][:, None, None] * To
    gather_o = lambda t: jnp.einsum("so,or->sr", O_k, t)        # (S, R)
    gather_s = lambda t: jnp.einsum("so,ors->sr", O_k, t)       # (S, R)
    TS_k = dict(
        S=gather_o(ctx.S), e=gather_o(1.0 - ctx.S),
        e2=gather_o((1.0 - ctx.S) ** 2),
        yy=gather_o(yy_t), Wy=[gather_o(a) for a in Wy_c],
        WW=[[gather_o(a) for a in row] for row in WWt_c],
        GY=gather_s(GY_t), G2=gather_s(G2_t),
        GW=[gather_s(a) for a in GW_c],
        CWW=CWW, CWy=CWy, Cyy=Cyy, CWg=CWg_sT, Cgy=Cgy, Cgg=Cgg,
    )
    reduce_ko = lambda w, t: jnp.einsum("sr,sr->s", w, t)

    take_k = lambda a: jnp.take_along_axis(a, k_best[:, None],
                                           axis=1)[:, 0]
    # restart from the (trustworthy) f32 GRID bracket, not the f32-Newton
    # shrunk one: near the optimum the f32 derivative signs are noise, and
    # a noise-shrunk bracket can exclude the true optimum, clamping the
    # f64 iterations ~1e-6 away from it
    st_k = (take_k(x32), take_k(br_lo).astype(sd),
            take_k(br_hi).astype(sd))
    st_k = jax.lax.fori_loop(
        0, newton_f64,
        lambda _, s: _newton_step(s, TS_k, reduce_ko, reduce_ko), st_k)
    delta_k = jax.nn.sigmoid(st_k[0])                   # (S,)

    # final f64 REML evaluation at (best rho, converged delta)
    d_k = (1 - delta_k)[:, None] * TS_k["S"] + delta_k[:, None]  # (S, R)
    A1k, b1k, q1k = _ne_family(1.0 / d_k, 1.0 / delta_k, TS_k,
                               reduce_ko, reduce_ko)
    L1k = unrolled_chol_factor(A1k)
    beta_k = unrolled_chol_solve(L1k, b1k)
    rss_k = q1k - sum(b1k[j] * beta_k[j] for j in range(p1))
    # clamp to the tensors' cancellation noise floor (see stage 1): keeps a
    # near-degenerate variant's scale finite instead of exploding Q
    rss_k = jnp.maximum(rss_k, 128 * jnp.finfo(f64).eps * q1k)
    rss_k = jnp.maximum(rss_k, jnp.finfo(sd).tiny)
    lml_k = -0.5 * (
        nu * jnp.log(2 * jnp.pi * rss_k / nu)
        + jnp.sum(jnp.log(d_k), axis=-1) + (n - R) * jnp.log(delta_k)
        + unrolled_chol_logdet(L1k)
        - ld_xx + nu
    )                                                   # (S,)
    scale_k = rss_k / nu
    v0_k = scale_k * (1 - delta_k)
    v1_k = scale_k * delta_k

    def per_snp(gt_k, at_s, ata, ay, aw, ag, wg, gg_s, gy_s,
                k, v0, v1, dstar_k, lml_k_s):
        # X = [W, g];  gt_k: (nrho, R) pre-rotated g; k: best-rho index
        # with v0/v1/delta from the converged f64 fit at that rho;
        # at_s: (R, C) score factor already rotated at the best rho.
        XX = jnp.block([[ctx.WW, wg[:, None]], [wg[None, :], gg_s[None, None]]])
        Xy = jnp.concatenate([ctx.Wy, gy_s[None]])

        Sb = jnp.take(ctx.S, k, axis=0)                              # (R,)
        rho1 = jnp.take(ctx.rho, k)

        # rotated quantities in the best-rho eigenbasis (all pre-rotated;
        # only cheap (R,.)-sized gathers here)
        Xt = jnp.concatenate(
            [jnp.take(Wt_all, k, axis=0),
             jnp.take(gt_k, k, axis=0)[:, None]], axis=1
        )                                                            # (R, p+1)
        yt = jnp.take(yt_all, k, axis=0)                             # (R,)
        At = at_s                                                    # (R, C)

        AX_full = jnp.concatenate([aw, ag[:, None]], axis=1)         # (C, p+1)
        Q, Wmat = score_test_core(Sb, Xt, yt, At, XX, Xy, AX_full, ay,
                                  ata, v0, v1)
        if device_pvalues:
            from .ops.linalg import safe_eigh

            # eigh in the CONTEXT dtype: the statistics stages promote
            # Wmat to f64 (see sd), but the f32 screen only needs
            # ~1e-6-relative mixture weights, and a batched f64 eigh is
            # costly.  The result is cast back to the statistics dtype for
            # the tail evaluations.
            lam = jnp.maximum(
                safe_eigh(Wmat.astype(ctx.y.dtype))[0], 0.0
            ).astype(Wmat.dtype)
        else:
            # exact path computes eigenvalues on host (LAPACK) from Wmat;
            # skip the costly batched device eigh
            lam = jnp.zeros(Wmat.shape[:1], Wmat.dtype)

        return {
            "Q": Q,
            "lambdas": lam,
            "Wmat": Wmat,
            "rho1": rho1,
            "e2": v0 * rho1,
            "g2": v0 * (1 - rho1),
            "eps2": v1,
            "v0": v0,
            "v1": v1,
            "delta": dstar_k,
            "lml": lml_k_s,
        }

    out = jax.vmap(per_snp,
                   in_axes=(2, 0, 2, 1, 2, 1, 1, 0, 0, 0, 0, 0, 0, 0))(
        Gt_all, At_all, AtA, Ay, AW, Ag, Wg, gg, gy,
        k_best, v0_k, v1_k, delta_k, lml_k
    )
    if device_pvalues:
        out["pv_liu"] = pv_mod.liu_sf(out["Q"], out["lambdas"])[0]
        out["pv_saddlepoint"] = pv_mod.saddlepoint_sf(
            out["Q"], out["lambdas"], n_iters=saddle_iters
        )
    else:
        out["pv_liu"] = jnp.ones_like(out["Q"])
        out["pv_saddlepoint"] = jnp.ones_like(out["Q"])
    return out


interaction_kernel = jax.jit(
    interaction_batch,
    static_argnames=("n", "delta_cfg", "saddle_iters", "device_pvalues",
                     "profile_stage", "newton_f32", "newton_f64",
                     "localize_f32"))


def interaction_multigene_batch(ctx: NullContext, G, G_score, n: int,
                                delta_cfg=(-18.0, 18.0, 64, 60),
                                saddle_iters=40,
                                device_pvalues: bool = True,
                                newton_f32: int = 6, newton_f64: int = 3,
                                localize_f32: bool = True):
    """Gene-batched interaction scan: genes x variants in ONE program.

    ``ctx``'s phenotype fields (y, Zy, Wy, yy) carry a leading gene axis;
    everything else is the shared per-dataset state.  vmap batches only the
    y-dependent tensors, so the heavy genotype contractions (Khatri-Rao
    rotate, per-rho W/G rotations, the score-factor rotation inputs) are
    computed ONCE and shared across genes — the per-gene increment is the
    small y-rotation family plus the per-(gene, variant) REML fits.  The
    reference re-runs its whole serial scan per gene
    (_cellregmap.py:63-131,317-440).
    """
    axes = NullContext(y=0, W=None, E0=None, Z=None, V=None, S=None,
                       rho=None, Zy=0, ZW=None, WW=None, Wy=0, yy=0)

    def one_gene(c):
        return interaction_batch(
            c, G, G_score, n, delta_cfg=delta_cfg,
            saddle_iters=saddle_iters, device_pvalues=device_pvalues,
            newton_f32=newton_f32, newton_f64=newton_f64,
            localize_f32=localize_f32)

    return jax.vmap(one_gene, in_axes=(axes,))(ctx)


interaction_multigene_kernel = jax.jit(
    interaction_multigene_batch,
    static_argnames=("n", "delta_cfg", "saddle_iters", "device_pvalues",
                     "newton_f32", "newton_f64", "localize_f32"))


@functools.partial(jax.jit, static_argnames=("n", "restricted", "delta_cfg"))
def mean_fit_kernel(ctx: NullContext, M, n: int, restricted: bool = True,
                    delta_cfg=(-18.0, 18.0, 64, 60)):
    """Fits over the rho grid with an arbitrary mean matrix M (n x pM).

    Used by estimate_aggregate_environment (reference :207-230 fits with
    M = [W, g, E0] against the *null* covariance family).
    """
    Mz = ctx.Z.T @ M
    return _fit_over_rho(ctx, Mz, M.T @ M, M.T @ ctx.y, n, restricted,
                         delta_cfg)


# --------------------------------------------------------------------------
# Association scan kernels
# --------------------------------------------------------------------------
@functools.partial(jax.jit, static_argnames=("n", "restricted", "delta_cfg"))
def null_association_kernel(ctx: NullContext, n: int, restricted: bool = False,
                            delta_cfg=(-18.0, 18.0, 64, 60)):
    """Covariate-only null fits over the rho grid (reference :246-266)."""
    fits = _fit_over_rho(ctx, ctx.ZW, ctx.WW, ctx.Wy, n, restricted,
                         delta_cfg)
    k = jnp.argmax(fits.lml)
    return fits, k


@full_f32_matmuls
def association_refit_batch(ctx: NullContext, G, k_rho, n: int,
                            delta_cfg=(-18.0, 18.0, 64, 60),
                            newton_f64: int = 10,
                            localize_f32: bool = True):
    """Per-variant full ML alternative fits at the null's best rho.

    The reference's "slow" association scan (_cellregmap.py:268-276): each
    variant refits delta with X = [W, g].  Round 3 ran the generic
    golden-section fitter here — 60 *sequential* objective evaluations per
    variant of tile-padded tiny matmuls.  This kernel
    reuses the interaction path's machinery instead: the coarse delta grid
    is evaluated as snp-SHARED batched GEMMs (one (K, R) weight tensor
    serves every variant) in f32, then a safeguarded Newton on the analytic
    ML derivatives (component form; no REML trace terms) converges in f64.
    P-value equality vs the golden path is pinned in
    tests/test_api.py::test_association_newton_matches_golden.
    """
    from .ops.linalg import (unrolled_chol_factor, unrolled_chol_logdet,
                             unrolled_chol_solve, sym_components_matvec)

    p = ctx.W.shape[1]
    p1 = p + 1
    R = ctx.S.shape[1]
    f64 = ctx.y.dtype
    fast = jnp.float32 if (f64 == jnp.float64 and localize_f32) else f64
    lo, hi, n_grid, _ = delta_cfg

    Vb = jnp.take(ctx.V, k_rho, axis=0)                 # (R, R)
    Sb = jnp.take(ctx.S, k_rho, axis=0)                 # (R,)

    ZG = ctx.Z.T @ G                                    # (R, S)
    Wt = Vb.T @ ctx.ZW                                  # (R, p)
    yt = Vb.T @ ctx.Zy                                  # (R,)
    Gt = Vb.T @ ZG                                      # (R, S)
    Wg = ctx.W.T @ G                                    # (p, S)
    gg = jnp.sum(G * G, axis=0)                         # (S,)
    gy = G.T @ ctx.y                                    # (S,)

    # complement Grams (rotation-invariant, as in interaction_batch)
    CWW = ctx.WW - ctx.ZW.T @ ctx.ZW
    CWy = ctx.Wy - ctx.ZW.T @ ctx.Zy
    Cyy = ctx.yy - ctx.Zy @ ctx.Zy
    CWg = Wg - ctx.ZW.T @ ZG                            # (p, S)
    Cgy = gy - ZG.T @ ctx.Zy                            # (S,)
    Cgg = gg - jnp.sum(ZG * ZG, axis=0)                 # (S,)

    # normal-equation component tensors (single rho: no leading nrho axis)
    yy_t = yt * yt                                      # (R,)
    Wy_c = [Wt[:, j] * yt for j in range(p)]
    WW_c = [[Wt[:, i] * Wt[:, j] for j in range(i + 1)] for i in range(p)]
    GY_t = Gt * yt[:, None]                             # (R, S)
    G2_t = Gt * Gt
    GW_c = [Gt * Wt[:, j][:, None] for j in range(p)]

    def _tset(dt):
        c = lambda a: a.astype(dt)
        return dict(
            S=c(Sb), e=c(1.0 - Sb), e2=c((1.0 - Sb) ** 2),
            yy=c(yy_t), Wy=[c(a) for a in Wy_c],
            WW=[[c(a) for a in row] for row in WW_c],
            GY=c(GY_t), G2=c(G2_t), GW=[c(a) for a in GW_c],
            CWW=c(CWW), CWy=c(CWy), Cyy=c(Cyy),
            CWg=c(CWg), Cgy=c(Cgy), Cgg=c(Cgg),
        )

    TS64 = _tset(f64)
    TS32 = _tset(fast) if fast != f64 else TS64

    def _ne_family(w, ic, TS, rs, ro):
        """A/b/q components under eigen-weights ``w`` plus complement
        weight ``ic``; ``ro``/``rs`` reduce the R axis of snp-shared /
        per-snp tensors."""
        A = [[ro(w, TS["WW"][i][j]) + TS["CWW"][i, j] * ic
              for j in range(i + 1)] for i in range(p)]
        g_row = [rs(w, TS["GW"][j]) + TS["CWg"][j] * ic for j in range(p)]
        g_row.append(rs(w, TS["G2"]) + TS["Cgg"] * ic)
        A.append(g_row)
        b = [ro(w, TS["Wy"][j]) + TS["CWy"][j] * ic for j in range(p)]
        b.append(rs(w, TS["GY"]) + TS["Cgy"] * ic)
        q = ro(w, TS["yy"]) + TS["Cyy"] * ic
        return A, b, q

    # --- stage 1: coarse delta grid as snp-shared batched GEMMs ----------
    TS = TS32
    deltas = jax.nn.sigmoid(jnp.linspace(lo, hi, n_grid)).astype(fast)
    d_grid = (1 - deltas)[:, None] * TS["S"][None] + deltas[:, None]  # (K,R)
    Wd = 1.0 / d_grid
    logdet_grid = jnp.sum(jnp.log(d_grid), axis=-1) \
        + (n - R) * jnp.log(deltas)                     # (K,)
    inv_d = (1.0 / deltas)[None]                        # (1, K)

    red_o = lambda t: (Wd @ t)[None]                    # (1, K)
    red_s = lambda t: (Wd @ t).T                        # (S, K)
    ro_g = lambda w, t: red_o(t)
    rs_g = lambda w, t: red_s(t)
    A_g, b_g, q_g = _ne_family(
        None, inv_d, dict(TS, CWg=TS["CWg"][:, :, None],
                          Cgy=TS["Cgy"][:, None], Cgg=TS["Cgg"][:, None]),
        rs_g, ro_g)
    beta_g, = (unrolled_chol_solve(unrolled_chol_factor(A_g), b_g),)
    rss_grid = q_g
    for j in range(p1):
        rss_grid = rss_grid - b_g[j] * beta_g[j]
    rss_collapsed = rss_grid <= 8 * jnp.finfo(fast).tiny
    rss_grid = jnp.maximum(rss_grid, jnp.finfo(fast).tiny)
    lml_grid = -0.5 * (n * jnp.log(2 * jnp.pi * rss_grid / n)
                       + logdet_grid[None] + n)         # (S, K)
    lml_grid = jnp.where(rss_collapsed | ~jnp.isfinite(lml_grid),
                         -jnp.inf, lml_grid)
    row_bad = jnp.all(~jnp.isfinite(lml_grid), axis=-1)
    k_grid = jnp.argmax(lml_grid, axis=-1)              # (S,)
    logit_grid = jnp.linspace(lo, hi, n_grid)
    br_lo = jnp.where(row_bad, lo, logit_grid[jnp.maximum(k_grid - 1, 0)])
    br_hi = jnp.where(row_bad, hi,
                      logit_grid[jnp.minimum(k_grid + 1, n_grid - 1)])

    # --- stage 2: f64 Newton on analytic ML derivatives ------------------
    ro_k = lambda w, t: w @ t                           # (S, R) @ (R,)
    rs_k = lambda w, t: jnp.einsum("sr,rs->s", w, t)

    def _derivs(delta, TS):
        dx = delta[:, None]
        d = (1 - dx) * TS["S"][None] + dx               # (S, R)
        w1 = 1.0 / d
        we2 = TS["e"][None] * w1 * w1
        we3 = TS["e2"][None] * w1 * w1 * w1
        i1 = 1.0 / delta
        i2 = i1 * i1
        i3 = i2 * i1
        A1, b1, q1 = _ne_family(w1, i1, TS, rs_k, ro_k)
        A2, b2, q2 = _ne_family(we2, i2, TS, rs_k, ro_k)
        A3, b3, q3 = _ne_family(we3, i3, TS, rs_k, ro_k)
        L1 = unrolled_chol_factor(A1)
        beta = unrolled_chol_solve(L1, b1)
        rss = q1 - sum(b1[j] * beta[j] for j in range(p1))
        rss = jnp.maximum(rss, jnp.finfo(d.dtype).tiny)
        A2b = sym_components_matvec(A2, beta)
        A3b = sym_components_matvec(A3, beta)
        beta_p = unrolled_chol_solve(
            L1, [A2b[j] - b2[j] for j in range(p1)])
        A2bp = sym_components_matvec(A2, beta_p)
        rss_p = -q2 + 2 * sum(b2[j] * beta[j] for j in range(p1)) \
            - sum(beta[j] * A2b[j] for j in range(p1))
        rss_pp = (2 * q3
                  - 4 * sum(b3[j] * beta[j] for j in range(p1))
                  + 2 * sum(b2[j] * beta_p[j] for j in range(p1))
                  - 2 * sum(beta[j] * A2bp[j] for j in range(p1))
                  + 2 * sum(beta[j] * A3b[j] for j in range(p1)))
        ld_d_p = ro_k(w1, TS["e"]) + (n - R) * i1
        ld_d_pp = -ro_k(w1 * w1, TS["e2"]) - (n - R) * i2
        u = rss_p / rss
        # ML objective: no REML logdet(A)/trace terms
        L_p = -0.5 * (n * u + ld_d_p)
        L_pp = -0.5 * (n * (rss_pp / rss - u * u) + ld_d_pp)
        return L_p, L_pp

    def _newton_step(st):
        x, lo_b, hi_b = st
        delta = jax.nn.sigmoid(x)
        Lp, Lpp = _derivs(delta, TS64)
        g_sig = delta * (1 - delta)
        Lx_p = Lp * g_sig
        Lx_pp = Lpp * g_sig * g_sig + Lp * g_sig * (1 - 2 * delta)
        lo2 = jnp.where(Lx_p > 0, x, lo_b)
        hi2 = jnp.where(Lx_p > 0, hi_b, x)
        x_newton = x - Lx_p / Lx_pp
        ok = (Lx_pp < 0) & (x_newton >= lo2) & (x_newton <= hi2) \
            & jnp.isfinite(x_newton)
        x_new = jnp.where(ok, x_newton, 0.5 * (lo2 + hi2))
        return x_new, lo2, hi2

    st = (0.5 * (br_lo + br_hi), br_lo, br_hi)
    st = jax.lax.fori_loop(0, newton_f64, lambda _, s: _newton_step(s), st)
    delta_k = jax.nn.sigmoid(st[0])                     # (S,)

    # final f64 ML evaluation at the converged delta
    dx = delta_k[:, None]
    d_k = (1 - dx) * TS64["S"][None] + dx
    A1k, b1k, q1k = _ne_family(1.0 / d_k, 1.0 / delta_k, TS64, rs_k, ro_k)
    beta_k = unrolled_chol_solve(unrolled_chol_factor(A1k), b1k)
    rss_k = q1k - sum(b1k[j] * beta_k[j] for j in range(p1))
    rss_k = jnp.maximum(rss_k, jnp.finfo(f64).tiny)
    lml_k = -0.5 * (
        n * jnp.log(2 * jnp.pi * rss_k / n)
        + jnp.sum(jnp.log(d_k), axis=-1) + (n - R) * jnp.log(delta_k)
        + n
    )
    return lml_k, jnp.stack(beta_k, axis=-1)


association_refit_kernel = jax.jit(
    association_refit_batch,
    static_argnames=("n", "delta_cfg", "newton_f64", "localize_f32"))


def association_refit_multigene_batch(ctx: NullContext, G, k_rho, n: int,
                                      delta_cfg=(-18.0, 18.0, 64, 60),
                                      newton_f64: int = 10,
                                      localize_f32: bool = True):
    """Gene-batched slow-association refits: per-variant ML alternative
    fits for a whole gene tile in one program.

    ``ctx``'s phenotype fields (y, Zy, Wy, yy) carry a leading gene axis
    (the `interaction_multigene_batch` convention) and ``k_rho`` is each
    gene's null best-rho index.  The genotype contractions (Z^T G, W^T G,
    Grams) are shared across genes by vmap's unbatched-operand rule; the
    per-gene increment is the best-rho rotations plus the per-(gene,
    variant) Newton fits.  Reference pattern per gene:
    _cellregmap.py:268-276.
    """
    axes = NullContext(y=0, W=None, E0=None, Z=None, V=None, S=None,
                       rho=None, Zy=0, ZW=None, WW=None, Wy=0, yy=0)

    def one_gene(c, k):
        return association_refit_batch(
            c, G, k, n, delta_cfg=delta_cfg, newton_f64=newton_f64,
            localize_f32=localize_f32)

    return jax.vmap(one_gene, in_axes=(axes, 0))(ctx, k_rho)


association_refit_multigene_kernel = jax.jit(
    association_refit_multigene_batch,
    static_argnames=("n", "delta_cfg", "newton_f64", "localize_f32"))


@functools.partial(jax.jit, static_argnames=("n", "delta_cfg"))
def association_refit_golden_kernel(ctx: NullContext, G, k_rho, n: int,
                                    delta_cfg=(-18.0, 18.0, 64, 60)):
    """Golden-section refit (round-3 path), kept as the parity oracle for
    :func:`association_refit_batch`."""
    ZG = ctx.Z.T @ G
    Wg = ctx.W.T @ G
    gg = jnp.sum(G * G, axis=0)
    gy = G.T @ ctx.y
    Vb = jnp.take(ctx.V, k_rho, axis=0)
    Sb = jnp.take(ctx.S, k_rho, axis=0)
    lo, hi, n_grid, n_iters = delta_cfg

    def per_snp(zg, wg, gg_s, gy_s):
        Xz = jnp.concatenate([ctx.ZW, zg[:, None]], axis=1)
        XX = jnp.block([[ctx.WW, wg[:, None]], [wg[None, :], gg_s[None, None]]])
        Xy = jnp.concatenate([ctx.Wy, gy_s[None]])
        Xt = Vb.T @ Xz
        yt = Vb.T @ ctx.Zy
        data = lmm_mod.EigData(
            S=Sb, Xt=Xt, yt=yt,
            Cxx=XX - Xt.T @ Xt,
            cxy=Xy - Xt.T @ yt,
            cyy=ctx.yy - yt @ yt,
        )
        fit = lmm_mod.fit_delta_eig(data, n, False, lo, hi, n_grid, n_iters)
        return fit.lml, fit.beta

    return jax.vmap(per_snp, in_axes=(1, 1, 0, 0))(ZG, Wg, gg, gy)


@functools.partial(jax.jit, static_argnames=("n",))
def fast_scan_kernel(ctx: NullContext, G, k_rho, delta, n: int):
    """Closed-form alternative lmls for all variants (FastScanner parity).

    Reference path: _cellregmap.py:306-309 via glimix-core FastScanner.
    """
    Vb = jnp.take(ctx.V, k_rho, axis=0)
    Sb = jnp.take(ctx.S, k_rho, axis=0)
    Wt = Vb.T @ ctx.ZW
    yt = Vb.T @ ctx.Zy
    ZG = ctx.Z.T @ G
    Gt = Vb.T @ ZG
    CWG = ctx.W.T @ G - Wt.T @ Gt
    cGy = G.T @ ctx.y - Gt.T @ yt
    cGG = jnp.sum(G * G, axis=0) - jnp.sum(Gt * Gt, axis=0)
    return lmm_mod.fast_scan(
        delta, Sb, Wt, yt,
        ctx.WW - Wt.T @ Wt, ctx.Wy - Wt.T @ yt, ctx.yy - yt @ yt,
        Gt, CWG, cGy, cGG, n,
    )


@functools.partial(jax.jit, static_argnames=("n", "restricted", "delta_cfg"))
def null_association_multigene_kernel(ctx: NullContext, n: int,
                                      restricted: bool = False,
                                      delta_cfg=(-18.0, 18.0, 64, 60)):
    """Covariate-only null fits for a gene batch in one program.

    ``ctx``'s phenotype fields (y, Zy, Wy, yy) carry a leading gene axis
    (the `interaction_multigene_batch` convention); the per-rho eigenbases
    are shared.  Returns per-gene fits (leading gene axis) plus each gene's
    best-rho index.  Reference: one serial 11-fit loop per gene
    (_cellregmap.py:289-298).
    """
    axes = NullContext(y=0, W=None, E0=None, Z=None, V=None, S=None,
                       rho=None, Zy=0, ZW=None, WW=None, Wy=0, yy=0)

    def one_gene(c):
        fits = _fit_over_rho(c, c.ZW, c.WW, c.Wy, n, restricted, delta_cfg)
        return fits, jnp.argmax(fits.lml)

    return jax.vmap(one_gene, in_axes=(axes,))(ctx)


@functools.partial(jax.jit, static_argnames=("n",))
def fast_scan_multigene_kernel(ctx: NullContext, G, k_rho, delta, n: int):
    """Closed-form alternative lmls for all (gene, variant) pairs.

    ``ctx``'s phenotype fields carry a leading gene axis; ``k_rho`` and
    ``delta`` are per-gene (each gene's null picks its own best rho and
    variance ratio).  The genotype contractions (Z^T G, W^T G, G^T Y, gg)
    are computed once and shared across genes; the per-gene increment is
    one best-rho rotation plus the rank-1 closed-form updates.  Reference
    path per gene: _cellregmap.py:306-309 via glimix-core FastScanner.
    """
    ZG = ctx.Z.T @ G                                    # (R, S)
    WG = ctx.W.T @ G                                    # (p, S)
    gg = jnp.sum(G * G, axis=0)                         # (S,)
    GY = G.T @ ctx.y.T                                  # (S, n_genes)

    def one_gene(zy, wy, yy, gy, k, d):
        Vb = jnp.take(ctx.V, k, axis=0)
        Sb = jnp.take(ctx.S, k, axis=0)
        Wt = Vb.T @ ctx.ZW
        yt = Vb.T @ zy
        Gt = Vb.T @ ZG
        return lmm_mod.fast_scan(
            d, Sb, Wt, yt,
            ctx.WW - Wt.T @ Wt, wy - Wt.T @ yt, yy - yt @ yt,
            Gt, WG - Wt.T @ Gt, gy - Gt.T @ yt,
            gg - jnp.sum(Gt * Gt, axis=0), n,
        )

    return jax.vmap(one_gene, in_axes=(0, 0, 0, 1, 0, 0))(
        ctx.Zy, ctx.Wy, ctx.yy, GY, k_rho, delta)


# --------------------------------------------------------------------------
# Effect-size estimation (Woodbury backend)
# --------------------------------------------------------------------------
class BetasContext(NamedTuple):
    """State for estimate_betas: fixed background U Lam U^T = sum_i L_i L_i^T.

    The mean design is D = [B, g] where B is the full-rank economic-SVD
    reduction of [W, E0] (glimix-core's tX = U S convention): the reference's
    M = [W, g, E0] (_cellregmap.py:155) is frequently *exactly* rank
    deficient (block-structured contexts span the intercept), and glimix's
    LMM fits on the SVD-reduced design.  Fitting the raw collinear design
    instead contaminates logdet(M^T D^{-1} M) with O(1) noise and corrupts
    the rho/delta argmaxes.  beta_g is the (unique, identifiable) g
    coefficient = the last entry of the reduced-design solution.
    """

    y: jax.Array       # (n,)
    B: jax.Array       # (n, pB) reduced design basis of [W, E0]
    E0: jax.Array      # (n, C)
    Zk: jax.Array      # (n, Rk) EIGEN-basis of the background (Vk folded
    #                     in at setup: Zk diag(Lam) Zk^T = sum_i L_i L_i^T,
    #                     so per-variant rotations come straight out of the
    #                     Khatri-Rao matmul with no extra Rk^2 rotation)
    Lam: jax.Array     # (Rk,)
    rho: jax.Array     # (n_rho,)
    uy: jax.Array      # (Rk,)  U^T y
    UB: jax.Array      # (Rk, pB)
    BB: jax.Array      # (pB, pB)
    By: jax.Array      # (pB,)
    yy: jax.Array


def reduced_design_basis(W, E0):
    """Full-rank basis of span[W, E0] in glimix tX = U S convention (host)."""
    import numpy as _np

    WE = _np.concatenate([_np.asarray(W, float), _np.asarray(E0, float)],
                         axis=1)
    U, sv, _ = _np.linalg.svd(WE, full_matrices=False)
    keep = sv >= _np.sqrt(_np.finfo(float).eps)
    return U[:, keep] * sv[keep]


def build_betas_context(y, W, E0, Ls: Optional[Sequence], rho_grid=None,
                        dtype=jnp.float64):
    # Pure-NumPy setup with one device upload at the end (same rationale as
    # build_null_context); Gk comes free from the QR R factor.
    import numpy as _np

    y_np = _np.asarray(jax.device_get(y), float).ravel()
    n = y_np.shape[0]
    W_np = (_np.ones((n, 1)) if W is None
            else _np.asarray(jax.device_get(W), float))
    E0_np = _np.asarray(jax.device_get(E0), float)
    B_np = reduced_design_basis(W_np, E0_np)
    parts = [_np.asarray(jax.device_get(L), float) for L in (Ls or [])]
    if parts:
        F = _np.concatenate(parts, axis=1)
        # Gram-route basis instead of host QR (dgeqrf is ~10x slower than
        # dgemm on the bench host; see _gram_basis), then the exact small
        # eigendecomposition of the represented covariance T T^T folded
        # into Zk — identical math to the previous QR -> eigh -> fold.
        Z0_np, T_np = _gram_basis(F)
        Lam_np, Vk_np = _np.linalg.eigh(T_np @ T_np.T)
        Lam_np = _np.maximum(Lam_np, 0.0)
        Zk_np = Z0_np @ Vk_np  # fold the eigenbasis into Zk (see above)
    else:
        # Degenerate background (reference still runs: hSigma_p = sqrt(rho) gE
        # only, _cellregmap.py:164-166).
        Zk_np = _np.zeros((n, 1))
        Lam_np = _np.zeros((1,))
    if rho_grid is None:
        rho_grid = _np.linspace(0.0, 1.0, 11)
    rho_np = _np.asarray(jax.device_get(rho_grid), float)
    U_T = lambda M: Zk_np.T @ M
    j = lambda a: jnp.asarray(a, dtype)
    return BetasContext(
        y=j(y_np), B=j(B_np), E0=j(E0_np), Zk=j(Zk_np),
        Lam=j(Lam_np), rho=j(rho_np),
        uy=j(U_T(y_np)), UB=j(U_T(B_np)),
        BB=j(B_np.T @ B_np), By=j(B_np.T @ y_np), yy=j(y_np @ y_np),
    )


@functools.partial(jax.jit,
                   static_argnames=("n", "delta_cfg", "localize_f32"))
@full_f32_matmuls
def predict_interaction_kernel(ctx: BetasContext, G, norm, n: int,
                               delta_cfg=(-18.0, 18.0, 64, 60),
                               localize_f32: bool = False):
    """Per-variant REML fits with covariance rho (gE)(gE)^T + (1-rho) K(.)E.

    Replaces the reference's per-SNP x per-rho thin SVDs
    (_cellregmap.py:152-198) with the Woodbury backend: no factorization at
    all per variant, just rank-C capacitance solves.  Returns
    (beta_g (S,), alpha_gxe (C, S)) with beta_gxe = E0 @ alpha_gxe computed
    by the caller as one matmul.  ``localize_f32`` runs the delta-grid
    localization in f32 (hybrid precision; final fits stay f64).

    The mean design is the reduced [B, g] (see :class:`BetasContext`);
    beta_g is the last coefficient.
    """
    B, E0, y = ctx.B, ctx.E0, ctx.y
    pB = B.shape[1]
    C = E0.shape[1]
    S = G.shape[1]
    lo, hi, n_grid, n_iters = delta_cfg

    # Heavy contractions, once per batch.  Zk is already the background
    # eigenbasis (Vk folded in at setup), so the Khatri-Rao rotate IS the
    # per-variant Ua — no extra Rk^2 rotation per variant.
    Tk = _khatri_rao_rotate(ctx.Zk, E0, G)           # (C, Rk, S) = Ua^T
    ZkG = ctx.Zk.T @ G                               # (Rk, S) = ug
    M2 = _e0_weighted_grams(E0, G * G)               # (C, C, S)  A^T A
    AB = _cross_weighted_grams(E0, B, G)             # (C, pB, S)  A^T B
    ay = E0.T @ (G * y[:, None])                     # (C, S)
    Ag2 = E0.T @ (G * G)                             # (C, S)  A^T g
    Bg = B.T @ G                                     # (pB, S)
    gg = jnp.sum(G * G, axis=0)
    gy = G.T @ y

    # batched rotated columns [Ua | UB, ug | uy]: (S, Rk, q)
    Rk = ctx.Lam.shape[0]
    q = C + pB + 2
    UaS = Tk.transpose(2, 1, 0)                      # (S, Rk, C)
    colsS = jnp.concatenate([
        UaS,
        jnp.broadcast_to(ctx.UB[None], (S, Rk, pB)),
        ZkG.T[:, :, None],
        jnp.broadcast_to(ctx.uy[None, :, None], (S, Rk, 1)),
    ], axis=2)

    # batched full-space Grams of [A | B, g | y]: (S, q, q)
    def gram_snp(m2, ab, ay_s, ag2, bg, gg_s, gy_s):
        xx = jnp.block([
            [ctx.BB, bg[:, None]],
            [bg[None, :], gg_s[None, None]],
        ])
        xy = jnp.concatenate([ctx.By, gy_s[None]])
        Ax = jnp.concatenate([ab, ag2[:, None]], axis=1)
        return jnp.block([
            [m2, Ax, ay_s[:, None]],
            [Ax.T, xx, xy[:, None]],
            [ay_s[None, :], xy[None, :], ctx.yy[None, None]],
        ])

    GfullS = jax.vmap(gram_snp, in_axes=(2, 2, 1, 1, 1, 0, 0))(
        M2, AB, ay, Ag2, Bg, gg, gy)

    # per-variant best-rho fits (the family fitter prunes + argmaxes rho)
    lml, delta, beta, scale, v0, v1, rho1 = \
        lmm_mod.fit_delta_woodbury_family(
            colsS, GfullS, ctx.Lam, ctx.rho, n, True, C,
            lo, hi, n_grid, localize_f32=localize_f32)

    beta_g = beta[:, pB]  # the g coefficient (last design column)

    # v = (v0 Sigma_p + v1 I)^{-1} (y - M beta) = D^{-1} r / scale
    def per_snp_alpha(cols_s, m2, ay_s, ag2, ab, rho1_s, delta_s, v0_s,
                      scale_s, beta_s, norm_s):
        Ua = cols_s[:, :C]                           # (Rk, C)
        Ux = cols_s[:, C : C + pB + 1]               # (Rk, pB+1)
        Ax = jnp.concatenate([ab, ag2[:, None]], axis=1)
        c = (1 - delta_s) * rho1_s
        m = (1 - delta_s) * (1 - rho1_s) * ctx.Lam + delta_s
        wm = 1.0 / m
        ur = ctx.uy - Ux @ beta_s                     # (Rk,)
        ar = ay_s - Ax @ beta_s                       # (C,)
        AmR = Ua.T @ (ur * wm) + (ar - Ua.T @ ur) / delta_s
        H = Ua.T @ (Ua * wm[:, None]) + (m2 - Ua.T @ Ua) / delta_s
        cap = jnp.eye(C, dtype=m2.dtype) + c * H
        AdR = AmR - c * H @ spd_solve(cap, AmR)
        return (v0_s * rho1_s) * AdR / scale_s * norm_s   # (C,)

    alpha = jax.vmap(per_snp_alpha,
                     in_axes=(0, 2, 1, 1, 2, 0, 0, 0, 0, 0, 0))(
        colsS, M2, ay, Ag2, AB, rho1, delta, v0, scale, beta, norm)
    return beta_g, alpha.T, {"rho1": rho1, "v0": v0, "v1": v1, "lml": lml}
