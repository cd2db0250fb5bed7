"""Public CellRegMap API (NumPy in / NumPy out).

Mirrors the reference's intended surface (/root/reference/cellregmap/
_cellregmap.py: class CellRegMap :23-440 and the module-level wrappers
:471-682), with the reference wrappers' argument-order bugs fixed (SURVEY.md
section 2.2): ``run_association``/``run_association_fast`` pass W and E to
the class correctly, and ``run_interaction`` forwards the permutation index
to ``idx_G``.

All heavy compute is dispatched to the batched device kernels in
``cellregmap_tpu.engine``; this layer does padding, batching, p-value ladder
dispatch and result assembly.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from . import engine
from ._config import DEFAULT_CONFIG, ScanConfig
from .models import pvalues as pv_mod
from .models.pvalues import lrt_pvalues
from .ops.hadamard import get_L_values as _get_L_values_jax
from .utils import trace
from .utils.maf import compute_maf


def get_L_values(hK, E):
    """Factors L_i with sum_i L_i L_i^T = K (.) EE^T (reference :533-545)."""
    return [np.asarray(L) for L in _get_L_values_jax(hK, E)]


def _pad_batch(G, batch):
    """Pad the variant axis to a multiple of ``batch`` by repeating col 0."""
    n_snps = G.shape[1]
    rem = (-n_snps) % batch
    if rem:
        G = np.concatenate([G, np.repeat(G[:, :1], rem, axis=1)], axis=1)
    return G, n_snps


def _pipelined(starts, launch, window: int = 4):
    """Dispatch ``launch(start)`` for every start, keeping up to ``window``
    device computations in flight before blocking on ``jax.device_get`` —
    h2d transfers and host-side assembly overlap device compute."""
    pending, outs = [], []
    for s in starts:
        pending.append(launch(s))
        if len(pending) >= window:
            outs.append(jax.device_get(pending.pop(0)))
    while pending:
        outs.append(jax.device_get(pending.pop(0)))
    return outs


def _run_checkpointed(starts, launch, checkpoint, ck_meta,
                      checkpoint_every: int = 1, axes=None, progress=False,
                      desc: str = "scan"):
    """Run ``launch(start) -> dict of arrays`` for every start with an
    optional durable cursor checkpoint (SURVEY 5.3/5.4).

    Without a checkpoint the batches run pipelined (window 4).  With one,
    batches serialize so every completed batch is durable before the next
    dispatch; a restarted call with matching ``ck_meta`` (shapes + content
    fingerprints) resumes at the cursor.  ``axes`` maps result keys to
    their concatenation axis (default 0).  Returns the concatenated dict.
    """
    axes = axes or {}
    cat = lambda accs: {k: np.concatenate([np.asarray(a[k]) for a in accs],
                                          axis=axes.get(k, 0))
                        for k in accs[0]}
    ckpt = None
    done = 0
    acc = []
    if checkpoint is not None:
        from .parallel.checkpoint import ScanCheckpoint

        ckpt = ScanCheckpoint(checkpoint)
        state = ckpt.load()
        if (state is not None
                and all(state["meta"].get(k) == v
                        for k, v in ck_meta.items())):
            done = state["cursor"]
            acc = [dict(state["results"])]
    todo = list(starts)[done:]
    n_total = len(list(starts))
    if ckpt is None:
        outs = _pipelined(_batch_starts(todo, 1, progress, desc), launch)
        acc.extend({k: np.asarray(v) for k, v in o.items()} for o in outs)
    else:
        for s in _batch_starts(todo, 1, progress, desc):
            out = jax.device_get(launch(s))
            acc.append({k: np.asarray(v) for k, v in out.items()})
            done += 1
            if done % checkpoint_every == 0 or done == n_total:
                flat = cat(acc)
                ckpt.save(done, flat, ck_meta)
                acc = [flat]
    flat = cat(acc) if acc else {}
    if ckpt is not None:
        ckpt.clear()
    return flat


def _content_sha(*arrays) -> str:
    """Short content fingerprint of checkpoint inputs (resume safety)."""
    import hashlib

    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(np.asarray(a, float)).tobytes())
    return h.hexdigest()[:16]


def _batch_starts(total, batch, progress, desc):
    """Batch-start iterator with optional tqdm progress (the reference shows
    per-SNP tqdm bars, _cellregmap.py:270,340).  ``total`` may be an int
    (iterate 0..total step batch) or an explicit list of batch starts."""
    starts = range(0, total, batch) if isinstance(total, int) else total
    if progress:
        try:
            from tqdm import tqdm

            return tqdm(starts, desc=desc, unit="batch")
        except ImportError:
            pass
    return starts


class CellRegMap:
    """Mixed-model with genetic effect heterogeneity (batched JAX engine).

    The model (reference docstring _cellregmap.py:24-61):

        y = W a + g b1 + g (.) b2 + e + u + eps,
        b2 ~ N(0, v3 E0 E0^T),          e ~ N(0, v1 rho1 E1 E1^T),
        u ~ N(0, v1 (1-rho1) K (.) E2 E2^T),   eps ~ N(0, v2 I).

    Interaction test: H0: v3 = 0 vs H1: v3 > 0 (score test).
    """

    def __init__(self, y, E, W=None, Ls=None, E1=None, hK=None,
                 config: ScanConfig = DEFAULT_CONFIG):
        self._cfg = config
        dtype = jnp.float64 if config.dtype == "float64" else jnp.float32

        y = np.asarray(y, float).ravel()
        E0 = np.asarray(E, float)
        E1 = E0 if E1 is None else np.asarray(E1, float)
        n = y.shape[0]
        W = np.ones((n, 1)) if W is None else np.asarray(W, float)
        if W.ndim == 1:
            W = W[:, None]
        Ls = [] if Ls is None else [np.asarray(L, float) for L in Ls]

        assert W.ndim == 2 and E0.ndim == 2 and E1.ndim == 2
        assert y.shape[0] == W.shape[0] == E0.shape[0] == E1.shape[0]
        for L in Ls:
            assert L.ndim == 2 and L.shape[0] == n
        # NaN/inf guard (the reference crashes deep inside glimix instead)
        for name, arr in (("y", y), ("W", W), ("E", E0), ("E1", E1)):
            if not np.isfinite(arr).all():
                raise ValueError(f"{name} contains non-finite values")

        if len(Ls) or hK is not None:
            rho_grid = np.linspace(0, 1, config.n_rho)
        else:
            rho_grid = np.array([1.0])

        self._y, self._W, self._E0, self._E1 = y, W, E0, E1
        self._Ls, self._hK = Ls, hK
        self._n = n
        self._rho_grid = rho_grid
        self._ctx_cache = None
        self._ctx32_cache = None
        self._dtype = dtype
        self._null_assoc = None
        self._bctx = None

    @property
    def _ctx(self):
        """Null-covariance factorization, built lazily on first use.

        A betas-only workflow (estimate_betas/predict_interaction) never
        touches the interaction/association null family, whose one-time
        host factorization dominates setup at large n — so construction is
        deferred until a scan needs it.
        """
        if self._ctx_cache is None:
            self._ctx_cache = engine.build_null_context(
                self._y, self._W, self._E1, E0=self._E0,
                Ls=self._Ls if len(self._Ls) else None, hK=self._hK,
                rho_grid=self._rho_grid, dtype=self._dtype,
            )
        return self._ctx_cache

    @property
    def n_samples(self) -> int:
        return self._y.shape[0]

    def with_phenotype(self, y) -> "CellRegMap":
        """A scanner for a different gene sharing this one's factorization.

        The expensive per-dataset state (workspace basis Z, per-rho
        eigendecompositions) depends only on (E, W, K) and is reused; only
        the phenotype rotations are recomputed.  The reference rebuilds the
        whole object per gene (_cellregmap.py:63-131).
        """
        y = np.asarray(y, float).ravel()
        if y.shape[0] != self._n:
            raise ValueError("phenotype length mismatch")
        if not np.isfinite(y).all():
            raise ValueError("y contains non-finite values")
        new = object.__new__(CellRegMap)
        new.__dict__ = dict(self.__dict__)
        new._y = y
        yj = jnp.asarray(y, self._dtype)
        new._ctx_cache = self._ctx._replace(
            y=yj, Zy=self._ctx.Z.T @ yj, Wy=self._ctx.W.T @ yj, yy=yj @ yj
        )
        new._ctx32_cache = None
        new._null_assoc = None
        # the betas context's y-independent parts (background eigenbasis,
        # reduced design) are shared; only the y-rotations are recomputed
        if self._bctx is not None:
            b = self._bctx
            new._bctx = b._replace(y=yj, uy=b.Zk.T @ yj, By=b.B.T @ yj,
                                   yy=yj @ yj)
        return new

    # -- interaction -------------------------------------------------------
    def scan_interaction(self, G, idx_E=None, idx_G=None,
                         checkpoint=None, checkpoint_every: int = 1):
        """Score test for GxC interaction per variant (reference :317-440).

        Returns ``(pvalues, info)`` with info = {rho1, e2, g2, eps2} arrays.

        ``checkpoint``: optional directory; completed variant batches are
        persisted there (cursor + result tables) and a restarted scan with
        the same inputs resumes from the cursor instead of redoing per-SNP
        work (the reference loses everything on a crash, SURVEY 5.3/5.4).
        """
        cfg = self._cfg
        G = np.asarray(G, float)
        if G.ndim == 1:
            G = G[:, None]
        ctx = self._ctx
        if idx_E is not None:
            ctx = ctx._replace(E0=jnp.asarray(self._E0[np.asarray(idx_E), :],
                                              self._dtype))
        Gs = G if idx_G is None else G[np.asarray(idx_G), :]

        batch = min(cfg.snp_batch, self._auto_batch_cap(),
                    max(G.shape[1], 1))
        Gp, n_snps = _pad_batch(G, batch)
        Gsp, _ = _pad_batch(Gs, batch)

        delta_cfg = (cfg.delta_logit_lo, cfg.delta_logit_hi,
                     cfg.n_delta_grid_interaction, cfg.n_golden_iters)
        timers = trace.PhaseTimers() if cfg.trace else None

        ckpt = None
        start_batch = 0
        outs = []
        ck_meta = {"n_snps": n_snps, "batch": batch,
                   "inputs_sha": (_content_sha(self._y, G)
                                  if checkpoint else None)}
        if checkpoint is not None:
            from .parallel.checkpoint import ScanCheckpoint

            ckpt = ScanCheckpoint(checkpoint)
            state = ckpt.load()
            if (state is not None
                    and all(state["meta"].get(k) == v
                            for k, v in ck_meta.items())):
                start_batch = state["cursor"]
                outs = [state["results"]]

        # Pipelined dispatch: XLA execution is async, so enqueue a window of
        # batches ahead before blocking on device_get — host work (h2d of
        # the next batch, result assembly, AND the p-value ladder: host
        # eigvalsh of the weight matrices + the threaded Davies C pass)
        # overlaps device compute instead of serializing with it.  Running
        # the ladder per drained batch (instead of once at the end) hides
        # its ~0.06 s/batch behind the next batch's device time.
        # Checkpointed scans serialize (window 1) so every completed batch
        # is durable before the next one is dispatched.
        window = 4 if ckpt is None else 1
        pending: list = []
        done = start_batch
        pv_parts: list = []
        lam_parts: list = []

        def _ladder_one(o):
            with trace.trace_scope("interaction/pvalue_ladder", timers) \
                    if timers else contextlib.nullcontext():
                pv_b, lam_b = self._pvalue_ladder(
                    o["Q"], o["lambdas"], o["pv_liu"],
                    o["pv_saddlepoint"], Wmat=o.get("Wmat"))
            pv_parts.append(np.asarray(pv_b))
            lam_parts.append(np.asarray(lam_b))

        if outs:  # resumed checkpoint blob: run its ladder up front
            _ladder_one(outs[0])

        def _drain(k):
            nonlocal done
            while len(pending) > k:
                with trace.trace_scope("interaction/device_get", timers) \
                        if timers else contextlib.nullcontext():
                    out = jax.device_get(pending.pop(0))
                outs.append(out)
                _ladder_one(out)
                done += 1
                if ckpt is not None and (done % checkpoint_every == 0
                                         or not pending):
                    flat = {kk: np.concatenate([np.asarray(o[kk])
                                                for o in outs])
                            for kk in outs[0]}
                    ckpt.save(done, flat, ck_meta)
                    outs[:] = [flat]
                    pv_parts[:] = [np.concatenate(pv_parts)]
                    lam_parts[:] = [np.concatenate(lam_parts)]

        all_starts = list(range(0, Gp.shape[1], batch))[start_batch:]
        for start in _batch_starts(all_starts, batch, cfg.progress,
                                   "scan_interaction"):
            with trace.trace_scope("interaction/dispatch", timers) \
                    if timers else contextlib.nullcontext():
                gb = jnp.asarray(Gp[:, start : start + batch], self._dtype)
                gsb = jnp.asarray(Gsp[:, start : start + batch], self._dtype)
                pending.append(engine.interaction_kernel(
                    ctx, gb, gsb, self._n, delta_cfg=delta_cfg,
                    # exact (davies) mode gets its eigenvalues on host from
                    # Wmat; skip the costly batched device eigh + tails
                    device_pvalues=(cfg.pvalue_method != "davies"),
                    localize_f32=cfg.hybrid_localization,
                ))
            _drain(window - 1)
        _drain(0)
        res = {k: np.concatenate([np.asarray(o[k]) for o in outs])[:n_snps]
               for k in outs[0]}
        if ckpt is not None:
            ckpt.clear()

        pvalues = np.concatenate(pv_parts)[:n_snps]
        lambdas = np.concatenate(lam_parts)[:n_snps]
        info = {k: np.asarray(res[k], float)
                for k in ("rho1", "e2", "g2", "eps2")}
        info["Q"] = res["Q"]
        info["lambdas"] = lambdas
        # in davies mode the device approximations are skipped entirely —
        # don't surface placeholder arrays as if they were real p-values
        if cfg.pvalue_method != "davies":
            info["pv_liu"] = res["pv_liu"]
            info["pv_saddlepoint"] = res["pv_saddlepoint"]
        if timers is not None:
            info["timers"] = timers.summary()
            trace.log_event("scan_interaction", n_snps=n_snps, batch=batch,
                            **{f"s_{k.rsplit('/', 1)[-1]}": round(v, 4)
                               for k, v in timers.summary().items()})
        return np.asarray(pvalues, float), info

    # -- two-pass screen -> confirm (f32 screen, f64 + Davies confirm) -----
    def _with_config(self, config: ScanConfig) -> "CellRegMap":
        """A view of this scanner with a different config (shared caches)."""
        new = object.__new__(CellRegMap)
        new.__dict__ = dict(self.__dict__)
        new._cfg = config
        return new

    @property
    def _ctx32(self):
        """Float32 copy of the null context, built lazily for the screen
        pass: the screen runs the WHOLE interaction kernel's heavy tensors
        in f32 and the confirm pass re-tests candidate hits through the
        full f64 + Davies path."""
        if self._ctx32_cache is None:
            self._ctx32_cache = jax.tree.map(
                lambda a: a.astype(jnp.float32), self._ctx)
        return self._ctx32_cache

    def _confirm_scanner(self) -> "CellRegMap":
        """Scanner used by the confirm pass: exact Davies tails always."""
        if self._cfg.dtype != "float64":
            raise ValueError(
                "screen->confirm scans need a float64 base config (the "
                "confirm pass re-tests hits at full precision)")
        if self._cfg.pvalue_method == "davies":
            return self
        import dataclasses

        return self._with_config(dataclasses.replace(
            self._cfg, pvalue_method="davies"))

    def scan_interaction_screen(self, G, significance: float = 5e-8,
                                screen_margin: float = 100.0,
                                checkpoint=None,
                                checkpoint_every: int = 1):
        """Two-pass interaction scan: f32 screen of every pair, exact
        f64 + Davies re-test of candidate hits.

        Pass 1 runs the full interaction kernel (REML fits, score
        statistic, mixture weights, saddlepoint tail) with float32 heavy
        tensors at full float32 precision.  Pass 2 gathers every pair whose
        screen p-value falls below ``significance * screen_margin`` (or is
        non-finite) and re-tests it through the standard full-precision
        path with exact Davies tails.

        Contract: any pair whose full-f64 p-value is below ``significance``
        is (a) in the confirmed set and (b) reported with its exact
        f64 + Davies p-value, PROVIDED the screen error stays within
        ``screen_margin`` (the screen error is measured against an f64
        saddlepoint scan by chip_smoke.py at the 10k-cell north-star shape
        and by tests/test_screen.py; the default margin is 2 decades).
        Pairs above the threshold carry the f32 saddlepoint approximation.

        Returns ``(pvalues, info)``; ``info["confirmed"]`` marks re-tested
        pairs, ``info["screen_pv"]`` keeps the raw screen p-values.

        This generalizes the reference's only genome-scale answer
        (``scan_association_fast``, _cellregmap.py:284-314) to the
        interaction scan: exact where it matters, fast everywhere else.
        """
        cfg = self._cfg
        G = np.asarray(G, float)
        if G.ndim == 1:
            G = G[:, None]
        n_snps = G.shape[1]
        thr = min(1.0, float(significance) * float(screen_margin))

        ctx32 = self._ctx32
        # f32 temporaries are smaller than the f64 ones _auto_batch_cap
        # budgets for, so the screen can run wider batches; 4x keeps slack
        # for the f32 score tensors
        batch = min(cfg.snp_batch * 2, 4 * self._auto_batch_cap(),
                    max(n_snps, 1))
        Gp, _ = _pad_batch(G, batch)
        delta_cfg = (cfg.delta_logit_lo, cfg.delta_logit_hi,
                     cfg.n_delta_grid_interaction, cfg.n_golden_iters)

        def _launch(start):
            gb = jnp.asarray(Gp[:, start : start + batch], jnp.float32)
            out = engine.interaction_kernel(
                ctx32, gb, gb, self._n, delta_cfg=delta_cfg,
                device_pvalues=True)
            return {k: out[k] for k in ("pv_saddlepoint", "pv_liu", "Q",
                                        "rho1", "e2", "g2", "eps2")}

        ck_meta = {"scan": "interaction_screen", "n_snps": n_snps,
                   "batch": batch,
                   "inputs_sha": (_content_sha(self._y, G)
                                  if checkpoint else None)}
        scr = _run_checkpointed(
            range(0, Gp.shape[1], batch), _launch, checkpoint, ck_meta,
            checkpoint_every, progress=cfg.progress, desc="screen")
        scr = {k: v[:n_snps] for k, v in scr.items()}
        sp = np.asarray(scr["pv_saddlepoint"], float)
        liu = np.asarray(scr["pv_liu"], float)
        screen_pv = np.where(np.isfinite(sp), sp, liu)

        hits = (~np.isfinite(screen_pv)) | (screen_pv < thr)
        idx = np.flatnonzero(hits)

        pvalues = np.asarray(screen_pv, float).copy()
        info = {k: np.asarray(scr[k], float)
                for k in ("rho1", "e2", "g2", "eps2", "Q")}
        if idx.size:
            # pad the hit set to one canonical confirm width so every
            # screen run shares a single compiled f64 program; 64 wide —
            # hit sets are small by design, and padding a handful of hits
            # to a full snp_batch made the confirm pass cost ~8x the whole
            # screen (measured at C=20: 3 underflow pairs -> a 512-wide
            # f64 batch)
            cb = min(64, cfg.snp_batch, self._auto_batch_cap())
            Gh = G[:, idx]
            pad = (-Gh.shape[1]) % cb
            if pad:
                Gh = np.concatenate(
                    [Gh, np.repeat(Gh[:, :1], pad, axis=1)], axis=1)
            import os as _os

            pv_c, info_c = self._confirm_scanner().scan_interaction(
                Gh,
                checkpoint=(_os.path.join(str(checkpoint), "confirm")
                            if checkpoint else None),
                checkpoint_every=checkpoint_every)
            pvalues[idx] = pv_c[: idx.size]
            for k in info:
                info[k][idx] = np.asarray(info_c[k], float)[: idx.size]
        info["screen_pv"] = screen_pv
        info["confirmed"] = hits
        info["screen_threshold"] = thr
        info["n_confirmed"] = int(idx.size)
        return pvalues, info

    def scan_interaction_multigene_screen(self, Y, G, gene_batch: int = 16,
                                          significance: float = 5e-8,
                                          screen_margin: float = 100.0):
        """Gene-batched two-pass screen -> confirm interaction scan.

        Pass 1 runs the gene-batched f32 kernel over every (gene, variant)
        pair (see :meth:`scan_interaction_screen` for the precision
        contract); pass 2 re-tests each gene's candidate hits through the
        exact single-gene f64 + Davies path (hit sets are padded to one
        canonical width, so the confirm pass compiles once).

        Returns ``(pvalues (n_genes, n_snps), info)`` with
        ``info["confirmed"]`` / ``info["screen_pv"]`` shaped like pvalues.
        """
        cfg = self._cfg
        Y = np.asarray(Y, float)
        if Y.ndim == 1:
            Y = Y[:, None]
        G = np.asarray(G, float)
        if G.ndim == 1:
            G = G[:, None]
        n_genes, n_snps = Y.shape[1], G.shape[1]
        gtile = max(1, min(gene_batch, n_genes))
        thr = min(1.0, float(significance) * float(screen_margin))

        ctx32 = self._ctx32
        R = int(self._ctx.S.shape[1])
        nrho = int(self._ctx.S.shape[0])
        C = int(self._ctx.E0.shape[1])
        # the screen's heavy tensors are f32, but its statistics stages
        # hold the SAME (gene, S, nrho, R) f64 weight family as the f64
        # multigene kernel (engine `sd`) — budget with the f64 accounting
        # (see scan_interaction_multigene's OOM note)
        per_gv = (nrho * R * 2 + (3 * C + 6) * R) * 8 * 8
        batch = min(cfg.snp_batch * 2, max(16, int(5e9 / per_gv / gtile)))
        Gp, _ = _pad_batch(G, batch)
        Yp, _ = _pad_batch(Y, gtile)
        delta_cfg = (cfg.delta_logit_lo, cfg.delta_logit_hi,
                     cfg.n_delta_grid_interaction, cfg.n_golden_iters)
        Z32, W32 = ctx32.Z, ctx32.W

        tiles = []
        for g0 in _batch_starts(range(0, Yp.shape[1], gtile), gtile,
                                cfg.progress, "screen_multigene"):
            Yt = jnp.asarray(Yp[:, g0 : g0 + gtile], jnp.float32)
            ctx_g = ctx32._replace(
                y=Yt.T, Zy=(Z32.T @ Yt).T, Wy=(W32.T @ Yt).T,
                yy=jnp.sum(Yt * Yt, axis=0),
            )
            outs = _pipelined(
                range(0, Gp.shape[1], batch),
                lambda start: engine.interaction_multigene_kernel(
                    ctx_g, jnp.asarray(Gp[:, start : start + batch],
                                       jnp.float32),
                    jnp.asarray(Gp[:, start : start + batch], jnp.float32),
                    self._n, delta_cfg=delta_cfg, device_pvalues=True),
                window=2,
            )
            tiles.append({k: np.concatenate(
                [np.asarray(o[k]) for o in outs], axis=1)[:, :n_snps]
                for k in outs[0]})
        scr = {k: np.concatenate([t[k] for t in tiles])[:n_genes]
               for k in tiles[0]}
        sp = np.asarray(scr["pv_saddlepoint"], float)
        liu = np.asarray(scr["pv_liu"], float)
        screen_pv = np.where(np.isfinite(sp), sp, liu)

        hits = (~np.isfinite(screen_pv)) | (screen_pv < thr)
        pvalues = np.asarray(screen_pv, float).copy()
        info = {k: np.asarray(scr[k], float)
                for k in ("rho1", "e2", "g2", "eps2", "Q")}

        confirm = self._confirm_scanner()
        cb = min(64, cfg.snp_batch, self._auto_batch_cap())
        for g in range(n_genes):
            idx = np.flatnonzero(hits[g])
            if not idx.size:
                continue
            Gh = G[:, idx]
            pad = (-Gh.shape[1]) % cb
            if pad:
                Gh = np.concatenate(
                    [Gh, np.repeat(Gh[:, :1], pad, axis=1)], axis=1)
            pv_c, info_c = confirm.with_phenotype(
                Y[:, g]).scan_interaction(Gh)
            pvalues[g, idx] = pv_c[: idx.size]
            for k in info:
                info[k][g, idx] = np.asarray(info_c[k], float)[: idx.size]
        info["screen_pv"] = screen_pv
        info["confirmed"] = hits
        info["screen_threshold"] = thr
        info["n_confirmed"] = int(hits.sum())
        return pvalues, info

    def scan_interaction_multigene(self, Y, G, gene_batch: int = 16,
                                   checkpoint=None,
                                   checkpoint_every: int = 1):
        """Interaction scan for many genes sharing this factorization.

        ``Y`` is (n_cells, n_genes); genes x variants run in ONE compiled
        program per (gene-tile, variant-batch): the genotype contractions
        and rotations are shared across genes inside the kernel (see
        engine.interaction_multigene_batch), so at 16 genes the per-pair
        cost is a fraction of the per-gene loop's.  Returns
        ``(pvalues (n_genes, n_snps), info)`` with info arrays shaped
        (n_genes, n_snps).  New capability vs the reference (which rebuilds
        everything per gene, _cellregmap.py:63-131).

        ``checkpoint``: optional directory; completed GENE TILES are
        persisted there (a tile is the unit of work) and a restarted scan
        with the same shapes resumes from the tile cursor, matching the
        single-gene path's crash-recovery contract.
        """
        cfg = self._cfg
        Y = np.asarray(Y, float)
        if Y.ndim == 1:
            Y = Y[:, None]
        if Y.shape[1] < 1:
            raise ValueError("Y must have at least one gene column")
        if not np.isfinite(Y).all():
            raise ValueError("Y contains non-finite values")
        G = np.asarray(G, float)
        if G.ndim == 1:
            G = G[:, None]
        if G.shape[1] < 1:
            raise ValueError("G must have at least one variant column")
        n_genes = Y.shape[1]
        gtile = max(1, min(gene_batch, n_genes))

        # per-(gene, variant) device memory: the rotated y-family and the
        # stage-2 delta/weight family are (gene, S, nrho, R) f64 tensors
        # that the XLA memory planner can hold in BOTH the S-major and
        # R-major layouts plus remat copies, so the budget is ~4x the
        # naive two-copy estimate
        R = int(self._ctx.S.shape[1])
        nrho = int(self._ctx.S.shape[0])
        C = int(self._ctx.E0.shape[1])
        per_gv = (nrho * R * 2 + (3 * C + 6) * R) * 8 * 8
        # canonical (gene_tile, snp_batch) shape: the variant axis pads UP
        # to the full batch instead of clamping to n_snps, so every
        # cis-window width shares ONE compiled program (a fresh gene-batched
        # compile costs far more than the padded columns' extra scan FLOPs)
        batch = min(cfg.snp_batch, self._auto_batch_cap(),
                    max(16, int(5e9 / per_gv / gtile)))
        Gp, n_snps = _pad_batch(G, batch)
        Yp, _ = _pad_batch(Y, gtile)

        delta_cfg = (cfg.delta_logit_lo, cfg.delta_logit_hi,
                     cfg.n_delta_grid_interaction, cfg.n_golden_iters)
        Z, W = self._ctx.Z, self._ctx.W

        ckpt = None
        start_tile = 0
        tiles = []
        # fingerprint the inputs, not just their shapes: resuming with
        # different Y/G of identical shape would silently splice
        # incompatible tiles
        ck_meta = {"n_snps": n_snps, "n_genes": n_genes, "gtile": gtile,
                   "batch": batch,
                   "inputs_sha": _content_sha(Y, G) if checkpoint else None}
        if checkpoint is not None:
            from .parallel.checkpoint import ScanCheckpoint

            ckpt = ScanCheckpoint(checkpoint)
            state = ckpt.load()
            if (state is not None
                    and all(state["meta"].get(k) == v
                            for k, v in ck_meta.items())):
                start_tile = state["cursor"]
                tiles = [state["results"]]

        tile_starts = list(enumerate(range(0, Yp.shape[1], gtile)))
        n_tiles = len(tile_starts)
        for ti, g0 in _batch_starts(tile_starts[start_tile:], gtile,
                                    cfg.progress, "scan_multigene"):
            Yt = jnp.asarray(Yp[:, g0 : g0 + gtile], self._dtype)
            ctx_g = self._ctx._replace(
                y=Yt.T, Zy=(Z.T @ Yt).T, Wy=(W.T @ Yt).T,
                yy=jnp.sum(Yt * Yt, axis=0),
            )
            outs = _pipelined(
                range(0, Gp.shape[1], batch),
                lambda start: engine.interaction_multigene_kernel(
                    ctx_g, jnp.asarray(Gp[:, start : start + batch],
                                       self._dtype),
                    jnp.asarray(Gp[:, start : start + batch], self._dtype),
                    self._n, delta_cfg=delta_cfg,
                    device_pvalues=(cfg.pvalue_method != "davies"),
                    localize_f32=cfg.hybrid_localization,
                ),
                window=2 if ckpt is None else 1,
            )
            tiles.append({k: np.concatenate([np.asarray(o[k]) for o in outs],
                                            axis=1)[:, :n_snps]
                          for k in outs[0]})
            if ckpt is not None and ((ti + 1 - start_tile) % checkpoint_every
                                     == 0 or ti + 1 == n_tiles):
                flat = {k: np.concatenate([t[k] for t in tiles])
                        for k in tiles[0]}
                ckpt.save(ti + 1, flat, ck_meta)
                tiles = [flat]
        res = {k: np.concatenate([t[k] for t in tiles])[:n_genes]
               for k in tiles[0]}
        if ckpt is not None:
            ckpt.clear()
        return self._multigene_ladder(res, n_genes, n_snps)

    def _multigene_ladder(self, res, n_genes, n_snps):
        """P-value ladder + info assembly for (gene, variant) result
        tables; shared by the local and mesh-sharded multigene drivers."""
        cfg = self._cfg
        flat = lambda a: np.reshape(np.asarray(a), (n_genes * n_snps,)
                                    + np.asarray(a).shape[2:])
        pv_flat, lam_flat = self._pvalue_ladder(
            flat(res["Q"]), flat(res["lambdas"]), flat(res["pv_liu"]),
            flat(res["pv_saddlepoint"]),
            Wmat=flat(res["Wmat"]) if "Wmat" in res else None,
        )
        pvalues = np.reshape(np.asarray(pv_flat, float), (n_genes, n_snps))
        info = {k: np.asarray(res[k], float)
                for k in ("rho1", "e2", "g2", "eps2")}
        info["Q"] = np.asarray(res["Q"])
        info["lambdas"] = np.reshape(np.asarray(lam_flat),
                                     (n_genes, n_snps, -1))
        if cfg.pvalue_method != "davies":
            info["pv_liu"] = np.asarray(res["pv_liu"])
            info["pv_saddlepoint"] = np.asarray(res["pv_saddlepoint"])
        return pvalues, info

    def _auto_batch_cap(self, kind: str = "interaction") -> int:
        """Variant-batch cap keeping a kernel's temporaries within device
        memory.

        Per-variant bytes, budgeted at a conservative 32 B per f64 element
        (sizing the cap from the device's memory is open work).
        ``interaction``: the (n_rho, R, batch) rotated-genotype family
        (Gt/GY/G2/GW + the stage-2 weight tensors, ~8 live f64 copies), the
        best-rho score factor (R, C) at ~3 copies, and the (n, C, batch)
        Khatri-Rao intermediates (~3 copies).
        ``association``: the per-variant delta grid materializes
        (batch, K, R) weighted intermediates (~6 copies).  ``betas``: the
        Khatri-Rao rotate plus the per-variant pair-product tensor
        (Rk, q^2) and the (n_rho x 16)-point family grids over Rk.
        Budget ~5 GB per batch.
        """
        C = int(self._E0.shape[1])
        n = self._n
        p = int(self._W.shape[1])
        if kind == "betas":
            # width of the background factor stack — computed WITHOUT the
            # null context, which the betas path never needs (see _ctx)
            Rk = max(sum(int(L.shape[1]) for L in self._Ls), 1)
        else:
            R = int(self._ctx.S.shape[1])
            nrho = int(self._ctx.S.shape[0])
        if kind == "interaction":
            per_variant = (nrho * max(R, 1) * 32 * 8
                           + max(R, 1) * max(C, 1) * 96
                           + n * (C + p) * 8 * 3)
        elif kind == "association":
            # Newton refit kernel: the delta grid is snp-shared, so per
            # variant only the (R,) rotated/derivative tensors (~8 live
            # f64 copies) and the raw genotype column remain
            per_variant = max(R, 1) * 32 * 8 + n * 8 * 2
        elif kind == "betas":
            q = C + p + C + 2   # [A | B, g | y] columns (pB <= p + C)
            # colsS (S, Rk, q) in f64 + f32 plus the chunk-scanned weighted
            # columns (bounded at ~250 MB inside the family evaluator) and
            # the (n, C, S) Khatri-Rao intermediates
            per_variant = Rk * q * 8 * 4 + n * C * 8 * 2
        else:  # pragma: no cover - defensive
            raise ValueError(kind)
        cap = int(5e9 / per_variant)
        return max(16, cap)

    def _pvalue_ladder(self, Q, lambdas, pv_liu, pv_sp, Wmat=None):
        """Returns (pvalues, lambdas_used)."""
        cfg = self._cfg
        method = cfg.pvalue_method
        if method == "liu":
            return pv_liu, np.asarray(lambdas)
        if method == "saddlepoint":
            return pv_sp, np.asarray(lambdas)
        if method == "davies" and Wmat is not None:
            # host LAPACK eigenvalues of the weight matrices for the exact
            # path (the device eigh is skipped in davies mode)
            Wm = np.asarray(Wmat, float)
            lambdas = np.linalg.eigvalsh((Wm + np.swapaxes(Wm, -1, -2)) / 2)
        if method == "davies":
            pv = pv_mod.davies_pvalue_batch(
                Q, lambdas, lim=cfg.davies_lim, acc=cfg.davies_acc,
                lambda_filter_ratio=cfg.lambda_filter_ratio,
            )
            return pv, np.asarray(lambdas)
        if method == "auto":
            pv = np.asarray(pv_sp, float).copy()
            refine = pv < cfg.davies_threshold
            if refine.any():
                lam_ref = np.asarray(lambdas)[refine]
                if Wmat is not None:
                    # the refined tail is exactly where 1e-8 agreement
                    # matters: recompute the refined subset's eigenvalues
                    # on host LAPACK from the weight matrices
                    Wm = np.asarray(Wmat, float)[refine]
                    lam_ref = np.linalg.eigvalsh(
                        (Wm + np.swapaxes(Wm, -1, -2)) / 2)
                pv[refine] = pv_mod.davies_pvalue_batch(
                    np.asarray(Q)[refine], lam_ref,
                    lim=cfg.davies_lim, acc=cfg.davies_acc,
                    lambda_filter_ratio=cfg.lambda_filter_ratio,
                )
            return pv, np.asarray(lambdas)
        raise ValueError(f"unknown pvalue_method {method!r}")

    # -- association -------------------------------------------------------
    def _fit_null_association(self):
        if self._null_assoc is None:
            delta_cfg = (self._cfg.delta_logit_lo, self._cfg.delta_logit_hi,
                         self._cfg.n_delta_grid, self._cfg.n_golden_iters)
            fits, k = engine.null_association_kernel(
                self._ctx, self._n, restricted=False, delta_cfg=delta_cfg
            )
            self._null_assoc = (jax.device_get(fits), int(k))
        return self._null_assoc

    def _assoc_info(self, fits, k):
        # rho1 comes from the context's actual grid (single source of truth
        # with the multigene path; a custom rho_grid would otherwise
        # silently diverge between them)
        rho_grid = np.asarray(self._ctx.rho)
        rho1 = float(rho_grid[k] if rho_grid.shape[0] > 1 else 1.0)
        v0 = float(fits.v0[k])
        return {
            "rho1": np.asarray([rho1]),
            "e2": np.asarray([v0 * rho1]),
            "g2": np.asarray([v0 * (1 - rho1)]),
            "eps2": np.asarray([float(fits.v1[k])]),
        }

    def scan_association(self, G, checkpoint=None, checkpoint_every: int = 1):
        """LRT association scan with per-variant ML refits (reference :246-281).

        ``checkpoint``: optional directory; completed variant batches are
        persisted (cursor + alt-lml table, inputs fingerprinted) and a
        restarted scan resumes at the cursor (SURVEY 5.3/5.4).
        """
        G = np.asarray(G, float)
        if G.ndim == 1:
            G = G[:, None]
        fits, k = self._fit_null_association()
        null_lml = float(fits.lml[k])

        cfg = self._cfg
        delta_cfg = (cfg.delta_logit_lo, cfg.delta_logit_hi,
                     cfg.n_delta_grid, cfg.n_golden_iters)
        # memory cap for the Newton refit kernel's per-variant (R,) tensors
        batch = min(cfg.snp_batch, self._auto_batch_cap("association"),
                    max(G.shape[1], 1))
        Gp, n_snps = _pad_batch(G, batch)
        def _launch(start):
            gb = jnp.asarray(Gp[:, start : start + batch], self._dtype)
            return {"lml": engine.association_refit_kernel(
                self._ctx, gb, k, self._n, delta_cfg=delta_cfg)[0]}

        ck_meta = {"scan": "association", "n_snps": n_snps, "batch": batch,
                   "k_rho": int(k),
                   "inputs_sha": (_content_sha(self._y, G)
                                  if checkpoint else None)}
        res = _run_checkpointed(
            range(0, Gp.shape[1], batch), _launch, checkpoint, ck_meta,
            checkpoint_every, progress=cfg.progress,
            desc="scan_association")
        alt_lmls = res["lml"][:n_snps]
        pv = lrt_pvalues(null_lml, alt_lmls, dof=1,
                         clip_lo=cfg.pv_clip_lo, clip_hi=cfg.pv_clip_hi)
        return np.asarray(pv, float), self._assoc_info(fits, k)

    def scan_association_fast(self, G, checkpoint=None,
                              checkpoint_every: int = 1):
        """LRT association scan via the closed-form fast scanner (:284-314).

        ``checkpoint`` as in :meth:`scan_association`.
        """
        G = np.asarray(G, float)
        if G.ndim == 1:
            G = G[:, None]
        fits, k = self._fit_null_association()
        null_lml = float(fits.lml[k])
        delta = float(fits.delta[k])

        cfg = self._cfg
        batch = min(cfg.snp_batch, max(G.shape[1], 1))
        Gp, n_snps = _pad_batch(G, batch)
        def _launch(start):
            gb = jnp.asarray(Gp[:, start : start + batch], self._dtype)
            return {"lml": engine.fast_scan_kernel(self._ctx, gb, k, delta,
                                                   self._n).lml}

        ck_meta = {"scan": "association_fast", "n_snps": n_snps,
                   "batch": batch, "k_rho": int(k),
                   "inputs_sha": (_content_sha(self._y, G)
                                  if checkpoint else None)}
        res = _run_checkpointed(
            range(0, Gp.shape[1], batch), _launch, checkpoint, ck_meta,
            checkpoint_every, progress=cfg.progress,
            desc="scan_association_fast")
        alt_lmls = res["lml"][:n_snps]
        pv = lrt_pvalues(null_lml, alt_lmls, dof=1,
                         clip_lo=cfg.pv_clip_lo, clip_hi=cfg.pv_clip_hi)
        return np.asarray(pv, float), self._assoc_info(fits, k)

    def scan_association_multigene(self, Y, G, gene_batch: int = 16,
                                   checkpoint=None,
                                   checkpoint_every: int = 1):
        """Slow (per-variant ML refit) association scan for many genes.

        ``Y`` is (n_cells, n_genes).  Per gene tile: vmapped covariate-only
        null fits over the rho grid, then every (gene, variant) pair gets a
        full ML refit through the gene-batched Newton kernel
        (engine.association_refit_multigene_batch) — genotype contractions
        shared across the tile.  Returns ``(pvalues (n_genes, n_snps),
        info)`` with per-gene info arrays.  Completes the scan matrix
        (interaction/fast-association both have multigene variants); the
        reference reruns its serial pipeline per gene
        (_cellregmap.py:246-281).
        """
        cfg = self._cfg
        Y = np.asarray(Y, float)
        if Y.ndim == 1:
            Y = Y[:, None]
        if Y.shape[1] < 1:
            raise ValueError("Y must have at least one gene column")
        if not np.isfinite(Y).all():
            raise ValueError("Y contains non-finite values")
        G = np.asarray(G, float)
        if G.ndim == 1:
            G = G[:, None]
        if G.shape[1] < 1:
            raise ValueError("G must have at least one variant column")
        n_genes = Y.shape[1]
        gtile = max(1, min(gene_batch, n_genes))
        batch = min(cfg.snp_batch,
                    max(16, self._auto_batch_cap("association") // gtile))
        Gp, n_snps = _pad_batch(G, batch)
        Yp, _ = _pad_batch(Y, gtile)
        delta_cfg = (cfg.delta_logit_lo, cfg.delta_logit_hi,
                     cfg.n_delta_grid, cfg.n_golden_iters)
        Z, W = self._ctx.Z, self._ctx.W
        rho_grid = np.asarray(self._ctx.rho)

        def _tile(g0):
            Yt = jnp.asarray(Yp[:, g0 : g0 + gtile], self._dtype)
            ctx_g = self._ctx._replace(
                y=Yt.T, Zy=(Z.T @ Yt).T, Wy=(W.T @ Yt).T,
                yy=jnp.sum(Yt * Yt, axis=0),
            )
            fits, k = engine.null_association_multigene_kernel(
                ctx_g, self._n, restricted=False, delta_cfg=delta_cfg)
            fits = jax.device_get(fits)
            k = np.asarray(k)
            rows = np.arange(k.shape[0])
            null_lml = fits.lml[rows, k]                     # (gtile,)
            kj = jnp.asarray(k)
            outs = _pipelined(
                range(0, Gp.shape[1], batch),
                lambda start: engine.association_refit_multigene_kernel(
                    ctx_g, jnp.asarray(Gp[:, start : start + batch],
                                       self._dtype),
                    kj, self._n, delta_cfg=delta_cfg,
                    localize_f32=cfg.hybrid_localization)[0],
            )
            alt = np.concatenate([np.asarray(o) for o in outs],
                                 axis=1)[:, :n_snps]         # (gtile, S)
            pv = lrt_pvalues(null_lml[:, None], alt, dof=1,
                             clip_lo=cfg.pv_clip_lo, clip_hi=cfg.pv_clip_hi)
            rho1 = (rho_grid[k] if rho_grid.shape[0] > 1
                    else np.ones(k.shape[0]))
            v0 = fits.v0[rows, k]
            return {"pv": np.asarray(pv), "rho1": rho1, "e2": v0 * rho1,
                    "g2": v0 * (1 - rho1), "eps2": fits.v1[rows, k]}

        ck_meta = {"scan": "association_multigene", "n_snps": n_snps,
                   "n_genes": n_genes, "gtile": gtile, "batch": batch,
                   "inputs_sha": _content_sha(Y, G) if checkpoint else None}
        res = _run_checkpointed(
            range(0, Yp.shape[1], gtile), _tile, checkpoint, ck_meta,
            checkpoint_every, progress=cfg.progress, desc="assoc_multigene")
        pvalues = res.pop("pv")[:n_genes]
        info = {kk: v[:n_genes] for kk, v in res.items()}
        return np.asarray(pvalues, float), info

    def scan_association_fast_multigene(self, Y, G, gene_batch: int = 64,
                                        checkpoint=None,
                                        checkpoint_every: int = 1):
        """Closed-form association scan for many genes in one program.

        ``Y`` is (n_cells, n_genes).  Per gene tile: the covariate-only
        null fits over the rho grid run vmapped (one program for the whole
        tile), then every (gene, variant) alternative lml comes from the
        gene-batched fast scanner, whose genotype contractions are shared
        across genes.  Returns ``(pvalues (n_genes, n_snps), info)`` with
        per-gene info arrays.  New capability vs the reference, which
        rebuilds its whole pipeline per gene (_cellregmap.py:63-131,
        284-314).
        """
        cfg = self._cfg
        Y = np.asarray(Y, float)
        if Y.ndim == 1:
            Y = Y[:, None]
        if Y.shape[1] < 1:
            raise ValueError("Y must have at least one gene column")
        if not np.isfinite(Y).all():
            raise ValueError("Y contains non-finite values")
        G = np.asarray(G, float)
        if G.ndim == 1:
            G = G[:, None]
        if G.shape[1] < 1:
            raise ValueError("G must have at least one variant column")
        n_genes = Y.shape[1]
        gtile = max(1, min(gene_batch, n_genes))
        # memory-aware cap: per (gene, variant) the kernel
        # holds the rotated genotype family (~4 live (R,) f64 copies at
        # 32 B/elem — ZG, Gt per gene, the complement Grams) plus the
        # pipeline window of 4 in-flight batches
        R = int(self._ctx.S.shape[1])
        per_gv = max(R, 1) * 32 * 4 * 4
        batch = min(cfg.snp_batch, max(16, int(5e9 / per_gv / gtile)))
        Gp, n_snps = _pad_batch(G, batch)
        Yp, _ = _pad_batch(Y, gtile)
        delta_cfg = (cfg.delta_logit_lo, cfg.delta_logit_hi,
                     cfg.n_delta_grid, cfg.n_golden_iters)
        Z, W = self._ctx.Z, self._ctx.W
        rho_grid = np.asarray(self._ctx.rho)

        def _tile(g0):
            Yt = jnp.asarray(Yp[:, g0 : g0 + gtile], self._dtype)
            ctx_g = self._ctx._replace(
                y=Yt.T, Zy=(Z.T @ Yt).T, Wy=(W.T @ Yt).T,
                yy=jnp.sum(Yt * Yt, axis=0),
            )
            fits, k = engine.null_association_multigene_kernel(
                ctx_g, self._n, restricted=False, delta_cfg=delta_cfg)
            fits = jax.device_get(fits)
            k = np.asarray(k)
            rows = np.arange(k.shape[0])
            null_lml = fits.lml[rows, k]                     # (gtile,)
            kj = jnp.asarray(k)
            dj = jnp.asarray(fits.delta[rows, k], self._dtype)
            outs = _pipelined(
                range(0, Gp.shape[1], batch),
                lambda start: engine.fast_scan_multigene_kernel(
                    ctx_g, jnp.asarray(Gp[:, start : start + batch],
                                       self._dtype),
                    kj, dj, self._n).lml,
            )
            alt = np.concatenate([np.asarray(o) for o in outs],
                                 axis=1)[:, :n_snps]         # (gtile, S)
            pv = lrt_pvalues(null_lml[:, None], alt, dof=1,
                             clip_lo=cfg.pv_clip_lo, clip_hi=cfg.pv_clip_hi)
            rho1 = (rho_grid[k] if rho_grid.shape[0] > 1
                    else np.ones(k.shape[0]))
            v0 = fits.v0[rows, k]
            return {"pv": np.asarray(pv), "rho1": rho1, "e2": v0 * rho1,
                    "g2": v0 * (1 - rho1), "eps2": fits.v1[rows, k]}

        ck_meta = {"scan": "association_fast_multigene", "n_snps": n_snps,
                   "n_genes": n_genes, "gtile": gtile, "batch": batch,
                   "inputs_sha": _content_sha(Y, G) if checkpoint else None}
        res = _run_checkpointed(
            range(0, Yp.shape[1], gtile), _tile, checkpoint, ck_meta,
            checkpoint_every, progress=cfg.progress,
            desc="assoc_fast_multigene")
        pvalues = res.pop("pv")[:n_genes]
        info = {kk: v[:n_genes] for kk, v in res.items()}
        return np.asarray(pvalues, float), info

    # -- effect sizes ------------------------------------------------------
    def _betas_context(self):
        """Build (once) and cache the betas state: the background QR/eigh
        is a one-time O(n Rk^2) host factorization — at 100k cells it
        dominated every predict_interaction call before caching."""
        if self._bctx is None:
            self._bctx = engine.build_betas_context(
                self._y, self._W, self._E0, self._Ls,
                rho_grid=np.linspace(0, 1, self._cfg.n_rho)
                if len(self._Ls) else np.asarray(self._ctx.rho),
                dtype=self._dtype,
            )
        return self._bctx

    def predict_interaction(self, G, MAF, checkpoint=None,
                            checkpoint_every: int = 1):
        """Effect-size decomposition per variant (reference :137-205).

        Returns ``(beta_g (S,), beta_gxe (n, S))``.

        ``checkpoint``: optional directory; completed variant batches are
        persisted (inputs fingerprinted) and a restarted call resumes at
        the batch cursor (SURVEY 5.3/5.4).
        """
        cfg = self._cfg
        G = np.asarray(G, float)
        if G.ndim == 1:
            G = G[:, None]
        p = np.atleast_1d(np.asarray(MAF, float))
        norm = 1.0 / np.sqrt(2 * p * (1 - p))

        bctx = self._betas_context()
        # Coarse Woodbury grid: 16 points localize the basin and the golden
        # refinement converges from any bracket; larger grids multiply the
        # (batch, n_rho, K) small-matrix tensors for no accuracy gain.
        delta_cfg = (cfg.delta_logit_lo, cfg.delta_logit_hi,
                     min(16, cfg.n_delta_grid), cfg.n_golden_iters)
        batch = min(cfg.snp_batch, self._auto_batch_cap("betas"),
                    max(G.shape[1], 1))
        Gp, n_snps = _pad_batch(G, batch)
        normp = np.concatenate([norm, np.repeat(norm[:1],
                                                Gp.shape[1] - len(norm))])
        def _launch(start):
            gb = jnp.asarray(Gp[:, start : start + batch], self._dtype)
            nb = jnp.asarray(normp[start : start + batch], self._dtype)
            beta_g, alpha, _ = engine.predict_interaction_kernel(
                bctx, gb, nb, self._n, delta_cfg=delta_cfg,
                localize_f32=cfg.hybrid_localization,
            )
            return {"beta_g": beta_g, "alpha": alpha}

        ck_meta = {"scan": "betas", "n_snps": n_snps, "batch": batch,
                   "inputs_sha": (_content_sha(self._y, G, norm)
                                  if checkpoint else None)}
        res = _run_checkpointed(
            range(0, Gp.shape[1], batch), _launch, checkpoint, ck_meta,
            checkpoint_every, axes={"alpha": 1}, progress=cfg.progress,
            desc="predict_interaction")
        beta_g = res["beta_g"][:n_snps]
        alpha = res["alpha"][:, :n_snps]
        beta_gxe = self._E0 @ alpha                              # (n, S)
        return beta_g, beta_gxe

    def estimate_aggregate_environment(self, g):
        """Per-cell aggregate GxC driver E0 @ beta_gxe (reference :207-244).

        Fits with the *null* covariance family (as the reference does at
        :222-223) and solves with the per-g covariance.
        """
        cfg = self._cfg
        g = np.asarray(g, float).ravel()
        n = self._n
        E0, W, y = self._E0, self._W, self._y
        gE = g[:, None] * E0
        # reduced full-rank design (see engine.BetasContext: [W, g, E0] is
        # often exactly collinear; glimix fits the SVD-reduced design)
        B = engine.reduced_design_basis(W, E0)
        M = np.concatenate((B, g[:, None]), axis=1)

        # Fits over the null rho grid with mean M (eig backend, dense host
        # assembly is fine: single variant).
        delta_cfg = (cfg.delta_logit_lo, cfg.delta_logit_hi,
                     cfg.n_delta_grid, cfg.n_golden_iters)
        fits = engine.mean_fit_kernel(
            self._ctx, jnp.asarray(M, self._dtype), n, True, delta_cfg
        )
        fits = jax.device_get(fits)
        k = int(np.argmax(fits.lml))
        rho1 = float(np.asarray(self._ctx.rho)[k])
        v0, v1 = float(fits.v0[k]), float(fits.v1[k])
        beta = np.asarray(fits.beta[k])

        yadj = y - M @ beta
        # cov = v0 * (rho1 gE gE^T + (1-rho1) sum_i L_i L_i^T) + v1 I,
        # solved with Woodbury on the host (single RHS).
        Ls = self._Ls
        if len(Ls):
            F = np.concatenate([np.asarray(L) for L in Ls], axis=1)
        else:
            F = np.zeros((n, 1))
        # cov = B + c A A^T with B = v0(1-rho1) F F^T + v1 I, c = v0 rho1
        c = v0 * rho1
        Bv = _lowrank_plus_diag_solve(F, v0 * (1 - rho1), v1, yadj)
        BiA = _lowrank_plus_diag_solve(F, v0 * (1 - rho1), v1, gE)
        cap = np.eye(E0.shape[1]) + c * (gE.T @ BiA)
        v = Bv - BiA @ np.linalg.solve(cap, c * (gE.T @ Bv))
        beta_gxe = (v0 * rho1) * (gE.T @ v)
        return E0 @ beta_gxe


def _lowrank_plus_diag_solve(F, a, b, rhs):
    """(a F F^T + b I)^{-1} rhs via the capacitance identity (host)."""
    if a == 0.0 or F.shape[1] == 0:
        return rhs / b
    m = F.shape[1]
    cap = np.eye(m) + (a / b) * (F.T @ F)
    Ft_rhs = F.T @ rhs
    return (rhs - F @ np.linalg.solve(cap, (a / b) * Ft_rhs)) / b


# --------------------------------------------------------------------------
# Module-level convenience wrappers (reference :471-682, bugs fixed)
# --------------------------------------------------------------------------
def run_interaction(y, E, G, W=None, E1=None, E2=None, hK=None, idx_G=None,
                    config: ScanConfig = DEFAULT_CONFIG):
    """Interaction test: cell-level GxC genetic effects (score test).

    Reference: _cellregmap.py:547-587.  The permutation index is forwarded
    to ``idx_G`` (the reference passes it positionally into ``idx_E``,
    SURVEY.md section 2.2).
    """
    E1 = E if E1 is None else E1
    E2 = E if E2 is None else E2
    Ls = None if hK is None else get_L_values(hK, E2)
    crm = CellRegMap(y=y, E=E, W=W, E1=E1, Ls=Ls, config=config)
    return crm.scan_interaction(G, idx_G=idx_G)


def run_interaction_screen(y, E, G, W=None, E1=None, E2=None, hK=None,
                           significance: float = 5e-8,
                           screen_margin: float = 100.0,
                           config: ScanConfig = DEFAULT_CONFIG):
    """Two-pass interaction scan: f32 screen of every pair, exact
    f64 + Davies re-test of candidate hits (pairs with screen p-value
    below ``significance * screen_margin``).  See
    :meth:`CellRegMap.scan_interaction_screen` for the precision contract.
    """
    E1 = E if E1 is None else E1
    E2 = E if E2 is None else E2
    Ls = None if hK is None else get_L_values(hK, E2)
    crm = CellRegMap(y=y, E=E, W=W, E1=E1, Ls=Ls, config=config)
    return crm.scan_interaction_screen(G, significance=significance,
                                       screen_margin=screen_margin)


def run_association(y, W, E, G, hK=None, config: ScanConfig = DEFAULT_CONFIG):
    """Association test (LRT, per-variant ML refits).  Reference :471-500."""
    crm = CellRegMap(y=y, E=E, W=W, hK=hK, config=config)
    return crm.scan_association(G)


def run_association_fast(y, W, E, G, hK=None,
                         config: ScanConfig = DEFAULT_CONFIG):
    """Association test (LRT, closed-form fast scanner).  Reference :502-531."""
    crm = CellRegMap(y=y, E=E, W=W, hK=hK, config=config)
    return crm.scan_association_fast(G)


def run_interaction_multigene(Y, E, G, W=None, E1=None, E2=None, hK=None,
                              Ls=None, gene_batch: int = 16,
                              config: ScanConfig = DEFAULT_CONFIG):
    """Interaction scan across many genes sharing one factorization.

    ``Y`` is (n_cells, n_genes); the covariance family (E, W, K) is
    factorized once and genes x variants run through the gene-batched
    kernel (engine.interaction_multigene_batch): the genotype contractions
    are computed once per variant batch and shared across all genes in a
    tile.  Returns ``(pvalues (n_genes, n_snps), info)`` with info arrays
    shaped (n_genes, n_snps).  New capability vs the reference (which
    rebuilds everything per gene).
    """
    Y = np.asarray(Y, float)
    if Y.ndim == 1:
        Y = Y[:, None]
    E1 = E if E1 is None else E1
    E2 = E if E2 is None else E2
    if Ls is None and hK is not None:
        Ls = get_L_values(hK, E2)
    base = CellRegMap(y=Y[:, 0], E=E, W=W, E1=E1, Ls=Ls, config=config)
    return base.scan_interaction_multigene(Y, G, gene_batch=gene_batch)


def run_association_multigene(Y, E, G, W=None, hK=None, Ls=None,
                              gene_batch: int = 16,
                              config: ScanConfig = DEFAULT_CONFIG):
    """Slow (per-variant ML refit) association scan across many genes
    sharing one factorization; see
    :meth:`CellRegMap.scan_association_multigene`."""
    Y = np.asarray(Y, float)
    if Y.ndim == 1:
        Y = Y[:, None]
    base = CellRegMap(y=Y[:, 0], E=E, W=W, hK=hK, Ls=Ls, config=config)
    return base.scan_association_multigene(Y, G, gene_batch=gene_batch)


def run_association_fast_multigene(Y, E, G, W=None, hK=None, Ls=None,
                                   gene_batch: int = 64,
                                   config: ScanConfig = DEFAULT_CONFIG):
    """Closed-form association scan across many genes sharing one
    factorization.

    ``Y`` is (n_cells, n_genes).  The covariance family is factorized
    once; per gene tile the null fits run vmapped and all (gene, variant)
    alternative lmls come from the gene-batched fast scanner.  ``Ls``
    selects the K (.) EE^T background (as in run_interaction_multigene);
    ``hK`` the plain-K background.  Returns ``(pvalues (n_genes, n_snps),
    info)`` with per-gene info arrays.  New capability vs the reference
    (which rebuilds everything per gene, _cellregmap.py:502-531).
    """
    Y = np.asarray(Y, float)
    if Y.ndim == 1:
        Y = Y[:, None]
    base = CellRegMap(y=Y[:, 0], E=E, W=W, hK=hK, Ls=Ls, config=config)
    return base.scan_association_fast_multigene(Y, G, gene_batch=gene_batch)


def estimate_betas(y, W, E, G, maf=None, E1=None, E2=None, hK=None,
                   checkpoint=None, config: ScanConfig = DEFAULT_CONFIG):
    """Effect sizes: persistent beta_G and cell-level beta_GxC.

    Reference: _cellregmap.py:640-682.  ``checkpoint``: optional directory
    for durable batch checkpoints (crash -> resume).
    """
    E1 = E if E1 is None else E1
    E2 = E if E2 is None else E2
    Ls = None if hK is None else get_L_values(hK, E2)
    crm = CellRegMap(y=y, E=E, W=W, E1=E1, Ls=Ls, config=config)
    if maf is None:
        maf = compute_maf(G)
    return crm.predict_interaction(G, maf, checkpoint=checkpoint)
