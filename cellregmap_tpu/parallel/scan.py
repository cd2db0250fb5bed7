"""Mesh-sharded scan driver: data-parallel over the variant axis.

Each device runs the same batched interaction kernel on its shard of the
variant batch; the per-dataset context is replicated.  No collectives are
needed inside the kernel (tests are independent); XLA's SPMD partitioner
keeps everything local to each chip and the host gathers sharded result
tables.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jax import shard_map

from .. import engine
from .._config import DEFAULT_CONFIG, ScanConfig
from .checkpoint import ScanCheckpoint
from .mesh import VARIANT_AXIS, make_mesh


def _sharded_impl(mesh: Mesh, n: int, delta_cfg, saddle_iters,
                  out_struct, device_pvalues: bool = True):
    """Build the shard_mapped interaction kernel for a given mesh/shape."""
    axis = mesh.axis_names[0]

    def body(ctx, G, G_score):
        return engine.interaction_batch(ctx, G, G_score, n,
                                        delta_cfg=delta_cfg,
                                        saddle_iters=saddle_iters,
                                        device_pvalues=device_pvalues)

    ctx_spec = jax.tree.map(lambda _: P(), out_struct["ctx_tree"])
    out_specs = jax.tree.map(
        lambda s: P(axis, *([None] * (len(s.shape) - 1))),
        out_struct["out_shapes"],
    )
    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(ctx_spec, P(None, axis), P(None, axis)),
        out_specs=out_specs,
        check_vma=False,
    )
    return jax.jit(fn)


class ShardedScanner:
    """Data-parallel interaction scanner with checkpoint/resume.

    Parameters
    ----------
    crm:
        A :class:`cellregmap_tpu.CellRegMap` instance (holds the factorized
        context).
    mesh:
        A 1-D `jax.sharding.Mesh`; defaults to all local devices.
    checkpoint:
        Optional directory for cursor/result checkpoints (new capability vs
        the reference, SURVEY.md section 5.3-5.4).
    """

    def __init__(self, crm, mesh: Optional[Mesh] = None,
                 checkpoint: Optional[str] = None):
        self.crm = crm
        self.mesh = mesh if mesh is not None else make_mesh()
        self.ckpt = ScanCheckpoint(checkpoint) if checkpoint else None
        self._compiled = {}

    @property
    def n_devices(self) -> int:
        return self.mesh.devices.size

    def _kernel(self, ctx, G_b, Gs_b, n, delta_cfg, device_pvalues=True):
        key = (G_b.shape, str(G_b.dtype), n, delta_cfg, device_pvalues)
        if key not in self._compiled:
            out_shapes = jax.eval_shape(
                lambda c, g, gs: engine.interaction_batch(
                    c, g, gs, n, delta_cfg=delta_cfg,
                    device_pvalues=device_pvalues,
                ),
                ctx, G_b, Gs_b,
            )
            self._compiled[key] = _sharded_impl(
                self.mesh, n, delta_cfg, 40,
                {"ctx_tree": ctx, "out_shapes": out_shapes},
                device_pvalues=device_pvalues,
            )
        return self._compiled[key]

    def scan_interaction(self, G, idx_E=None, idx_G=None,
                         checkpoint_every: int = 1) -> Dict:
        """Sharded equivalent of ``CellRegMap.scan_interaction``.

        Returns ``(pvalues, info)`` like the reference API.  With a
        checkpoint directory, completed batches are persisted and a
        restarted call resumes from the cursor.
        """
        crm = self.crm
        cfg = crm._cfg
        nd = self.n_devices
        G = np.asarray(G, float)
        if G.ndim == 1:
            G = G[:, None]
        ctx = crm._ctx
        if idx_E is not None:
            ctx = ctx._replace(
                E0=jnp.asarray(crm._E0[np.asarray(idx_E), :], crm._dtype)
            )
        Gs = G if idx_G is None else G[np.asarray(idx_G), :]

        # pad to a multiple of devices * per-device batch
        per_dev = max(1, min(cfg.snp_batch, -(-G.shape[1] // nd)))
        step = per_dev * nd
        n_snps = G.shape[1]
        rem = (-n_snps) % step
        if rem:
            G = np.concatenate([G, np.repeat(G[:, :1], rem, axis=1)], axis=1)
            Gs = np.concatenate([Gs, np.repeat(Gs[:, :1], rem, axis=1)],
                                axis=1)

        delta_cfg = (cfg.delta_logit_lo, cfg.delta_logit_hi,
                     cfg.n_delta_grid_interaction, cfg.n_golden_iters)

        start_batch = 0
        acc: Dict[str, list] = {}
        if self.ckpt is not None:
            state = self.ckpt.load()
            if state is not None and state["meta"].get("n_snps") == n_snps:
                start_batch = state["cursor"]
                acc = {k: [v] for k, v in state["results"].items()}

        dev_pv = cfg.pvalue_method != "davies"
        n_batches = G.shape[1] // step
        for b in range(start_batch, n_batches):
            sl = slice(b * step, (b + 1) * step)
            gb = jnp.asarray(G[:, sl], crm._dtype)
            gsb = jnp.asarray(Gs[:, sl], crm._dtype)
            kernel = self._kernel(ctx, gb, gsb, crm._n, delta_cfg, dev_pv)
            out = jax.device_get(kernel(ctx, gb, gsb))
            for k, v in out.items():
                acc.setdefault(k, []).append(np.asarray(v))
            if self.ckpt is not None and (b + 1) % checkpoint_every == 0:
                flat = {k: np.concatenate(v) for k, v in acc.items()}
                self.ckpt.save(b + 1, flat, {"n_snps": n_snps})
                acc = {k: [v2] for k, v2 in flat.items()}

        res = {k: np.concatenate(v)[:n_snps] for k, v in acc.items()}
        pvalues, lambdas = crm._pvalue_ladder(
            res["Q"], res["lambdas"], res["pv_liu"], res["pv_saddlepoint"],
            Wmat=res.get("Wmat"),
        )
        info = {k: res[k] for k in ("rho1", "e2", "g2", "eps2")}
        info.update({k: res[k] for k in ("Q", "pv_liu", "pv_saddlepoint")})
        info["lambdas"] = lambdas
        if self.ckpt is not None:
            self.ckpt.clear()
        return np.asarray(pvalues, float), info

    def scan_interaction_multigene(self, Y, G, gene_batch: int = 16):
        """Sharded equivalent of ``CellRegMap.scan_interaction_multigene``:
        genes replicated per device, variants sharded over the mesh.

        Returns ``(pvalues (n_genes, n_snps), info)`` identical to the
        local driver (equality pinned in tests/test_parallel.py).
        """
        crm = self.crm
        cfg = crm._cfg
        nd = self.n_devices
        Y = np.asarray(Y, float)
        if Y.ndim == 1:
            Y = Y[:, None]
        G = np.asarray(G, float)
        if G.ndim == 1:
            G = G[:, None]
        n_genes, n_snps = Y.shape[1], G.shape[1]
        gtile = max(1, min(gene_batch, n_genes))

        # per-device HBM cap for the gene-batched kernel (the (gene, S,
        # nrho, R) f64 weight family plans at ~4x its naive size; see
        # CellRegMap.scan_interaction_multigene's OOM note)
        R = int(crm._ctx.S.shape[1])
        nrho = int(crm._ctx.S.shape[0])
        C = int(crm._ctx.E0.shape[1])
        per_gv = (nrho * R * 2 + (3 * C + 6) * R) * 8 * 8
        dev_cap = max(16, int(5e9 / per_gv / gtile))
        per_dev = max(1, min(cfg.snp_batch, dev_cap, -(-n_snps // nd)))
        step = per_dev * nd
        rem = (-n_snps) % step
        Gp = (np.concatenate([G, np.repeat(G[:, :1], rem, axis=1)], axis=1)
              if rem else G)
        remg = (-n_genes) % gtile
        Yp = (np.concatenate([Y, np.repeat(Y[:, :1], remg, axis=1)], axis=1)
              if remg else Y)

        delta_cfg = (cfg.delta_logit_lo, cfg.delta_logit_hi,
                     cfg.n_delta_grid_interaction, cfg.n_golden_iters)
        dev_pv = cfg.pvalue_method != "davies"
        Z, W = crm._ctx.Z, crm._ctx.W
        tiles = []
        fn = None  # compiled once for the canonical (gtile, step) shape
        for g0 in range(0, Yp.shape[1], gtile):
            Yt = jnp.asarray(Yp[:, g0 : g0 + gtile], crm._dtype)
            ctx_g = crm._ctx._replace(
                y=Yt.T, Zy=(Z.T @ Yt).T, Wy=(W.T @ Yt).T,
                yy=jnp.sum(Yt * Yt, axis=0),
            )
            outs = []
            for b in range(0, Gp.shape[1], step):
                gb = jnp.asarray(Gp[:, b : b + step], crm._dtype)
                if fn is None:
                    # one shard_map + jit for ALL tiles and batches (every
                    # (gtile, step) slice shares the shape); re-building it
                    # per call retraced and recompiled the gene-batched
                    # program each batch
                    fn = build_sharded_interaction_multigene(
                        self.mesh, ctx_g, gb, crm._n, delta_cfg=delta_cfg,
                        device_pvalues=dev_pv,
                        localize_f32=cfg.hybrid_localization)
                outs.append(jax.device_get(fn(ctx_g, gb, gb)))
            tiles.append({k: np.concatenate(
                [np.asarray(o[k]) for o in outs], axis=1)[:, :n_snps]
                for k in outs[0]})
        res = {k: np.concatenate([t[k] for t in tiles])[:n_genes]
               for k in tiles[0]}
        return crm._multigene_ladder(res, n_genes, n_snps)

    @property
    def _ckpt_dir(self):
        return str(self.ckpt.path) if self.ckpt is not None else None

    def scan_interaction_screen(self, G, significance: float = 5e-8,
                                screen_margin: float = 100.0,
                                checkpoint_every: int = 1):
        """Mesh-sharded two-pass screen -> confirm interaction scan.

        The f32 screen pass shards the variant axis over the mesh (same
        data-parallel layout as :meth:`scan_interaction`); the exact
        f64 + Davies confirm pass re-tests the (small) hit set through
        the local full-precision path.  Precision contract as in
        :meth:`cellregmap_tpu.CellRegMap.scan_interaction_screen`.
        """
        from ..api import _content_sha, _run_checkpointed

        crm = self.crm
        cfg = crm._cfg
        nd = self.n_devices
        G = np.asarray(G, float)
        if G.ndim == 1:
            G = G[:, None]
        n_snps = G.shape[1]
        thr = min(1.0, float(significance) * float(screen_margin))
        ctx32 = crm._ctx32

        per_dev = max(1, min(cfg.snp_batch * 2, -(-n_snps // nd)))
        step = per_dev * nd
        rem = (-n_snps) % step
        Gp = (np.concatenate([G, np.repeat(G[:, :1], rem, axis=1)], axis=1)
              if rem else G)
        delta_cfg = (cfg.delta_logit_lo, cfg.delta_logit_hi,
                     cfg.n_delta_grid_interaction, cfg.n_golden_iters)

        def _launch(b):
            gb = jnp.asarray(Gp[:, b : b + step], jnp.float32)
            fn = self._kernel(ctx32, gb, gb, crm._n, delta_cfg, True)
            out = fn(ctx32, gb, gb)
            return {k: out[k] for k in ("pv_saddlepoint", "pv_liu", "Q",
                                        "rho1", "e2", "g2", "eps2")}

        ck_meta = {"scan": "sharded_screen", "n_snps": n_snps,
                   "step": step, "thr": thr,
                   "inputs_sha": (_content_sha(crm._y, G)
                                  if self.ckpt else None)}
        scr = _run_checkpointed(
            range(0, Gp.shape[1], step), _launch, self._ckpt_dir, ck_meta,
            checkpoint_every, progress=cfg.progress, desc="sharded_screen")
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
            cb = min(64, cfg.snp_batch, crm._auto_batch_cap())
            Gh = G[:, idx]
            pad = (-Gh.shape[1]) % cb
            if pad:
                Gh = np.concatenate(
                    [Gh, np.repeat(Gh[:, :1], pad, axis=1)], axis=1)
            pv_c, info_c = crm._confirm_scanner().scan_interaction(Gh)
            pvalues[idx] = pv_c[: idx.size]
            for k in info:
                info[k][idx] = np.asarray(info_c[k], float)[: idx.size]
        info["screen_pv"] = screen_pv
        info["confirmed"] = hits
        info["screen_threshold"] = thr
        info["n_confirmed"] = int(idx.size)
        return pvalues, info

    def scan_association_fast(self, G, checkpoint_every: int = 1):
        """Sharded equivalent of ``CellRegMap.scan_association_fast``:
        closed-form LRT association with the variant axis split over the
        mesh (null fit on one device, replicated).  With a checkpoint
        directory, completed batches are durable and a restarted call
        resumes at the cursor."""
        from ..api import _content_sha, _run_checkpointed
        from ..models.pvalues import lrt_pvalues

        crm = self.crm
        cfg = crm._cfg
        nd = self.n_devices
        G = np.asarray(G, float)
        if G.ndim == 1:
            G = G[:, None]
        n_snps = G.shape[1]
        fits, k = crm._fit_null_association()
        null_lml = float(fits.lml[k])
        delta = float(fits.delta[k])

        per_dev = max(1, min(cfg.snp_batch, -(-n_snps // nd)))
        step = per_dev * nd
        rem = (-n_snps) % step
        Gp = (np.concatenate([G, np.repeat(G[:, :1], rem, axis=1)], axis=1)
              if rem else G)
        fn_c = {}

        def _launch(b):
            gb = jnp.asarray(Gp[:, b : b + step], crm._dtype)
            if "fn" not in fn_c:  # one compile for all same-shape batches
                fn_c["fn"] = build_sharded_fast_scan(
                    self.mesh, crm._ctx, gb, k, delta, crm._n)
            return {"lml": fn_c["fn"](crm._ctx, gb).lml}

        ck_meta = {"scan": "sharded_association_fast", "n_snps": n_snps,
                   "step": step, "k_rho": int(k),
                   "inputs_sha": (_content_sha(crm._y, G)
                                  if self.ckpt else None)}
        res = _run_checkpointed(
            range(0, Gp.shape[1], step), _launch, self._ckpt_dir, ck_meta,
            checkpoint_every, progress=cfg.progress,
            desc="sharded_assoc_fast")
        alt_lmls = res["lml"][:n_snps]
        pv = lrt_pvalues(null_lml, alt_lmls, dof=1,
                         clip_lo=cfg.pv_clip_lo, clip_hi=cfg.pv_clip_hi)
        return np.asarray(pv, float), crm._assoc_info(fits, k)

    def scan_association(self, G, checkpoint_every: int = 1):
        """Sharded equivalent of ``CellRegMap.scan_association``: the
        per-variant Newton ML refits run on each device's shard of the
        variant axis (null fit replicated).  Equality vs the local driver
        is pinned in tests/test_parallel.py."""
        from ..api import _content_sha, _run_checkpointed
        from ..models.pvalues import lrt_pvalues

        crm = self.crm
        cfg = crm._cfg
        nd = self.n_devices
        G = np.asarray(G, float)
        if G.ndim == 1:
            G = G[:, None]
        n_snps = G.shape[1]
        fits, k = crm._fit_null_association()
        null_lml = float(fits.lml[k])
        delta_cfg = (cfg.delta_logit_lo, cfg.delta_logit_hi,
                     cfg.n_delta_grid, cfg.n_golden_iters)

        per_dev = max(1, min(min(cfg.snp_batch,
                                 crm._auto_batch_cap("association")),
                             -(-n_snps // nd)))
        step = per_dev * nd
        rem = (-n_snps) % step
        Gp = (np.concatenate([G, np.repeat(G[:, :1], rem, axis=1)], axis=1)
              if rem else G)
        fn_c = {}

        def _launch(b):
            gb = jnp.asarray(Gp[:, b : b + step], crm._dtype)
            if "fn" not in fn_c:
                fn_c["fn"] = build_sharded_association_refit(
                    self.mesh, crm._ctx, gb, k, crm._n,
                    delta_cfg=delta_cfg,
                    localize_f32=cfg.hybrid_localization)
            return {"lml": fn_c["fn"](crm._ctx, gb)[0]}

        ck_meta = {"scan": "sharded_association", "n_snps": n_snps,
                   "step": step, "k_rho": int(k),
                   "inputs_sha": (_content_sha(crm._y, G)
                                  if self.ckpt else None)}
        res = _run_checkpointed(
            range(0, Gp.shape[1], step), _launch, self._ckpt_dir, ck_meta,
            checkpoint_every, progress=cfg.progress,
            desc="sharded_assoc")
        alt_lmls = res["lml"][:n_snps]
        pv = lrt_pvalues(null_lml, alt_lmls, dof=1,
                         clip_lo=cfg.pv_clip_lo, clip_hi=cfg.pv_clip_hi)
        return np.asarray(pv, float), crm._assoc_info(fits, k)

    def _multigene_assoc_tiles(self, Y, G, gene_batch, kernel_builder,
                               use_delta, checkpoint_every, scan_name):
        """Shared tile driver for the sharded multigene association scans:
        per gene tile, vmapped covariate-only null fits (replicated), then
        the sharded gene-batched alternative kernel over variant batches.
        """
        from .. import engine as eng
        from ..api import _content_sha, _run_checkpointed
        from ..models.pvalues import lrt_pvalues

        crm = self.crm
        cfg = crm._cfg
        nd = self.n_devices
        Y = np.asarray(Y, float)
        if Y.ndim == 1:
            Y = Y[:, None]
        G = np.asarray(G, float)
        if G.ndim == 1:
            G = G[:, None]
        n_genes, n_snps = Y.shape[1], G.shape[1]
        gtile = max(1, min(gene_batch, n_genes))
        per_dev = max(1, min(cfg.snp_batch, -(-n_snps // nd)))
        step = per_dev * nd
        rem = (-n_snps) % step
        Gp = (np.concatenate([G, np.repeat(G[:, :1], rem, axis=1)], axis=1)
              if rem else G)
        remg = (-n_genes) % gtile
        Yp = (np.concatenate([Y, np.repeat(Y[:, :1], remg, axis=1)], axis=1)
              if remg else Y)
        delta_cfg = (cfg.delta_logit_lo, cfg.delta_logit_hi,
                     cfg.n_delta_grid, cfg.n_golden_iters)
        Z, W = crm._ctx.Z, crm._ctx.W
        rho_grid = np.asarray(crm._ctx.rho)
        fn_c = {}

        def _tile(g0):
            Yt = jnp.asarray(Yp[:, g0 : g0 + gtile], crm._dtype)
            ctx_g = crm._ctx._replace(
                y=Yt.T, Zy=(Z.T @ Yt).T, Wy=(W.T @ Yt).T,
                yy=jnp.sum(Yt * Yt, axis=0),
            )
            fits, k = eng.null_association_multigene_kernel(
                ctx_g, crm._n, restricted=False, delta_cfg=delta_cfg)
            fits = jax.device_get(fits)
            k = np.asarray(k)
            rows = np.arange(k.shape[0])
            null_lml = fits.lml[rows, k]
            kj = jnp.asarray(k)
            dj = jnp.asarray(fits.delta[rows, k], crm._dtype)
            alt = []
            for b in range(0, Gp.shape[1], step):
                gb = jnp.asarray(Gp[:, b : b + step], crm._dtype)
                if "fn" not in fn_c:
                    fn_c["fn"] = kernel_builder(ctx_g, gb)
                if use_delta:
                    out = fn_c["fn"](ctx_g, gb, kj, dj).lml
                else:
                    out = fn_c["fn"](ctx_g, gb, kj)[0]
                alt.append(np.asarray(out))
            alt = np.concatenate(alt, axis=1)[:, :n_snps]
            pv = lrt_pvalues(null_lml[:, None], alt, dof=1,
                             clip_lo=cfg.pv_clip_lo, clip_hi=cfg.pv_clip_hi)
            rho1 = (rho_grid[k] if rho_grid.shape[0] > 1
                    else np.ones(k.shape[0]))
            v0 = fits.v0[rows, k]
            return {"pv": np.asarray(pv), "rho1": rho1, "e2": v0 * rho1,
                    "g2": v0 * (1 - rho1), "eps2": fits.v1[rows, k]}

        ck_meta = {"scan": scan_name, "n_snps": n_snps, "n_genes": n_genes,
                   "gtile": gtile, "step": step,
                   "inputs_sha": (_content_sha(Y, G) if self.ckpt
                                  else None)}
        res = _run_checkpointed(
            range(0, Yp.shape[1], gtile), _tile, self._ckpt_dir, ck_meta,
            checkpoint_every, progress=cfg.progress, desc=scan_name)
        pvalues = res.pop("pv")[:n_genes]
        info = {kk: v[:n_genes] for kk, v in res.items()}
        return np.asarray(pvalues, float), info

    def scan_association_multigene(self, Y, G, gene_batch: int = 16,
                                   checkpoint_every: int = 1):
        """Sharded equivalent of
        ``CellRegMap.scan_association_multigene``: per (gene, variant)
        Newton ML refits with genes replicated and variants sharded."""
        crm = self.crm
        cfg = crm._cfg
        delta_cfg = (cfg.delta_logit_lo, cfg.delta_logit_hi,
                     cfg.n_delta_grid, cfg.n_golden_iters)
        builder = lambda ctx_g, gb: build_sharded_association_refit_multigene(
            self.mesh, ctx_g, gb, crm._n, delta_cfg=delta_cfg,
            localize_f32=cfg.hybrid_localization)
        return self._multigene_assoc_tiles(
            Y, G, gene_batch, builder, use_delta=False,
            checkpoint_every=checkpoint_every,
            scan_name="sharded_association_multigene")

    def scan_association_fast_multigene(self, Y, G, gene_batch: int = 64,
                                        checkpoint_every: int = 1):
        """Sharded equivalent of
        ``CellRegMap.scan_association_fast_multigene``: gene-batched
        closed-form alternative lmls with variants sharded (wires
        ``build_sharded_fast_scan_multigene`` to the null fits +
        padding)."""
        crm = self.crm

        def builder(ctx_g, gb):
            import jax.numpy as _jnp

            gtile = int(np.asarray(ctx_g.yy).shape[0])
            k_d = _jnp.zeros((gtile,), _jnp.int64)
            d_d = _jnp.zeros((gtile,), crm._dtype)
            return build_sharded_fast_scan_multigene(
                self.mesh, ctx_g, gb, k_d, d_d, crm._n)

        return self._multigene_assoc_tiles(
            Y, G, gene_batch, builder, use_delta=True,
            checkpoint_every=checkpoint_every,
            scan_name="sharded_association_fast_multigene")

    def predict_interaction(self, G, MAF, checkpoint_every: int = 1):
        """Sharded equivalent of ``CellRegMap.predict_interaction``:
        effect-size estimation with the variant axis split over the mesh.

        Returns ``(beta_g (S,), beta_gxe (n, S))`` identical to the local
        driver (equality pinned in tests/test_parallel.py).  With a
        checkpoint directory, completed batches are durable.
        """
        from ..api import _content_sha, _run_checkpointed

        crm = self.crm
        cfg = crm._cfg
        nd = self.n_devices
        G = np.asarray(G, float)
        if G.ndim == 1:
            G = G[:, None]
        p = np.atleast_1d(np.asarray(MAF, float))
        norm = 1.0 / np.sqrt(2 * p * (1 - p))
        n_snps = G.shape[1]

        bctx = crm._betas_context()
        per_dev = max(1, min(min(cfg.snp_batch,
                                 crm._auto_batch_cap("betas")),
                             -(-n_snps // nd)))
        step = per_dev * nd
        rem = (-n_snps) % step
        if rem:
            G = np.concatenate([G, np.repeat(G[:, :1], rem, axis=1)],
                               axis=1)
            norm = np.concatenate([norm, np.repeat(norm[:1], rem)])
        delta_cfg = (cfg.delta_logit_lo, cfg.delta_logit_hi,
                     min(16, cfg.n_delta_grid), cfg.n_golden_iters)
        fn_c = {}

        def _launch(b):
            gb = jnp.asarray(G[:, b : b + step], crm._dtype)
            nb = jnp.asarray(norm[b : b + step], crm._dtype)
            if "fn" not in fn_c:  # one compile for all same-shape batches
                fn_c["fn"] = build_sharded_betas(
                    self.mesh, bctx, gb, nb, crm._n, delta_cfg=delta_cfg,
                    localize_f32=cfg.hybrid_localization)
            beta_g, alpha, _ = fn_c["fn"](bctx, gb, nb)
            return {"beta_g": beta_g, "alpha": alpha}

        ck_meta = {"scan": "sharded_betas", "n_snps": n_snps, "step": step,
                   "inputs_sha": (_content_sha(crm._y, G, norm)
                                  if self.ckpt else None)}
        res = _run_checkpointed(
            range(0, G.shape[1], step), _launch, self._ckpt_dir, ck_meta,
            checkpoint_every, axes={"alpha": 1}, progress=cfg.progress,
            desc="sharded_betas")
        beta_g = res["beta_g"][:n_snps]
        alpha = res["alpha"][:, :n_snps]
        beta_gxe = crm._E0 @ alpha
        return beta_g, beta_gxe


def sharded_interaction_batch(mesh: Mesh, ctx, G, G_score, n: int,
                              delta_cfg=(-18.0, 18.0, 64, 60)):
    """One-shot shard_mapped interaction batch (functional form)."""
    out_shapes = jax.eval_shape(
        lambda c, g, gs: engine.interaction_batch(c, g, gs, n,
                                                  delta_cfg=delta_cfg),
        ctx, G, G_score,
    )
    fn = _sharded_impl(mesh, n, delta_cfg, 40,
                       {"ctx_tree": ctx, "out_shapes": out_shapes})
    return fn(ctx, G, G_score)


# --------------------------------------------------------------------------
# Gene-batched (multigene) sharded kernels: shard the variant axis,
# replicate the gene tile.  The north-star workload
# (pod-scale gene-variant batches, BASELINE.json) runs the gene-batched
# kernels; these give them the same data-parallel story as the single-gene
# scan.  Outputs carry (gene, variant, ...) axes, so the variant axis is
# axis 1 in every out_spec.
# --------------------------------------------------------------------------
def build_sharded_interaction_multigene(mesh: Mesh, ctx_g, G, n: int,
                                        delta_cfg=(-18.0, 18.0, 64, 60),
                                        device_pvalues: bool = True,
                                        localize_f32: bool = True):
    """Compiled sharded gene-batched interaction kernel
    ``fn(ctx_g, G, G_score)`` for one (gene_tile, variant_batch) shape;
    reuse it across equally-shaped tiles/batches (re-building per call
    retraces + recompiles the gene-batched program every time).
    ``localize_f32`` matches the local driver's hybrid-precision
    setting so sharded and local results are bit-identical.
    """
    axis = mesh.axis_names[0]

    def body(ctx, G_, G_score):
        return engine.interaction_multigene_batch(
            ctx, G_, G_score, n, delta_cfg=delta_cfg,
            saddle_iters=40, device_pvalues=device_pvalues,
            localize_f32=localize_f32)

    ctx_spec = jax.tree.map(lambda _: P(), ctx_g)
    out_shapes = jax.eval_shape(
        lambda c, g, gs: engine.interaction_multigene_batch(
            c, g, gs, n, delta_cfg=delta_cfg,
            device_pvalues=device_pvalues, localize_f32=localize_f32),
        ctx_g, G, G,
    )
    out_specs = jax.tree.map(
        lambda s: P(None, axis, *([None] * (len(s.shape) - 2))),
        out_shapes,
    )
    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(ctx_spec, P(None, axis), P(None, axis)),
        out_specs=out_specs,
        check_vma=False,
    )
    return jax.jit(fn)


def sharded_interaction_multigene_batch(mesh: Mesh, ctx_g, G, G_score,
                                        n: int,
                                        delta_cfg=(-18.0, 18.0, 64, 60),
                                        device_pvalues: bool = True,
                                        localize_f32: bool = True):
    """Gene-batched interaction scan, variants sharded over the mesh.

    ``ctx_g`` follows the `engine.interaction_multigene_batch` convention
    (phenotype fields carry a leading gene axis); every context leaf is
    replicated, the variant batch is split across devices, and each device
    runs the full gene tile on its shard — no collectives needed (tests are
    independent; the host gathers sharded result tables).  One-shot form;
    drivers should use :func:`build_sharded_interaction_multigene` and
    reuse the compiled fn across batches.
    """
    fn = build_sharded_interaction_multigene(
        mesh, ctx_g, G, n, delta_cfg=delta_cfg,
        device_pvalues=device_pvalues, localize_f32=localize_f32)
    return fn(ctx_g, G, G_score)


def build_sharded_betas(mesh: Mesh, bctx, G, norm, n: int,
                        delta_cfg=(-18.0, 18.0, 16, 60),
                        localize_f32: bool = True):
    """Compiled sharded betas kernel ``fn(bctx, G, norm)`` for one batch
    shape; reuse it across equally-shaped batches (re-jitting per batch
    recompiles every time)."""
    axis = mesh.axis_names[0]

    def body(c, G_, norm_):
        return engine.predict_interaction_kernel(
            c, G_, norm_, n, delta_cfg=delta_cfg,
            localize_f32=localize_f32)

    ctx_spec = jax.tree.map(lambda _: P(), bctx)
    out_shapes = jax.eval_shape(
        lambda c, g, m: engine.predict_interaction_kernel(
            c, g, m, n, delta_cfg=delta_cfg, localize_f32=localize_f32),
        bctx, G, norm,
    )
    # beta_g (S,) and the info dict shard on axis 0; alpha (C, S) on axis 1
    out_specs = (P(axis), P(None, axis),
                 jax.tree.map(lambda s: P(axis, *([None] * (len(s.shape)
                                                           - 1))),
                              out_shapes[2]))
    return jax.jit(shard_map(
        body,
        mesh=mesh,
        in_specs=(ctx_spec, P(None, axis), P(axis)),
        out_specs=out_specs,
        check_vma=False,
    ))


def sharded_betas_batch(mesh: Mesh, bctx, G, norm, n: int,
                        delta_cfg=(-18.0, 18.0, 16, 60),
                        localize_f32: bool = True):
    """One-shot sharded effect-size batch; returns ``(beta_g (S,),
    alpha (C, S), info)`` like the local kernel."""
    return build_sharded_betas(mesh, bctx, G, norm, n, delta_cfg,
                               localize_f32)(bctx, G, norm)


def build_sharded_fast_scan(mesh: Mesh, ctx, G, k_rho, delta, n: int):
    """Compiled sharded fast-scan ``fn(ctx, G)`` for one batch shape
    (``k_rho``/``delta`` closed over as constants)."""
    axis = mesh.axis_names[0]

    def body(c, G_):
        return engine.fast_scan_kernel(c, G_, k_rho, delta, n)

    ctx_spec = jax.tree.map(lambda _: P(), ctx)
    out_shapes = jax.eval_shape(
        lambda c, g: engine.fast_scan_kernel(c, g, k_rho, delta, n),
        ctx, G,
    )
    out_specs = jax.tree.map(
        lambda s: P(axis, *([None] * (len(s.shape) - 1))), out_shapes)
    return jax.jit(shard_map(
        body,
        mesh=mesh,
        in_specs=(ctx_spec, P(None, axis)),
        out_specs=out_specs,
        check_vma=False,
    ))


def sharded_fast_scan(mesh: Mesh, ctx, G, k_rho, delta, n: int):
    """Single-gene closed-form association lmls, variants sharded."""
    return build_sharded_fast_scan(mesh, ctx, G, k_rho, delta, n)(ctx, G)


def build_sharded_fast_scan_multigene(mesh: Mesh, ctx_g, G, k_rho, delta,
                                      n: int):
    """Compiled gene-batched sharded fast-scan ``fn(ctx_g, G, k_rho,
    delta)`` for one (gene_tile, variant_batch) shape; reuse across
    equally-shaped batches/tiles."""
    axis = mesh.axis_names[0]

    def body(ctx, G_, k_, d_):
        return engine.fast_scan_multigene_kernel(ctx, G_, k_, d_, n)

    ctx_spec = jax.tree.map(lambda _: P(), ctx_g)
    out_shapes = jax.eval_shape(
        lambda c, g, k_, d_: engine.fast_scan_multigene_kernel(
            c, g, k_, d_, n),
        ctx_g, G, k_rho, delta,
    )
    out_specs = jax.tree.map(
        lambda s: P(None, axis, *([None] * (len(s.shape) - 2))),
        out_shapes,
    )
    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(ctx_spec, P(None, axis), P(), P()),
        out_specs=out_specs,
        check_vma=False,
    )
    return jax.jit(fn)


def sharded_fast_scan_multigene(mesh: Mesh, ctx_g, G, k_rho, delta, n: int):
    """Gene-batched closed-form association lmls, variants sharded.

    ``k_rho``/``delta`` are per-gene (replicated); the genotype batch is
    split across devices.  Returns the FastScanResult with (gene, variant)
    leading axes.
    """
    return build_sharded_fast_scan_multigene(mesh, ctx_g, G, k_rho, delta,
                                             n)(ctx_g, G, k_rho, delta)


def build_sharded_association_refit(mesh: Mesh, ctx, G, k_rho, n: int,
                                    delta_cfg=(-18.0, 18.0, 256, 60),
                                    localize_f32: bool = True):
    """Compiled sharded Newton-refit association kernel ``fn(ctx, G)``
    (``k_rho`` closed over); variants split across devices."""
    axis = mesh.axis_names[0]

    def body(c, G_):
        return engine.association_refit_batch(
            c, G_, k_rho, n, delta_cfg=delta_cfg,
            localize_f32=localize_f32)

    ctx_spec = jax.tree.map(lambda _: P(), ctx)
    out_shapes = jax.eval_shape(
        lambda c, g: engine.association_refit_batch(
            c, g, k_rho, n, delta_cfg=delta_cfg,
            localize_f32=localize_f32),
        ctx, G,
    )
    out_specs = jax.tree.map(
        lambda s: P(axis, *([None] * (len(s.shape) - 1))), out_shapes)
    return jax.jit(shard_map(
        body,
        mesh=mesh,
        in_specs=(ctx_spec, P(None, axis)),
        out_specs=out_specs,
        check_vma=False,
    ))


def build_sharded_association_refit_multigene(
        mesh: Mesh, ctx_g, G, n: int, delta_cfg=(-18.0, 18.0, 256, 60),
        localize_f32: bool = True):
    """Compiled sharded gene-batched Newton-refit kernel
    ``fn(ctx_g, G, k_rho)``; genes replicated, variants sharded."""
    axis = mesh.axis_names[0]

    def body(c, G_, k_):
        return engine.association_refit_multigene_batch(
            c, G_, k_, n, delta_cfg=delta_cfg, localize_f32=localize_f32)

    ctx_spec = jax.tree.map(lambda _: P(), ctx_g)
    k_spec = P()
    import jax.numpy as _jnp

    k_dummy = _jnp.zeros((ctx_g.y.shape[0],), _jnp.int32)
    out_shapes = jax.eval_shape(
        lambda c, g, k_: engine.association_refit_multigene_batch(
            c, g, k_, n, delta_cfg=delta_cfg, localize_f32=localize_f32),
        ctx_g, G, k_dummy,
    )
    out_specs = jax.tree.map(
        lambda s: P(None, axis, *([None] * (len(s.shape) - 2))),
        out_shapes)
    return jax.jit(shard_map(
        body,
        mesh=mesh,
        in_specs=(ctx_spec, P(None, axis), k_spec),
        out_specs=out_specs,
        check_vma=False,
    ))
