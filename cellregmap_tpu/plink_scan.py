"""Streaming, checkpointed interaction scans straight from PLINK filesets.

The reference has no genotype IO at all — users must materialize a full
(n_samples x n_variants) matrix in memory before calling ``run_interaction``
(/root/reference/cellregmap/_cellregmap.py:547-587).  Here variant blocks
stream from the native .bed decoder (utils/plink.py), get donor->cell
expanded, MAF-filtered, imputed and standardized on the fly, and run through
the batched device kernel with a durable per-block checkpoint — a crashed
100k-variant scan resumes at its last completed block.

One-command usage (see ``main``)::

    python -m cellregmap_tpu.plink_scan --bed cohort --data dataset.npz \
        --out results.npz --checkpoint ckpt_dir

where ``dataset.npz`` holds cell-level ``y``, ``E`` and optionally ``W``,
``hK``, and ``donor_to_cell`` (int indices mapping each cell to a .fam row)
or ``donor_ids`` (per-cell donor IIDs matched against the .fam).

Gene-batched cis mode: provide ``Y`` (n_cells x n_genes) and ``windows``
(n_genes x 2 [start, end) .bim row ranges) in the npz instead of ``y`` —
gene tiles decode the union of their cis windows once and run every
(gene, variant) pair through the shared-contraction multigene kernel
(:func:`scan_interaction_multigene_plink`).
"""
from __future__ import annotations

import json
from typing import Optional

import numpy as np

from ._config import DEFAULT_CONFIG, ScanConfig
from .api import CellRegMap, get_L_values
from .parallel.checkpoint import ScanCheckpoint
from .utils.maf import compute_maf
from .utils.plink import PlinkReader


def resolve_donor_to_cell(reader: PlinkReader, donor_to_cell=None,
                          donor_ids=None) -> np.ndarray:
    """Per-cell row indices into the .fam sample table."""
    if donor_to_cell is not None:
        idx = np.asarray(donor_to_cell, int)
        if idx.min() < 0 or idx.max() >= reader.n_samples:
            raise ValueError("donor_to_cell index out of .fam range")
        return idx
    if donor_ids is None:
        raise ValueError("need donor_to_cell or donor_ids")
    iid_to_row = {iid: i for i, (_, iid) in enumerate(reader.samples)}
    try:
        return np.asarray([iid_to_row[str(d)] for d in np.asarray(donor_ids)])
    except KeyError as e:
        raise ValueError(f"donor id {e} not present in {reader.prefix}.fam")


def _decode_block(reader: PlinkReader, v0: int, v1: int, d2c,
                  maf_min: float, standardize: bool):
    """Decode .bim rows [v0, v1): donor genotypes -> mean-impute ->
    MAF/variance filter -> donor->cell expand -> optional standardize.

    Returns ``(Gc (n_cells, kept) or None, maf_kept, kept_idx)``.
    """
    Gd = reader.read(v0, v1)                      # (n_donors, B)
    maf = np.asarray(compute_maf(Gd), float)
    miss = np.isnan(Gd)
    if miss.any():
        mu = np.nanmean(np.where(miss, np.nan, Gd), axis=0)
        Gd = np.where(miss, mu[None, :], Gd)
    sd = Gd.std(axis=0)
    keep = (maf >= maf_min) & (sd > 0) & np.isfinite(maf)
    kept_idx = v0 + np.flatnonzero(keep)
    if not keep.any():
        return None, maf[keep], kept_idx
    Gc = Gd[d2c][:, keep]                         # cells x kept
    if standardize:
        Gc = (Gc - Gc.mean(0)) / Gc.std(0)
    return Gc, maf[keep], kept_idx


def _blocks_iter(start_block, n_blocks, progress, desc):
    it = range(start_block, n_blocks)
    if progress:
        try:
            from tqdm import tqdm

            it = tqdm(it, desc=desc, unit="block")
        except ImportError:
            pass
    return it


def scan_interaction_plink(crm: CellRegMap, prefix: str, *,
                           donor_to_cell=None, donor_ids=None,
                           block_size: int = 2048, maf_min: float = 0.0,
                           standardize: bool = True,
                           checkpoint: Optional[str] = None,
                           progress: bool = False):
    """Checkpointed streaming interaction scan over a PLINK fileset.

    Per block: decode donor-level genotypes, mean-impute missing calls,
    drop variants with MAF < ``maf_min`` or zero variance, expand donors to
    cells, (optionally) standardize the cell-level columns, and run
    ``crm.scan_interaction``.  Completed blocks are persisted to
    ``checkpoint`` (cursor + accumulated tables); a rerun with the same
    fileset and block size resumes after the last durable block.

    Returns ``(pvalues, info, variant_index)`` where ``variant_index`` maps
    each result row to its .bim row (post-filter).
    """
    reader = PlinkReader(prefix)
    d2c = resolve_donor_to_cell(reader, donor_to_cell, donor_ids)
    if d2c.shape[0] != crm.n_samples:
        raise ValueError("donor map length != model's n_cells")

    n_blocks = -(-reader.n_variants // block_size)
    meta = {"scan": "interaction", "prefix": str(prefix),
            "n_variants": reader.n_variants,
            "block_size": block_size, "maf_min": maf_min}

    ckpt = ScanCheckpoint(checkpoint) if checkpoint is not None else None
    start_block = 0
    acc: dict = {}
    if ckpt is not None:
        state = ckpt.load()
        if state is not None and all(
                state["meta"].get(k) == v for k, v in meta.items()):
            start_block = state["cursor"]
            acc = dict(state["results"])

    def _append(name, arr):
        arr = np.asarray(arr)
        acc[name] = (np.concatenate([acc[name], arr])
                     if name in acc else arr)

    for b in _blocks_iter(start_block, n_blocks, progress, "scan_plink"):
        v0 = b * block_size
        v1 = min(v0 + block_size, reader.n_variants)
        Gc, maf_kept, kept_idx = _decode_block(reader, v0, v1, d2c,
                                               maf_min, standardize)
        if Gc is not None:
            pv, info = crm.scan_interaction(Gc)
            _append("pvalues", pv)
            _append("maf", maf_kept)
            for k in ("rho1", "e2", "g2", "eps2", "Q"):
                _append(k, info[k])
        _append("variant_index", kept_idx)
        if ckpt is not None:
            ckpt.save(b + 1, acc, meta)

    if ckpt is not None:
        ckpt.clear()
    pv = acc.get("pvalues", np.zeros(0))
    vidx = acc.get("variant_index", np.zeros(0, int))
    info = {k: acc[k] for k in ("rho1", "e2", "g2", "eps2", "Q", "maf")
            if k in acc}
    return pv, info, vidx


def scan_interaction_screen_plink(crm: CellRegMap, prefix: str, *,
                                  donor_to_cell=None, donor_ids=None,
                                  significance: float = 5e-8,
                                  screen_margin: float = 100.0,
                                  block_size: int = 2048,
                                  maf_min: float = 0.0,
                                  standardize: bool = True,
                                  checkpoint: Optional[str] = None,
                                  progress: bool = False):
    """Genome-scale two-pass screen -> confirm scan over a PLINK fileset.

    Per block the f32 screen kernel tests every variant
    and the f64 + Davies confirm pass re-tests candidate hits exactly
    (see :meth:`CellRegMap.scan_interaction_screen` for the precision
    contract).  Completed blocks are durable; a rerun resumes at the
    block cursor.

    Returns ``(pvalues, info, variant_index)`` where ``info`` carries
    ``confirmed`` / ``screen_pv`` per kept variant.
    """
    reader = PlinkReader(prefix)
    d2c = resolve_donor_to_cell(reader, donor_to_cell, donor_ids)
    if d2c.shape[0] != crm.n_samples:
        raise ValueError("donor map length != model's n_cells")

    n_blocks = -(-reader.n_variants // block_size)
    meta = {"scan": "interaction_screen", "prefix": str(prefix),
            "n_variants": reader.n_variants, "block_size": block_size,
            "maf_min": maf_min, "significance": significance,
            "screen_margin": screen_margin}

    ckpt = ScanCheckpoint(checkpoint) if checkpoint is not None else None
    start_block = 0
    acc: dict = {}
    if ckpt is not None:
        state = ckpt.load()
        if state is not None and all(
                state["meta"].get(k) == v for k, v in meta.items()):
            start_block = state["cursor"]
            acc = dict(state["results"])

    def _append(name, arr):
        arr = np.asarray(arr)
        acc[name] = (np.concatenate([acc[name], arr])
                     if name in acc else arr)

    for b in _blocks_iter(start_block, n_blocks, progress, "screen_plink"):
        v0 = b * block_size
        v1 = min(v0 + block_size, reader.n_variants)
        Gc, maf_kept, kept_idx = _decode_block(reader, v0, v1, d2c,
                                               maf_min, standardize)
        if Gc is not None:
            pv, info = crm.scan_interaction_screen(
                Gc, significance=significance, screen_margin=screen_margin)
            _append("pvalues", pv)
            _append("maf", maf_kept)
            _append("confirmed", info["confirmed"])
            _append("screen_pv", info["screen_pv"])
            for k in ("rho1", "e2", "g2", "eps2", "Q"):
                _append(k, info[k])
        _append("variant_index", kept_idx)
        if ckpt is not None:
            ckpt.save(b + 1, acc, meta)

    if ckpt is not None:
        ckpt.clear()
    pv = acc.get("pvalues", np.zeros(0))
    vidx = acc.get("variant_index", np.zeros(0, int))
    info = {k: acc[k] for k in ("rho1", "e2", "g2", "eps2", "Q", "maf",
                                "confirmed", "screen_pv") if k in acc}
    return pv, info, vidx


def scan_association_plink(crm: CellRegMap, prefix: str, *,
                           donor_to_cell=None, donor_ids=None,
                           fast: bool = True, block_size: int = 2048,
                           maf_min: float = 0.0, standardize: bool = True,
                           checkpoint: Optional[str] = None,
                           progress: bool = False):
    """Checkpointed streaming association (LRT) scan over a PLINK fileset.

    ``fast=True`` runs the closed-form fast scanner per block (reference
    pattern _cellregmap.py:284-314), ``fast=False`` the per-variant Newton
    ML refits (:246-281).  The covariate-only null fits once, outside the
    block loop.  Completed blocks are durable; a rerun with the same
    fileset resumes after the last checkpointed block (the reference has
    no genotype IO at all).

    Returns ``(pvalues, info, variant_index)`` like
    :func:`scan_interaction_plink`.
    """
    reader = PlinkReader(prefix)
    d2c = resolve_donor_to_cell(reader, donor_to_cell, donor_ids)
    if d2c.shape[0] != crm.n_samples:
        raise ValueError("donor map length != model's n_cells")
    crm._fit_null_association()   # once, before the block loop

    n_blocks = -(-reader.n_variants // block_size)
    meta = {"scan": "association_fast" if fast else "association",
            "prefix": str(prefix), "n_variants": reader.n_variants,
            "block_size": block_size, "maf_min": maf_min}

    ckpt = ScanCheckpoint(checkpoint) if checkpoint is not None else None
    start_block = 0
    acc: dict = {}
    if ckpt is not None:
        state = ckpt.load()
        if state is not None and all(
                state["meta"].get(k) == v for k, v in meta.items()):
            start_block = state["cursor"]
            acc = dict(state["results"])

    def _append(name, arr):
        arr = np.asarray(arr)
        acc[name] = (np.concatenate([acc[name], arr])
                     if name in acc else arr)

    scan = (crm.scan_association_fast if fast else crm.scan_association)
    for b in _blocks_iter(start_block, n_blocks, progress, "assoc_plink"):
        v0 = b * block_size
        v1 = min(v0 + block_size, reader.n_variants)
        Gc, maf_kept, kept_idx = _decode_block(reader, v0, v1, d2c,
                                               maf_min, standardize)
        if Gc is not None:
            pv, _ = scan(Gc)
            _append("pvalues", pv)
            _append("maf", maf_kept)
        _append("variant_index", kept_idx)
        if ckpt is not None:
            ckpt.save(b + 1, acc, meta)

    if ckpt is not None:
        ckpt.clear()
    pv = acc.get("pvalues", np.zeros(0))
    vidx = acc.get("variant_index", np.zeros(0, int))
    fits, k = crm._fit_null_association()
    info = crm._assoc_info(fits, k)
    info["maf"] = acc.get("maf", np.zeros(0))
    return pv, info, vidx


def estimate_betas_plink(crm: CellRegMap, prefix: str, *,
                         donor_to_cell=None, donor_ids=None,
                         block_size: int = 2048, maf_min: float = 0.0,
                         standardize: bool = False,
                         checkpoint: Optional[str] = None,
                         progress: bool = False):
    """Checkpointed streaming effect-size estimation over a PLINK fileset.

    Per block: decode + impute + filter (``standardize`` defaults to False
    — the reference's ``estimate_betas`` consumes raw 0/1/2 genotypes and
    normalizes by 1/sqrt(2 p (1-p)) itself, _cellregmap.py:640-682), then
    ``crm.predict_interaction`` with the block's donor-level MAF.  Durable
    per-block checkpoints.

    Returns ``(beta_g (V,), beta_gxe (n_cells, V), maf, variant_index)``.
    """
    reader = PlinkReader(prefix)
    d2c = resolve_donor_to_cell(reader, donor_to_cell, donor_ids)
    if d2c.shape[0] != crm.n_samples:
        raise ValueError("donor map length != model's n_cells")
    crm._betas_context()          # one-time background factorization

    n_blocks = -(-reader.n_variants // block_size)
    meta = {"scan": "betas", "prefix": str(prefix),
            "n_variants": reader.n_variants, "block_size": block_size,
            "maf_min": maf_min}

    ckpt = ScanCheckpoint(checkpoint) if checkpoint is not None else None
    start_block = 0
    acc: dict = {}
    if ckpt is not None:
        state = ckpt.load()
        if state is not None and all(
                state["meta"].get(k) == v for k, v in meta.items()):
            start_block = state["cursor"]
            acc = dict(state["results"])

    def _append(name, arr, axis=0):
        arr = np.asarray(arr)
        acc[name] = (np.concatenate([acc[name], arr], axis=axis)
                     if name in acc else arr)

    for b in _blocks_iter(start_block, n_blocks, progress, "betas_plink"):
        v0 = b * block_size
        v1 = min(v0 + block_size, reader.n_variants)
        Gc, maf_kept, kept_idx = _decode_block(reader, v0, v1, d2c,
                                               maf_min, standardize)
        if Gc is not None:
            bg, bgxe = crm.predict_interaction(Gc, maf_kept)
            _append("beta_g", bg)
            _append("beta_gxe", bgxe, axis=1)
            _append("maf", maf_kept)
        _append("variant_index", kept_idx)
        if ckpt is not None:
            ckpt.save(b + 1, acc, meta)

    if ckpt is not None:
        ckpt.clear()
    n = crm.n_samples
    return (acc.get("beta_g", np.zeros(0)),
            acc.get("beta_gxe", np.zeros((n, 0))),
            acc.get("maf", np.zeros(0)),
            acc.get("variant_index", np.zeros(0, int)))


def scan_interaction_multigene_plink(crm: CellRegMap, prefix: str, Y,
                                     windows, *, donor_to_cell=None,
                                     donor_ids=None, gene_batch: int = 16,
                                     maf_min: float = 0.0,
                                     standardize: bool = True,
                                     checkpoint: Optional[str] = None,
                                     progress: bool = False):
    """Gene-batched cis-window interaction scans from a PLINK fileset.

    The production eQTL workload: ``Y`` is (n_cells, n_genes) and
    ``windows`` is (n_genes, 2) with each gene's [start, end) .bim row
    range (e.g. TSS +- 1 Mb).  Genes are tiled in window order; each tile
    decodes the UNION of its members' windows once, runs every (gene,
    variant) pair through the gene-batched kernel (one compiled program,
    genotype contractions shared across the tile — adjacent cis-windows
    overlap heavily), and keeps only pairs inside each gene's own window.
    Completed tiles are checkpointed durably; a rerun resumes at the tile
    cursor.

    Returns a dict of flat arrays: ``gene`` (original Y column per row),
    ``variant_index`` (.bim row), ``pvalues``, ``maf``, ``rho1``, ``e2``,
    ``g2``, ``eps2``, ``Q``.
    """
    Y = np.asarray(Y, float)
    if Y.ndim == 1:
        Y = Y[:, None]
    windows = np.asarray(windows, int)
    if windows.shape != (Y.shape[1], 2):
        raise ValueError("windows must be (n_genes, 2) [start, end) rows")
    reader = PlinkReader(prefix)
    if (windows[:, 0] < 0).any() or (windows[:, 1] > reader.n_variants).any():
        raise ValueError("window out of .bim range")
    d2c = resolve_donor_to_cell(reader, donor_to_cell, donor_ids)
    if d2c.shape[0] != crm.n_samples:
        raise ValueError("donor map length != model's n_cells")

    order = np.argsort(windows[:, 0], kind="stable")
    tiles = [order[i : i + gene_batch]
             for i in range(0, len(order), gene_batch)]
    import hashlib

    # resuming with different windows or phenotypes would silently splice
    # incompatible tiles; fingerprint both into the checkpoint meta
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(windows).tobytes())
    h.update(np.ascontiguousarray(Y).tobytes())
    meta = {"prefix": str(prefix), "n_variants": reader.n_variants,
            "n_genes": int(Y.shape[1]), "gene_batch": gene_batch,
            "maf_min": maf_min, "inputs_sha": h.hexdigest()[:16]}

    ckpt = ScanCheckpoint(checkpoint) if checkpoint is not None else None
    start_tile = 0
    acc: dict = {}
    if ckpt is not None:
        state = ckpt.load()
        if state is not None and all(
                state["meta"].get(k) == v for k, v in meta.items()):
            start_tile = state["cursor"]
            acc = dict(state["results"])

    def _append(name, arr):
        arr = np.asarray(arr)
        acc[name] = (np.concatenate([acc[name], arr])
                     if name in acc else arr)

    it = range(start_tile, len(tiles))
    if progress:
        try:
            from tqdm import tqdm

            it = tqdm(it, desc="scan_plink_multigene", unit="tile")
        except ImportError:
            pass

    for t in it:
        genes = tiles[t]
        v0 = int(windows[genes, 0].min())
        v1 = int(windows[genes, 1].max())
        Gd = reader.read(v0, v1)                      # (n_donors, U)
        maf = np.asarray(compute_maf(Gd), float)
        miss = np.isnan(Gd)
        if miss.any():
            mu = np.nanmean(np.where(miss, np.nan, Gd), axis=0)
            Gd = np.where(miss, mu[None, :], Gd)
        sd = Gd.std(axis=0)
        keep = (maf >= maf_min) & (sd > 0) & np.isfinite(maf)
        kept_idx = v0 + np.flatnonzero(keep)          # .bim rows
        if keep.any():
            Gc = Gd[d2c][:, keep]
            if standardize:
                Gc = (Gc - Gc.mean(0)) / Gc.std(0)
            pv, info = crm.scan_interaction_multigene(
                Y[:, genes], Gc, gene_batch=len(genes))
            for gi, g in enumerate(genes):
                inwin = ((kept_idx >= windows[g, 0])
                         & (kept_idx < windows[g, 1]))
                if not inwin.any():
                    continue
                _append("gene", np.full(int(inwin.sum()), g, int))
                _append("variant_index", kept_idx[inwin])
                _append("pvalues", pv[gi][inwin])
                _append("maf", maf[keep][inwin])
                for k in ("rho1", "e2", "g2", "eps2", "Q"):
                    _append(k, info[k][gi][inwin])
        if ckpt is not None:
            ckpt.save(t + 1, acc, meta)

    if ckpt is not None:
        ckpt.clear()
    empty_f = np.zeros(0)
    out = {"gene": acc.get("gene", np.zeros(0, int)),
           "variant_index": acc.get("variant_index", np.zeros(0, int))}
    for k in ("pvalues", "maf", "rho1", "e2", "g2", "eps2", "Q"):
        out[k] = acc.get(k, empty_f)
    return out


def main(argv=None):
    """CLI: checkpointed interaction scan from a .bed file."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m cellregmap_tpu.plink_scan",
        description="Streaming checkpointed CellRegMap interaction scan "
                    "over a PLINK fileset")
    ap.add_argument("--bed", required=True,
                    help="PLINK prefix (prefix.bed/.bim/.fam)")
    ap.add_argument("--data", required=True,
                    help="npz with y, E[, W, hK, donor_to_cell|donor_ids]")
    ap.add_argument("--out", required=True, help="output npz path")
    ap.add_argument("--checkpoint", default=None, help="checkpoint dir")
    ap.add_argument("--block-size", type=int, default=2048)
    ap.add_argument("--maf-min", type=float, default=0.0)
    ap.add_argument("--snp-batch", type=int, default=None)
    ap.add_argument("--pvalue-method", default=None)
    ap.add_argument("--gene-batch", type=int, default=16,
                    help="gene tile size for multigene (Y + windows) scans")
    ap.add_argument("--mode", default="interaction",
                    choices=("interaction", "interaction-screen",
                             "association", "association-fast", "betas"),
                    help="scan type (multigene Y+windows data implies the "
                         "gene-batched interaction scan)")
    ap.add_argument("--significance", type=float, default=5e-8,
                    help="interaction-screen mode: genome-wide cutoff")
    ap.add_argument("--screen-margin", type=float, default=100.0,
                    help="interaction-screen mode: confirm-threshold "
                         "multiple over --significance")
    args = ap.parse_args(argv)

    with np.load(args.data, allow_pickle=False) as z:
        d = {k: z[k] for k in z.files}
    cfg = DEFAULT_CONFIG
    overrides = {}
    if args.snp_batch is not None:
        overrides["snp_batch"] = args.snp_batch
    if args.pvalue_method is not None:
        overrides["pvalue_method"] = args.pvalue_method
    if overrides:
        import dataclasses

        cfg = dataclasses.replace(cfg, **overrides)

    E = d["E"]
    Ls = get_L_values(d["hK"], E) if "hK" in d else None
    multigene = "Y" in d and "windows" in d
    y0 = d["Y"][:, 0] if multigene else d["y"]
    crm = CellRegMap(y=y0, E=E, W=d.get("W"), Ls=Ls, config=cfg)
    if multigene:
        res = scan_interaction_multigene_plink(
            crm, args.bed, d["Y"], d["windows"],
            donor_to_cell=d.get("donor_to_cell"),
            donor_ids=d.get("donor_ids"),
            gene_batch=args.gene_batch, maf_min=args.maf_min,
            checkpoint=args.checkpoint, progress=True,
        )
        np.savez(args.out, **res)
        print(json.dumps({"n_tested": int(res["pvalues"].shape[0]),
                          "n_genes": int(d["Y"].shape[1]),
                          "out": args.out}))
        return 0
    common = dict(donor_to_cell=d.get("donor_to_cell"),
                  donor_ids=d.get("donor_ids"),
                  block_size=args.block_size, maf_min=args.maf_min,
                  checkpoint=args.checkpoint, progress=True)
    if args.mode == "betas":
        bg, bgxe, maf, vidx = estimate_betas_plink(crm, args.bed, **common)
        np.savez(args.out, beta_g=bg, beta_gxe=bgxe, maf=maf,
                 variant_index=vidx)
        print(json.dumps({"n_tested": int(bg.shape[0]),
                          "n_variants": int(vidx.shape[0]),
                          "out": args.out}))
        return 0
    if args.mode == "interaction-screen":
        pv, info, vidx = scan_interaction_screen_plink(
            crm, args.bed, significance=args.significance,
            screen_margin=args.screen_margin, **common)
        np.savez(args.out, pvalues=pv, variant_index=vidx, **info)
        print(json.dumps({"n_tested": int(pv.shape[0]),
                          "n_confirmed": int(info["confirmed"].sum())
                          if "confirmed" in info else 0,
                          "out": args.out}))
        return 0
    if args.mode in ("association", "association-fast"):
        pv, info, vidx = scan_association_plink(
            crm, args.bed, fast=(args.mode == "association-fast"), **common)
        np.savez(args.out, pvalues=pv, variant_index=vidx,
                 maf=info["maf"])
        print(json.dumps({"n_tested": int(pv.shape[0]),
                          "n_variants": int(vidx.shape[0]),
                          "out": args.out}))
        return 0
    pv, info, vidx = scan_interaction_plink(crm, args.bed, **common)
    np.savez(args.out, pvalues=pv, variant_index=vidx, **info)
    print(json.dumps({"n_tested": int(pv.shape[0]),
                      "n_variants": int(vidx.shape[0]),
                      "out": args.out}))
    return 0


if __name__ == "__main__":  # pragma: no cover - exercised via CLI test
    import sys

    sys.exit(main())
