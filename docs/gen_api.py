"""Generate docs/api.md: the full public API reference.

Offline equivalent of the reference's Sphinx API docs
(/root/reference/docs/conf.py, docs/functions.rst) — introspects every
public symbol and writes a markdown reference.  Run from the repo root:

    python docs/gen_api.py
"""
import inspect
import io
from pathlib import Path


def _sig(obj):
    try:
        return str(inspect.signature(obj))
    except (TypeError, ValueError):
        return "(...)"


def _doc(obj, indent=""):
    d = inspect.getdoc(obj) or "*(undocumented)*"
    return "\n".join(indent + line for line in d.splitlines())


def emit_callable(out, name, obj, level="###"):
    kind = "class" if inspect.isclass(obj) else "def"
    out.write(f"{level} `{kind} {name}{_sig(obj)}`\n\n")
    out.write(_doc(obj) + "\n\n")
    if inspect.isclass(obj):
        for mname, m in sorted(vars(obj).items()):
            if mname.startswith("_") or not callable(m):
                continue
            out.write(f"{level}# `.{mname}{_sig(m)}`\n\n")
            out.write(_doc(m) + "\n\n")


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import cellregmap_tpu as crt
    from cellregmap_tpu import engine, oracle, plink_scan, sim
    from cellregmap_tpu.models import lmm, pvalues
    from cellregmap_tpu.parallel import checkpoint, mesh, scan
    from cellregmap_tpu.utils import plink, trace

    out = io.StringIO()
    out.write("# cellregmap_tpu API reference\n\n")
    out.write(f"Version {crt.__version__}.  Generated by `docs/gen_api.py` "
              "— regenerate after changing any public docstring.\n\n")
    out.write(_doc(crt) + "\n\n")

    out.write("## Top-level package\n\n")
    for name in crt.__all__:
        obj = getattr(crt, name)
        if callable(obj):
            emit_callable(out, name, obj)
        else:
            out.write(f"### `{name}`\n\n")
            out.write(f"`{obj!r}`\n\n" if not inspect.ismodule(obj)
                      else _doc(obj) + "\n\n")

    sections = [
        ("Engine (device kernels)", engine,
         ["build_null_context", "interaction_batch",
          "interaction_multigene_batch", "score_test_core",
          "build_betas_context", "predict_interaction_kernel",
          "association_refit_kernel", "fast_scan_kernel",
          "null_association_kernel", "mean_fit_kernel"]),
        ("LMM fitters", lmm,
         [n for n in ("EigData", "fit_delta_eig", "lml_at_delta_eig",
                      "fast_scan", "delta_derivatives",
                      "fit_delta_woodbury_family")
          if hasattr(lmm, n)]),
        ("P-values", pvalues,
         [n for n in ("davies_pvalue", "davies_pvalue_batch", "liu_sf",
                      "saddlepoint_sf", "score_statistic_liu_params",
                      "lrt_pvalues", "qmin", "imhof_sf")
          if hasattr(pvalues, n)]),
        ("Streaming PLINK scans", plink_scan,
         ["scan_interaction_plink", "scan_interaction_multigene_plink",
          "resolve_donor_to_cell", "main"]),
        ("PLINK IO", plink, ["PlinkReader", "write_bed"]),
        ("Parallel: mesh / sharded scan / checkpoint", mesh,
         ["make_mesh", "initialize_distributed"]),
        ("", scan, ["ShardedScanner"]),
        ("", checkpoint, ["ScanCheckpoint"]),
        ("Observability", trace,
         ["PhaseTimers", "trace_scope", "profile_to", "log_event"]),
        ("Simulation", sim,
         ["create_variances", "sample_phenotype", "sample_phenotype_gxe",
          "sample_genotype", "sample_maf", "sample_covariance_matrix"]),
        ("Dense oracles (test baselines)", oracle,
         [n for n in ("scan_interaction_dense",
                      "scan_interaction_reference_style", "P_matrix",
                      "score_statistic", "imhof_sf")
          if hasattr(oracle, n)]),
    ]
    for title, module, names in sections:
        if title:
            out.write(f"## {title}\n\n")
            out.write(f"Module `{module.__name__}`.\n\n")
        for name in names:
            emit_callable(out, name, getattr(module, name))

    path = Path(__file__).parent / "api.md"
    path.write_text(out.getvalue())
    print(f"wrote {path} ({len(out.getvalue().splitlines())} lines)")


if __name__ == "__main__":
    main()
