"""Where the package keeps its compile and build caches.

JAX_COMPILATION_CACHE_DIR, when set, decides the XLA cache directory and the
package sets none of its own; otherwise the cache lives at one fixed path
inside the checkout.  Native libraries build beside it.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

_PROBE = ("import jax, cellregmap_tpu; "
          "print(jax.config.jax_compilation_cache_dir)")


@pytest.mark.parametrize("env_dir", [None, "given"])
def test_compilation_cache_dir(tmp_path, env_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT))
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "xla")
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120, check=True).stdout.strip()
    want = (tmp_path / "xla") if env_dir else (ROOT / ".cache" / "xla")
    assert Path(out) == want


def test_native_library_builds_inside_checkout():
    from cellregmap_tpu._config import CACHE_ROOT
    from cellregmap_tpu.utils import native

    assert CACHE_ROOT == ROOT / ".cache"
    path = native._build("qfc.cc")
    assert path.parent == CACHE_ROOT / "native" and path.exists()
    # named by the source digest: the same source maps to the same file
    assert native._build("qfc.cc") == path


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A source that does not compile raises with the compiler's output; no
    caller falls back to a slower path."""
    from cellregmap_tpu.utils import native

    (tmp_path / "broken.cc").write_text("this is not C++\n")
    monkeypatch.setattr(native, "_NATIVE_SRC", tmp_path)
    monkeypatch.setattr(native, "CACHE_ROOT", tmp_path / "cache")
    with pytest.raises(RuntimeError, match="building broken.cc failed"):
        native._build("broken.cc")
    assert not any((tmp_path / "cache" / "native").iterdir())
