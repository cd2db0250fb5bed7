"""chip_smoke.py on the CPU: its checks and report helpers at tiny sizes,
and its refusal to run without a GPU."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def test_max_abs_diff_within_tolerance():
    got = np.array([0.5, 1e-9, 0.25])
    want = got + np.array([3e-9, -1e-9, 0.0])
    assert cs.max_abs_diff("pv", got, want, 1e-8) == pytest.approx(3e-9)


@pytest.mark.parametrize("got, want", [
    (np.array([0.5, 0.1]), np.array([0.5, 0.1 + 2e-8])),   # too far
    (np.array([0.5, np.nan]), np.array([0.5, 0.1])),      # non-finite
    (np.array([0.5, 0.1]), np.array([0.5, 0.1, 0.2])),    # shape
])
def test_max_abs_diff_fails(got, want):
    with pytest.raises(cs.SmokeFailure):
        cs.max_abs_diff("pv", got, want, 1e-8)


def test_same_values():
    rho = np.array([0.0, 0.1, 1.0])
    assert cs.same_values("rho1", rho, rho.copy()) == 3
    with pytest.raises(cs.SmokeFailure, match="1 entries differ"):
        cs.same_values("rho1", rho, np.array([0.0, 0.2, 1.0]))


def test_log10_gap():
    pv = np.array([1e-3, 0.5, np.nan, 1e-10, 0.0])
    ref = np.array([1e-4, 0.5, 0.2, 1e-10, 1e-5])
    gmax, q99, n = cs.log10_gap(pv, ref)
    assert n == 3                       # the nan and zero pairs drop out
    assert gmax == pytest.approx(1.0)
    assert 0.0 < q99 <= gmax
    with pytest.raises(cs.SmokeFailure):
        cs.log10_gap(np.array([np.nan]), np.array([0.1]))


def test_result_line_names_the_device():
    import jax

    line = cs.result_line(jax.devices())
    d = jax.devices()[0]
    assert json.loads(line) == {"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}


def test_require_gpu_refuses_cpu():
    with pytest.raises(cs.SmokeFailure, match="no GPU"):
        cs.require_gpu(1)


def test_main_refuses_cpu_in_process(capsys):
    assert cs.main([]) != 0
    assert '"ok": true' not in capsys.readouterr().out


@pytest.mark.parametrize("alone", [False, True],
                         ids=["in_checkout", "script_alone"])
def test_script_fails_without_gpu(tmp_path, alone):
    """Run as a script on a CPU-only JAX, in the checkout and as a lone
    copy: a non-zero exit and no result line."""
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    if alone:
        cwd = tmp_path
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_phase_oracle_tiny():
    """The oracle phase end to end at a tiny size (CPU backend)."""
    cs.phase_oracle(dict(cs.ORACLE, n_cells=300, n_contexts=3, n_donors=15))
