"""Real multi-process distribution.

Two OS processes initialize `jax.distributed` over a localhost coordinator
(CPU backend, gloo collectives, 2 virtual devices each -> 4 global devices),
each scans its shard of the variant axis, and the result tables are merged
with a genuine cross-process `process_allgather`.  The parent asserts both
processes produced the same merged table and that it matches a
single-process scan — the SURVEY 2.4/5.8 comm-backend requirement.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
from numpy.testing import assert_allclose

import cellregmap_tpu as crt

_WORKER = r"""
import os, sys
import numpy as np

pid = int(sys.argv[1]); nproc = int(sys.argv[2])
port = sys.argv[3]; outdir = sys.argv[4]

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_cpu_collectives_implementation", "gloo")

from cellregmap_tpu.parallel import initialize_distributed
initialize_distributed(f"localhost:{port}", nproc, pid)
assert jax.process_count() == nproc, jax.process_count()
assert len(jax.devices()) == 2 * nproc, len(jax.devices())

import jax.numpy as jnp
import cellregmap_tpu as crt

rng = np.random.default_rng(31)
n, C, S = 50, 3, 8
E = rng.normal(size=(n, C))
W = np.ones((n, 1))
hK = rng.normal(size=(n, 6)) / np.sqrt(6)
Ls = [np.asarray(L) for L in crt.get_L_values(hK, E)]
G = rng.choice([0.0, 1.0, 2.0], size=(n, S), p=[0.49, 0.42, 0.09])
G = (G - G.mean(0)) / G.std(0)
KE = sum(L @ L.T for L in Ls)
y = (0.5 * rng.normal(size=n)
     + np.linalg.cholesky(KE + 1e-8 * np.eye(n)) @ rng.normal(size=n))

crm = crt.CellRegMap(y=y, E=E, W=W, Ls=Ls)
shards = np.array_split(np.arange(S), nproc)
pv_local, _ = crm.scan_interaction(G[:, shards[pid]])

from jax.experimental import multihost_utils
pv_all = multihost_utils.process_allgather(jnp.asarray(pv_local))
np.save(os.path.join(outdir, f"pv_{pid}.npy"),
        np.asarray(pv_all).reshape(-1))
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_distributed_scan(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    port = _free_port()

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + env.get("PYTHONPATH", "").split(os.pathsep))
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)

    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(pid), "2", str(port),
             str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for pid in range(2)
    ]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-3000:]

    pv0 = np.load(tmp_path / "pv_0.npy")
    pv1 = np.load(tmp_path / "pv_1.npy")
    # both processes hold the identical merged table
    assert_allclose(pv0, pv1, rtol=0, atol=0)

    # merged table matches a single-process scan
    rng = np.random.default_rng(31)
    n, C, S = 50, 3, 8
    E = rng.normal(size=(n, C))
    W = np.ones((n, 1))
    hK = rng.normal(size=(n, 6)) / np.sqrt(6)
    Ls = [np.asarray(L) for L in crt.get_L_values(hK, E)]
    G = rng.choice([0.0, 1.0, 2.0], size=(n, S), p=[0.49, 0.42, 0.09])
    G = (G - G.mean(0)) / G.std(0)
    KE = sum(L @ L.T for L in Ls)
    y = (0.5 * rng.normal(size=n)
         + np.linalg.cholesky(KE + 1e-8 * np.eye(n)) @ rng.normal(size=n))
    crm = crt.CellRegMap(y=y, E=E, W=W, Ls=Ls)
    pv_ref, _ = crm.scan_interaction(G)
    assert_allclose(pv0, pv_ref, atol=1e-9)
