"""Device-mesh construction for data-parallel scans.

The reference has no parallelism at all (serial SNP loops,
/root/reference/cellregmap/_cellregmap.py:270,340).  Here the variant axis is
the data-parallel axis (SURVEY.md section 2.4): the per-dataset state
(y, W, E, the factorized covariance family) is replicated per device and
variant batches are sharded over a 1-D mesh; result tables come back sharded
and are gathered on the host.  Multi-host: `jax.distributed.initialize` +
the same mesh over all processes' devices.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import jax
from jax.sharding import Mesh


VARIANT_AXIS = "variants"


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None,
              axis_name: str = VARIANT_AXIS) -> Mesh:
    """1-D mesh over the variant (data-parallel) axis."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis_name,))


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Multi-host init.

    No-op only when the distributed runtime is *already* initialized
    (re-entrant callers); genuine misconfiguration propagates — silently
    swallowing it made multi-host failures invisible.
    """
    import logging

    log = logging.getLogger("cellregmap_tpu")
    if jax.distributed.is_initialized():
        log.debug("jax.distributed already initialized; skipping")
        return
    log.info(
        "initializing jax.distributed (coordinator=%s, %s processes, id=%s)",
        coordinator_address, num_processes, process_id,
    )
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
