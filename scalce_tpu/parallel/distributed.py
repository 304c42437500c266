"""Multi-host bootstrap over ``jax.distributed`` (SURVEY.md §3
"Multi-host DP", §6 "Distributed communication backend").

The reference has no distributed story at all; scalce_tpu's is
deliberately thin because blocks are independent:

  1. every host calls :func:`init_multihost` (network rendezvous),
  2. every host runs ``driver.compress`` with ``n_hosts``/``host_id``
     filled from the process group — each encodes its strided share of
     blocks to a private triplet,
  3. :func:`barrier` (a tiny device all-reduce across hosts),
  4. rank 0 runs ``driver.merge_hosts`` — the deterministic ordered
     gather; output is byte-identical to a 1-host run (tested in
     tests/test_multihost.py via simulated hosts).

The only tensor collective in the framework is the lossy-histogram
psum (``mesh.make_lossy_hist_allreduce``); everything else is host-level
manifest movement, which is exactly what the block container makes
safe.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import numpy as np


@dataclasses.dataclass(frozen=True)
class HostTopology:
    host_id: int
    n_hosts: int
    n_local_devices: int
    n_global_devices: int


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None) -> HostTopology:
    """Initialize ``jax.distributed`` (no-op when single-process) and
    return this host's coordinates.

    Arguments default to the standard JAX environment variables
    (``JAX_COORDINATOR_ADDRESS`` etc.) / cluster auto-detection.
    """
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id)
    return HostTopology(
        host_id=jax.process_index(),
        n_hosts=jax.process_count(),
        n_local_devices=jax.local_device_count(),
        n_global_devices=jax.device_count())


def barrier(tag: int = 0) -> None:
    """Cross-host barrier.

    Used between "all hosts finished encoding" and "rank 0 merges"
    (merge reads every host's files, so they must be durable first).

    Multi-process: ``multihost_utils.sync_global_devices`` — a named
    rendezvous through the coordination service + a tiny device
    all-reduce (a plain ``device_put`` over a global mesh would fail on
    the non-addressable devices of other hosts, which is why the naive
    psum formulation cannot work here).  Single-process: local psum
    sanity check only.
    """
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices(f"scalce_tpu_barrier_{tag}")
        return
    devs = np.array(jax.local_devices())
    total = int(jax.jit(lambda v: v.sum())(
        np.full(len(devs), tag + 1, np.int32)))
    assert total == (tag + 1) * len(devs)


def global_quality_histogram(local_hist: np.ndarray) -> np.ndarray:
    """All-reduce the lossy sampling histogram across hosts so every
    host builds the identical quantization map (SURVEY.md §6).

    Single-process: identity.  Multi-process: psum over all devices
    (each host contributes its local histogram once, on its first
    local device; other devices contribute zeros).
    """
    if jax.process_count() == 1:
        return local_hist
    from jax.experimental import multihost_utils
    summed = multihost_utils.process_allgather(local_hist)
    return np.asarray(summed).sum(axis=0)
