"""Device-mesh parallelism for tike-tpu.

Replaces the reference's entire communicators layer
(`upstream/src/tike/communicators/`: ThreadPool + MPIComm + stream
pipelines, ~1500 LoC of explicit device-to-device copies) with a single
jax.sharding.Mesh. The parallel decomposition is data-parallel over
diffraction patterns (the reference's primary axis, SURVEY.md §2.3):

- diffraction data and scan positions are sharded along the pattern axis;
- psi / probe / eigen probes are replicated;
- the scatter-add of the object numerator and the sum-reduction of the probe
  numerator become XLA collectives (psum over ICI) inserted automatically by
  GSPMD — the hand-written `pool.reduce_gpu` / `MPI.Allreduce` of the
  reference collapse into compiler-inserted all-reduces.

Data is stored batch-major (num_batch, L, ...) with L padded to a multiple of
the device count, so per-batch slicing never crosses shard boundaries.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

BATCH_AXIS = "batch"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """Create a 1D mesh over the pattern (data-parallel) axis."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (BATCH_AXIS,))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for replicated arrays (psi, probe, options state)."""
    return NamedSharding(mesh, P())


def batch_sharding(mesh: Mesh, axis: int = 0) -> NamedSharding:
    """Sharding that partitions the given axis over the mesh."""
    spec = [None] * axis + [BATCH_AXIS]
    return NamedSharding(mesh, P(*spec))


# ---------------------------------------------------------------------------
# Multi-process (jax.distributed) array placement and gathering, shared by
# the striped ptycho path and the lamino/bucket drivers.
# ---------------------------------------------------------------------------


def put_process_local(local_block, sharding, global_rows: int):
    """Assemble a globally-sharded array from this process's leading-axis
    block (`jax.make_array_from_process_local_data`); single-process falls
    back to a plain device_put."""
    if jax.process_count() > 1:
        local_block = np.asarray(local_block)
        return jax.make_array_from_process_local_data(
            sharding,
            local_block,
            global_shape=(global_rows, *local_block.shape[1:]),
        )
    return jax.device_put(local_block, sharding)


def put_replicated_global(host, sharding):
    """Place an identical full host array on every device of a (possibly
    multi-process) mesh."""
    if jax.process_count() > 1:
        host = np.asarray(host)
        return jax.make_array_from_callback(
            host.shape, sharding, lambda idx: host[idx]
        )
    return jax.device_put(host, sharding)


def fetch_global(x) -> np.ndarray:
    """Host copy of a (possibly cross-process) sharded array.

    Gathers non-addressable shards via `process_allgather` (the
    reference's rank-0 MPI gather at join time).
    """
    if (
        jax.process_count() > 1
        and hasattr(x, "is_fully_addressable")
        and not x.is_fully_addressable
    ):
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(x)
