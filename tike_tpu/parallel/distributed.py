"""Multi-host tier: the reference's MPI axis in JAX.

The reference composes two communication tiers — a ThreadPool over the GPUs
of one node and mpi4py across nodes — and hand-writes hierarchical
reductions (pool-reduce then MPI.Allreduce,
`upstream/src/tike/communicators/comm.py:80-136`) plus per-rank data
loading (`MPIio_ptycho` stripes scan positions across ranks,
`mpi.py:61-92`). Here both tiers are one device mesh: every process
contributes its local devices to a single global `jax.sharding.Mesh`, GSPMD
`psum` reductions cross devices and hosts automatically, and the only
genuinely multi-host concern left is *data
placement* — each process must load only its own stripe of the diffraction
patterns and contribute it to the globally-sharded array.

Flow (the `mpiexec -n P` equivalent):

    import tike_tpu.parallel.distributed as dist
    dist.initialize(coordinator_address=..., num_processes=P, process_id=r)
    local = dist.stripe_for_process(scan)     # this process's pattern rows
    data_local = load_my_patterns(local)      # only |local| patterns in RAM
    mesh = dist.global_mesh()
    parameters = PtychoParameters(scan=scan, ...)   # full scan (small)
    result = tike_tpu.ptycho.reconstruct(
        data_local, parameters, mesh=mesh)    # identical result on all ranks

The full scan is replicated (it is tiny — 8 bytes/position); the data is
never gathered. Batch layouts are computed identically on every process from
the full scan, so all processes execute the same XLA program.
"""

from __future__ import annotations

import logging
import typing

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from . import BATCH_AXIS

logger = logging.getLogger(__name__)


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    **kwargs,
) -> None:
    """Join the multi-process runtime (`jax.distributed.initialize` wrapper).

    Equivalent of the reference's implicit ``MPI.COMM_WORLD`` attachment
    (`mpi.py:198-219`). Must be called before any other JAX call — like
    ``jax.distributed.initialize`` itself, which refuses to run once the
    XLA backend exists (so this wrapper must NOT touch ``jax.process_count``
    or ``jax.devices`` first). No-op when the distributed runtime is
    already attached. Where the cluster environment describes the job (for
    example SLURM), all arguments are auto-detected.
    """
    # Detect prior initialization WITHOUT initializing the backend:
    # the global client object exists iff initialize() already ran.
    try:
        from jax._src.distributed import global_state as _state
    except ImportError:  # future jax: fall back to the public surface
        _state = getattr(jax.distributed, "global_state", None)
    if _state is not None and getattr(_state, "client", None) is not None:
        return  # already initialized
    if coordinator_address is None and num_processes is None:
        # Auto-detected environment (cluster env vars).
        try:
            jax.distributed.initialize(**kwargs)
        except Exception as error:
            # Only swallow the genuinely-single-process case; re-raise when
            # the backend was already touched (a real ordering bug) so
            # multi-host runs cannot silently degrade to single-process mode.
            if "must be called before" in str(error):
                raise
            logger.info(
                "single-process mode (no distributed runtime): %s", error
            )
        return
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            **kwargs,
        )
    except RuntimeError as error:
        # Belt-and-braces for the private global_state probe above: if a
        # future JAX moves that attribute, double initialization surfaces
        # here instead — treat it as the documented no-op.
        if "already initialized" in str(error):
            logger.info("distributed runtime already attached: %s", error)
            return
        raise


def global_mesh(axis_name: str = BATCH_AXIS) -> Mesh:
    """A 1-D mesh over every chip of every process (DCN x ICI flattened).

    Device order is process-major (``jax.devices()`` convention), so a
    batch axis sharded over this mesh assigns a contiguous block of slots
    to each process — the property `striped_batches` relies on.
    """
    return Mesh(np.asarray(jax.devices()), (axis_name,))


def dcn_mesh(ici_axis: str = "ici", dcn_axis: str = "dcn") -> Mesh:
    """A 2-D (process, local-chip) mesh for mixed shardings.

    Use when different tensors shard over different tiers (e.g. lamino
    theta over DCN, volume over ICI); for pure data parallelism prefer the
    flattened :func:`global_mesh`.
    """
    devices = np.asarray(jax.devices()).reshape(
        jax.process_count(), jax.local_device_count()
    )
    return Mesh(devices, (dcn_axis, ici_axis))


def stripe_indices(
    scan: np.ndarray, num_processes: int | None = None
) -> typing.List[np.ndarray]:
    """Partition pattern rows into per-process stripes by scan coordinate.

    Equivalent of ``MPIio_ptycho`` (`mpi.py:61-85`), with one deliberate
    change: the reference cuts at equally-spaced *coordinate* edges, which
    yields unequal shard sizes for non-uniform scans; here stripes carry
    equal *counts* (argsort of the row coordinate, like the intra-node
    `stripes_equal_count`) so every process computes on the same shapes —
    a requirement for single-program SPMD.
    """
    from ..cluster import stripes_equal_count

    if num_processes is None:
        num_processes = jax.process_count()
    return stripes_equal_count(np.asarray(scan), num_processes, dim=0)


def stripe_for_process(
    scan: np.ndarray,
    *args: np.ndarray,
    num_processes: int | None = None,
    process_id: int | None = None,
):
    """Return this process's pattern row indices (and strided extra arrays).

    ``stripe_for_process(scan)`` -> index array; with extra arrays, returns
    ``(indices, arg0[indices], ...)`` like the reference's
    ``MPIio_ptycho(scan, data)``.
    """
    if process_id is None:
        process_id = jax.process_index()
    idx = stripe_indices(scan, num_processes)[process_id]
    if not args:
        return idx
    return (idx, *(np.asarray(a)[idx] for a in args))


def split_for_process(
    *args: np.ndarray,
    axis: int = 0,
    num_processes: int | None = None,
    process_id: int | None = None,
):
    """``MPIio_lamino`` equivalent (`mpi.py:87-92`): split along an axis."""
    if num_processes is None:
        num_processes = jax.process_count()
    if process_id is None:
        process_id = jax.process_index()
    out = tuple(
        np.array_split(np.asarray(a), num_processes, axis=axis)[process_id]
        for a in args
    )
    return out[0] if len(out) == 1 else out


def striped_batches(
    scan: np.ndarray,
    num_processes: int,
    batch_method: str,
    num_batch: int,
    rng: np.random.Generator,
    local_multiple: int,
):
    """Global stripe-major batch layout for multi-host reconstruction.

    Every process calls this with the *full* scan and an identically-seeded
    rng, producing the same layout everywhere:

    - ``global_order`` (N,) — global pattern indices in stripe-major
      clustered order (``scan_ordered = scan[global_order]``).
    - ``batch_idx`` (nb, P*Lp) / ``batch_mask`` — batch n's slots, laid out
      as [stripe-0 slots | stripe-1 slots | ...] with every stripe padded to
      the same ``Lp`` (a multiple of ``local_multiple``), so sharding the
      slot axis over a process-major device list places each pattern on its
      owning process.
    - ``stripe_slots`` — per process: (ordered local row positions (nb, Lp),
      local mask) for assembling the process-local data block.
    - ``stripe_start`` — per-stripe minimum row coordinate (for object
      striping interop).
    """
    from ..cluster import by_scan_stripes_contiguous, batches_padded

    order, batches, stripe_start = by_scan_stripes_contiguous(
        scan=np.asarray(scan),
        num_stripes=num_processes,
        batch_method=batch_method,
        num_batch=num_batch,
        rng=rng,
    )
    padded = [
        batches_padded(b, multiple_of=local_multiple) for b in batches
    ]
    Lp = max(idx.shape[1] for idx, _ in padded)
    Lp = -(-Lp // local_multiple) * local_multiple
    nb = len(batches[0])

    def repad(idx, mask):
        if idx.shape[1] == Lp:
            return idx, mask
        idx2 = np.concatenate(
            [idx, np.repeat(idx[:, :1], Lp - idx.shape[1], axis=1)], axis=1
        )
        mask2 = np.concatenate(
            [mask, np.zeros((nb, Lp - mask.shape[1]), np.float32)], axis=1
        )
        return idx2, mask2

    padded = [repad(idx, mask) for idx, mask in padded]

    offsets = np.cumsum([0] + [len(o) for o in order])[:-1]
    batch_idx = np.concatenate(
        [idx + off for (idx, _), off in zip(padded, offsets)], axis=1
    ).astype(np.int32)
    batch_mask = np.concatenate([m for _, m in padded], axis=1)
    global_order = np.concatenate(order)
    stripe_slots = [(idx, mask) for idx, mask in padded]
    return global_order, batch_idx, batch_mask, stripe_slots, stripe_start


def make_global_batch_data(
    mesh: Mesh,
    local_block: np.ndarray,
    num_processes: int,
) -> jax.Array:
    """Assemble the (nb, P*Lp, DET, DET) global data from per-process blocks.

    ``local_block`` is this process's (nb, Lp, DET, DET) slice; the result
    is sharded on the slot axis over all global devices without any host
    gathering (the reference never gathers data across ranks either).
    """
    nb, Lp = local_block.shape[:2]
    sharding = NamedSharding(mesh, P(None, mesh.axis_names[0]))
    return jax.make_array_from_process_local_data(
        sharding,
        local_block,
        global_shape=(nb, num_processes * Lp, *local_block.shape[2:]),
    )


class HostStreamedBatches:
    """Host-resident per-process data, uploaded one mini-batch at a time.

    The >HBM host-streaming mode composed with the multi-host DP layout:
    the reference's CUDA-stream pipeline (`stream.py:285-404`) runs
    unchanged under MPI (`mpi.py:61-85` stripes the rows; the solvers
    stream regardless). Here each process keeps only its own
    (nb, Lp, DET, DET) stripe block in host RAM and ``data[n]`` assembles
    mini-batch ``n`` as ONE globally-sharded (P*Lp, DET, DET) device array
    (no host gathering). Uploads are asynchronous, so the solvers'
    double-buffered prefetch overlaps batch k+1's upload with batch k's
    compute exactly as in the single-process streaming mode.
    """

    def __init__(
        self,
        mesh: Mesh,
        local_block: np.ndarray,
        num_processes: int,
    ):
        self.mesh = mesh
        self.local = local_block
        nb, Lp = local_block.shape[:2]
        self.shape = (
            nb,
            num_processes * Lp,
            *local_block.shape[2:],
        )
        self.ndim = 4
        self._sharding = NamedSharding(mesh, P(mesh.axis_names[0]))

    def __len__(self) -> int:
        return self.shape[0]

    def __getitem__(self, n) -> jax.Array:
        """Upload mini-batch ``n`` as a globally-sharded device array."""
        n = int(n)
        return jax.make_array_from_process_local_data(
            self._sharding,
            np.ascontiguousarray(self.local[n]),
            global_shape=self.shape[1:],
        )
