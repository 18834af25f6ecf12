"""Data-parallel execution of the production alignment pipeline over a mesh.

The framework's scaling model (SURVEY §2.4, device equivalent):

- the sorted k-mer index of the assembly is replicated on every device
  (the reference replicates DB blocks per cluster node,
  ``snakemake/Snakefile:998-1037``),
- extension-dispatch lanes (independent candidate alignments) are sharded
  along the mesh's ``dp`` axis — one Snakemake block job ↔ one mesh shard,
- per-shard outputs are merged with an ``all_gather`` collective instead
  of file-level ``LAmerge`` (``Snakefile:1025-1037``): every device ends
  the dispatch holding the full trace-point record set.

The sharded kernel is the *production* ``_extend_scan_v3`` (the same code
the single-device path runs — see :func:`dentist_tpu.ops.banded.sharded_extend_v3`),
so sharded output equals single-device output exactly; the driver's
``dryrun_multichip`` and ``tests/test_parallel.py`` assert this on real
simulated sequences end-to-end through :func:`dentist_tpu.ops.mapper.map_reads`.
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh

from ..utils.log import log_json

__all__ = ["make_mesh", "default_mesh", "init_distributed", "stage_global",
           "dispatch_workers"]


def dispatch_workers(default: int) -> int:
    """Thread count for pools that LAUNCH device programs.

    A multi-process mesh requires every process to enqueue collectives
    in the same order — concurrent launch threads would race and corrupt
    the collective streams (observed with gloo as ``op.preamble.length``
    mismatches) — so launches serialize through one FIFO worker.  Single-process
    meshes keep ``default`` workers to overlap host staging with device
    compute."""
    return 1 if jax.process_count() > 1 else default


def stage_global(mesh, spec, arr):
    """Stage a host array for a ``shard_map`` dispatch over ``mesh``.

    Single-process (all mesh devices addressable): a plain device put —
    jit moves it to the right sharding.  Multi-process (one process per
    host, ``init_distributed``): every process holds the SAME full
    array (the host pipeline is deterministic), so the global array is
    assembled from per-process local shards via
    ``jax.make_array_from_callback`` — each host uploads only its own
    rows, and the allgathered outputs come back fully replicated (the
    collective replaces the reference's shared-filesystem merge, SURVEY
    §2.4 communication-backend row).
    """
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    if jax.process_count() == 1:
        return jnp.asarray(arr)
    arr = np.asarray(arr)
    sh = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(
        arr.shape, sh, lambda idx: np.ascontiguousarray(arr[idx]))

_distributed_initialized = False


def init_distributed() -> bool:
    """Join a multi-host JAX cluster when the environment describes one.

    The reference scales across hosts via Snakemake cluster jobs + file
    merges (``snakemake/Snakefile`` cluster profiles); the equivalent
    here is one process per host in a ``jax.distributed`` cluster, after
    which ``jax.devices()`` spans every host's GPUs and the same ``dp``
    mesh + ``all_gather`` collectives run unchanged across hosts.

    Controlled by environment variables set by the launcher:
    ``DENTIST_TPU_COORDINATOR`` (host:port),
    ``DENTIST_TPU_NUM_PROCESSES`` and ``DENTIST_TPU_PROCESS_ID``.
    Returns True when running distributed.
    """
    global _distributed_initialized
    if _distributed_initialized:
        return True
    coord = os.environ.get("DENTIST_TPU_COORDINATOR")
    if not coord:
        return False
    n = int(os.environ.get("DENTIST_TPU_NUM_PROCESSES", "0")) or None
    pid = os.environ.get("DENTIST_TPU_PROCESS_ID")
    # generous heartbeat: co-located test processes (and loaded CI hosts)
    # stall on compile bursts long enough to miss the 100 s default
    jax.distributed.initialize(
        coordinator_address=coord,
        num_processes=n,
        process_id=int(pid) if pid is not None else None,
        heartbeat_timeout_seconds=int(
            os.environ.get("DENTIST_TPU_HEARTBEAT_TIMEOUT", "300")),
    )
    _distributed_initialized = True
    log_json("info", event="distributedInit", coordinator=coord,
             processes=jax.process_count(), processIndex=jax.process_index(),
             globalDevices=len(jax.devices()),
             localDevices=len(jax.local_devices()))
    return True


def make_mesh(n_devices: int | None = None) -> Mesh:
    """A 1-D ``dp`` mesh over the first ``n_devices`` (global) devices.

    Under :func:`init_distributed`, ``jax.devices()`` spans all hosts and
    the mesh is a multi-host mesh; shard_map inputs must then be globally
    consistent (each flush's lanes are identical on every host, which the
    deterministic host pipeline guarantees).
    """
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), ("dp",))


def default_mesh() -> Mesh | None:
    """The mesh the pipeline auto-shards over: all devices (all hosts
    when distributed), or ``None`` when only one device exists.

    ``DENTIST_TPU_FORCE_SINGLE=1`` forces the single-device path even on
    a multi-device backend — the reference baseline the multichip dryrun
    compares whole-pipeline sharded output against."""
    if os.environ.get("DENTIST_TPU_FORCE_SINGLE"):
        return None
    init_distributed()
    return make_mesh() if len(jax.devices()) > 1 else None
