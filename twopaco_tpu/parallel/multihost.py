"""Multi-host scaffolding: process init, per-host input sharding, and a
multi-host entry point for the distributed engine.

The reference is strictly single-node (SURVEY.md §2.4 — pthreads, no
sockets); multi-host is a new capability this framework introduces. The
design follows the standard JAX SPMD recipe:

  * every process calls :func:`initialize` (jax.distributed) and then
    runs the SAME program over a global mesh spanning all hosts'
    devices — collectives go through NCCL on GPUs (NVLink within a
    host, the network across hosts) and Gloo on CPU devices;
  * input is sharded BY ROWS of each window batch: device d owns rows
    [d*B/D, (d+1)*B/D), so a host materializes only its own devices'
    rows (jax.make_array_from_process_local_data) — FASTA parsing is
    replicated per host (cheap, streaming) while device memory and all
    record building/routing/sorting are fully sharded;
  * results are gathered with process_allgather; process 0 writes the
    output (.dbg) — single-writer, like every pass of the reference.

Degenerate single-process runs take the exact same code path (the
global mesh is just the local one), which is how this module is tested
in this repo — real multi-host hardware is not available here
(docs/PARITY.md).
"""

from __future__ import annotations

import os
from typing import Callable, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Initialize the multi-process JAX runtime (no-op if single
    process and no coordinator is configured).

    Arguments default from the env vars JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID. Nothing discovers a GPU cluster
    on its own: every process needs the coordinator's host:port, the
    process count and its own id.
    """
    if jax.distributed.is_initialized():
        return  # idempotent: entry points call this defensively
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address is None and (num_processes or 1) == 1:
        return  # single-process: nothing to initialize
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh() -> Mesh:
    """1-D mesh over every device of every process, host-major (each
    host's devices contiguous, so batch rows shard host-locally)."""
    return Mesh(np.array(jax.devices()), ("shard",))


def make_put(mesh: Mesh) -> Callable[[np.ndarray], jax.Array]:
    """Row-sharding placement function for window-batch arrays.

    Single-process: plain device_put. Multi-process: the local slice of
    the global batch is assembled per host
    (jax.make_array_from_process_local_data), so a host only ever
    touches its own devices' rows.
    """
    sharding = NamedSharding(mesh, P("shard"))
    n_proc = jax.process_count()
    if n_proc == 1:
        return lambda a: jax.device_put(a, sharding)
    pid = jax.process_index()

    def put(a: np.ndarray) -> jax.Array:
        rows = a.shape[0]
        assert rows % n_proc == 0, (rows, n_proc)
        local = a[pid * (rows // n_proc) : (pid + 1) * (rows // n_proc)]
        return jax.make_array_from_process_local_data(sharding, local)

    return put


def fetch(a) -> np.ndarray:
    """Gather a (possibly cross-host sharded) array to every host.

    Replicated or fully-addressable arrays convert directly (passing
    them to process_allgather would CONCATENATE one copy per process);
    only cross-host row-sharded arrays need the cross-host all-gather."""
    if (
        jax.process_count() == 1
        or not isinstance(a, jax.Array)
        or a.is_fully_replicated
        or a.is_fully_addressable
    ):
        return np.asarray(a)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(a, tiled=True))


def barrier(name: str) -> None:
    """Block until every process reaches this point (no-op when
    single-process). Used to order proc-0 file writes (checkpoints)
    against other processes reading them back."""
    if jax.process_count() == 1:
        return
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices(name)


def is_writer() -> bool:
    """True on the process that owns file output (single-writer)."""
    return jax.process_index() == 0


def build_junctions_multihost(
    input_paths: Sequence[str] | None,
    config,
    out_path: str | None = None,
    sequences=None,
    log: Callable[[str], None] = lambda s: None,
    checkpoint_dir: str | None = None,
    bloom_gate: bool = False,
):
    """Multi-host entry: initialize(), build over the global mesh,
    process 0 writes. Every process must call this with identical
    arguments (SPMD); each parses the input itself (streaming, host
    RAM only) while device work is sharded across all hosts.
    checkpoint_dir must be on a filesystem every process can read
    (process 0 writes the round files, a barrier orders the reads)."""
    initialize()
    from twopaco_tpu.parallel.distpipe import build_junctions_dist

    mesh = global_mesh()
    return build_junctions_dist(
        input_paths,
        config,
        mesh=mesh,
        out_path=out_path if is_writer() else None,
        sequences=sequences,
        log=log if is_writer() else (lambda s: None),
        checkpoint_dir=checkpoint_dir,
        bloom_gate=bloom_gate,
    )
