"""Multi-host runtime.

The reference scales out with Kafka consumers on separate machines
(docker-compose.yml, config/node/*.env); here several hosts can instead
run one JAX process each, all participating in the same mesh, with XLA
collectives doing the merging and the network between hosts used only
for process bootstrap and host-level work intake (the service queue).

Environment contract (deploy/aligner.env documents all of these):

* ``ALIGNER_COORDINATOR``    — ``host:port`` of process 0
* ``ALIGNER_PROCESS_ID``     — this process's index
* ``ALIGNER_NUM_PROCESSES``  — total process count

Nothing is auto-detected: without ``ALIGNER_NUM_PROCESSES`` > 1 the
process runs alone (deploy/launch_pod.sh sets all three).
"""

from __future__ import annotations

import os

import jax
import numpy as np

from .mesh import make_mesh


def initialize_from_env() -> None:
    """``jax.distributed.initialize`` with the ALIGNER_* env contract;
    a no-op unless ``ALIGNER_NUM_PROCESSES`` > 1."""
    n = int(os.environ.get("ALIGNER_NUM_PROCESSES", "1"))
    if n <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=os.environ["ALIGNER_COORDINATOR"],
        num_processes=n,
        process_id=int(os.environ["ALIGNER_PROCESS_ID"]),
    )


def global_mesh(axes: tuple[str, str] = ("data", "matrix")):
    """Mesh over every device of every participating process."""
    return make_mesh(len(jax.devices()), axes)


def shard_local_batch(mesh, axis: str, local_array: np.ndarray,
                      global_rows: int | None = None):
    """Build a global sharded array from per-process local data.

    Each process contributes its own slice of the problem batch (the
    host-level work feed replaces Kafka partitioning); the result is a
    jax.Array sharded over ``axis`` that sharded steps consume directly.

    Pass ``global_rows`` (the TOTAL batch size) whenever per-process
    spans can be uneven — :func:`process_span`'s ceil-div gives the
    tail process fewer (possibly zero) rows.  Uneven totals are padded
    HERE to a shard-aligned size (``jax.make_array_from_process_local_
    data`` requires the global dim divisible by the mesh axis): every
    process contributes an equal zero-padded block, so the returned
    array's leading dim may exceed ``global_rows``.  Layout note for
    consumers: process i's real rows [lo_i, hi_i) from
    :func:`process_span` land at ``i*per_pad + (g - lo_i)`` with
    ``per_pad = result_rows // process_count`` — per-process blocks
    each padded at the END with zero rows (zero lengths: the
    framework's free-problem convention).  With a divisible
    ``global_rows`` no padding happens and the layout is the plain
    contiguous batch.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..errors import ValidationError

    sharding = NamedSharding(mesh, P(axis))
    if global_rows is None:
        return jax.make_array_from_process_local_data(sharding, local_array)
    n = jax.process_count()
    axis_n = mesh.shape[axis]
    if axis_n % n:
        raise ValidationError(
            f"mesh axis {axis!r} ({axis_n} shards) does not divide over "
            f"{n} processes — every process must own an equal shard span"
        )
    per = -(-global_rows // n)  # process_span's ceil-div share
    per_pad = -(-per // (axis_n // n)) * (axis_n // n)  # shard-aligned
    local_array = np.asarray(local_array)
    pad = per_pad - local_array.shape[0]
    if pad < 0:
        raise ValidationError(
            f"local batch has {local_array.shape[0]} rows but this "
            f"process's share of {global_rows} is {per} (process_span)"
        )
    if pad:
        local_array = np.concatenate([
            local_array,
            np.zeros((pad, *local_array.shape[1:]), local_array.dtype),
        ])
    global_shape = (per_pad * n, *local_array.shape[1:])
    return jax.make_array_from_process_local_data(
        sharding, local_array, global_shape=global_shape
    )


def process_span(total: int) -> tuple[int, int]:
    """This process's contiguous [lo, hi) share of a global batch."""
    n = jax.process_count()
    i = jax.process_index()
    per = -(-total // n)
    return min(i * per, total), min((i + 1) * per, total)
