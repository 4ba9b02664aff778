"""Subprocess body for the 2-process jax.distributed test.

Run as: python multihost_proc.py <outfile>
with ALIGNER_COORDINATOR / ALIGNER_PROCESS_ID / ALIGNER_NUM_PROCESSES set
(the deploy/aligner.env contract).  Exercises the real multihost helpers:
initialize_from_env → global_mesh → process_span → shard_local_batch →
sharded_scores, then process 0 writes the gathered scores as JSON.
"""

import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=2"
).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from aligner_tpu.parallel import multihost  # noqa: E402
from aligner_tpu.parallel.mesh import sharded_scores  # noqa: E402


def main() -> int:
    outfile = sys.argv[1]
    multihost.initialize_from_env()
    assert jax.process_count() == 2, jax.process_count()
    assert len(jax.devices()) == 4  # 2 hosts x 2 local devices

    mesh = multihost.global_mesh()

    # deterministic global problem batch, same on every process
    rng = np.random.default_rng(7)
    B, L = 16, 24
    q = rng.integers(0, 24, (B, L)).astype(np.int32)
    t = rng.integers(0, 24, (B, L)).astype(np.int32)
    ql = np.full(B, L, np.int32)
    tl = np.full(B, L, np.int32)
    from aligner_tpu.matrices import blosum62

    mat = np.asarray(blosum62(), np.float32)

    # each process contributes only its own slice (the host work feed)
    lo, hi = multihost.process_span(B)
    qg = multihost.shard_local_batch(mesh, "data", q[lo:hi], global_rows=B)
    tg = multihost.shard_local_batch(mesh, "data", t[lo:hi], global_rows=B)
    qlg = multihost.shard_local_batch(mesh, "data", ql[lo:hi], global_rows=B)
    tlg = multihost.shard_local_batch(mesh, "data", tl[lo:hi], global_rows=B)

    fmax, fy, fx, end = sharded_scores(
        mesh, qg, qlg, tg, tlg, mat, 11.0, 2.0, mode="local", engine="xla"
    )
    from jax.experimental import multihost_utils

    gathered = np.asarray(
        multihost_utils.process_allgather(fmax, tiled=True)
    )

    # UNEVEN global batch (B=10 over the 4-shard data axis, 2 procs):
    # shard_local_batch pads internally to a shard-aligned size; the
    # real rows' scores must match the even-batch run's first 10
    Bu = 10
    lo_u, hi_u = multihost.process_span(Bu)
    qg_u = multihost.shard_local_batch(mesh, "data", q[lo_u:hi_u], global_rows=Bu)
    tg_u = multihost.shard_local_batch(mesh, "data", t[lo_u:hi_u], global_rows=Bu)
    qlg_u = multihost.shard_local_batch(mesh, "data", ql[lo_u:hi_u], global_rows=Bu)
    tlg_u = multihost.shard_local_batch(mesh, "data", tl[lo_u:hi_u], global_rows=Bu)
    fmax_u, *_ = sharded_scores(
        mesh, qg_u, qlg_u, tg_u, tlg_u, mat, 11.0, 2.0, mode="local",
        engine="xla",
    )
    gathered_u = np.asarray(
        multihost_utils.process_allgather(fmax_u, tiled=True)
    )
    assert gathered_u.shape[0] >= Bu
    # padded layout: per-process blocks of per_pad rows, real rows first
    per_pad = gathered_u.shape[0] // jax.process_count()
    for i in range(jax.process_count()):
        per = -(-Bu // jax.process_count())
        pl, ph = min(i * per, Bu), min((i + 1) * per, Bu)
        assert np.array_equal(
            gathered_u[i * per_pad : i * per_pad + (ph - pl)],
            gathered[pl:ph],
        ), (i, gathered_u, gathered[:Bu])

    # cross-PROCESS wavefront: one global pair, columns sharded over the
    # 4 global devices (2 per process) — the boundary-halo ppermute hops
    # across the process boundary over the distributed runtime
    from jax.sharding import Mesh

    from aligner_tpu.parallel.wavefront_sp import sharded_global_end_score

    mesh1d = Mesh(np.array(jax.devices()).reshape(-1), ("data",))
    wq = rng.integers(0, 24, 96).astype(np.int8)
    wt = rng.integers(0, 24, 70).astype(np.int8)
    wf_end = float(sharded_global_end_score(
        mesh1d, wq, wt, np.asarray(blosum62()), 11.0, 2.0, tr=16,
    ))

    # cross-process FULL alignment: the forward pipeline all-gathers the
    # trace records so every process replays/walks locally; the strings
    # must be bit-equal on both processes (asserted by the test) and to
    # the oracle
    from aligner_tpu.parallel.wavefront_sp import sharded_global_align

    aln_end, qa, ta, coords = sharded_global_align(
        mesh1d, wq, wt, np.asarray(blosum62()), 11.0, 2.0, tr=16,
        tb_rows=32,
    )

    # every process writes ITS OWN view of the alignment
    with open(f"{outfile}.p{jax.process_index()}", "w") as fh:
        json.dump({
            "aln_end": aln_end, "qa": qa.tolist(), "ta": ta.tolist(),
            "coords": coords,
        }, fh)
    if jax.process_index() == 0:
        with open(outfile, "w") as fh:
            json.dump({
                "fmax": gathered.tolist(), "span": [lo, hi],
                "wf_end": wf_end,
                "wf_seqs": [wq.tolist(), wt.tolist()],
            }, fh)
    multihost_utils.sync_global_devices("done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
