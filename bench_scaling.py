"""Weak-scaling benchmark: sharded scores throughput vs mesh size.

Per-device load is held constant while the mesh grows; efficiency(n) =
throughput(n) / (n * throughput(1)).  With ``--platform cpu`` the mesh is
virtual (8 CPU host devices); otherwise it spans the visible GPUs; the
harness is the same either way (BASELINE.md: ≥85% weak-
scaling efficiency target at 2+ hosts).

Usage: python bench_scaling.py [--per-device 512] [--length 128]
Prints one JSON line per mesh size plus a summary line.
"""

import argparse
import json
import os
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--per-device", type=int, default=512)
    ap.add_argument("--length", type=int, default=128)
    ap.add_argument("--platform", default=None, help="cpu forces virtual devices")
    args = ap.parse_args()

    if args.platform:
        os.environ["JAX_PLATFORMS"] = args.platform
    if os.environ.get("JAX_PLATFORMS") == "cpu":
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
        )

    import jax
    import numpy as np

    from jax.sharding import Mesh

    from aligner_tpu.matrices import blosum62
    from aligner_tpu.parallel import sharded_scores

    n_dev = len(jax.devices())
    sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= n_dev]
    rng = np.random.default_rng(0)
    M = np.asarray(blosum62())
    L = args.length

    results = {}
    for n in sizes:
        # all devices on the data axis — this bench shards problems only
        mesh = Mesh(np.array(jax.devices()[:n]).reshape(n, 1), ("data", "matrix"))
        B = args.per_device * n
        q = rng.integers(0, 24, (B, L)).astype(np.int32)
        t = rng.integers(0, 24, (B, L)).astype(np.int32)
        ql = np.full(B, L, np.int32)
        tl = np.full(B, L, np.int32)
        # warm (compile)
        out = sharded_scores(mesh, q, ql, t, tl, M, 11.0, 2.0)
        np.asarray(out[0])
        reps = 3
        t0 = time.time()
        for _ in range(reps):
            out = sharded_scores(mesh, q, ql, t, tl, M, 11.0, 2.0)
            np.asarray(out[0])
        dt = (time.time() - t0) / reps
        gcups = B * L * L / dt / 1e9
        results[n] = gcups
        print(json.dumps({"mesh": n, "batch": B, "gcups": round(gcups, 3)}))

    base = results[sizes[0]]
    for n in sizes[1:]:
        eff = results[n] / (n * base)
        print(json.dumps({"weak_scaling": n, "efficiency": round(eff, 3)}))


if __name__ == "__main__":
    main()
