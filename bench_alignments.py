"""End-to-end alignment throughput (alignments/sec), BASELINE metric #2.

Two workloads on protein.fasta-sized problems (~400aa pairs):

* ``scores``      — one query vs N targets, scores only (database sweep);
* ``alignments``  — full results including traceback (on-device
  walk by default; 2-bit step streams transfer, not planes);
* ``huge``        — ONE chromosome-scale global pair through
  ``align_global``'s auto route: the exact int32 row-scan pipeline over
  the local devices (``sharded_global_align``), checkpoint-and-replay
  traceback with the single-dispatch on-device backward walk.

Prints one JSON line per workload.
"""

import argparse
import json
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--length", type=int, default=400)
    ap.add_argument("--backend", default=None)
    ap.add_argument("--huge", type=int, nargs=2, default=(0, 0),
                    metavar=("QLEN", "TLEN"),
                    help="chromosome-scale pair shape, e.g. 16384 32768 "
                         "(opt-in: adds a compile plus warm + 3 timed "
                         "checkpoint-and-replay alignments)")
    args = ap.parse_args()

    import aligner_tpu as at

    rng = np.random.default_rng(0)
    L = args.length
    B = args.batch
    M = at.blosum62()
    if B:  # --batch 0 skips the batch stages (huge-pair-only runs)
        qs = [rng.integers(0, 24, L).astype(np.int8) for _ in range(B)]
        ts = [rng.integers(0, 24, L).astype(np.int8) for _ in range(B)]

        # scores-only
        at.batch_align(qs, ts, M, 11.0, 2.0, backend=args.backend)  # warm
        t0 = time.time()
        reps = 3
        for _ in range(reps):
            at.batch_align(qs, ts, M, 11.0, 2.0, backend=args.backend)
        dt = (time.time() - t0) / reps
        print(json.dumps({
            "metric": "batch scores-only alignments/sec (400aa pairs)",
            "value": round(B / dt, 1), "unit": "alignments/s",
            "gcups": round(B * L * L / dt / 1e9, 1),
        }))

        # full alignments (device fill + on-device walk)
        Bf = min(B, 512)
        at.batch_align(qs[:Bf], ts[:Bf], M, 11.0, 2.0, backend=args.backend,
                       with_alignments=True)  # warm
        t0 = time.time()
        res = at.batch_align(qs[:Bf], ts[:Bf], M, 11.0, 2.0,
                             backend=args.backend, with_alignments=True)
        dt = time.time() - t0
        assert len(res) == Bf and res[0].alignment.f >= 0
        print(json.dumps({
            "metric": "full alignments/sec incl. traceback (400aa pairs)",
            "value": round(Bf / dt, 1), "unit": "alignments/s",
        }))

    # one huge exact pair (checkpoint-and-replay + on-device walk)
    C, R = args.huge
    if C and R:
        import jax

        hq = rng.integers(0, 24, C).astype(np.int8)
        ht = rng.integers(0, 24, R).astype(np.int8)
        at.align_global(hq, ht, M, 11.0, 2.0)  # warm
        times = []
        for _ in range(3):
            t0 = time.time()
            res = at.align_global(hq, ht, M, 11.0, 2.0)
            times.append(time.time() - t0)
        dt = min(times)
        print(json.dumps({
            "metric": f"huge-pair exact alignment wall time ({C}x{R}, "
                      f"{len(jax.local_devices())}-device mesh)",
            "value": round(dt, 3), "unit": "s",
            "gcells": round(C * R / 1e9, 2),
            "gcups_effective": round(C * R / 1e9 / dt, 1),
            "alignment_len": len(res.alignment.query),
        }))


if __name__ == "__main__":
    main()
