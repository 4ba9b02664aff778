"""``aligner-calc`` — p-value backfill worker.

Equivalent of aligner-core/src/bin/calc/main.rs: for every task with a
NULL p-value, load its promoted result (query, target, f, del, matrix)
and compute a Karlin-Altschul p-value with (del, del) gap params, then
store it.  The 5,000 shuffled alignments per task run as one batched
device launch.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..alphabet import Protein
from ..backend import ENGINES
from ..observability import log
from ..service.store import Store, open_store
from ..statistics import calculate_p_value


def run_once(store: Store, *, rng=None, backend=None, n_sequences=5000) -> int:
    done = 0
    for task_id in store.get_ids_with_null_p_value():
        row = store.get_result_matrix_by_task_id(task_id)
        if row is None:
            continue  # not promoted yet
        query, target, f_value, del_value, matrix = row
        try:
            # strict=False matches how the dispatcher/worker treated
            # these sequences (unknown characters skipped) — strict
            # encoding would crash the whole backfill on one task the
            # rest of the pipeline accepted, and the same task would
            # starve every later one on every pass
            p = calculate_p_value(
                Protein.encode(query, strict=False),
                Protein.encode(target, strict=False),
                f_value, del_value, del_value, matrix,
                rng=rng or np.random.default_rng(), backend=backend,
                n_sequences=n_sequences,
            )
        except Exception as e:
            log.warning("task %s: p-value failed (%s: %s); skipping",
                        task_id, type(e).__name__, e)
            continue
        store.add_p_value_by_id(p, task_id)
        done += 1
    return done


def main(argv=None):
    ap = argparse.ArgumentParser(prog="aligner-calc", description=__doc__)
    ap.add_argument("--db", default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--backend", default=None, choices=ENGINES)
    ap.add_argument("--sequences", type=int, default=5000)
    args = ap.parse_args(argv)
    store = open_store(args.db)
    n = run_once(
        store, rng=np.random.default_rng(args.seed), backend=args.backend,
        n_sequences=args.sequences,
    )
    print(f"backfilled {n} p-value(s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
