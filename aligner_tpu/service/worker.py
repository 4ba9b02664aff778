"""Worker node (aligner-web/src/bin/node/main.rs).

Consumes alignment jobs and writes subtask results to the store.  The
reference's node deserializes one Kafka message at a time and runs one
heuristic local alignment per message (node/main.rs:49-88, calling the
heuristic with del for both gap params — the AlignJob carries a single
``del_value``).  This worker claims a *batch* of jobs and groups them by
task hash, so each task's whole candidate-matrix population advances as
one batched device launch per heuristic iteration
(heuristic_align_population) — the batched replacement for one-process-per-
message.

Failure semantics kept: at-least-once (lease redelivery instead of Kafka
auto-commit), commit before the store write is *not* replicated — the
reference commits the Kafka offset before inserting into the DB
(node/main.rs:76-88), which can lose results on a crash; here jobs are
committed only after their subtasks are stored, with one retry on store
failure (matching the node's single reconnect-retry).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import defaultdict

import numpy as np

log = logging.getLogger("aligner_tpu.worker")

from ..alphabet import Protein
from ..backend import ENGINES
from ..heuristic import Heuristics, heuristic_align_population
from .dispatcher import GROUP, TOPIC_JOBS
from .models import AlignJob
from .queue import HEALTH_WINDOW, JobQueue, open_queue
from .store import Store, open_store


class _LeaseKeeper:
    """Background heartbeat while a claimed batch is being processed.

    A cold worker's first kernel compiles can take minutes — far past
    the job lease — so without this the first batch lease-expires mid-compile
    and gets redelivered to every other cold worker in turn.  Each
    heartbeat refreshes the consumer registry AND extends the leases of
    THIS batch's jobs (queue.heartbeat with the claimed ids — scoped so
    jobs deliberately left claimed for redelivery still expire), the
    liveness contract Kafka's max.poll.interval gave the reference for
    free (node/main.rs:32-44).
    """

    def __init__(self, queue, name: str, group: str,
                 job_ids: list[int] | None = None,
                 interval: float = HEALTH_WINDOW / 3.0):
        self._queue = queue
        self._name = name
        self._group = group
        self._job_ids = list(job_ids or [])
        self._interval = interval
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.wait(self._interval):
            try:
                self._queue.heartbeat(self._name, self._group,
                                      job_ids=self._job_ids)
            except Exception:
                pass  # a flaky state endpoint must not kill processing

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=self._interval + 5.0)


class Worker:
    def __init__(
        self,
        store: Store | None = None,
        queue: JobQueue | None = None,
        name: str | None = None,
        batch: int = 64,
        backend: str | None = None,
    ):
        # ALIGNER_DB may be an http:// URL: then this worker talks to the
        # host-0 state endpoint and joining is just "start the process on
        # another machine" (the reference's add-a-Kafka-consumer property)
        self.store = store or open_store()
        self.queue = queue or open_queue()
        self.name = self.queue.register_consumer(GROUP, name)
        self.batch = batch
        self.backend = backend

    def warmup(self) -> int:
        """Precompile the kernel set for the next claimable batch WITHOUT
        taking a lease: peek at the real pending payloads, rebuild the
        exact shapes :func:`heuristic_align_population` will launch, and
        run one all-skip launch per task group (zero-length problems —
        free compute, full compile).  Returns task groups warmed.  The
        first *leased* batch then starts hot instead of spending its
        lease inside the compiler."""
        from ..heuristic import warmup_population

        by_task: dict[str, list[AlignJob]] = defaultdict(list)
        for payload in self.queue.peek(TOPIC_JOBS, GROUP, limit=self.batch):
            try:
                job = AlignJob.from_json(payload)
            except Exception:
                continue  # poison handling belongs to process_batch
            by_task[job.hash].append(job)
        for jobs in by_task.values():
            ref = jobs[0]
            warmup_population(
                Protein.encode(ref.sequence_1, strict=False),
                Protein.encode(ref.sequence_2, strict=False),
                len(jobs), ref.del_value, ref.del_value,
                backend=self.backend,
            )
        if by_task:
            log.info("warmup: precompiled %d task group(s)", len(by_task))
        return len(by_task)

    def process_batch(self) -> int:
        """Claim and process up to ``batch`` jobs; returns jobs handled."""
        self.queue.heartbeat(self.name, GROUP)
        claimed = self.queue.claim_batch(
            TOPIC_JOBS, self.name, GROUP, limit=self.batch
        )
        if not claimed:
            return 0
        ids = [job_id for job_id, _ in claimed]
        with _LeaseKeeper(self.queue, self.name, GROUP, job_ids=ids):
            return self._process_claimed(claimed)

    def _process_claimed(self, claimed: list[tuple[int, str]]) -> int:
        by_task: dict[str, list[tuple[int, AlignJob]]] = defaultdict(list)
        poison: list[int] = []
        for job_id, payload in claimed:
            try:
                job = AlignJob.from_json(payload)
            except Exception:
                # a malformed payload would otherwise be redelivered
                # forever (the reference node just panics, node/main.rs:61)
                log.warning("dropping undecodable job %s", job_id)
                poison.append(job_id)
                continue
            by_task[job.hash].append((job_id, job))
        self.queue.commit(poison)

        from ..errors import AlignerError

        for hash_, items in by_task.items():
            jobs = [j for _, j in items]
            ref = jobs[0]
            try:
                # batch prep sits INSIDE the try: a decodable job with a
                # missing/ragged matrix raises from np.stack and must be
                # poison-handled, not crash-loop the whole fleet
                mats = np.stack([j.matrix for j in jobs])
                heur = Heuristics(
                    kd=ref.kd_value, r_squared=ref.r_squared_value,
                    frequencies=ref.frequences,
                )
                results = heuristic_align_population(
                    Protein.encode(ref.sequence_1, strict=False),
                    Protein.encode(ref.sequence_2, strict=False),
                    mats, ref.del_value, ref.del_value, heur,
                    backend=self.backend,
                )
            except (AlignerError, ValueError, TypeError) as e:
                # deterministic per-task failures (a dim/frequency
                # combination the heuristic math rejects, a malformed
                # matrix payload) can never succeed on redelivery —
                # commit the jobs away like poison instead of bouncing
                # them between lease expiries forever
                log.warning(
                    "task %s: heuristic population failed (%s: %s); "
                    "dropping its %d jobs", hash_, type(e).__name__, e,
                    len(items),
                )
                self.queue.commit([job_id for job_id, _ in items])
                continue
            except Exception as e:
                # anything else (device/infra error) is presumed
                # transient: leave the jobs claimed so lease expiry
                # redelivers them (at-least-once), keep the worker alive
                # for the remaining task groups
                log.warning(
                    "task %s: transient failure (%s: %s); leaving its "
                    "%d jobs for lease-expiry redelivery", hash_,
                    type(e).__name__, e, len(items),
                )
                continue
            done_ids = []
            for (job_id, _), res in zip(items, results):
                if res is None:
                    # this candidate matrix admits no alignment (see
                    # heuristic_align_population); retrying can never
                    # succeed, so commit the job away instead of
                    # redelivering it forever (the reference node would
                    # panic and lose the message the same way)
                    log.warning(
                        "job %s: matrix admits no alignment; dropping",
                        job_id,
                    )
                    done_ids.append(job_id)
                    continue
                qa, ta = res.alignment.render()
                # source_key = queue job id: a lease-expiry redelivery of
                # this job (crash between store and commit) re-inserts
                # idempotently instead of duplicating the subtask
                try:
                    self.store.insert_align_subtask(
                        hash_, res.alignment.f, res.matrix, qa, ta,
                        source_key=str(job_id),
                    )
                except Exception:
                    # one retry on a fresh connection (node/main.rs:78-88)
                    time.sleep(0.05)
                    try:
                        self.store.insert_align_subtask(
                            hash_, res.alignment.f, res.matrix, qa, ta,
                            source_key=str(job_id),
                        )
                    except Exception:
                        continue  # job stays claimed → redelivered on lease expiry
                done_ids.append(job_id)
            self.queue.commit(done_ids)
        return len(claimed)

    def run_forever(self, poll_interval: float = 0.5,
                    max_batches: int | None = None, warmup: bool = False):
        n = 0
        try:
            if warmup:
                try:
                    self.warmup()
                except Exception:
                    log.warning("warmup failed; continuing cold", exc_info=True)
            while max_batches is None or n < max_batches:
                handled = self.process_batch()
                if handled == 0:
                    time.sleep(poll_interval)
                n += 1
        finally:
            # clean shutdown (bounded run, SIGINT): drop our consumer
            # row so /health/check doesn't report a dead node for an
            # hour after every routine restart.  A crash skips this and
            # stays visible — that's the intended crash signal.
            try:
                self.queue.deregister_consumer(self.name)
            except Exception:
                pass  # shutdown must not fail on a dead state endpoint


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(prog="aligner-node", description=__doc__)
    ap.add_argument("--name", default=None)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--backend", default=None, choices=ENGINES)
    ap.add_argument("--poll-interval", type=float, default=0.5)
    ap.add_argument("--max-batches", type=int, default=None,
                    help="exit after N poll cycles (tests/bounded runs)")
    ap.add_argument("--warmup", action="store_true",
                    help="precompile the kernel set against pending job "
                         "shapes before claiming any lease (cold-start fix)")
    args = ap.parse_args(argv)
    Worker(name=args.name, batch=args.batch, backend=args.backend).run_forever(
        poll_interval=args.poll_interval, max_batches=args.max_batches,
        warmup=args.warmup,
    )
    return 0


if __name__ == "__main__":
    main()
