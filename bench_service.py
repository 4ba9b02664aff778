"""Service-layer throughput (VERDICT r3 #4): dispatcher + N real worker
processes over the sqlite queue/store — the capacity number for the
Kafka/MariaDB pipeline replacement (handlers.rs:238-250, node/main.rs:49-88).

Two measurements, printed as JSON lines:

* ``service_queue_throughput`` — raw orchestration capacity: jobs/s
  through claim→commit with no compute (N threads on one queue), plus
  insert rate.  This bounds what any worker fleet can drain.
* ``service_e2e_throughput`` — the full pipeline: HTTP POST /validate
  (protein.fasta pair, matrices_volume candidate matrices) → worker
  subprocesses (real ``python -m aligner_tpu.service.worker``
  processes competing on the queue) → atomic promotion; measures jobs/s
  claimed→committed and time-to-promotion.  Workers run the heuristic
  on the CPU xla backend unless ``--backend pallas`` (one worker per
  card by default; several share the card, each with its memory
  fraction, printed as ``worker_mem_fraction``).  The queue number above
  isolates the service machinery.

Usage: python bench_service.py [--workers 1] [--volume 64] [--port 3035]
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request


def bench_queue(n_threads=4, n_jobs=2000, batch=64):
    from aligner_tpu.service.queue import JobQueue

    with tempfile.TemporaryDirectory() as td:
        db = os.path.join(td, "q.db")
        q = JobQueue(db)
        payload = json.dumps({"k": "v" * 200})
        t0 = time.time()
        for i in range(n_jobs):
            q.produce("bench.jobs", payload, group="bench.group")
        t_insert = time.time() - t0
        done = []
        lock = threading.Lock()

        def drain(name):
            qq = JobQueue(db)
            n = 0
            while True:
                items = qq.claim_batch("bench.jobs", name,
                                       group="bench.group", limit=batch)
                if not items:
                    break
                qq.commit([jid for jid, _ in items])
                n += len(items)
            with lock:
                done.append(n)

        t0 = time.time()
        ts = [threading.Thread(target=drain, args=(f"w{i}",))
              for i in range(n_threads)]
        [t.start() for t in ts]
        [t.join() for t in ts]
        dt = time.time() - t0
        assert sum(done) == n_jobs, done
        print(json.dumps({
            "bench": "service_queue_throughput",
            "jobs": n_jobs, "threads": n_threads, "batch": batch,
            "insert_jobs_per_s": round(n_jobs / t_insert, 1),
            "claim_commit_jobs_per_s": round(n_jobs / dt, 1),
            "note": "no-compute drain: the orchestration ceiling of the "
                    "sqlite lease queue (claim->commit, exactly-once)",
        }))


def bench_e2e(n_workers=2, volume=64, port=3035, backend="xla",
              warm_rounds=1, worker_warmup=False):
    import numpy as np

    from aligner_tpu.io import read_fasta_file
    from aligner_tpu.service.dispatcher import Dispatcher, serve
    from aligner_tpu.service.queue import JobQueue
    from aligner_tpu.service.store import Store

    recs = read_fasta_file("examples/protein.fasta")

    def _s(rec):
        s = rec.seq
        return s.decode() if isinstance(s, (bytes, bytearray)) else str(s)

    s0, s1 = _s(recs[0]), _s(recs[1])
    fasta = f">a\n{s0}\n>b\n{s1}\n"
    td = tempfile.mkdtemp(prefix="aligner_bench_svc_")
    db = os.path.join(td, "svc.db")
    store, queue = Store(db), JobQueue(db)
    disp = Dispatcher(store, queue, rng=np.random.default_rng(0))
    server = serve("127.0.0.1", port, dispatcher=disp)
    threading.Thread(target=server.serve_forever, daemon=True).start()

    env = dict(os.environ, ALIGNER_DB=db)
    mem_fraction = None
    if backend != "pallas":
        env.update(JAX_PLATFORMS="cpu")
    elif n_workers > 1:
        # each JAX process reserves most of the card when it first uses
        # it: give every worker its share of one card
        mem_fraction = round(0.75 / n_workers, 3)
        env.update(XLA_PYTHON_CLIENT_MEM_FRACTION=str(mem_fraction))
    workers = [
        subprocess.Popen(
            [sys.executable, "-m", "aligner_tpu.service.worker",
             "--name", f"bench-w{i}", "--batch", "16",
             "--backend", backend, "--poll-interval", "0.1"]
            + (["--warmup"] if worker_warmup else []),
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        )
        for i in range(n_workers)
    ]

    # lease-margin monitor: min(lease_until - now) over claimed jobs.
    # If it never goes negative, no claimed job lease-expired during the
    # round — i.e. nothing bounced/redelivered even through a long cold
    # compile (the heartbeat lease-extension contract, queue.heartbeat)
    import sqlite3

    margin = {"min": None, "stop": False}

    def watch():
        while not margin["stop"]:
            try:
                conn = sqlite3.connect(db, timeout=5.0)
                row = conn.execute(
                    "select min(lease_until) - ? from jobs "
                    "where status = 'claimed'", (time.time(),)
                ).fetchone()
                conn.close()
                if row and row[0] is not None:
                    m = float(row[0])
                    if margin["min"] is None or m < margin["min"]:
                        margin["min"] = m
            except Exception:
                pass
            time.sleep(0.5)

    mon = threading.Thread(target=watch, daemon=True)
    mon.start()
    def run_round(seqs, label):
        req = json.dumps({
            "sequences": seqs, "kdValue": 0.0, "rSquaredValue": 1e5,
            "delValue": 11.0, "dimValue": 24,
            "matricesVolumeValue": volume,
        }).encode()
        t0 = time.time()
        with urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{port}/validate", data=req,
            headers={"Content-Type": "application/json"},
        )) as r:
            resp = json.loads(r.read())
        hashes = resp["hashes"]
        t_submit = time.time() - t0
        n_jobs = volume * len(hashes)
        # poll progress until every task promotes (progress == 100 and
        # result row exists — the updater semantics)
        deadline = time.time() + 1800
        t_done = {}
        snap = None
        while time.time() < deadline and len(t_done) < len(hashes):
            snap = disp.progress_snapshot(hashes)
            for h, pct in snap["progress"].items():
                if pct == 100.0 and h not in t_done:
                    t_done[h] = time.time() - t0
            time.sleep(0.25)
        assert len(t_done) == len(hashes), (t_done, snap)
        total = max(t_done.values())
        print(json.dumps({
            "bench": f"service_e2e_throughput_{label}",
            "workers_processes": n_workers, "backend": backend,
            "worker_mem_fraction": mem_fraction,
            "matrices_volume": volume,
            "pairs": len(hashes), "jobs": n_jobs,
            "submit_s": round(t_submit, 3),
            "time_to_promotion_s": round(total, 2),
            "jobs_per_s_claimed_to_committed": round(n_jobs / total, 2),
            "worker_warmup": worker_warmup,
            "min_lease_margin_s": (
                None if margin["min"] is None else round(margin["min"], 1)
            ),
            "note": "protein.fasta pair (~400aa) heuristic workers "
                    "(compute-bound by design; the queue row above "
                    "isolates orchestration capacity). min_lease_margin"
                    " >= 0 means no claimed job lease-expired (no "
                    "redelivery bounce) during this round",
        }))

    try:
        run_round(fasta, "cold")
        for r in range(warm_rounds):
            # perturb one residue: new task hashes, same compiled shapes
            seq = list(s1)
            seq[r % len(seq)] = "A" if seq[r % len(seq)] != "A" else "G"
            run_round(f">a\n{s0}\n>b\n{''.join(seq)}\n", "warm")
    finally:
        margin["stop"] = True
        for w in workers:
            w.terminate()
        for w in workers:
            try:
                w.wait(timeout=10)
            except subprocess.TimeoutExpired:
                w.kill()
        server.shutdown()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workers", type=int, default=1,
                    help="worker processes; with --backend pallas they "
                         "share one card, each with its memory fraction")
    ap.add_argument("--volume", type=int, default=64)
    ap.add_argument("--port", type=int, default=3035)
    ap.add_argument("--queue-jobs", type=int, default=2000)
    ap.add_argument("--backend", default="xla",
                    help="worker backend; 'pallas' runs workers on the "
                         "GPU, anything else on the CPU")
    ap.add_argument("--skip-queue", action="store_true")
    ap.add_argument("--worker-warmup", action="store_true",
                    help="pass --warmup to the spawned workers "
                         "(precompile before the first lease)")
    args = ap.parse_args()
    if not args.skip_queue:
        bench_queue(n_jobs=args.queue_jobs)
    bench_e2e(n_workers=args.workers, volume=args.volume, port=args.port,
              backend=args.backend, worker_warmup=args.worker_warmup)


if __name__ == "__main__":
    main()
