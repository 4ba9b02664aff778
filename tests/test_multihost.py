"""Multi-host (multi-process) tests (VERDICT round-1 item 2).

Two layers, both executed with real OS processes:

* a 2-process ``jax.distributed`` run covering initialize_from_env /
  global_mesh / process_span / shard_local_batch / sharded_scores, whose
  gathered scores must equal a single-process fill bit for bit;
* the actual ``deploy/launch_pod.sh`` script run as a 2-"host" service
  (host 0: state endpoint + dispatcher + worker; host 1: worker over
  HTTP), driven end-to-end through the dispatcher API.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _clean_env() -> dict:
    env = dict(os.environ)
    # the test process's own JAX/XLA settings must not leak into children
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    # Child scripts are run by path (sys.path gets tests/, not the repo
    # root), so make the package importable even when not pip-installed.
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_two_process_jax_distributed(tmp_path):
    """Spawn 2 JAX processes; the sharded score batch built from
    per-process local slices must match a single-process computation."""
    port = _free_port()
    outfile = tmp_path / "scores.json"
    procs = []
    for pid in range(2):
        env = _clean_env()
        env.update(
            ALIGNER_COORDINATOR=f"127.0.0.1:{port}",
            ALIGNER_NUM_PROCESSES="2",
            ALIGNER_PROCESS_ID=str(pid),
        )
        procs.append(
            subprocess.Popen(
                [sys.executable, os.path.join(REPO, "tests", "multihost_proc.py"),
                 str(outfile)],
                env=env, cwd=REPO,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
        )
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("jax.distributed processes timed out")
        outs.append(out)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    data = json.loads(outfile.read_text())
    assert data["span"] == [0, 8]  # process 0's half of the batch

    # single-process reference (same seed/shapes as multihost_proc.py)
    import jax.numpy as jnp

    from aligner_tpu.matrices import blosum62
    from aligner_tpu.ops.scan_engine import fill_batch

    rng = np.random.default_rng(7)
    B, L = 16, 24
    q = rng.integers(0, 24, (B, L)).astype(np.int32)
    t = rng.integers(0, 24, (B, L)).astype(np.int32)
    ql = np.full(B, L, np.int32)
    tl = np.full(B, L, np.int32)
    ref = fill_batch(
        q, ql, t, tl, jnp.asarray(np.asarray(blosum62()), jnp.float32),
        11.0, 2.0, mode="local", with_planes=False, dtype=jnp.float32,
    )
    np.testing.assert_array_equal(
        np.asarray(data["fmax"], np.float32), np.asarray(ref.fmax)
    )

    # the cross-process wavefront end score (ppermute halos over the
    # process boundary) must equal the single-process oracle
    from aligner_tpu import host

    wq = np.asarray(data["wf_seqs"][0], np.int8)
    wt = np.asarray(data["wf_seqs"][1], np.int8)
    ref_wf = host.align_global(wq, wt, np.asarray(blosum62()), 11.0, 2.0)
    assert data["wf_end"] == ref_wf.score[len(wt), len(wq)]

    # cross-process FULL alignment (round-5: the trace records are
    # all-gathered in-pipeline): both processes must produce the same
    # strings bit for bit, equal to the oracle's traceback
    p0 = json.loads((tmp_path / "scores.json.p0").read_text())
    p1 = json.loads((tmp_path / "scores.json.p1").read_text())
    assert p0 == p1  # bit-equal across processes (strings, end, coords)
    assert p0["aln_end"] == ref_wf.score[len(wt), len(wq)]
    np.testing.assert_array_equal(
        np.asarray(p0["qa"], np.int16),
        np.asarray(ref_wf.query_aligned, np.int16),
    )
    np.testing.assert_array_equal(
        np.asarray(p0["ta"], np.int16),
        np.asarray(ref_wf.target_aligned, np.int16),
    )


REQ = {
    "sequences": ">q\nHEAGAWGHEEHEAGAWGHEE\n>t\nPAWHEAEPAWHEAEHEAGAW\n",
    "kdValue": 0.0,
    "rSquaredValue": 100.0,
    "delValue": 7.0,
    "dimValue": 24,
    "matricesVolumeValue": 2,
}


def test_launch_pod_script_two_hosts(tmp_path):
    """Execute deploy/launch_pod.sh for host 0 and host 1 locally and
    drive a task through the dispatcher: host 1's worker reaches the
    state only over HTTP, and together they complete the job."""
    state_port = _free_port()
    http_port = _free_port()
    db = tmp_path / "aligner.db"
    env = _clean_env()
    env.update(
        ALIGNER_DB=str(db),
        ALIGNER_STATE_PORT=str(state_port),
        ALIGNER_HTTP_PORT=str(http_port),
        # generous bound: max_batches counts idle poll cycles too, and
        # under full-suite load startup alone can eat tens of seconds
        ALIGNER_WORKER_ARGS="--backend xla --poll-interval 0.2 --max-batches 3000",
        ALIGNER_LOG="info",
        # multi-host launches fail closed without a shared token; this
        # also exercises the authenticated state-RPC path end to end
        ALIGNER_STATE_TOKEN="test-pod-secret",
    )
    env_h1 = dict(env)
    del env_h1["ALIGNER_DB"]  # host 1 must derive the HTTP endpoint itself
    script = os.path.join(REPO, "deploy", "launch_pod.sh")
    # own sessions so the whole per-host tree (state server + dispatcher
    # + worker) can be stopped via its process group
    h0 = subprocess.Popen(
        ["bash", script, "2", "0", "127.0.0.1"], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True,
    )
    h1 = subprocess.Popen(
        ["bash", script, "2", "1", "127.0.0.1"], env=env_h1, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True,
    )
    try:
        # wait for the dispatcher API
        deadline = time.time() + 300
        while True:
            try:
                with urllib.request.urlopen(
                    f"http://127.0.0.1:{http_port}/health/check", timeout=2
                ) as r:
                    json.loads(r.read())
                break
            except Exception:
                if time.time() > deadline:
                    h0.kill()
                    h1.kill()
                    out0 = h0.communicate()[0]
                    pytest.fail(f"dispatcher never came up; host0 log:\n{out0}")
                time.sleep(0.5)

        # both workers must register as consumers (host 1 via HTTP state)
        deadline = time.time() + 300
        while True:
            with urllib.request.urlopen(
                f"http://127.0.0.1:{http_port}/health/check", timeout=5
            ) as r:
                nodes = {n["consumerName"] for n in json.loads(r.read())["nodes"]}
            if {"node-host0", "node-host1"} <= nodes:
                break
            if time.time() > deadline:
                h0.kill()
                h1.kill()
                pytest.fail(f"workers never registered, saw {nodes}")
            time.sleep(0.5)

        req = urllib.request.Request(
            f"http://127.0.0.1:{http_port}/validate",
            data=json.dumps(REQ).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=30) as r:
            hashes = json.loads(r.read())["hashes"]
        assert len(hashes) == 1

        # stream progress (this is also what triggers the 100% promotion,
        # handlers.rs:165-172) until the result matrix lands in the store
        import sqlite3

        deadline = time.time() + 300
        promoted = False
        while not promoted and time.time() < deadline:
            with urllib.request.urlopen(
                f"http://127.0.0.1:{http_port}/progress?hashes={hashes[0]}",
                timeout=60,
            ) as r:
                line = r.readline().decode().strip()
                assert line.startswith("data:")
                msg = json.loads(line[5:])
                assert hashes[0] in msg["progress"]
            with sqlite3.connect(db) as conn:
                row = conn.execute(
                    """select count(1) from result_matrices rm
                       inner join align_tasks at2 on rm.task_id = at2.id
                       where at2.hash = ?""",
                    (hashes[0],),
                ).fetchone()
            promoted = row[0] == 1
            if not promoted:
                time.sleep(0.5)
        assert promoted, "promotion never landed in result_matrices"
    finally:
        import signal

        for h in (h0, h1):
            try:
                os.killpg(h.pid, signal.SIGTERM)
            except ProcessLookupError:
                pass
        try:
            h0.communicate(timeout=20)
            h1.communicate(timeout=20)
        except subprocess.TimeoutExpired:
            for h in (h0, h1):
                try:
                    os.killpg(h.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
