"""Mesh integration of the production paths (VERDICT round-1 item 1).

The conftest exposes 8 virtual CPU devices, so the automatic data
sharding in align._fill/_fill_pwm engages for every batched call here.
Each test runs a *real engine entry point* twice — sharded (default)
and with ALIGNER_AUTO_SHARD=0 — and asserts bit-identical results,
matching the reference thread fan-outs these paths replace
(statistics/mod.rs:253-291, engine/calc.rs:45-75, node/main.rs:61-88).
"""

from __future__ import annotations

import numpy as np
import pytest

import aligner_tpu as at
from aligner_tpu.align import batch_align, batch_align_pwm
from aligner_tpu.repeat.engine import (
    SearchOptions,
    calculate_cycle,
    calculate_starting_values,
)
from aligner_tpu.statistics import calculate_p_value

# the GPU kernel ("pallas") runs in Pallas interpret mode on the CPU
pytestmark = pytest.mark.usefixtures("pallas_interpret")


def _unsharded(monkeypatch):
    monkeypatch.setenv("ALIGNER_AUTO_SHARD", "0")


def test_devices_visible():
    import jax

    assert len(jax.devices()) == 8  # the tests below rely on a real mesh


def test_p_value_engine_sharded_equals_single(rng, monkeypatch):
    """statistics.calculate_p_value end-to-end: the 500-shuffle batch is
    sharded over the mesh and the fitted p-value is bit-identical."""
    M = at.blosum62()
    q = rng.integers(0, 24, 60).astype(np.int8)
    t = rng.integers(0, 24, 64).astype(np.int8)
    f = at.align_local(q, t, M, 11.0, 2.0, backend="xla").alignment.f
    p_sharded = calculate_p_value(
        q, t, f, 11.0, 2.0, M, rng=np.random.default_rng(3), backend="xla",
        n_sequences=500,
    )
    _unsharded(monkeypatch)
    p_single = calculate_p_value(
        q, t, f, 11.0, 2.0, M, rng=np.random.default_rng(3), backend="xla",
        n_sequences=500,
    )
    assert p_sharded == p_single


def test_repeat_scan_sharded_equals_single(rng, monkeypatch):
    """The window-scan production path (calculate_starting_values +
    calculate_cycle) over the mesh: scores, stats, and surviving tasks
    are bit-identical to a single-device run."""
    seq = rng.integers(0, 4, 3000).astype(np.int8)
    opts = SearchOptions(
        repeat_length=48, query_offset=16, deletions=6.0, extension=2.0,
        backend="xla",
    )
    pwm = rng.integers(-1, 2, (4, 48)).astype(np.float64)

    mean_s, std_s = calculate_starting_values(
        seq, pwm, opts, np.random.default_rng(11)
    )
    tasks_s = calculate_cycle(seq, pwm, [], mean_s, std_s, opts)

    _unsharded(monkeypatch)
    mean_1, std_1 = calculate_starting_values(
        seq, pwm, opts, np.random.default_rng(11)
    )
    tasks_1 = calculate_cycle(seq, pwm, [], mean_1, std_1, opts)

    assert mean_s == mean_1 and std_s == std_1
    assert len(tasks_s) == len(tasks_1)
    for a, b in zip(tasks_s, tasks_1):
        assert (a.left_coord, a.right_coord) == (b.left_coord, b.right_coord)
        assert a.z == b.z and a.f == b.f
        np.testing.assert_array_equal(
            a.alignment.frequency_matrix(), b.alignment.frequency_matrix()
        )


def test_worker_population_sharded_equals_single(rng, monkeypatch, tmp_path):
    """Worker.process_batch end-to-end over the mesh: the per-matrix
    subtask results written to the store are bit-identical."""
    from aligner_tpu.service.dispatcher import TOPIC_JOBS
    from aligner_tpu.service.models import AlignJob
    from aligner_tpu.service.queue import JobQueue
    from aligner_tpu.service.store import Store
    from aligner_tpu.service.worker import Worker

    def run(db):
        store = Store(str(db))
        queue = JobQueue(str(db))

        class Req:
            kd_value = 0.0
            r_squared_value = 100.0
            del_value = 7.0
            dim_value = 24
            matrices_volume_value = 3

        qs = "".join("ARNDCQEGHILKMFPSTWYV"[c] for c in rng0.integers(0, 20, 40))
        ts = "".join("ARNDCQEGHILKMFPSTWYV"[c] for c in rng0.integers(0, 20, 44))
        store.insert_align_task(Req, "h1", "q", qs, "t", ts)
        freqs = np.full(24, 1.0 / 24)
        for m in range(3):
            job = AlignJob(
                sequence_1=qs, sequence_2=ts,
                matrix=rng1.integers(-1, 2, (24, 24)).astype(np.float64),
                frequences=freqs, kd_value=0.0, r_squared_value=100.0,
                del_value=7.0, matrices_volume_value=3, hash=has_h,
            )
            queue.produce(TOPIC_JOBS, job.to_json())
        w = Worker(store=store, queue=queue, name="w0", backend="xla")
        assert w.process_batch() == 3
        with store._conn() as c:
            rows = c.execute(
                "select f_value, matrix_json from align_subtasks order by id"
            ).fetchall()
        return rows

    has_h = "h1"
    rng0 = np.random.default_rng(0)
    rng1 = np.random.default_rng(1)
    rows_sharded = run(tmp_path / "a.db")
    rng0 = np.random.default_rng(0)
    rng1 = np.random.default_rng(1)
    _unsharded(monkeypatch)
    rows_single = run(tmp_path / "b.db")
    assert rows_sharded == rows_single


@pytest.mark.parametrize("mode", ["local", "global"])
def test_pallas_sharded_fill_matches_unsharded(rng, monkeypatch, mode):
    """The pallas shard branch (interpret mode on CPU): scores and
    direction planes from the sharded fill equal the single-device
    pallas wrapper bit for bit."""
    from aligner_tpu.align import _fill_sharded
    from aligner_tpu.ops.pallas_dp import fill_batch_pallas

    B = 11  # deliberately not divisible by 8 — exercises padding
    qs = [rng.integers(0, 24, int(rng.integers(5, 20))) for _ in range(B)]
    ts = [rng.integers(0, 24, int(rng.integers(5, 20))) for _ in range(B)]
    from aligner_tpu.align import pad_batch

    q, ql = pad_batch(qs)
    t, tl = pad_batch(ts)
    M = np.asarray(at.blosum62())
    import jax.numpy as jnp

    res_s = _fill_sharded(
        q, ql, t, tl, M, 11.0, 2.0, mode, True, "pallas", jnp.float32,
        True, 8,
    )
    res_1 = fill_batch_pallas(
        q, ql, t, tl, M, 11.0, 2.0, mode=mode, with_planes=True,
        dtype=jnp.float32,
    )
    np.testing.assert_array_equal(np.asarray(res_s.fmax), np.asarray(res_1.fmax))
    np.testing.assert_array_equal(np.asarray(res_s.fy), np.asarray(res_1.fy))
    np.testing.assert_array_equal(np.asarray(res_s.fx), np.asarray(res_1.fx))
    np.testing.assert_array_equal(np.asarray(res_s.end), np.asarray(res_1.end))
    np.testing.assert_array_equal(res_s.dirs, res_1.dirs)


def test_pallas_sharded_pwm_matches_unsharded(rng):
    from aligner_tpu.align import _fill_pwm_sharded, pad_batch
    from aligner_tpu.ops.pallas_dp import fill_pwm_batch_pallas

    B = 10
    qs = [rng.integers(0, 4, int(rng.integers(8, 30))) for _ in range(B)]
    q, ql = pad_batch(qs)
    pwm = rng.integers(-1, 2, (4, 12)).astype(np.float64)
    import jax.numpy as jnp

    res_s = _fill_pwm_sharded(q, ql, pwm, 3.0, 1.0, True, "pallas",
                              jnp.float32, 8)
    res_1 = fill_pwm_batch_pallas(
        q, ql, pwm, 3.0, 1.0, with_planes=True, dtype=jnp.float32,
    )
    np.testing.assert_array_equal(np.asarray(res_s.fmax), np.asarray(res_1.fmax))
    np.testing.assert_array_equal(res_s.dirs, res_1.dirs)


def test_batched_matrices_sharded(rng, monkeypatch):
    """Per-problem matrices (the worker population layout) shard over
    data and stay bit-identical — xla engine."""
    B = 6
    qs = [rng.integers(0, 24, 25) for _ in range(B)]
    ts = [rng.integers(0, 24, 25) for _ in range(B)]
    mats = rng.integers(-3, 4, (B, 24, 24)).astype(np.float64)
    r_s = batch_align(qs, ts, mats, 7.0, 3.0, mode="local", backend="xla")
    out_s = [
        batch_align(qs, ts, mats, 7.0, 3.0, mode="local", backend="xla",
                    with_alignments=True)[i].alignment for i in range(B)
    ]
    _unsharded(monkeypatch)
    r_1 = batch_align(qs, ts, mats, 7.0, 3.0, mode="local", backend="xla")
    np.testing.assert_array_equal(np.asarray(r_s.fmax), np.asarray(r_1.fmax))
    out_1 = batch_align(qs, ts, mats, 7.0, 3.0, mode="local", backend="xla",
                        with_alignments=True)
    for a, b in zip(out_s, out_1):
        assert a.f == b.alignment.f
        assert np.array_equal(a.query, b.alignment.query)


def test_pwm_full_mode_sharded_equals_single(rng, monkeypatch):
    """batch_align_pwm with alignments (the survivor pass of the repeat
    search) sharded vs single-device."""
    B = 9
    qs = [rng.integers(0, 4, int(rng.integers(20, 50))) for _ in range(B)]
    pwm = rng.integers(-1, 2, (4, 24)).astype(np.float64)
    out_s = batch_align_pwm(qs, pwm, 6.0, 2.0, backend="xla",
                            with_alignments=True)
    _unsharded(monkeypatch)
    out_1 = batch_align_pwm(qs, pwm, 6.0, 2.0, backend="xla",
                            with_alignments=True)
    for a, b in zip(out_s, out_1):
        assert a.alignment.f == b.alignment.f
        assert a.alignment.coords == b.alignment.coords
        np.testing.assert_array_equal(
            a.alignment.frequency_matrix(), b.alignment.frequency_matrix()
        )


def test_pwm_batched_matrices_sharded(rng, monkeypatch):
    """(B, 4, W) per-problem PWMs shard over data (scores and full mode)."""
    B = 6
    qs = [rng.integers(0, 4, 40) for _ in range(B)]
    pwms = rng.integers(-1, 2, (B, 4, 16)).astype(np.float64)
    r_s = batch_align_pwm(qs, pwms, 5.0, 2.0, backend="xla")
    out_s = batch_align_pwm(qs, pwms, 5.0, 2.0, backend="xla",
                            with_alignments=True)
    _unsharded(monkeypatch)
    r_1 = batch_align_pwm(qs, pwms, 5.0, 2.0, backend="xla")
    out_1 = batch_align_pwm(qs, pwms, 5.0, 2.0, backend="xla",
                            with_alignments=True)
    np.testing.assert_array_equal(np.asarray(r_s.fmax), np.asarray(r_1.fmax))
    for a, b in zip(out_s, out_1):
        assert a.alignment.f == b.alignment.f
        np.testing.assert_array_equal(a.alignment.query, b.alignment.query)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_sharded_step_built_once_per_configuration(rng, backend):
    """Repeated sharded fills of one configuration reuse one jitted
    shard_map program (a fresh one per call recompiled the whole
    per-shard fill, kernel included, on every batch)."""
    from aligner_tpu import align as align_mod

    qs = [rng.integers(0, 24, 20).astype(np.int8) for _ in range(11)]
    ts = [rng.integers(0, 24, 20).astype(np.int8) for _ in range(11)]
    M = np.asarray(at.blosum62())
    first = batch_align(qs, ts, M, 11.0, 2.0, backend=backend)
    size = align_mod._sharded_step.cache_info().currsize
    again = batch_align(qs, ts, M, 11.0, 2.0, backend=backend)
    assert align_mod._sharded_step.cache_info().currsize == size
    np.testing.assert_array_equal(first.fmax, again.fmax)
