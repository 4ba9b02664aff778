"""Latent-repeat-search engine and CLI tests."""

import json
import os

import numpy as np
import pytest

from aligner_tpu.repeat.engine import (
    SearchOptions,
    Task,
    calculate_cycle,
    calculate_starting_values,
    filter_tasks,
    generate_descendants,
    mutate,
    perform_calculation_per_sequence,
    run_testing_cmd,
    windows_of,
)

# the GPU kernel ("pallas") runs in Pallas interpret mode on the CPU
pytestmark = pytest.mark.usefixtures("pallas_interpret")


def _task(z, left, right):
    return Task(alignment=None, left_coord=left, right_coord=right, z=z, f=0.0)


def test_filter_reference_golden():
    """Port of the reference's filter_test (engine/test.rs:5-64)."""
    tasks = [
        _task(12.240966, 300, 630),
        _task(12.378159, 360, 690),
        _task(11.762683, 1080, 1410),
        _task(10.471823, 1740, 2070),
        _task(11.392030, 1860, 2190),
    ]
    out = filter_tasks(tasks)
    got = [(t.z, t.left_coord, t.right_coord) for t in out]
    assert got == [
        (12.378159, 360, 690),
        (11.762683, 1080, 1410),
        (11.392030, 1860, 2190),
    ]


def test_filter_edge_cases():
    assert filter_tasks([]) == []
    one = [_task(1.0, 0, 10)]
    assert filter_tasks(one) == one
    # all overlapping: max-z wins, last task re-checked but deduped by
    # left_coord only when equal
    out = filter_tasks([_task(1.0, 0, 100), _task(5.0, 10, 110), _task(2.0, 20, 120)])
    zs = sorted(t.z for t in out)
    assert 5.0 in zs


def test_windows_enumeration():
    opts = SearchOptions(repeat_length=30, query_offset=10, threads=1)
    wins = windows_of(100, opts, 10)
    assert wins[0] == (0, 40)
    assert wins[1] == (10, 50)
    # clipping: j + 30 + 10 >= 100 → border = 100
    assert all(b == 100 for (j, b) in wins if j + 40 >= 100)
    # multi-thread window set: same set, thread-major order
    opts3 = SearchOptions(repeat_length=30, query_offset=10, threads=3)
    wins3 = windows_of(100, opts3, 10)
    assert sorted(wins3) == sorted(wins)


def test_mutate_and_descendants(rng):
    seq = np.zeros(20, dtype=np.int8)
    m = mutate(seq, 4, 1, rng)
    changed = np.flatnonzero(m != 0)
    assert set(changed).issubset({1, 5, 9, 13, 17})
    ds = generate_descendants(seq, 10, 4, rng)
    assert len(ds) == 10
    assert all(len(d) == 20 for d in ds)


def test_testing_mode_finds_planted_repeats(rng):
    opts = SearchOptions(
        repeat_length=24, query_offset=8, deletions=5.0, extension=2.0,
        rsquared=100.0, kd=0.0, backend="xla",
    )
    res = run_testing_cmd(opts, rng, sequence_length=3000, descendants_amount=6)
    assert "test" in res
    tasks, matrix = res["test"].tasks, res["test"].matrix
    assert matrix.shape == (4, 24)
    # planted mutated repeats should produce some high-z windows
    assert len(tasks) >= 1


def test_perform_calculation_per_sequence(rng):
    # synthetic chromosome with an embedded repeat family and an N-run
    motif = rng.integers(0, 4, 40)
    chrom = []
    for _ in range(6):
        chrom.append(rng.integers(0, 4, 120))
        chrom.append(motif)
    raw = "".join("ATCG"[c] for arr in chrom for c in arr)
    raw = raw[:200] + "NNNNN" + raw[200:]  # invalid run → Index records
    opts = SearchOptions(
        repeat_length=32, query_offset=12, deletions=6.0, extension=2.0,
        repeats=2, reverse=True, backend="xla",
    )
    res = perform_calculation_per_sequence(opts, raw.encode(), "chr", rng)
    assert "direct" in res and "inverse" in res
    for t in res["direct"].tasks:
        assert 0 <= t.left_coord < t.right_coord <= len(raw)


def test_cli_exploring(tmp_path, rng):
    from aligner_tpu.cli.repeat_search import main

    motif = "".join("ATCG"[c] for c in rng.integers(0, 4, 30))
    seq = "".join(
        "".join("ATCG"[c] for c in rng.integers(0, 4, 80)) + motif for _ in range(5)
    )
    fasta = tmp_path / "in.fasta"
    fasta.write_text(">chrT\n" + seq + "\n")
    out = tmp_path / "res.csv"
    rc = main([
        "-i", str(fasta), "-o", str(out), "-r", "24", "-q", "8",
        "-d", "6", "-e", "2", "--repeats", "2", "--seed", "0",
        "--backend", "xla",
    ])
    assert rc == 0
    assert out.exists()
    mats = json.loads((tmp_path / "res.csv.matrices.json").read_text())
    for v in mats.values():
        assert v["v"] == 1 and v["dim"] == [4, 24]
        assert len(v["data"]) == 4 * 24


def test_cli_align(tmp_path, capsys):
    from aligner_tpu.cli.align import main

    # default output = the reference's exact debug format (main.rs:53):
    # the local book example's match string is _AW_HE_EE (including the
    # aligner-core traceback's seeded-pair duplication, SURVEY §2.3.6)
    rc = main(["-i", "examples/book_example_1.fasta", "--backend", "oracle"])
    assert rc == 0
    out = capsys.readouterr().out
    assert out.strip() == "[Blank, A, W, Blank, H, E, Blank, E, E]"

    rc = main(["-i", "examples/book_example_1.fasta", "--backend", "oracle",
               "--pretty"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "query :" in out and "score :" in out

    rc = main([
        "-i", "examples/book_example_1.fasta", "-g",
        "--backend", "oracle", "-o", str(tmp_path / "res.txt"),
    ])
    assert rc == 0
    assert (tmp_path / "res.txt").exists()


def test_cli_search(tmp_path, capsys, rng):
    from aligner_tpu.cli.search import main

    qf = tmp_path / "q.fasta"
    dbf = tmp_path / "db.fasta"
    qf.write_text(">q\nHEAGAWGHEE\n")
    letters = "ARNDCQEGHILKMFPSTWYV"
    recs = [
        f">d{i}\n" + "".join(letters[c] for c in rng.integers(0, 20, 30))
        for i in range(10)
    ]
    recs.append(">planted\nHEAGAWGHEE")
    dbf.write_text("\n".join(recs) + "\n")
    rc = main(["-q", str(qf), "-i", str(dbf), "-k", "3", "--backend", "xla"])
    assert rc == 0
    out = capsys.readouterr().out
    assert out.splitlines()[0].split("\t")[1] == "planted"


def test_cli_align_blosum50_and_dna(tmp_path, capsys):
    from aligner_tpu.cli.align import main

    rc = main(["-i", "examples/book_example_1.fasta", "-m", "blosum50",
               "-d", "8", "-e", "8", "--backend", "oracle", "--pretty"])
    assert rc == 0
    assert "score :" in capsys.readouterr().out


def test_checkpoint_resume(tmp_path, rng):
    from aligner_tpu.repeat.engine import (
        TaskResult,
        _load_checkpoint,
        _save_checkpoint,
        perform_calculation_per_sequence,
    )

    motif = "".join("ATCG"[c] for c in rng.integers(0, 4, 40))
    raw = "".join(
        "".join("ATCG"[c] for c in rng.integers(0, 4, 100)) + motif
        for _ in range(6)
    ).encode()
    ckpt = str(tmp_path / "state.json")
    opts = SearchOptions(
        repeat_length=32, query_offset=12, deletions=6.0, extension=2.0,
        repeats=3, backend="xla",
    )
    res1 = perform_calculation_per_sequence(opts, raw, "chr", rng,
                                            checkpoint=ckpt)
    # the run completed → the checkpoint carries the final results and
    # loads back as a dict of TaskResult
    state = _load_checkpoint(ckpt, "chr")
    assert isinstance(state, dict) and "direct" in state
    # resume skips the whole record and replays the stored results
    res2 = perform_calculation_per_sequence(opts, raw, "chr",
                                            np.random.default_rng(999),
                                            checkpoint=ckpt)
    assert [(t.left_coord, t.right_coord, t.z) for t in res2["direct"].tasks] \
        == [(t.left_coord, t.right_coord, t.z) for t in res1["direct"].tasks]
    np.testing.assert_array_equal(res2["direct"].matrix, res1["direct"].matrix)
    # mismatched head → fresh run path (checkpoint ignored)
    assert _load_checkpoint(ckpt, "other") is None

    # mid-run resume: rewrite the checkpoint as cycle-1 in-flight state
    # and check it resumes from cycle 1 (not from scratch) and finishes
    mid = _load_checkpoint(ckpt, "chr")["direct"]
    _save_checkpoint(ckpt, "chr", 1, 10.0, 2.0, mid.matrix, mid.tasks)
    cycle, mean, std, matrix, tasks = _load_checkpoint(ckpt, "chr")
    assert cycle == 1 and mean == 10.0 and matrix.shape == (4, 32)
    res3 = perform_calculation_per_sequence(opts, raw, "chr",
                                            np.random.default_rng(7),
                                            checkpoint=ckpt)
    assert "direct" in res3
    assert isinstance(_load_checkpoint(ckpt, "chr"), dict)


def test_exploring_per_record_checkpoints(tmp_path, rng):
    """Multi-record FASTA resume: each record gets its own checkpoint
    file, and finished records are not redone (ADVICE.md round-1 item)."""
    from aligner_tpu.repeat.engine import (
        _record_checkpoint_path,
        run_exploring_cmd,
    )

    def rand_dna(n, r):
        return "".join("ATCG"[c] for c in r.integers(0, 4, n))

    fa = tmp_path / "two.fasta"
    fa.write_text(
        f">recA\n{rand_dna(400, rng)}\n>recB\n{rand_dna(400, rng)}\n"
    )
    base = str(tmp_path / "state.json")
    opts = SearchOptions(
        repeat_length=24, query_offset=10, deletions=6.0, extension=2.0,
        repeats=2, backend="xla",
    )
    res1 = run_exploring_cmd(opts, fa, np.random.default_rng(5),
                             checkpoint=base)
    pa = _record_checkpoint_path(base, "recA")
    pb = _record_checkpoint_path(base, "recB")
    assert pa != pb and os.path.exists(pa) and os.path.exists(pb)
    # rerun: both records replay from their own completed checkpoints
    res2 = run_exploring_cmd(opts, fa, np.random.default_rng(999),
                             checkpoint=base)
    for key in res1:
        assert [(t.left_coord, t.z) for t in res2[key].tasks] == [
            (t.left_coord, t.z) for t in res1[key].tasks
        ]


def test_filter_tasks_tie_break_last_max():
    """Equal-z overlapping tasks: Rust Iterator::max_by returns the
    *last* maximum (engine/mod.rs:93-99), so the survivor must be the
    latest-sorted task of the batch."""
    from aligner_tpu.repeat.engine import Task, filter_tasks

    mk = lambda left, right, z: Task(  # noqa: E731
        alignment=None, left_coord=left, right_coord=right, z=z, f=z
    )
    # three mutually overlapping tasks with identical z
    tasks = [mk(0, 100, 5.0), mk(10, 110, 5.0), mk(20, 120, 5.0)]
    out = filter_tasks(tasks)
    assert len(out) == 1
    assert out[0].left_coord == 20  # last maximum, not first
    # tie on a later batch too, after a disjoint leading task
    tasks = [mk(0, 10, 1.0), mk(50, 150, 2.0), mk(60, 160, 2.0)]
    out = filter_tasks(tasks)
    assert [t.left_coord for t in out] == [0, 60]


def test_csv_mode_checkpoint_resume(tmp_path, rng):
    """csv (masked) mode resumes per record exactly like exploring mode
    (VERDICT r2 weak #7: cmd/csv.rs runs the same per-sequence engine)."""
    from aligner_tpu.repeat.engine import (
        _load_checkpoint,
        _record_checkpoint_path,
        run_csv_cmd,
    )

    def rand_dna(n, r):
        return "".join("ATCG"[c] for c in r.integers(0, 4, n))

    fa = tmp_path / "one.fasta"
    fa.write_text(f">recC\n{rand_dna(400, rng)}\n")
    csv = tmp_path / "known.csv"
    csv.write_text(
        "name,z_value,left_coord,right_coord\nrecC,3.0,10,40\n"
    )
    base = str(tmp_path / "state.json")
    opts = SearchOptions(
        repeat_length=24, query_offset=10, deletions=6.0, extension=2.0,
        repeats=2, backend="xla",
    )
    res1 = run_csv_cmd(opts, fa, csv, np.random.default_rng(5),
                       checkpoint=base)
    pc = _record_checkpoint_path(base, "recC")
    assert os.path.exists(pc)
    assert isinstance(_load_checkpoint(pc, "recC"), dict)  # completed
    # rerun with a different rng: the completed checkpoint replays, so
    # results are identical (nothing recomputed)
    res2 = run_csv_cmd(opts, fa, csv, np.random.default_rng(999),
                       checkpoint=base)
    for key in res1:
        assert [(t.left_coord, t.z) for t in res2[key].tasks] == [
            (t.left_coord, t.z) for t in res1[key].tasks
        ]


def test_checkpoint_rejects_different_input(tmp_path, rng):
    """A checkpoint written for one scan input must not resume a scan of
    a different one: csv mode masks the sequence before scanning, so
    exploring-mode state under the same path/head would otherwise replay
    unmasked results silently (review r3 #4)."""
    from aligner_tpu.repeat.engine import (
        _input_fingerprint,
        _load_checkpoint,
        perform_calculation_per_sequence,
    )

    motif = "".join("ATCG"[c] for c in rng.integers(0, 4, 40))
    raw = "".join(
        "".join("ATCG"[c] for c in rng.integers(0, 4, 100)) + motif
        for _ in range(6)
    ).encode()
    masked = b"N" * 120 + raw[120:]
    opts = SearchOptions(
        repeat_length=32, query_offset=12, deletions=6.0, extension=2.0,
        repeats=2, backend="xla",
    )
    assert _input_fingerprint(raw, opts) != _input_fingerprint(masked, opts)
    assert _input_fingerprint(raw, opts) != _input_fingerprint(
        raw, SearchOptions(repeat_length=30, query_offset=12,
                           deletions=6.0, extension=2.0, repeats=2)
    )

    # array inputs hash the full buffer, not str()'s TRUNCATED repr:
    # two long arrays differing only in the middle must differ
    a1 = rng.integers(0, 4, 5000).astype(np.int8)
    a2 = a1.copy()
    a2[2500] = (a2[2500] + 1) % 4
    assert _input_fingerprint(a1, opts) != _input_fingerprint(a2, opts)

    ckpt = str(tmp_path / "state.json")
    res_raw = perform_calculation_per_sequence(opts, raw, "chr", rng,
                                               checkpoint=ckpt)
    # same head, same path, DIFFERENT input: the complete-state shortcut
    # must not fire — the masked scan starts fresh
    assert isinstance(
        _load_checkpoint(ckpt, "chr", _input_fingerprint(raw, opts)), dict
    )
    assert _load_checkpoint(
        ckpt, "chr", _input_fingerprint(masked, opts)
    ) is None
    res_masked = perform_calculation_per_sequence(
        opts, masked, "chr", np.random.default_rng(3), checkpoint=ckpt
    )
    # and the fresh masked run overwrote the checkpoint under its own fp
    assert isinstance(
        _load_checkpoint(ckpt, "chr", _input_fingerprint(masked, opts)),
        dict,
    )
    del res_raw, res_masked


def test_seeded_resume_reproduces_uninterrupted_run(tmp_path, rng):
    """Per-record rng streams: a run that resumes record 1 from its
    checkpoint must produce the SAME results for record 2 as an
    uninterrupted seeded run (a shared stream would shift record 2's
    randomness by however many draws record 1 skipped)."""
    from aligner_tpu.repeat.engine import run_exploring_cmd

    def mk(n):
        return "".join("ATCG"[c] for c in rng.integers(0, 4, n))

    motif = mk(30)
    fasta = tmp_path / "two.fasta"
    fasta.write_text(
        ">chrA\n" + (mk(80) + motif) * 4 + "\n"
        ">chrB\n" + (mk(90) + motif) * 4 + "\n"
    )
    opts = SearchOptions(
        repeat_length=24, query_offset=10, deletions=6.0, extension=2.0,
        repeats=2, backend="xla",
    )
    ck1 = str(tmp_path / "a" / "ck.json")
    ck2 = str(tmp_path / "b" / "ck.json")
    os.makedirs(os.path.dirname(ck1)); os.makedirs(os.path.dirname(ck2))
    full = run_exploring_cmd(opts, str(fasta),
                             np.random.default_rng(77), checkpoint=ck1)
    # run the same seed into ck2, wipe chrB's per-record checkpoint, and
    # rerun: chrA replays from its checkpoint (zero draws), chrB re-runs
    run_exploring_cmd(opts, str(fasta), np.random.default_rng(77),
                      checkpoint=ck2)
    from aligner_tpu.repeat.engine import _record_checkpoint_path
    os.remove(_record_checkpoint_path(ck2, "chrB"))
    resumed = run_exploring_cmd(opts, str(fasta),
                                np.random.default_rng(77), checkpoint=ck2)
    for key in full:
        a = [(t.left_coord, t.right_coord, t.z) for t in full[key].tasks]
        b = [(t.left_coord, t.right_coord, t.z) for t in resumed[key].tasks]
        assert a == b, key
        np.testing.assert_array_equal(full[key].matrix, resumed[key].matrix)


def test_scan_device_gather_matches_host(rng, monkeypatch):
    """The device-side window gather (_scan_chunk_gather: sequence
    uploaded once, windows sliced on device) produces exactly the same
    scores as the host-materialized batch_align_pwm path, including the
    clipped windows at the sequence end, for both backends."""
    from aligner_tpu.repeat import engine as E

    seq = rng.integers(0, 4, 3000).astype(np.int8)
    opts = E.SearchOptions(repeat_length=40, query_offset=10,
                           deletions=5.0, extension=2.0, backend="xla")
    wins = E.windows_of(len(seq), opts, opts.query_offset)
    pwm = rng.integers(-1, 2, (4, 40)).astype(np.float64)
    monkeypatch.setenv("ALIGNER_AUTO_SHARD", "0")  # gather is 1-device
    monkeypatch.setenv("ALIGNER_SCAN_DEVICE_GATHER", "0")
    host = E._scan_scores(seq, wins, pwm, opts)
    monkeypatch.setenv("ALIGNER_SCAN_DEVICE_GATHER", "1")
    for backend in ("xla", "pallas"):
        opts.backend = backend
        dev = E._scan_scores(seq, wins, pwm, opts)
        assert np.array_equal(host, dev), backend
