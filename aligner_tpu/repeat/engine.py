"""Latent-repeat-search engine.

Faithful re-architecture of the reference engine
(aligner-core/src/bin/latent-repeat-search/engine/): the thread fan-outs
over windows (calc.rs:45-75, 105-144) become batched device launches —
a scores-only pass over every window, then a full-alignment pass over
only the z-filtered survivors (whose frequency matrices feed the next
cycle's matrix).

Replicated behavior details:

* window enumeration: thread i starts at ``i*query_offset`` and steps by
  ``step*threads``; ``step`` is ``len/1000`` for the simple-init starting
  scan, else ``query_offset`` (calc.rs:37-41,56,114); window end clips at
  the sequence end when ``j + repeat_length + query_offset >= length``;
* starting stats use the std *with* sqrt (calc.rs:78-86), cycle updates
  use the variance as σ — the reference's missing-sqrt quirk
  (calc.rs:197-202);
* z threshold 3.0 (calc.rs:17), applied ``z >= Z``;
* the overlap filter is transcribed statement-for-statement from
  engine/mod.rs:49-102, including its non-transitive intersection check
  against the batch's first task and the possible re-processing of the
  final task when a batch extends to the end of the list;
* cycle loop: break on an empty scan keeping the previous tasks; matrix
  re-derivation only when another cycle follows (calc.rs:182-219);
  kd=0, r² = del*ext for every transform in exploring mode
  (calc.rs:156-164,209-215);
* reversed pass: one extra cycle on the reversed compacted sequence with
  rotated indices, reusing the final mean/std/matrix (calc.rs:223-238).
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import os

import numpy as np

from ..align import batch_align_pwm
from ..alphabet import DNA, Index, index_coord, rotate_indices
from ..heuristic import Heuristics, heuristic_align_pwm
from ..matrices import random_pwm, transform_matrix
from ..result import PWMAlignment

Z = 3.0
TEST_SEQUENCE_LENGTH = 100_000
DESCENDANTS_AMOUNT = 10
SCAN_CHUNK = 8192  # windows per device launch


@dataclasses.dataclass
class Task:
    """A candidate repeat site (engine/task.rs:4-10)."""

    alignment: PWMAlignment | None
    left_coord: int
    right_coord: int
    z: float
    f: float


@dataclasses.dataclass
class TaskResult:
    tasks: list[Task]
    matrix: np.ndarray


@dataclasses.dataclass
class SearchOptions:
    """CLI options (latent-repeat-search/args.rs:5-44 defaults)."""

    repeat_length: int = 300
    query_offset: int = 30
    deletions: float = 30.0
    extension: float = 7.0
    rsquared: float = 100_000.0
    kd: float = 0.0
    threads: int = 1
    repeats: int = 10
    simple_init: bool = False
    reverse: bool = False
    backend: str | None = None


def windows_of(length: int, opts: SearchOptions, step: int) -> list[tuple[int, int]]:
    """The exact window set of the reference's thread fan-out.

    Thread i yields ``j = i*query_offset, i*query_offset + step*threads,
    ...`` (calc.rs:56,114); results arrive over an mpsc channel in
    nondeterministic order, so order here (thread-major) is as good as
    the reference's.
    """
    out = []
    for i in range(opts.threads):
        j = i * opts.query_offset
        stride = max(step * opts.threads, 1)
        while j < length:
            border = (
                length
                if j + opts.repeat_length + opts.query_offset >= length
                else j + opts.repeat_length + opts.query_offset
            )
            out.append((j, border))
            j += stride
    return out


_SCAN_GATHER_JIT = None


def _scan_chunk_gather_impl(seq_dev, starts, borders, pwm_dev,
                            *, Wmax, backend, del_, ext):
    """Jitted chunk scorer with ON-DEVICE window extraction: windows are
    gathered from the device-resident sequence instead of materialized
    host-side, so a chromosome scan uploads the sequence ONCE (O(len))
    rather than O(len·W/offset) of window copies per cycle — at 10 Mb /
    W=300 / offset=30 that is ~10 MB once vs ~440 MB per cycle through
    the host link.  Scores are identical to the host-materialized path
    (same fills, padding-invariant; pinned by test_repeat)."""
    import jax.numpy as jnp

    ql = (borders - starts).astype(jnp.int32)
    idx = starts[:, None] + jnp.arange(Wmax, dtype=jnp.int32)[None, :]
    q = jnp.where(
        jnp.arange(Wmax, dtype=jnp.int32)[None, :] < ql[:, None],
        seq_dev[jnp.clip(idx, 0, seq_dev.shape[0] - 1)],
        0,
    )
    if backend == "pallas":
        from ..ops.pallas_dp import fill_pwm_scores_traced

        fmax, _, _, _ = fill_pwm_scores_traced(
            q, ql, pwm_dev, del_, ext, dtype=pwm_dev.dtype,
            track_argmax=False,
        )
        return fmax
    from ..ops.scan_engine import fill_pwm_batch

    return fill_pwm_batch(
        q, ql, pwm_dev, del_, ext, with_planes=False, dtype=pwm_dev.dtype
    ).fmax


def _scan_chunk_gather(*args, **kw):
    global _SCAN_GATHER_JIT
    if _SCAN_GATHER_JIT is None:
        import jax

        _SCAN_GATHER_JIT = jax.jit(
            _scan_chunk_gather_impl,
            static_argnames=("Wmax", "backend", "del_", "ext"),
        )
    return _SCAN_GATHER_JIT(*args, **kw)


def _scan_scores(
    seq: np.ndarray, wins: list[tuple[int, int]], matrix: np.ndarray,
    opts: SearchOptions,
) -> np.ndarray:
    """Scores-only PWM alignment of every window (chunked launches)."""
    from ..align import _auto_shard_devices
    from ..backend import default_dtype, pick_backend

    fs = np.empty(len(wins), dtype=np.float64)
    backend_r = pick_backend(opts.backend)
    # device-side window gather: single-device scans upload the sequence
    # once and slice windows on device (see _scan_chunk_gather_impl);
    # multi-device meshes keep the host path, whose batch_align_pwm
    # auto-shards the window axis (ALIGNER_SCAN_DEVICE_GATHER=0 opts out)
    use_gather = (
        backend_r in ("xla", "pallas")
        and _auto_shard_devices() == 1
        and len(wins) > 1
        and os.environ.get("ALIGNER_SCAN_DEVICE_GATHER", "1") != "0"
    )
    if use_gather:
        import jax.numpy as jnp

        from ..observability import measure

        dtype = default_dtype()
        Wmax = -(-(opts.repeat_length + opts.query_offset) // 8) * 8
        seq_dev = jnp.asarray(seq, jnp.int32)
        pwm_dev = jnp.asarray(matrix, dtype)
        starts = np.fromiter((j for j, _ in wins), np.int32, len(wins))
        borders = np.fromiter((b for _, b in wins), np.int32, len(wins))
        cells = int((borders - starts).sum()) * int(matrix.shape[-1])
        # pow2-bucketed chunk: a small scan (simple-init starting values,
        # testing mode) must not pay a full 8192-lane fill — the fill's
        # cost is O(B·R·C) regardless of zero-length padding.  Buckets
        # keep the compiled-variant count log-bounded.
        chunk_b = min(SCAN_CHUNK, 1 << max(len(wins) - 1, 1).bit_length())
        with measure(f"{backend_r}/pwm-devgather", cells, len(wins)):
            for lo in range(0, len(wins), chunk_b):
                hi = min(lo + chunk_b, len(wins))
                s = np.zeros(chunk_b, np.int32)
                b = np.zeros(chunk_b, np.int32)  # empty-pad the tail
                s[: hi - lo] = starts[lo:hi]
                b[: hi - lo] = borders[lo:hi]
                fmax = _scan_chunk_gather(
                    seq_dev, jnp.asarray(s), jnp.asarray(b), pwm_dev,
                    Wmax=Wmax, backend=backend_r,
                    del_=float(opts.deletions), ext=float(opts.extension),
                )
                fs[lo:hi] = np.asarray(fmax, np.float64)[: hi - lo]
        return fs
    for lo in range(0, len(wins), SCAN_CHUNK):
        chunk = wins[lo : lo + SCAN_CHUNK]
        qs = [seq[j:border] for j, border in chunk]
        # pad the final partial chunk with empty windows so every launch
        # reuses the same compiled shape
        pad = SCAN_CHUNK - len(chunk) if len(wins) > SCAN_CHUNK else 0
        if pad:
            qs = qs + [seq[:0]] * pad
        res = batch_align_pwm(
            qs, matrix, opts.deletions, opts.extension,
            backend=opts.backend,
            # only f feeds the mean/std and z-filter (calc.rs:72-86,
            # 139-144) — skip the per-cell argmax bookkeeping
            track_argmax=False,
        )
        fs[lo : lo + len(chunk)] = np.asarray(res.fmax, np.float64)[: len(chunk)]
    return fs


def calculate_starting_values(
    seq: np.ndarray, matrix: np.ndarray, opts: SearchOptions,
    rng: np.random.Generator,
) -> tuple[float, float]:
    """Mean/std of window scores over the shuffled sequence
    (calc.rs:19-86)."""
    shuffled = np.array(seq)
    rng.shuffle(shuffled)
    step = len(seq) // 1000 if opts.simple_init else opts.query_offset
    wins = windows_of(len(seq), opts, step)
    fs = _scan_scores(shuffled, wins, matrix, opts)
    mean = float(fs.mean())
    std = float(np.sqrt(((fs - mean) ** 2).mean()))
    return mean, std


def calculate_cycle(
    seq: np.ndarray,
    matrix: np.ndarray,
    indices: list[Index],
    mean: float,
    std: float,
    opts: SearchOptions,
) -> list[Task]:
    """One scan over the real sequence; keep windows with z >= 3
    (calc.rs:88-147).  Alignments (needed for frequency matrices) are
    computed only for the surviving windows, in a second full-mode pass.
    """
    wins = windows_of(len(seq), opts, opts.query_offset)
    fs = _scan_scores(seq, wins, matrix, opts)
    with np.errstate(divide="ignore", invalid="ignore"):
        z = (fs - mean) / std  # std may be 0 — inf/nan matches the reference
    keep = np.flatnonzero(z >= Z)
    tasks: list[Task] = []
    for lo in range(0, len(keep), SCAN_CHUNK):
        idxs = keep[lo : lo + SCAN_CHUNK]
        qs = [seq[wins[i][0] : wins[i][1]] for i in idxs]
        # pad the survivor batch to a fixed bucket: the survivor count
        # changes every cycle, and each new batch shape is a fresh
        # kernel compile — the CLAUDE.md constant-shapes invariant.  Power-of-two buckets
        # keep the variant count log-bounded; ``pad_to`` padding is
        # zero-length problems (free), not duplicated real fills.
        bucket = 1
        while bucket < len(qs):
            bucket *= 2
        full = batch_align_pwm(
            qs, matrix, opts.deletions, opts.extension,
            backend=opts.backend, with_alignments=True, pad_to=bucket,
        )
        for res, i in zip(full, idxs):
            j, border = wins[i]
            tasks.append(
                Task(
                    alignment=res.alignment,
                    left_coord=index_coord(j, indices),
                    right_coord=index_coord(border, indices),
                    z=float(z[i]),
                    f=float(fs[i]),
                )
            )
    return tasks


def _check_intersection(c1: tuple[int, int], c2: tuple[int, int]) -> bool:
    """engine/mod.rs:104-119 (verbatim, including the duplicated first
    clause)."""
    if c2[0] <= c1[0] <= c2[1]:
        return True
    if c2[0] <= c1[1] <= c2[1]:
        return True
    if c2[0] >= c1[0] and c2[1] <= c1[1]:
        return True
    if c2[0] <= c1[0] <= c2[1]:
        return True
    return False


def filter_tasks(tasks: list[Task]) -> list[Task]:
    """Overlap de-duplication keeping max-z per batch (engine/mod.rs:49-102).

    Statement-for-statement port: batches grow while tasks intersect the
    batch's *first* task; when a batch runs to the end of the list the
    final task is revisited and re-added unless one with the same
    left_coord is already in the result (Task PartialEq, task.rs:12-16).
    """
    if not tasks:
        return []
    if len(tasks) == 1:
        return list(tasks)

    result: list[Task] = []
    tasks = sorted(tasks, key=lambda t: t.left_coord)

    while tasks:
        if len(tasks) == 1:
            if all(t.left_coord != tasks[0].left_coord for t in result):
                result.append(tasks[0])
            break

        current = tasks[0]
        batch = [current]
        index = 0
        for i, task in enumerate(tasks[1:]):
            index = i
            if _check_intersection(
                (current.left_coord, current.right_coord),
                (task.left_coord, task.right_coord),
            ):
                batch.append(task)
            else:
                break

        if len(batch) == 1:
            result.append(batch[0])
        else:
            # Rust Iterator::max_by keeps the *last* maximum on ties
            # (engine/mod.rs:93-99) — `>=` while folding reproduces that
            result.append(
                functools.reduce(lambda a, b: b if b.z >= a.z else a, batch)
            )

        tasks = tasks[index + 1 :]

    return result


def generate_descendants(
    sequence: np.ndarray, amount: int, offset: int, rng: np.random.Generator,
    volume: int = 4,
) -> list[np.ndarray]:
    """engine/mod.rs:17-31 (MutationPercent::Quarter → offset 4)."""
    return [mutate(sequence, offset, i, rng, volume) for i in range(amount)]


def mutate(
    sequence: np.ndarray, offset: int, start: int, rng: np.random.Generator,
    volume: int = 4,
) -> np.ndarray:
    """Randomize every ``offset``-th position from phase ``start``
    (engine/mod.rs:33-47)."""
    out = np.array(sequence)
    for i in range(start, len(sequence), offset):
        out[i] = rng.integers(0, volume)
    return out


def _tasks_to_json(tasks: list[Task]) -> list[dict]:
    return [
        {"left": t.left_coord, "right": t.right_coord, "z": t.z, "f": t.f}
        for t in tasks
    ]


def _tasks_from_json(items: list[dict]) -> list[Task]:
    return [
        Task(alignment=None, left_coord=t["left"], right_coord=t["right"],
             z=t["z"], f=t["f"])
        for t in items
    ]


def _matrix_to_json(matrix: np.ndarray) -> dict:
    # the shared serde codec (service/models.py) — old checkpoints
    # without the "v" field still load (the reader keys on dim/data)
    from ..service.models import matrix_to_serde_dict

    return matrix_to_serde_dict(matrix)


def _matrix_from_json(obj: dict) -> np.ndarray:
    from ..service.models import matrix_from_json

    return matrix_from_json(obj)


def _input_fingerprint(raw_seq: bytes, opts: SearchOptions) -> str:
    """Digest of the exact scan input: the sequence bytes AS SCANNED
    (csv mode masks known repeats first, so the same FASTA under a
    different mask — or an edited known.csv — fingerprints differently)
    plus the options that shape the search state.  A checkpoint from a
    different input must not resume silently (review r3 #4)."""
    if isinstance(raw_seq, np.ndarray):
        # str() of a long array is the TRUNCATED repr ('[2 0 3 ... ]'):
        # two different inputs sharing edge elements would fingerprint
        # identically — hash the full buffer instead
        raw_seq = np.ascontiguousarray(raw_seq).tobytes()
    elif isinstance(raw_seq, str):
        raw_seq = raw_seq.encode("utf-8", "replace")
    elif not isinstance(raw_seq, (bytes, bytearray, memoryview)):
        raw_seq = np.asarray(raw_seq).tobytes()
    h = hashlib.sha1(raw_seq)
    h.update(
        repr((opts.repeat_length, opts.query_offset, opts.deletions,
              opts.extension, opts.rsquared, opts.kd, opts.threads,
              opts.repeats, opts.simple_init, opts.reverse)).encode()
    )
    return h.hexdigest()[:16]


def _save_checkpoint(path: str, head: str, cycle: int, mean: float,
                     std: float, matrix: np.ndarray, tasks: list[Task],
                     results: dict[str, TaskResult] | None = None,
                     fp: str | None = None):
    """Durable per-cycle state: enough to resume a long chromosome scan
    (the per-cycle analogue of the service store's subtask checkpointing,
    which the reference CLI lacks entirely).  ``results`` marks the
    record complete: resume then skips the record entirely and replays
    the stored task lists (alignments are not needed downstream — the
    CSV/JSON outputs consume only coords/z/f and the matrices)."""
    import json

    state = {
        "head": head, "fp": fp, "cycle": cycle, "mean": mean, "std": std,
        "matrix": _matrix_to_json(matrix),
        "tasks": _tasks_to_json(tasks),
    }
    if results is not None:
        state["complete"] = {
            key: {"tasks": _tasks_to_json(r.tasks),
                  "matrix": _matrix_to_json(r.matrix)}
            for key, r in results.items()
        }
    tmp = f"{path}.tmp"
    with open(tmp, "w") as fh:
        json.dump(state, fh)
    os.replace(tmp, path)


def _load_checkpoint(path: str, head: str, fp: str | None = None):
    """Returns None (no usable checkpoint), a dict of TaskResult (record
    already complete), or a (cycle, mean, std, matrix, tasks) resume
    tuple.  ``fp`` is the current input fingerprint: state saved under a
    different fingerprint (other mask / options) is rejected — resuming
    it would silently replay results computed from a different input.  A
    legacy checkpoint with no fingerprint is accepted with a warning so
    pre-upgrade in-flight scans survive."""
    import json

    from ..observability import log

    if not path or not os.path.exists(path):
        return None
    try:
        with open(path) as fh:
            state = json.load(fh)
    except (OSError, ValueError) as e:
        log.warning(
            "checkpoint %s is unreadable (%s) — starting fresh", path, e
        )
        return None
    if not isinstance(state, dict) or state.get("head") != head:
        return None
    saved_fp = state.get("fp")
    if fp is not None and saved_fp is not None and saved_fp != fp:
        log.warning(
            "checkpoint %s was written for a different input "
            "(mask/options changed?) — starting fresh", path,
        )
        return None
    if fp is not None and saved_fp is None:
        log.warning(
            "checkpoint %s predates input fingerprinting; resuming "
            "unverified", path,
        )
    if "complete" in state:
        return {
            key: TaskResult(_tasks_from_json(r["tasks"]),
                            _matrix_from_json(r["matrix"]))
            for key, r in state["complete"].items()
        }
    m = _matrix_from_json(state["matrix"])
    return state["cycle"], state["mean"], state["std"], m, _tasks_from_json(
        state["tasks"]
    )


def _record_checkpoint_path(base: str, head: str) -> str:
    """Per-record checkpoint file so multi-record FASTA inputs resume
    correctly (one shared file would be clobbered by the next record).

    Falls back to the bare base path when only a pre-round-2 shared
    checkpoint exists for this head, so in-flight scans survive the
    path-scheme change."""
    digest = hashlib.sha1(head.encode("utf-8", "replace")).hexdigest()[:12]
    path = f"{base}.{digest}"
    if not os.path.exists(path) and os.path.exists(base):
        try:
            import json

            with open(base) as fh:
                if json.load(fh).get("head") == head:
                    return base
        except (OSError, ValueError):
            pass
    return path


def perform_calculation_per_sequence(
    opts: SearchOptions, raw_seq: bytes, head: str,
    rng: np.random.Generator,
    checkpoint: str | None = None,
) -> dict[str, TaskResult]:
    """Full per-chromosome search (calc.rs:149-241).

    ``checkpoint`` names a JSON file updated after every cycle; if it
    exists (and matches ``head``) the scan resumes from the next cycle —
    the matrix/statistics state is exact, completed cycles are not redone
    (surviving tasks reload without their alignments, which only the next
    matrix derivation consumed).
    """
    seq, freqs, indices = DNA.encode_with_freqs_and_indices(raw_seq)

    fp = _input_fingerprint(raw_seq, opts) if checkpoint else None
    resume = _load_checkpoint(checkpoint, head, fp) if checkpoint else None
    if isinstance(resume, dict):
        return resume  # record already completed in a previous run
    if resume is not None:
        start_cycle, mean, std, matrix, tasks = resume
    else:
        matrix = random_pwm(opts.repeat_length, rng)
        matrix = transform_matrix(
            matrix, 0.0, opts.deletions * opts.extension, freqs
        )
        mean, std = calculate_starting_values(seq, matrix, opts, rng)
        start_cycle, tasks = 0, []
        if checkpoint:
            # the starting scan is the expensive prelude — persist it even
            # before the first cycle completes
            _save_checkpoint(checkpoint, head, 0, mean, std, matrix,
                             tasks, fp=fp)

    result: dict[str, TaskResult] = {}

    executed = start_cycle  # cycles whose scan actually ran (for the
    # complete-state stamp below; an empty-break scan counts — it ran)
    for i in range(start_cycle, opts.repeats):
        new_tasks = calculate_cycle(seq, matrix, indices, mean, std, opts)
        executed = i + 1
        if not new_tasks:
            break
        tasks = filter_tasks(new_tasks)

        if i < opts.repeats - 1:
            fs = np.array([t.f for t in tasks])
            mean = float(fs.mean())
            # reference quirk: variance used as sigma (no sqrt, calc.rs:197-202)
            std = float(((fs - mean) ** 2).mean())

            matrix = np.zeros_like(matrix)
            for task in tasks:
                matrix = matrix + task.alignment.frequency_matrix()
            matrix = transform_matrix(
                matrix, 0.0, opts.deletions * opts.extension, freqs
            )

        if checkpoint:
            _save_checkpoint(checkpoint, head, i + 1, mean, std, matrix,
                             tasks, fp=fp)

    result["direct"] = TaskResult(tasks, matrix.copy())

    if opts.reverse:
        rev = seq[::-1].copy()
        rotated = rotate_indices(indices, len(rev))
        inv = calculate_cycle(rev, matrix, rotated, mean, std, opts)
        result["inverse"] = TaskResult(filter_tasks(inv), matrix)

    if checkpoint:
        # the complete state's ``cycle`` records how many cycle scans
        # actually EXECUTED (early break included) — resume never reads
        # it (the results dict short-circuits), but honest throughput
        # accounting does (bench_chromosome.py)
        _save_checkpoint(
            checkpoint, head, executed, mean, std, matrix, tasks,
            results=result, fp=fp,
        )

    return result


# --- CLI modes (cmd/{testing,exploring,csv}.rs) ---


def run_testing_cmd(
    opts: SearchOptions, rng: np.random.Generator,
    sequence_length: int = TEST_SEQUENCE_LENGTH,
    descendants_amount: int = DESCENDANTS_AMOUNT,
) -> dict[str, TaskResult]:
    """Synthetic self-test (cmd/testing.rs): plant 10 mutated copies of a
    random query in a random chromosome and search for them.  The length
    knobs default to the reference constants (testing.rs:10-11)."""
    sequence_raw = DNA.random_seq(sequence_length, rng)
    query, freqs = DNA.random_seq_with_freqs(
        opts.repeat_length + opts.query_offset, rng
    )

    matrix = random_pwm(opts.repeat_length, rng)
    res = heuristic_align_pwm(
        query, matrix, opts.deletions, opts.extension,
        Heuristics(kd=opts.kd, r_squared=opts.rsquared, frequencies=freqs),
        backend=opts.backend,
    )
    matrix = res.matrix

    descendants = generate_descendants(query, descendants_amount, 4, rng)
    offset = len(sequence_raw) // (len(descendants) + 1)
    # exact reference construction (testing.rs:52-57): the first chunk is
    # reused for descendant 0
    parts = [sequence_raw[:offset]]
    for i, d in enumerate(descendants):
        parts.append(d)
        parts.append(sequence_raw[offset * i : offset * (i + 1)])
    sequence = np.concatenate(parts)

    mean, std = calculate_starting_values(sequence, matrix, opts, rng)
    tasks = calculate_cycle(sequence, matrix, [], mean, std, opts)
    return {"test": TaskResult(tasks, matrix)}


def _run_per_record(
    opts: SearchOptions, fasta_path, rng: np.random.Generator,
    checkpoint: str | None, prep_seq=None,
) -> dict[str, TaskResult]:
    """Shared per-record orchestration of exploring/csv modes: derive the
    record's checkpoint path and independent RNG stream, run the search,
    unpack direct/inverse results.  ``prep_seq(head, seq)`` transforms
    the sequence first (csv mode's known-repeat masking) — keeping ONE
    copy of the resume/rng logic so the two CLI modes cannot drift."""
    from ..io import read_fasta_file

    result: dict[str, TaskResult] = {}
    for rec in read_fasta_file(fasta_path):
        seq = prep_seq(rec.head, rec.seq) if prep_seq else rec.seq
        per_ckpt = (
            _record_checkpoint_path(checkpoint, rec.head) if checkpoint else None
        )
        per_seq = perform_calculation_per_sequence(
            opts, seq, rec.head, _record_rng(rng), checkpoint=per_ckpt
        )
        if "direct" in per_seq:
            result[rec.head] = per_seq["direct"]
        if "inverse" in per_seq:
            result[f"{rec.head}-reversed"] = per_seq["inverse"]
    return result


def run_exploring_cmd(
    opts: SearchOptions, fasta_path, rng: np.random.Generator,
    checkpoint: str | None = None,
) -> dict[str, TaskResult]:
    """Search every record of a FASTA file (cmd/exploring.rs)."""
    return _run_per_record(opts, fasta_path, rng, checkpoint)


def _record_rng(rng: np.random.Generator) -> np.random.Generator:
    """One independent stream per FASTA record, derived by a single
    draw from the command-level generator.  A checkpoint-resumed record
    consumes ZERO in-record draws (its scan is replayed from state), so
    sharing one stream across records would shift every later record's
    randomness depending on where a resume happened — with per-record
    streams a seeded resumed run reproduces the uninterrupted one."""
    return np.random.default_rng(int(rng.integers(0, 2**63)))


def run_csv_cmd(
    opts: SearchOptions, fasta_path, csv_path, rng: np.random.Generator,
    checkpoint: str | None = None,
) -> dict[str, TaskResult]:
    """Exploring mode with known repeats masked out (cmd/csv.rs +
    sequences.rs:33-43).  ``checkpoint`` resumes per record exactly like
    exploring mode — csv runs the same chromosome-scale scans."""
    from ..io import read_records
    from ..io.fasta import mask_intervals

    data = read_records(csv_path)

    def mask(head, seq):
        if head in data:
            return mask_intervals(
                seq, [(r.left_coord, r.right_coord) for r in data[head]]
            )
        return seq

    return _run_per_record(opts, fasta_path, rng, checkpoint, prep_seq=mask)
