"""Smoke test of the system on NVIDIA GPUs, through the public entry points.

One card (no arguments):

0. the ``gpu``-marked tests, in a child process before this one opens
   the card;
1. example parity: the ``aligner-align`` CLI path on the three example
   FASTAs with the GPU kernel forced, against the frozen goldens;
2. batched fill: ``batch_align`` on 32,768 seeded 400×400 protein pairs
   (scores-only local, BLOSUM62, del 11, ext 2), then 4,096 pairs of
   50–400 aa with alignments in local and global mode — equal to the XLA
   engine on the same card and to the native host engine on 64 samples;
3. p-value: ``calculate_p_value`` on the protein.fasta pair (5,000
   shuffles + ML fit), equal to the same call on the XLA engine;
4. repeat scan: ``perform_calculation_per_sequence`` on a 1 Mb seeded
   chromosome with planted repeats at the reference defaults (W=300,
   offset 30, del 30, ext 7, reverse, 2 cycles), equal to the XLA run;
5. heuristic population: ``heuristic_align_population`` with 64 members
   on the protein.fasta pair, against the same fused loop on the CPU in
   float32 (alignments equal; f and matrices within the stated
   tolerance: the in-loop transform rounds in f32 and the GPU may sum
   in another order);
6. huge global pair: ``align_global`` on a seeded 16k×32k pair through
   the row-scan pipeline, equal to the native host engine.

``--four-cards`` runs only the paths that exist across cards: (a) the
phase-2 batches auto-sharded over four cards against one card, (b)
``sharded_global_align`` / ``sharded_global_end_score`` over a 1-D
four-card mesh on a seeded 32k×32k pair against the native host engine,
(c) the mesh collectives of ``__graft_entry__.dryrun_multichip``.

Prints the card's name and power limit, the JAX version and compile
cache, one line per phase, and as the last line
``{"ok": true, "device": {...}}``.  Exits non-zero without that line
when JAX finds no GPU, the repository is missing, or any phase fails.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016


class PhaseFailed(Exception):
    pass


def _check(cond, what):
    if not cond:
        raise PhaseFailed(what)


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def _child_platform() -> str:
    """JAX's default platform, asked in a child so that this process
    does not open the card before the test child runs."""
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax; print(jax.devices()[0].platform)"],
        capture_output=True, text=True, timeout=300, cwd=HERE,
    )
    return out.stdout.strip().splitlines()[-1] if out.returncode == 0 else ""


def _gpu_tests() -> None:
    t0 = time.perf_counter()
    env = dict(os.environ, ALIGNER_TEST_PLATFORM="gpu")
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "tests", "-m", "gpu", "-q",
         "-p", "no:cacheprovider"],
        capture_output=True, text=True, timeout=900, cwd=HERE, env=env,
    )
    tail = out.stdout.strip().splitlines()[-1:] or ["(no output)"]
    print(json.dumps({"phase": "0_gpu_tests", "rc": out.returncode,
                      "summary": tail[0],
                      "seconds": time.perf_counter() - t0}), flush=True)
    _check(out.returncode == 0, "gpu-marked tests failed:\n" + out.stdout[-4000:])
    _check(" passed" in tail[0] and "skipped" not in tail[0],
           f"gpu-marked tests did not all run: {tail[0]}")


class Phase:
    """Collects one phase's report line: shapes, compile (first call)
    and warm seconds, match result, peak device bytes."""

    def __init__(self, name, **shapes):
        self.row = {"phase": name, **shapes}

    def timed(self, key, fn):
        t0 = time.perf_counter()
        res = fn()
        self.row[key] = time.perf_counter() - t0
        return res

    def report(self, devices):
        self.row["match"] = True
        self.row["peak_bytes_in_use"] = [
            (d.memory_stats() or {}).get("peak_bytes_in_use") for d in devices
        ]
        print(json.dumps(self.row), flush=True)


def _seqs(rng, n, lo, hi, vol=24):
    lens = rng.integers(lo, hi + 1, n)
    return [rng.integers(0, vol, int(k)).astype(np.int8) for k in lens]


def _same_scores(a, b):
    return all(np.array_equal(np.asarray(getattr(a, k)),
                              np.asarray(getattr(b, k)))
               for k in ("fmax", "fy", "fx", "end"))


def _same_aln(a, b):
    if (a is None) != (b is None):
        return False
    if a is None:
        return True
    x, y = a.alignment, b.alignment
    return (np.array_equal(x.query, y.query)
            and np.array_equal(x.target, y.target)
            and x.coords == y.coords and x.f == y.f)


def _read_pair(name):
    from aligner_tpu.alphabet import Protein
    from aligner_tpu.io import read_fasta_file

    recs = read_fasta_file(os.path.join(HERE, "examples", f"{name}.fasta"))
    return [Protein.encode(r.seq, strict=True) for r in recs[:2]]


# --- one card --------------------------------------------------------


def phase_examples(devs):
    from aligner_tpu.cli.align import main as align_main

    golden = json.load(open(os.path.join(HERE, "tests", "fixtures",
                                         "examples_golden.json")))
    ph = Phase("1_examples", files=sorted(golden))
    t0 = time.perf_counter()
    for example, cases in sorted(golden.items()):
        for key, want in cases.items():
            mode, d, e = key.split("_")
            argv = ["-i", os.path.join(HERE, "examples", f"{example}.fasta"),
                    "-d", d[1:], "-e", e[1:], "--backend", "pallas",
                    "--pretty"] + (["-g"] if mode == "global" else [])
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                _check(align_main(argv) == 0, f"cli failed: {argv}")
            lines = dict(ln.split(":", 1) for ln in buf.getvalue().splitlines())
            got_f = float(lines["score "].strip())
            _check(lines["query "].strip() == want["query"]
                   and lines["target"].strip() == want["target"]
                   and got_f == want["f"]
                   and lines["coords"].strip() == "query {}, target {}".format(
                       tuple(want["coords"][0]), tuple(want["coords"][1])),
                   f"{example} {key}: CLI output differs from the golden")
    ph.row["seconds"] = time.perf_counter() - t0
    ph.report(devs)


def phase_batch(devs, rng):
    import aligner_tpu as at

    M = at.blosum62()
    ph = Phase("2a_batch_scores", pairs=32768, shape="400x400",
               mode="local", matrix="blosum62", dele=11, ext=2)
    qs = _seqs(rng, 32768, 400, 400)
    ts = _seqs(rng, 32768, 400, 400)

    def run(b):
        return at.batch_align(qs, ts, M, 11.0, 2.0, mode="local", backend=b)

    got = ph.timed("compile_s", lambda: run("pallas"))
    got = ph.timed("warm_s", lambda: run("pallas"))
    ref = ph.timed("xla_s", lambda: run("xla"))
    _check(_same_scores(got, ref), "scores differ from the XLA engine")
    for i in rng.choice(len(qs), 64, replace=False):
        f, (my, mx) = at.local_max_score(qs[i], ts[i], M, 11.0, 2.0)
        _check((got.fmax[i], got.fy[i], got.fx[i]) == (f, my, mx),
               f"problem {i} differs from the native engine")
    ph.row["native_sample"] = 64
    ph.report(devs)

    for mode in ("local", "global"):
        ph = Phase(f"2b_batch_alignments_{mode}", pairs=4096,
                   lengths="50-400", mode=mode)
        qs = _seqs(rng, 4096, 50, 400)
        ts = _seqs(rng, 4096, 50, 400)

        def run(b):
            return at.batch_align(qs, ts, M, 11.0, 2.0, mode=mode, backend=b,
                                  with_alignments=True)

        got = ph.timed("compile_s", lambda: run("pallas"))
        got = ph.timed("warm_s", lambda: run("pallas"))
        ref = ph.timed("xla_s", lambda: run("xla"))
        _check(len(got) == len(ref)
               and all(_same_aln(a, b) for a, b in zip(got, ref)),
               f"{mode} alignments differ from the XLA engine")
        fn = at.align_local if mode == "local" else at.align_global
        for i in rng.choice(len(qs), 64, replace=False):
            host = fn(qs[i], ts[i], M, 11.0, 2.0, backend="oracle")
            _check(_same_aln(got[i], host),
                   f"{mode} problem {i} differs from the native engine")
        ph.row["native_sample"] = 64
        ph.report(devs)


def phase_pvalue(devs):
    """calculate_p_value on the pair's own alignment score, equal to the
    same call on the XLA engine; and, since that p-value is degenerate
    (0.0 for a real homolog), the fitted distribution itself: the 4,999
    shuffled scores and the ML fit (k, lambda, h) equal on both engines."""
    import aligner_tpu as at
    from aligner_tpu.statistics import (
        calculate_distribution_params,
        calculate_p_value,
        shuffle_and_randomize_sequence,
    )

    q, t = _read_pair("protein")
    M = at.blosum62()
    f = at.align_local(q, t, M, 11.0, 2.0).alignment.f
    ph = Phase("3_p_value", shuffles=5000, qlen=len(q), tlen=len(t))

    def run(b):
        return calculate_p_value(q, t, f, 11.0, 2.0, M,
                                 rng=np.random.default_rng(SEED), backend=b)

    got = ph.timed("compile_s", lambda: run("pallas"))
    got = ph.timed("warm_s", lambda: run("pallas"))
    ref = ph.timed("xla_s", lambda: run("xla"))
    ph.row["p_value"] = got
    _check(got == ref or (np.isnan(got) and np.isnan(ref)),
           f"p-value {got!r} != XLA engine {ref!r}")

    rng = np.random.default_rng(SEED)
    shuffles = [shuffle_and_randomize_sequence(t, rng) for _ in range(4999)]
    lengths = np.array([len(t)] + [len(x) for x in shuffles])
    fits = {}
    for b in ("pallas", "xla"):
        res = at.batch_align([q] * len(shuffles), shuffles, M, 11.0, 2.0,
                             mode="local", backend=b, track_argmax=False)
        scores = np.concatenate([[f], np.asarray(res.fmax, np.float64)])
        fits[b] = (scores, calculate_distribution_params(len(q), lengths,
                                                         scores))
    _check(np.array_equal(fits["pallas"][0], fits["xla"][0]),
           "shuffled scores differ from the XLA engine")
    fp, fx = fits["pallas"][1], fits["xla"][1]
    _check((fp.k, fp.lambda_, fp.h) == (fx.k, fx.lambda_, fx.h),
           "ML fit differs from the XLA engine")
    ph.row["fit"] = {"k": fp.k, "lambda": fp.lambda_, "h": fp.h}
    ph.report(devs)


def _chromosome(rng, n=1_000_000, n_repeats=40, unit=300):
    """Seeded DNA with ``n_repeats`` planted copies (5% mutated) of one
    repeat unit, some reverse-complemented."""
    seq = rng.integers(0, 4, n).astype(np.int8)
    motif = rng.integers(0, 4, unit).astype(np.int8)
    for k, pos in enumerate(rng.choice(n - unit, n_repeats, replace=False)):
        copy = motif.copy()
        mut = rng.random(unit) < 0.05
        copy[mut] = rng.integers(0, 4, int(mut.sum()))
        if k % 2:
            copy = (3 - copy)[::-1]
        seq[pos:pos + unit] = copy
    return "".join("ACGT"[c] for c in seq).encode()


def phase_repeat(devs):
    from aligner_tpu.repeat.engine import (
        SearchOptions,
        perform_calculation_per_sequence,
    )

    raw = _chromosome(np.random.default_rng(SEED))
    ph = Phase("4_repeat_scan", bases=len(raw), window=300, offset=30,
               dele=30, ext=7, reverse=True, cycles=2)

    def run(b):
        opts = SearchOptions(repeat_length=300, query_offset=30,
                             deletions=30.0, extension=7.0, repeats=2,
                             reverse=True, backend=b)
        return perform_calculation_per_sequence(
            opts, raw, "chr_smoke", np.random.default_rng(SEED)
        )

    got = ph.timed("compile_s", lambda: run("pallas"))
    got = ph.timed("warm_s", lambda: run("pallas"))
    ref = ph.timed("xla_s", lambda: run("xla"))
    _check(sorted(got) == sorted(ref), "different record sets")
    n_tasks = 0
    for key in got:
        a, b = got[key], ref[key]
        _check(np.array_equal(a.matrix, b.matrix), f"{key}: matrix differs")
        _check(len(a.tasks) == len(b.tasks), f"{key}: task count differs")
        for x, y in zip(a.tasks, b.tasks):
            _check((x.left_coord, x.right_coord, x.z, x.f)
                   == (y.left_coord, y.right_coord, y.z, y.f),
                   f"{key}: task differs")
            if x.alignment is not None or y.alignment is not None:
                _check(np.array_equal(x.alignment.numbered,
                                      y.alignment.numbered)
                       and np.array_equal(x.alignment.query,
                                          y.alignment.query),
                       f"{key}: task alignment differs")
        n_tasks += len(a.tasks)
    ph.row["records"] = sorted(got)
    ph.row["tasks"] = n_tasks
    ph.report(devs)


def phase_population(devs):
    """The fused population loop (the service worker's hot loop).

    The fill/walk/count pipeline is exact, so (i) one iteration on the
    GPU equals one on the CPU bit for bit (scores, convergence flags) and
    (ii) every member's final alignment equals a CPU float32 fill of that
    member's final matrix.  Across iterations the in-loop transform
    rounds in f32 and the GPU may sum in another order, so (iii) the full
    run is compared with the CPU float32 run at a tolerance (f rel 1e-3,
    matrices rtol = atol = 1e-4) for every member that took the same
    path; a member whose path forks at a tie within that rounding is
    counted, and at most an eighth of the population may fork."""
    import jax
    import jax.numpy as jnp

    import aligner_tpu as at
    from aligner_tpu.alphabet import Protein
    from aligner_tpu.heuristic import (
        Heuristics,
        _population_device_loop,
        _tile_pair,
        heuristic_align_population,
    )
    from aligner_tpu.matrices import transform_matrix
    from aligner_tpu.service.dispatcher import symbol_frequencies

    cpu = jax.devices("cpu")[0]
    q, t = _read_pair("protein")
    M = 64
    freqs = symbol_frequencies(Protein.decode(q), Protein.decode(t), 24)
    h = Heuristics(kd=0.0, r_squared=1e5, frequencies=freqs)
    mats = np.random.default_rng(SEED).integers(-1, 2, (M, 24, 24)).astype(
        np.float64)
    ph = Phase("5_heuristic_population", members=M, qlen=len(q),
               tlen=len(t), tolerance="f rel 1e-3, matrices rtol=atol=1e-4")

    # (i) one iteration, GPU vs CPU, from the same float32 matrices
    start = np.stack([transform_matrix(m, 0.0, 1e5, freqs) for m in mats])
    q2, ql0, t2, tl0 = _tile_pair(q, t, M)

    def one_iter(backend, device):
        with jax.default_device(device):
            f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
            out = _population_device_loop(
                q2, ql0, t2, tl0, f32(start), f32(freqs), f32(0.0),
                f32(1e5), jnp.asarray(1, jnp.int32), backend=backend,
                del_=11.0, ext=11.0,
            )
            return [np.asarray(o) for o in out]

    g1, c1 = one_iter("pallas", devs[0]), one_iter("xla", cpu)
    for k, name in ((1, "done"), (2, "dead"), (3, "max_f")):
        _check(np.array_equal(g1[k], c1[k]), f"first iteration: {name} differs")
    _check(np.allclose(g1[4], c1[4], rtol=1e-4, atol=1e-4),
           "first iteration: transformed matrices outside tolerance")

    # (ii) the public call on the GPU; each final alignment re-filled on
    # the CPU from that member's own final matrix
    def run(b):
        return heuristic_align_population(q, t, mats, 11.0, 11.0, h,
                                          backend=b, device_loop=True)

    got = ph.timed("compile_s", lambda: run("pallas"))
    got = ph.timed("warm_s", lambda: run("pallas"))
    alive = [m for m in range(M) if got[m] is not None]
    with jax.default_device(cpu):
        refill = at.batch_align(
            [q] * len(alive), [t] * len(alive),
            np.stack([got[m].matrix for m in alive]), 11.0, 11.0,
            mode="local", backend="xla", with_alignments=True,
            dtype=jnp.float32,
        )
        # (iii) the whole loop on the CPU in float32
        ref = ph.timed("cpu_f32_s", lambda: run("xla"))
    for m, r in zip(alive, refill):
        _check(_same_aln(got[m], r), f"member {m}: final alignment differs "
               "from a CPU fill of its final matrix")
    forked = 0
    for m, (a, b) in enumerate(zip(got, ref)):
        _check((a is None) == (b is None), f"member {m}: dead on one side")
        if a is None:
            continue
        x, y = a.alignment, b.alignment
        if not (np.array_equal(x.query, y.query)
                and np.array_equal(x.target, y.target)
                and x.coords == y.coords):
            forked += 1
            continue
        _check(abs(x.f - y.f) <= 1e-3 * max(1.0, abs(y.f)),
               f"member {m}: f {x.f} vs {y.f}")
        _check(np.allclose(a.matrix, b.matrix, rtol=1e-4, atol=1e-4),
               f"member {m}: final matrix outside tolerance")
    ph.row["members_aligned"] = len(alive)
    ph.row["members_forked_vs_cpu"] = forked
    _check(forked * 8 <= M, f"{forked} of {M} members took another path")
    ph.report(devs)


def phase_huge_pair(devs):
    import aligner_tpu as at
    from aligner_tpu import host

    rng = np.random.default_rng(SEED)
    q = rng.integers(0, 24, 16384).astype(np.int8)
    t = rng.integers(0, 24, 32768).astype(np.int8)
    M = np.asarray(at.blosum62())
    ph = Phase("6_huge_global_pair", qlen=len(q), tlen=len(t),
               route="row-scan pipeline, local devices")
    got = ph.timed("compile_s", lambda: at.align_global(q, t, M, 11.0, 2.0))
    got = ph.timed("warm_s", lambda: at.align_global(q, t, M, 11.0, 2.0))
    end = ph.timed("end_score_s",
                   lambda: at.global_end_score(q, t, M, 11.0, 2.0))
    ref = ph.timed("native_s", lambda: host.align_global(q, t, M, 11.0, 2.0))
    _check(np.array_equal(got.alignment.query, ref.query_aligned)
           and np.array_equal(got.alignment.target, ref.target_aligned),
           "alignment differs from the native engine")
    _check(end == ref.score[len(t), len(q)], "end score differs")
    ph.row["end_score"] = end
    ph.report(devs)


# --- four cards --------------------------------------------------------


def phase_four_batch(devs, rng):
    import aligner_tpu as at

    M = at.blosum62()
    ph = Phase("a_auto_sharded_batch", devices=len(devs), pairs=32768,
               shape="400x400", aligned_pairs=4096)
    qs = _seqs(rng, 32768, 400, 400)
    ts = _seqs(rng, 32768, 400, 400)
    qa = _seqs(rng, 4096, 50, 400)
    ta = _seqs(rng, 4096, 50, 400)

    def run():
        return (at.batch_align(qs, ts, M, 11.0, 2.0, mode="local"),
                at.batch_align(qa, ta, M, 11.0, 2.0, mode="local",
                               with_alignments=True))

    got = ph.timed("compile_s", run)
    got = ph.timed("warm_s", run)
    os.environ["ALIGNER_AUTO_SHARD"] = "0"
    try:
        ref = ph.timed("one_card_compile_s", run)
        ref = ph.timed("one_card_s", run)
    finally:
        del os.environ["ALIGNER_AUTO_SHARD"]
    _check(_same_scores(got[0], ref[0]), "sharded scores differ")
    _check(all(_same_aln(a, b) for a, b in zip(got[1], ref[1])),
           "sharded alignments differ")
    ph.report(devs)


def phase_four_pipeline(devs):
    import jax
    from jax.sharding import Mesh

    import aligner_tpu as at
    from aligner_tpu import host
    from aligner_tpu.parallel import (
        sharded_global_align,
        sharded_global_end_score,
    )

    rng = np.random.default_rng(SEED + 1)
    q = rng.integers(0, 24, 32768).astype(np.int8)
    t = rng.integers(0, 24, 32768).astype(np.int8)
    M = np.asarray(at.blosum62())
    mesh = Mesh(np.array(jax.devices()[:4]), ("data",))
    ph = Phase("b_sharded_pipeline", devices=4, qlen=len(q), tlen=len(t))
    got = ph.timed("compile_s",
                   lambda: sharded_global_align(mesh, q, t, M, 11.0, 2.0))
    got = ph.timed("warm_s",
                   lambda: sharded_global_align(mesh, q, t, M, 11.0, 2.0))
    end = ph.timed("end_score_s",
                   lambda: sharded_global_end_score(mesh, q, t, M, 11.0, 2.0))
    ref = ph.timed("native_s", lambda: host.align_global(q, t, M, 11.0, 2.0))
    want = ref.score[len(t), len(q)]
    _check(got[0] == want and end == want, "end score differs")
    _check(np.array_equal(got[1], ref.query_aligned)
           and np.array_equal(got[2], ref.target_aligned),
           "alignment differs from the native engine")
    ph.row["end_score"] = end
    ph.report(devs)


def phase_four_collectives(devs):
    from __graft_entry__ import dryrun_multichip

    ph = Phase("c_mesh_collectives", devices=4)
    ph.timed("seconds", lambda: dryrun_multichip(4))
    ph.report(devs)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card paths (a-c)")
    args = ap.parse_args()
    n_cards = 4 if args.four_cards else 1

    if not os.path.isdir(os.path.join(HERE, "aligner_tpu")):
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 1
    try:
        print(_nvidia_smi(), flush=True)
    except (OSError, subprocess.SubprocessError) as e:
        print(f"nvidia-smi failed: {e}", file=sys.stderr)
        return 1
    platform = _child_platform()
    if platform != "gpu":
        print(f"JAX finds no GPU (default platform {platform!r})",
              file=sys.stderr)
        return 1
    try:
        if not args.four_cards:
            _gpu_tests()

        sys.path.insert(0, HERE)
        import jax

        from aligner_tpu.backend import configure_compile_cache

        devs = jax.devices()
        if devs[0].platform != "gpu" or len(devs) < n_cards:
            print(f"need {n_cards} GPU(s), JAX finds {devs}", file=sys.stderr)
            return 1
        devs = devs[:n_cards]
        print(json.dumps({"jax": jax.__version__,
                          "compile_cache": configure_compile_cache(),
                          "devices": [d.device_kind for d in devs]}),
              flush=True)
        rng = np.random.default_rng(SEED)
        if args.four_cards:
            phase_four_batch(devs, rng)
            phase_four_pipeline(devs)
            phase_four_collectives(devs)
        else:
            phase_examples(devs)
            phase_batch(devs, rng)
            phase_pvalue(devs)
            phase_repeat(devs)
            phase_population(devs)
            phase_huge_pair(devs)
    except PhaseFailed as e:
        print(f"FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
