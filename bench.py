"""Kernel-vs-XLA timing of the batched DP fill on one GPU.

Times the GPU batch kernel (``backend="pallas"``) against what XLA makes
of the ``lax.scan`` engine (``backend="xla"``) through the public batch
entry points, at the shapes the workloads use:

* ``scores_32k``  — 32,768 protein pairs of 400×400, scores-only local
  (BLOSUM62, del 11, ext 2);
* ``p_value_5k``  — 5,000 such pairs (one p-value's shuffle batch; one
  problem per thread fills only a few per cent of the card);
* ``align_4k_local`` / ``align_4k_global`` — 4,096 pairs of 50–400 aa
  with full alignments (fill + on-device traceback walk);
* ``pwm_scan_w300`` — 8,192 DNA windows of 330 bases against one PWM of
  width 300, scores-only (the repeat search's window scan);
* ``single_*``    — one pair per call: the host engine against a
  one-problem kernel launch and, for global mode, the row-scan pipeline.

Every case checks that the engines return the same numbers.  Prints the
card's name and power limit, then one JSON line per (case, engine), and
a last summary line.  Needs a GPU: exits 2 without one.

``--trace`` adds, per batch case and engine, one more warm call under the
JAX profiler and reduces its trace (:func:`device_times`): device busy
seconds (union of kernel intervals on the GPU streams), idle share of
the traced window, and the summed time of the batch kernel's own events
(``dp_fill_*``, the ``pallas_call`` name).

Each engine runs once to compile and then ``REPS`` (kernel) or
``XLA_REPS`` warm times; the XLA engine is slow enough that one warm
call settles its time.

Usage: ``python bench.py [--only CASE ...] [--trace]``
"""

from __future__ import annotations

import argparse
import glob
import json
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPS, XLA_REPS = 3, 1


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def _timed(fn, reps: int):
    """(first-call seconds incl. compile, [warm seconds...], result)."""
    t0 = time.perf_counter()
    res = fn()
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        res = fn()
        times.append(time.perf_counter() - t0)
    return first, times, res


def device_times(fn, kernel_prefix: str = "dp_fill") -> dict:
    """Run ``fn`` once under the profiler; reduce the trace to device
    busy seconds, idle share of the window, and kernel seconds."""
    import jax
    from jax.profiler import ProfileData

    tmp = tempfile.mkdtemp()
    try:
        t0 = time.perf_counter()
        with jax.profiler.trace(tmp):
            fn()
        window = time.perf_counter() - t0
        path = sorted(glob.glob(f"{tmp}/**/*.xplane.pb", recursive=True))[-1]
        spans, kernel_ns, by_name = [], 0, {}
        for plane in ProfileData.from_file(path).planes:
            if not plane.name.startswith("/device:GPU"):
                continue
            for line in plane.lines:
                if not line.name.startswith("Stream"):
                    continue
                for e in line.events:
                    spans.append((e.start_ns, e.start_ns + e.duration_ns))
                    by_name[e.name] = by_name.get(e.name, 0) + e.duration_ns
                    if e.name.startswith(kernel_prefix):
                        kernel_ns += e.duration_ns
        busy, end = 0.0, -1.0
        for a, b in sorted(spans):
            if b > end:
                busy += b - max(a, end)
                end = b
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        return {
            "window_s": window, "device_busy_s": busy / 1e9,
            "idle_share": 1 - busy / 1e9 / window,
            "kernel_s": kernel_ns / 1e9, "events": len(spans),
            "top_events_s": [(n[:60], d / 1e9) for n, d in top],
        }
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _same_scores(a, b, keys=("fmax", "fy", "fx", "end")) -> bool:
    return all(
        np.array_equal(np.asarray(getattr(a, k)), np.asarray(getattr(b, k)))
        for k in keys
    )


def _same_alignments(a, b) -> bool:
    for x, y in zip(a, b):
        if (x is None) != (y is None):
            return False
        if x is None:
            continue
        xa, ya = x.alignment, y.alignment
        if not (
            np.array_equal(xa.query, ya.query)
            and np.array_equal(xa.target, ya.target)
            and xa.coords == ya.coords and xa.f == ya.f
        ):
            return False
    return len(a) == len(b)


def _seqs(rng, n, lo, hi, vol):
    lens = rng.integers(lo, hi + 1, n) if lo < hi else np.full(n, lo)
    return [rng.integers(0, vol, int(k)).astype(np.int8) for k in lens]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*", default=None,
                    help="run only these cases")
    ap.add_argument("--trace", action="store_true",
                    help="add a profiled warm call per case and engine")
    args = ap.parse_args()

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2
    print(_nvidia_smi(), flush=True)

    import aligner_tpu as at
    from aligner_tpu.matrices import random_pwm

    rng = np.random.default_rng(7)
    M = at.blosum62()
    results = []

    def want(name):
        return args.only is None or name in args.only

    def record(case, engine, cells, first, times, ok, **extra):
        warm = min(times) if times else None
        row = {
            "case": case, "engine": engine, "first_call_s": first,
            "warm_s": times, "match": ok,
            "gcups": (cells / warm / 1e9) if warm else None, **extra,
        }
        results.append(row)
        print(json.dumps(row), flush=True)

    def batch_case(name, qs, ts, **kw):
        cells = float(sum(len(q) * len(t) for q, t in zip(qs, ts)))
        out = {}
        for eng, reps in (("pallas", REPS), ("xla", XLA_REPS)):
            first, times, out[eng] = _timed(
                lambda: at.batch_align(qs, ts, M, 11.0, 2.0, backend=eng,
                                       **kw),
                reps,
            )
            extra = {}
            if args.trace:
                extra["trace"] = device_times(
                    lambda: at.batch_align(qs, ts, M, 11.0, 2.0, backend=eng,
                                           **kw))
            record(name, eng, cells, first, times, None, batch=len(qs),
                   **extra)
        if kw.get("with_alignments"):
            same = _same_alignments(out["pallas"], out["xla"])
        else:
            # without argmax tracking only fmax is defined on the kernel
            keys = (("fmax", "fy", "fx", "end") if kw.get("track_argmax", True)
                    else ("fmax",))
            same = _same_scores(out["pallas"], out["xla"], keys)
        results[-1]["match"] = results[-2]["match"] = bool(same)
        print(json.dumps({"case": name, "pallas_equals_xla": bool(same)}),
              flush=True)

    if want("scores_32k"):
        qs = _seqs(rng, 32768, 400, 400, 24)
        ts = _seqs(rng, 32768, 400, 400, 24)
        batch_case("scores_32k", qs, ts, mode="local")
    if want("p_value_5k"):
        qs = _seqs(rng, 5000, 400, 400, 24)
        ts = _seqs(rng, 5000, 400, 400, 24)
        batch_case("p_value_5k", qs, ts, mode="local", track_argmax=False)
    for mode in ("local", "global"):
        name = f"align_4k_{mode}"
        if want(name):
            qs = _seqs(rng, 4096, 50, 400, 24)
            ts = _seqs(rng, 4096, 50, 400, 24)
            batch_case(name, qs, ts, mode=mode, with_alignments=True)
    if want("pwm_scan_w300"):
        pwm = random_pwm(300, rng)
        ws = _seqs(rng, 8192, 330, 330, 4)
        cells = float(8192 * 330 * 300)
        out = {}
        for eng, reps in (("pallas", REPS), ("xla", XLA_REPS)):
            first, times, out[eng] = _timed(
                lambda: at.batch_align_pwm(ws, pwm, 30.0, 7.0, backend=eng,
                                           track_argmax=False),
                reps,
            )
            extra = {}
            if args.trace:
                extra["trace"] = device_times(
                    lambda: at.batch_align_pwm(ws, pwm, 30.0, 7.0,
                                               backend=eng,
                                               track_argmax=False))
            record("pwm_scan_w300", eng, cells, first, times, None,
                   batch=len(ws), **extra)
        same = np.array_equal(out["pallas"].fmax, out["xla"].fmax)
        results[-1]["match"] = results[-2]["match"] = bool(same)
        print(json.dumps({"case": "pwm_scan_w300",
                          "pallas_equals_xla": bool(same)}), flush=True)

    # single pairs: where does a one-problem kernel launch stop losing to
    # the host engine (and, in global mode, to the row-scan pipeline)?
    for n in (1024, 2048, 4096):
        name = f"single_{n}"
        if not want(name):
            continue
        q = rng.integers(0, 24, n).astype(np.int8)
        t = rng.integers(0, 24, n).astype(np.int8)
        for mode in ("local", "global"):
            fn = at.align_local if mode == "local" else at.align_global
            engines = ["oracle", "pallas"]
            if mode == "global":
                engines.append("wavefront")
            ref = None
            for eng in engines:
                first, times, res = _timed(
                    lambda: fn(q, t, M, 11.0, 2.0, backend=eng), 2
                )
                a = res.alignment
                key = (a.query.tobytes(), a.target.tobytes(), a.coords,
                       a.f)
                ok = True if ref is None else key == ref
                ref = ref or key
                record(f"{name}_{mode}", eng, float(n * n), first, times, ok)

    ok = all(r["match"] is not False for r in results)
    print(json.dumps({
        "bench": "dp_fill_kernel_vs_xla", "ok": ok,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
