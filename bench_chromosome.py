"""Chromosome-scale flagship measurement (VERDICT r4 #4): exploring-mode
latent-repeat search on a >=10 Mb synthetic chromosome at the reference
defaults (W=300, offset=30, ~350k windows per cycle, 10 cycles;
engine/calc.rs:149-241 at its design scale), WITH a mid-scan kill +
checkpoint resume to exercise the fingerprinted per-cycle checkpoints at
the scale they were built for.

Runs the real CLI (python -m aligner_tpu.cli.repeat_search) as a
subprocess, SIGKILLs it once the checkpoint file reaches --kill-cycle,
reruns the same command (which resumes), and prints JSON lines:

  chromosome_scan_phase1   wall to the kill, cycle reached
  chromosome_scan_resume   resume wall, total wall, cells, eff. GCUPS
  repeat_search_chromosome one summary line (merged fields)

Usage: python bench_chromosome.py [--mb 10] [--repeats 10]
       [--kill-cycle 3] [--backend pallas] [--workdir DIR]
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import time


def make_chromosome(path: str, mb: float, seed: int = 7,
                    n_planted: int = 40) -> int:
    """Synthetic chromosome: random DNA + n_planted mutated copies of one
    330-base query at regular offsets (the testing-mode construction,
    cmd/testing.rs:52-57, scaled up).  Returns the sequence length."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = int(mb * 1_000_000)
    letters = np.frombuffer(b"ATCG", np.uint8)
    seq = letters[rng.integers(0, 4, n)]
    query = letters[rng.integers(0, 4, 330)]
    stride = n // (n_planted + 1)
    for i in range(n_planted):
        copy = query.copy()
        # every 4th position randomized, phase i (engine/mod.rs:17-47)
        idx = np.arange(i % 4, len(copy), 4)
        copy[idx] = letters[rng.integers(0, 4, len(idx))]
        pos = (i + 1) * stride
        seq[pos : pos + len(copy)] = copy
    with open(path, "w") as fh:
        fh.write(">chr_synthetic\n")
        for lo in range(0, n, 80):
            fh.write(seq[lo : lo + 80].tobytes().decode())
            fh.write("\n")
    return n


def read_ck_cycle(ck_base: str) -> int | None:
    """Highest cycle recorded in any per-record checkpoint file.

    Returns 10**9 once a checkpoint carries the ``complete`` marker."""
    import glob

    best = None
    for p in glob.glob(ck_base + "*"):
        try:
            with open(p) as fh:
                st = json.load(fh)
        except (OSError, ValueError):
            continue
        if isinstance(st, dict) and "complete" in st:
            return 10**9  # finished
        if isinstance(st, dict) and "cycle" in st:
            c = int(st["cycle"])
            best = c if best is None else max(best, c)
    return best


def read_ck_executed(ck_base: str) -> int | None:
    """Exact executed-cycle count from a COMPLETE checkpoint (the engine
    stamps the complete state's ``cycle`` with how many cycle scans
    actually ran, early break included)."""
    import glob

    best = None
    for p in glob.glob(ck_base + "*"):
        try:
            with open(p) as fh:
                st = json.load(fh)
        except (OSError, ValueError):
            continue
        if isinstance(st, dict) and "complete" in st and "cycle" in st:
            c = int(st["cycle"])
            best = c if best is None else max(best, c)
    return best


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=float, default=10.0)
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--kill-cycle", type=int, default=3)
    ap.add_argument("--backend", default=None)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()

    wd = args.workdir or os.path.join(
        os.getcwd(), f"bench_chromosome_{int(args.mb)}mb"
    )
    os.makedirs(wd, exist_ok=True)
    fasta = os.path.join(wd, "chr.fasta")
    ck = os.path.join(wd, "scan.ckpt")
    out = os.path.join(wd, "output.csv")
    if not os.path.exists(fasta):
        n = make_chromosome(fasta, args.mb, args.seed)
    else:
        n = sum(len(l.strip()) for l in open(fasta) if not l.startswith(">"))

    cmd = [
        sys.executable, "-m", "aligner_tpu.cli.repeat_search",
        "-i", fasta, "-o", out, "--checkpoint", ck,
        "--repeats", str(args.repeats), "--seed", str(args.seed),
    ]
    if args.backend:
        cmd += ["--backend", args.backend]

    # --- phase 1: run until the checkpoint reaches kill-cycle, then KILL
    log1 = open(os.path.join(wd, "phase1.log"), "w")
    t0 = time.time()
    p = subprocess.Popen(cmd, stdout=log1, stderr=subprocess.STDOUT)
    killed_at = None
    while p.poll() is None:
        c = read_ck_cycle(ck)
        if c is not None and c >= args.kill_cycle and c < 10**9:
            p.send_signal(signal.SIGKILL)
            p.wait()
            killed_at = c
            break
        time.sleep(1.0)
    t1 = time.time() - t0
    log1.close()
    if killed_at is None:
        # the run ended (success or crash) before the kill fired — there
        # is no kill+resume measurement to report; saying so loudly beats
        # recording a "resume" of an already-complete checkpoint
        print(json.dumps({
            "bench": "chromosome_scan_phase1",
            "error": f"phase 1 exited rc={p.returncode} before the "
                     f"checkpoint reached --kill-cycle {args.kill_cycle} "
                     "(scan converged early or the 1 s poll missed it) — "
                     "no kill+resume was exercised; rerun with a smaller "
                     "--kill-cycle",
        }))
        return 1
    print(json.dumps({
        "bench": "chromosome_scan_phase1",
        "len_bp": n, "wall_s": round(t1, 1),
        "killed_at_cycle": killed_at,
        "note": "SIGKILLed mid-scan; per-cycle fingerprinted checkpoint "
                "on disk",
    }), flush=True)

    # --- phase 2: identical command — must RESUME from the checkpoint.
    # Poll the checkpoint here too so cell accounting can use the cycles
    # that actually EXECUTED (the cycle loop breaks early on an empty
    # scan; assuming all --repeats cycles ran would overstate GCUPS).
    log2 = open(os.path.join(wd, "phase2.log"), "w")
    t0 = time.time()
    p2 = subprocess.Popen(cmd, stdout=log2, stderr=subprocess.STDOUT)
    max_cycle = killed_at  # phase 1 completed cycles 1..killed_at
    while p2.poll() is None:
        c = read_ck_cycle(ck)
        if c is not None and c < 10**9:
            max_cycle = max(max_cycle, c)
        time.sleep(1.0)
    rc = p2.returncode
    t2 = time.time() - t0
    log2.close()
    if rc != 0:
        print(json.dumps({"bench": "chromosome_scan_resume",
                          "error": f"resume exited rc={rc}"}))
        return 1

    from aligner_tpu.repeat.engine import SearchOptions, windows_of

    opts = SearchOptions(repeats=args.repeats)
    wins = windows_of(n, opts, opts.query_offset)
    cells_scan = sum((b - j) for j, b in wins) * opts.repeat_length
    import csv as _csv

    with open(out) as fh:
        found = sum(1 for _ in _csv.reader(fh)) - 1
    # executed scans = 1 initial-stats scan + executed cycles — exact
    # from the complete checkpoint's stamp when available, else the
    # poll-observed maximum (conservative: the killed cycle's discarded
    # partial work is never counted either way)
    exact = read_ck_executed(ck)
    if exact is not None:
        max_cycle = max(max_cycle, exact)
    n_scans = 1 + max_cycle
    total_cells = cells_scan * n_scans
    wall = t1 + t2
    row = {
        "bench": "repeat_search_chromosome",
        "len_bp": n, "windows_per_cycle": len(wins),
        "cycles_requested": args.repeats, "cycles_executed": max_cycle,
        "resume_killed_at_cycle": killed_at,
        "wall_phase1_s": round(t1, 1), "wall_resume_s": round(t2, 1),
        "wall_total_s": round(wall, 1),
        "cells": total_cells,
        "effective_gcups": round(total_cells / wall / 1e9, 2),
        "found_sites": found,
        "note": "exploring mode, reference defaults (W=300 offset=30 "
                "del=30 ext=7), SIGKILL at cycle "
                f"{killed_at} + checkpoint resume; cells count the "
                "initial scan + checkpoint-observed executed cycles only "
                "(the killed cycle's discarded partial work is excluded, "
                "so the rate is conservative)",
    }
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
