"""Tracing, profiling and throughput counters.

The reference has only leveled logging (SURVEY.md §5); this fills the gap
for the device engines:

* :class:`Counters` — process-wide cells/launches/seconds per engine,
  giving live GCUPS without external tooling;
* :func:`profile_trace` — context manager around the JAX profiler
  (produces a TensorBoard/Perfetto trace directory);
* :func:`configure_logging` — ``ALIGNER_LOG``-controlled logging, the
  equivalent of the reference's ``RUST_LOG`` contract
  (Dockerfile.node:RUST_LOG=info).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import threading
import time
from collections import defaultdict

log = logging.getLogger("aligner_tpu")


_LEVELS = {"DEBUG", "INFO", "WARNING", "WARN", "ERROR", "CRITICAL", "FATAL"}


def configure_logging(level: str | None = None) -> None:
    lvl = (level or os.environ.get("ALIGNER_LOG", "warning")).upper()
    # whitelist: a stray ALIGNER_LOG value must fall back to WARNING,
    # not resolve to an arbitrary logging-module attribute
    if lvl not in _LEVELS:
        lvl = "WARNING"
    logging.basicConfig(
        level=getattr(logging, lvl),
        format="%(asctime)s %(levelname)s %(name)s %(message)s",
    )
    # basicConfig is a no-op once ANY root handler exists (an embedding
    # app configuring logging first would silently defeat ALIGNER_LOG);
    # set the level explicitly so the contract holds either way
    logging.getLogger().setLevel(getattr(logging, lvl))


@dataclasses.dataclass
class EngineStats:
    launches: int = 0
    cells: int = 0
    problems: int = 0
    seconds: float = 0.0

    @property
    def gcups(self) -> float:
        return self.cells / self.seconds / 1e9 if self.seconds > 0 else 0.0


class Counters:
    """Process-wide per-engine throughput counters (thread-safe)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._stats: dict[str, EngineStats] = defaultdict(EngineStats)

    def record(self, engine: str, cells: int, problems: int, seconds: float):
        with self._lock:
            s = self._stats[engine]
            s.launches += 1
            s.cells += cells
            s.problems += problems
            s.seconds += seconds

    def snapshot(self) -> dict[str, EngineStats]:
        with self._lock:
            return {k: dataclasses.replace(v) for k, v in self._stats.items()}

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()

    def report(self) -> str:
        lines = []
        for name, s in sorted(self.snapshot().items()):
            lines.append(
                f"{name}: {s.launches} launches, {s.problems} problems, "
                f"{s.cells / 1e9:.3f} Gcells in {s.seconds:.3f}s "
                f"({s.gcups:.2f} GCUPS)"
            )
        return "\n".join(lines) or "(no launches recorded)"


counters = Counters()


@contextlib.contextmanager
def measure(engine: str, cells: int, problems: int):
    """Record a launch in the global counters."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        counters.record(engine, cells, problems, time.perf_counter() - t0)


@contextlib.contextmanager
def profile_trace(logdir: str):
    """JAX profiler trace (view with TensorBoard or ui.perfetto.dev)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()
