"""Backend/platform helpers.

The framework has three compute engines for the DP fill, all implementing
the same exact semantics (SURVEY.md §2.3):

* ``oracle``  — scalar host engine (native C++ when built, else NumPy
  float64; the ground truth).
* ``xla``     — batched ``lax.scan`` engine (any platform).
* ``pallas``  — the GPU batch kernel (``ops/pallas_dp.py``, one problem
  per thread).

``PLATFORMS`` is the one table that routes by platform: the engine, the
device dtype, and whether the heuristic population loop runs fused on
the device.  A platform missing from it is an error, not a default.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from pathlib import Path

import jax
import jax.numpy as jnp

# Persistent compilation cache: DP-fill kernels recompile per (shape,
# params) tuple.  JAX reads JAX_COMPILATION_CACHE_DIR itself; without it
# the cache sits at one fixed, git-ignored path inside the checkout.
CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def configure_compile_cache() -> str:
    """Point JAX's persistent cache at its directory; returns the path."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    CACHE_DIR.mkdir(exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return str(CACHE_DIR)


configure_compile_cache()


@dataclasses.dataclass(frozen=True)
class Platform:
    engine: str  # batched fill engine picked by pick_backend(None)
    x64_dtype: bool  # float64 when jax_enable_x64 is on, else float32
    fused_population: bool  # heuristic population loop as one dispatch
    # a single non-huge pair past SMALL_PROBLEM_CELLS_NATIVE runs on the
    # batch engine (else on the native host engine, when it is built).
    # On the GPU a one-problem launch is one thread: the host engine was
    # 6-12x faster at 1k-4k square pairs (H100, see PERF.md)
    single_pair_on_device: bool


PLATFORMS = {
    "cpu": Platform(engine="xla", x64_dtype=True, fused_population=False,
                    single_pair_on_device=True),
    "gpu": Platform(engine="pallas", x64_dtype=False, fused_population=True,
                    single_pair_on_device=False),
}


def platform_entry(name: str) -> Platform:
    try:
        return PLATFORMS[name]
    except KeyError:
        raise RuntimeError(
            f"unsupported JAX platform {name!r} (known: {sorted(PLATFORMS)})"
        ) from None


@functools.cache
def default_platform() -> str:
    return jax.devices()[0].platform


def platform() -> Platform:
    """Table entry of the default device's platform."""
    return platform_entry(default_platform())


def default_dtype() -> jnp.dtype:
    if platform().x64_dtype and jax.config.jax_enable_x64:
        return jnp.float64
    return jnp.float32


# Below this many DP cells a single problem runs faster on the host than
# the device round-trip + compile; batch paths ignore this.  With the C++
# scalar engine available the host wins far longer than pure Python does.
SMALL_PROBLEM_CELLS = 64 * 64
SMALL_PROBLEM_CELLS_NATIVE = 768 * 768

ENGINES = ("oracle", "xla", "pallas")


def pick_backend(backend: str | None = None, cells: int | None = None) -> str:
    """Resolve a backend name; ``None``/"auto" → the platform's engine.

    ``cells`` (problem area) lets single-pair entry points route
    problems to the host engine — identical results, no device launch.
    """
    if backend in (None, "auto"):
        if cells is not None:
            from . import native

            if native.available():
                if (cells <= SMALL_PROBLEM_CELLS_NATIVE
                        or not platform().single_pair_on_device):
                    return "oracle"
            elif cells <= SMALL_PROBLEM_CELLS:
                return "oracle"
        return platform().engine
    if backend not in ENGINES:
        raise ValueError(f"unknown backend {backend!r}")
    return backend
