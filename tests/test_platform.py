"""The platform table (backend.PLATFORMS), the compile-cache location, and
chip_smoke.py's refusal to run without a GPU."""

from __future__ import annotations

import os
import pathlib
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from aligner_tpu import backend, native
from aligner_tpu.ops import pallas_dp

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def on_platform(monkeypatch):
    """Pretend the default JAX device is on the given platform."""

    def set_(name):
        monkeypatch.setattr(backend, "default_platform", lambda: name)

    return set_


@pytest.mark.parametrize("name,engine", [("cpu", "xla"), ("gpu", "pallas")])
def test_engine_per_platform(on_platform, name, engine):
    on_platform(name)
    assert backend.platform_entry(name).engine == engine
    assert backend.pick_backend() == engine
    assert backend.pick_backend("auto") == engine


@pytest.mark.parametrize("name", ["metal", "rocm", ""])
def test_unknown_platform_raises(on_platform, name):
    on_platform(name)
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        backend.pick_backend()
    with pytest.raises(RuntimeError):
        backend.default_dtype()


def test_explicit_backend_names(on_platform):
    on_platform("gpu")
    for name in backend.ENGINES:
        assert backend.pick_backend(name) == name
    with pytest.raises(ValueError, match="unknown backend"):
        backend.pick_backend("mosaic")


@pytest.mark.parametrize("name,expect", [("cpu", jnp.float64),
                                         ("gpu", jnp.float32)])
def test_default_dtype_per_platform(on_platform, name, expect):
    on_platform(name)  # the test session runs with x64 enabled
    assert backend.default_dtype() == expect


@pytest.mark.parametrize("name", ["cpu", "gpu"])
@pytest.mark.parametrize("cells", [100, 900 * 900, 4096 * 4096])
def test_single_pair_routing(on_platform, name, cells):
    """Small pairs always run on the host; past the native engine's
    threshold only the CPU sends a single pair to its batch engine —
    on the GPU a one-problem launch is one thread, slower than the host."""
    on_platform(name)
    got = backend.pick_backend(None, cells=cells)
    if not native.available():
        want = "oracle" if cells <= backend.SMALL_PROBLEM_CELLS else (
            backend.PLATFORMS[name].engine)
    elif cells <= backend.SMALL_PROBLEM_CELLS_NATIVE or name == "gpu":
        want = "oracle"
    else:
        want = "xla"
    assert got == want


@pytest.mark.parametrize("name,fused", [("cpu", False), ("gpu", True)])
def test_fused_population_per_platform(on_platform, monkeypatch, name, fused):
    from aligner_tpu.heuristic import _use_device_loop

    on_platform(name)
    monkeypatch.delenv("ALIGNER_POP_DEVICE_LOOP", raising=False)
    assert _use_device_loop(backend.PLATFORMS[name].engine) is fused
    assert _use_device_loop("oracle") is False
    monkeypatch.setenv("ALIGNER_POP_DEVICE_LOOP", "1")
    assert _use_device_loop("xla") is True


@pytest.mark.parametrize("name", ["cpu", "gpu"])
def test_kernel_interpret_never_chosen_by_platform(on_platform, monkeypatch,
                                                   name):
    """The kernel launch gets interpret=False whatever the platform;
    only the INTERPRET switch (set by tests) changes it."""
    on_platform(name)
    seen = []

    def fake_run(qT, tT, qlen, tlen, mat, **kw):
        seen.append(kw["interpret"])
        Bp = tT.shape[1]
        z = jnp.zeros((Bp,), jnp.int32)
        return z, z, z, z

    monkeypatch.setattr(pallas_dp, "_run", fake_run)
    q = np.zeros((3, 5), np.int32)
    ln = np.full(3, 5, np.int32)
    mat = jnp.zeros((24, 24), jnp.int32)
    monkeypatch.setattr(pallas_dp, "INTERPRET", False)
    pallas_dp.fill_scores_traced(q, ln, q, ln, mat, 11.0, 2.0)
    monkeypatch.setattr(pallas_dp, "INTERPRET", True)
    pallas_dp.fill_scores_traced(q, ln, q, ln, mat, 11.0, 2.0)
    assert seen == [False, True]


# --- compile cache ----------------------------------------------------

_SHOW_CACHE = (
    "import jax, aligner_tpu.backend as b; "
    "print(jax.config.jax_compilation_cache_dir); "
    "print(b.configure_compile_cache())"
)


def _cache_dirs(env_value):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    out = subprocess.run([sys.executable, "-c", _SHOW_CACHE], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    return out.stdout.split()


def test_compile_cache_defaults_inside_checkout():
    """Without JAX_COMPILATION_CACHE_DIR the cache sits at one fixed path
    inside the checkout, and git ignores it."""
    jax_dir, ours = _cache_dirs(None)
    want = str(REPO / ".jax_cache")
    assert jax_dir == ours == want
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


def test_compile_cache_honours_env(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, that directory is the cache
    and the package sets no other."""
    jax_dir, ours = _cache_dirs(str(tmp_path))
    assert jax_dir == ours == str(tmp_path)


# --- chip_smoke.py without a GPU -----------------------------------------


def _run_smoke(script_dir, path_dirs, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PATH=os.pathsep.join(path_dirs))
    return subprocess.run(
        [sys.executable, str(script_dir / "chip_smoke.py")], env=env,
        capture_output=True, text=True, timeout=300, cwd=cwd,
    )


def _assert_refused(out):
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_without_gpu(tmp_path):
    """A fake nvidia-smi gets the script past its first check; JAX then
    reports the CPU and the script exits non-zero with no ok line."""
    fake = tmp_path / "nvidia-smi"
    fake.write_text("#!/bin/sh\necho 'Fake Card, 1.00 W'\n")
    fake.chmod(0o755)
    out = _run_smoke(REPO, [str(tmp_path), os.path.dirname(sys.executable),
                            "/usr/bin", "/bin"], REPO)
    _assert_refused(out)
    assert "no GPU" in out.stderr


def test_chip_smoke_fails_without_nvidia_smi(tmp_path):
    out = _run_smoke(REPO, [os.path.dirname(sys.executable)], REPO)
    _assert_refused(out)


def test_chip_smoke_fails_outside_checkout(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path, [os.path.dirname(sys.executable),
                                "/usr/bin", "/bin"], tmp_path)
    _assert_refused(out)
