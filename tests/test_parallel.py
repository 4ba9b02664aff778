"""Mesh-sharded steps on the 8-virtual-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aligner_tpu import oracle
from aligner_tpu.matrices import blosum62, random_pwm
from aligner_tpu.parallel import (
    make_mesh,
    matrix_population_step,
    sharded_scores,
    window_scan_step,
)

# the GPU kernel ("pallas") runs in Pallas interpret mode on the CPU
pytestmark = pytest.mark.usefixtures("pallas_interpret")

DT = jnp.float64


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return make_mesh(8)


def test_mesh_shape(mesh):
    assert mesh.shape["data"] * mesh.shape["matrix"] == 8
    assert mesh.shape["data"] >= mesh.shape["matrix"]


def test_sharded_scores_match_oracle(mesh, rng):
    M = blosum62()
    B, L = 16, 12
    q = rng.integers(0, 24, (B, L)).astype(np.int32)
    t = rng.integers(0, 24, (B, L)).astype(np.int32)
    ql = np.full(B, L, np.int32)
    tl = np.full(B, L, np.int32)
    fmax, fy, fx, end = sharded_scores(mesh, q, ql, t, tl, M, 11.0, 2.0, dtype=DT)
    for b in range(B):
        a, _ = oracle.fill_local(q[b], t[b], M, 11.0, 2.0)
        assert float(fmax[b]) == a.max()


def test_window_scan_step_stats(mesh, rng):
    B, L, W = 16, 20, 8
    pwm = random_pwm(W, rng)
    ws = rng.integers(0, 4, (B, L)).astype(np.int32)
    wl = np.full(B, L, np.int32)
    scores, z, mean, std = window_scan_step(mesh, ws, wl, pwm, 3.0, 1.0, dtype=DT)
    s = np.asarray(scores)
    assert np.isclose(float(mean), s.mean())
    assert np.isclose(float(std), s.std())
    assert np.allclose(np.asarray(z), (s - s.mean()) / max(s.std(), 1e-300))
    for b in range(3):
        a, _ = oracle.fill_pwm(ws[b], pwm, 3.0, 1.0)
        assert float(scores[b]) == a.max()


def test_matrix_population_best(mesh, rng):
    M = blosum62()
    Bq, L, nM = 4, 10, 6
    q = rng.integers(0, 24, (Bq, L)).astype(np.int32)
    t = rng.integers(0, 24, (Bq, L)).astype(np.int32)
    ql = np.full(Bq, L, np.int32)
    tl = np.full(Bq, L, np.int32)
    mats = np.stack([M + rng.integers(-2, 3, (24, 24)) for _ in range(nM)]).astype(
        np.float64
    )
    best, win = matrix_population_step(mesh, q, ql, t, tl, mats, 7.0, 3.0, dtype=DT)
    for b in range(Bq):
        fs = [oracle.fill_local(q[b], t[b], mats[m], 7.0, 3.0)[0].max() for m in range(nM)]
        assert float(best[b]) == max(fs)
        assert fs[int(win[b])] == max(fs)


def test_sharded_scores_pallas_engine(mesh, rng):
    """The pallas kernel per device inside shard_map (interpret on CPU)."""
    from aligner_tpu.matrices import blosum62
    from aligner_tpu import oracle

    M = blosum62()
    B, L = 16, 16
    q = rng.integers(0, 24, (B, L)).astype(np.int32)
    t = rng.integers(0, 24, (B, L)).astype(np.int32)
    ql = np.full(B, L, np.int32)
    tl = np.full(B, L, np.int32)
    fmax, fy, fx, end = sharded_scores(
        mesh, q, ql, t, tl, M, 11.0, 2.0, dtype=jnp.float64, engine="pallas"
    )
    for b in range(B):
        a, _ = oracle.fill_local(q[b], t[b], M, 11.0, 2.0)
        assert float(fmax[b]) == a.max()


def test_window_scan_pallas_engine(mesh, rng):
    from aligner_tpu.matrices import random_pwm
    from aligner_tpu import oracle

    B, L, W = 16, 24, 8
    pwm = random_pwm(W, rng)
    ws = rng.integers(0, 4, (B, L)).astype(np.int32)
    wl = np.full(B, L, np.int32)
    scores, z, mean, std = window_scan_step(
        mesh, ws, wl, pwm, 3.0, 1.0, dtype=jnp.float64, engine="pallas"
    )
    for b in range(4):
        a, _ = oracle.fill_pwm(ws[b], pwm, 3.0, 1.0)
        assert float(scores[b]) == a.max()
