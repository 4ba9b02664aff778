"""GPU batch kernel parity tests.

On the CPU the kernel runs in Pallas interpret mode (the
``pallas_interpret`` fixture); the ``gpu``-marked tests run it compiled
for the card (``ALIGNER_TEST_PLATFORM=gpu python -m pytest tests -m gpu``).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aligner_tpu import oracle
from aligner_tpu.matrices import blosum62
from aligner_tpu.ops import pallas_dp
from aligner_tpu.ops.pallas_dp import (
    fill_batch_pallas,
    fill_pwm_batch_pallas,
    matrix_operand,
)
from aligner_tpu.ops.scan_engine import fill_batch, fill_pwm_batch

pytestmark = pytest.mark.usefixtures("pallas_interpret")

DT = jnp.float64


def _random_batch(rng, B, Cmax, Rmax, vol=24, full=False):
    qs = np.zeros((B, Cmax), np.int32)
    ts = np.zeros((B, Rmax), np.int32)
    ql = np.full(B, Cmax, np.int32)
    tl = np.full(B, Rmax, np.int32)
    for b in range(B):
        if not full:
            ql[b] = rng.integers(1, Cmax + 1)
            tl[b] = rng.integers(1, Rmax + 1)
        qs[b, : ql[b]] = rng.integers(0, vol, ql[b])
        ts[b, : tl[b]] = rng.integers(0, vol, tl[b])
    return qs, ql, ts, tl


@pytest.mark.parametrize("mode", ["local", "global"])
def test_pallas_planes_match_oracle(rng, mode):
    M = blosum62()
    q, ql, t, tl = _random_batch(rng, 6, 9, 11)
    r = fill_batch_pallas(q, ql, t, tl, M, 11.0, 2.0, mode=mode, dtype=DT)
    dirs = np.asarray(r.dirs)
    assert r.plane is None  # keep_planes callers use the XLA engine
    fn = oracle.fill_local if mode == "local" else oracle.fill_global
    for b in range(6):
        a_o, d_o = fn(q[b, : ql[b]], t[b, : tl[b]], M, 11.0, 2.0)
        assert np.array_equal(d_o, dirs[b, : tl[b] + 1, : ql[b] + 1])
        if mode == "local":
            my, mx = oracle.argmax_first_rowmajor(a_o)
            assert (int(r.fy[b]), int(r.fx[b])) == (my, mx)
            assert float(r.fmax[b]) == a_o.max()
        assert float(r.end[b]) == a_o[tl[b], ql[b]]


def test_pallas_scores_only(rng):
    M = blosum62()
    q, ql, t, tl = _random_batch(rng, 6, 9, 11)
    r = fill_batch_pallas(
        q, ql, t, tl, M, 11.0, 2.0, mode="local", with_planes=False, dtype=DT
    )
    assert r.plane is None and r.dirs is None
    for b in range(6):
        a_o, _ = oracle.fill_local(q[b, : ql[b]], t[b, : tl[b]], M, 11.0, 2.0)
        assert float(r.fmax[b]) == a_o.max()


def test_pallas_pwm_shared_and_batched(rng):
    W = 7
    pwm = rng.integers(-1, 2, (4, W)).astype(np.float64)
    pwms = rng.integers(-1, 2, (6, 4, W)).astype(np.float64)
    q, ql, _, _ = _random_batch(rng, 6, 14, 14, vol=4)
    r = fill_pwm_batch_pallas(q, ql, pwm, 3.0, 1.0, dtype=DT)
    rb = fill_pwm_batch_pallas(q, ql, pwms, 3.0, 1.0, dtype=DT, with_planes=False)
    for b in range(6):
        a_o, d_o = oracle.fill_pwm(q[b, : ql[b]], pwm, 3.0, 1.0)
        assert float(r.fmax[b]) == a_o.max()
        assert np.array_equal(d_o, np.asarray(r.dirs)[b, : ql[b] + 1, :])
        a_b, _ = oracle.fill_pwm(q[b, : ql[b]], pwms[b], 3.0, 1.0)
        assert float(rb.fmax[b]) == a_b.max()


def test_pallas_batched_matrices(rng):
    M = blosum62()
    mats = np.stack([M + rng.integers(-2, 3, (24, 24)) for _ in range(5)]).astype(
        np.float64
    )
    q, ql, t, tl = _random_batch(rng, 5, 8, 8)
    r = fill_batch_pallas(q, ql, t, tl, mats, 7.0, 3.0, mode="local", dtype=DT)
    for b in range(5):
        a_o, d_o = oracle.fill_local(q[b, : ql[b]], t[b, : tl[b]], mats[b], 7.0, 3.0)
        assert np.array_equal(d_o, np.asarray(r.dirs)[b, : tl[b] + 1, : ql[b] + 1])
        assert float(r.fmax[b]) == a_o.max()


# --- the kernel against the XLA engine over every mode the callers use ---
_MATS = ("shared_int", "shared_float", "batched")
_CASES = [
    (mode, planes, argmax, mat, ragged)
    for mode, planes, argmax, mat, ragged in itertools.product(
        ("local", "global", "pwm"), (True, False), (True, False), _MATS,
        (True, False),
    )
    # direction planes always track the argmax (the walk starts there)
    if not (planes and not argmax)
]


@pytest.mark.parametrize("mode,planes,argmax,mat,ragged", _CASES)
def test_kernel_matches_scan_engine(rng, mode, planes, argmax, mat, ragged):
    B, C, R = 37, 13, 19  # B not a multiple of the block, R not of 8
    vol = 4 if mode == "pwm" else 24
    q, ql, t, tl = _random_batch(rng, B, C, R, vol=vol, full=not ragged)
    if mode == "pwm":
        base = rng.integers(-2, 3, (4, C)).astype(np.float64)
    else:
        base = np.asarray(blosum62(), np.float64)
    if mat == "shared_float":
        m = base + 0.25
    elif mat == "batched":
        m = np.stack([base + rng.integers(-1, 2, base.shape)
                      for _ in range(B)]).astype(np.float64)
    else:
        m = base
    d, e = (3.0, 1.0) if mode == "pwm" else (11.0, 2.0)
    if mode == "pwm":
        ref = fill_pwm_batch(t, tl, jnp.asarray(m), d, e,
                             with_planes=planes, dtype=DT)
        got = fill_pwm_batch_pallas(t, tl, m, d, e, with_planes=planes,
                                    dtype=DT, track_argmax=argmax)
    else:
        ref = fill_batch(q, ql, t, tl, jnp.asarray(m), d, e, mode=mode,
                         with_planes=planes, dtype=DT)
        got = fill_batch_pallas(q, ql, t, tl, m, d, e, mode=mode,
                                with_planes=planes, dtype=DT,
                                track_argmax=argmax)
    np.testing.assert_array_equal(np.asarray(got.fmax), np.asarray(ref.fmax))
    if argmax or mode == "global":
        for k in ("fy", "fx", "end"):
            np.testing.assert_array_equal(
                np.asarray(getattr(got, k)), np.asarray(getattr(ref, k))
            )
    if planes:
        np.testing.assert_array_equal(np.asarray(got.dirs),
                                      np.asarray(ref.dirs))


@pytest.mark.parametrize(
    "matrix,del_,ext,expect",
    [
        ("blosum", 11.0, 2.0, jnp.int32),
        ("blosum", 11.5, 2.0, jnp.float32),
        ("blosum", 11.0, 2.5, jnp.float32),
        ("half", 11.0, 2.0, jnp.float32),
        ("batched", 7.0, 3.0, jnp.int32),
    ],
)
def test_matrix_operand_dtype(rng, matrix, del_, ext, expect):
    """Integral matrix AND penalties → exact int32 kernel arithmetic;
    anything else keeps the requested float dtype."""
    M = np.asarray(blosum62(), np.float64)
    m = {"blosum": M, "half": M + 0.5,
         "batched": np.stack([M, M - 1])}[matrix]
    op = matrix_operand(m, jnp.float32, del_, ext)
    assert op.dtype == expect and op.shape == m.shape
    np.testing.assert_array_equal(np.asarray(op, np.float64), m)


@pytest.mark.parametrize("B", [1, 31, 32, 33, 70])
def test_kernel_batch_padding(rng, B):
    """Batches that are not a block multiple pad with zero-length
    problems that stay inert; outputs are sliced back to B."""
    q, ql, t, tl = _random_batch(rng, B, 9, 10)
    M = blosum62()
    ref = fill_batch(q, ql, t, tl, jnp.asarray(M, DT), 11.0, 2.0,
                     mode="local", with_planes=False, dtype=DT)
    got = fill_batch_pallas(q, ql, t, tl, M, 11.0, 2.0, mode="local",
                            with_planes=False, dtype=DT)
    assert np.asarray(got.fmax).shape == (B,)
    for k in ("fmax", "fy", "fx", "end"):
        np.testing.assert_array_equal(np.asarray(getattr(got, k)),
                                      np.asarray(getattr(ref, k)))


@pytest.mark.parametrize("R", [1, 7, 8, 9, 16, 23])
def test_dirs_from_packed_roundtrip(rng, R):
    """The problem-major packed words unpack to exactly the XLA
    engine's direction planes (row padding to the word multiple
    dropped, reference border directions restored)."""
    q, ql, t, tl = _random_batch(rng, 3, 6, R)
    M = blosum62()
    for mode in ("local", "global"):
        ref = fill_batch(q, ql, t, tl, jnp.asarray(M, DT), 11.0, 2.0,
                         mode=mode, dtype=DT)
        got = fill_batch_pallas(q, ql, t, tl, M, 11.0, 2.0, mode=mode,
                                dtype=DT)
        assert got.dirs.shape == (3, R + 1, 7)
        np.testing.assert_array_equal(got.dirs, np.asarray(ref.dirs))


def test_kernel_under_jit_and_while_loop(rng):
    """The traced entry points compose with jit and lax.while_loop (the
    fused population loop calls the kernel inside one)."""
    from aligner_tpu.ops.pallas_dp import fill_scores_traced

    q, ql, t, tl = _random_batch(rng, 8, 10, 10)
    M = jnp.asarray(np.asarray(blosum62(), np.int32))

    @jax.jit
    def twice(q, ql, t, tl):
        def body(c):
            i, acc = c
            f = fill_scores_traced(q, ql, t, tl, M, 11.0, 2.0, dtype=DT)[0]
            return i + 1, acc + f

        return jax.lax.while_loop(lambda c: c[0] < 2, body,
                                  (0, jnp.zeros(8, DT)))[1]

    ref = fill_batch(q, ql, t, tl, jnp.asarray(M, DT), 11.0, 2.0,
                     mode="local", with_planes=False, dtype=DT).fmax
    np.testing.assert_array_equal(np.asarray(twice(q, ql, t, tl)),
                                  2 * np.asarray(ref))


# --- compiled on the card ---------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["local", "global"])
def test_pallas_gpu_full_planes_match_scan_engine(gpu, rng, mode, monkeypatch):
    """Compiled kernel vs the XLA engine on the card, with planes."""
    monkeypatch.setattr(pallas_dp, "INTERPRET", False)
    M = blosum62()
    q, ql, t, tl = _random_batch(rng, 140, 33, 50)
    rp = fill_batch_pallas(q, ql, t, tl, M, 11.0, 2.0, mode=mode,
                           dtype=jnp.float32)
    rx = fill_batch(q, ql, t, tl, jnp.asarray(M, jnp.float32), 11.0, 2.0,
                    mode=mode, dtype=jnp.float32)
    np.testing.assert_array_equal(rp.dirs, np.asarray(rx.dirs))
    for k in ("fmax", "fy", "fx", "end"):
        np.testing.assert_array_equal(np.asarray(getattr(rp, k)),
                                      np.asarray(getattr(rx, k)))


@pytest.mark.gpu
def test_pallas_gpu_large_batch_matches_scan_engine(gpu, rng, monkeypatch):
    monkeypatch.setattr(pallas_dp, "INTERPRET", False)
    M = blosum62()
    q, ql, t, tl = _random_batch(rng, 2048, 64, 64)
    rp = fill_batch_pallas(q, ql, t, tl, M, 11.0, 2.0, mode="local",
                           with_planes=False, dtype=jnp.float32)
    rx = fill_batch(q, ql, t, tl, jnp.asarray(M, jnp.float32), 11.0, 2.0,
                    mode="local", with_planes=False, dtype=jnp.float32)
    for k in ("fmax", "fy", "fx", "end"):
        np.testing.assert_array_equal(np.asarray(getattr(rp, k)),
                                      np.asarray(getattr(rx, k)))


@pytest.mark.gpu
def test_pallas_gpu_pwm_and_batched_matrices(gpu, rng, monkeypatch):
    monkeypatch.setattr(pallas_dp, "INTERPRET", False)
    W = 12
    pwms = rng.normal(size=(256, 4, W))
    q, ql, _, _ = _random_batch(rng, 256, 40, 40, vol=4)
    rp = fill_pwm_batch_pallas(q, ql, pwms, 3.0, 1.0, dtype=jnp.float32)
    rx = fill_pwm_batch(q, ql, jnp.asarray(pwms, jnp.float32), 3.0, 1.0,
                        dtype=jnp.float32)
    np.testing.assert_array_equal(rp.dirs, np.asarray(rx.dirs))
    for k in ("fmax", "fy", "fx", "end"):
        np.testing.assert_array_equal(np.asarray(getattr(rp, k)),
                                      np.asarray(getattr(rx, k)))
    M = blosum62()
    mats = np.stack([M * (1 + 0.01 * i) for i in range(256)])
    q, ql, t, tl = _random_batch(rng, 256, 30, 30)
    rp = fill_batch_pallas(q, ql, t, tl, mats, 7.0, 3.0, mode="local",
                           dtype=jnp.float32)
    rx = fill_batch(q, ql, t, tl, jnp.asarray(mats, jnp.float32), 7.0, 3.0,
                    mode="local", dtype=jnp.float32)
    np.testing.assert_array_equal(rp.dirs, np.asarray(rx.dirs))
    np.testing.assert_array_equal(np.asarray(rp.fmax), np.asarray(rx.fmax))
