"""On-device traceback walk vs the host walkers, bit for bit.

batch_align / batch_align_pwm default to the device walk
(ops/device_walk.py): direction planes stay in HBM and only 2-bit step
streams transfer.  ALIGNER_DEVICE_WALK=0 restores the host walks
(native.traceback_batch / the NumPy walkers).  Both must produce
identical alignments — same semantics as simple/mod.rs:99-127 and
pwm/mod.rs:81-103.
"""

import numpy as np
import pytest

import aligner_tpu as at
from aligner_tpu.align import batch_align, batch_align_pwm

# the GPU kernel ("pallas") runs in Pallas interpret mode on the CPU
pytestmark = pytest.mark.usefixtures("pallas_interpret")


def _rand_batch(rng, n, lo=1, hi=60, v=24, related=False):
    qs = [rng.integers(0, v, rng.integers(lo, hi)).astype(np.int8)
          for _ in range(n)]
    if related:
        # mutated copies: local mode always has a positive-scoring cell
        ts = []
        for q in qs:
            t = q.copy()
            if len(t) > 1:  # keep t[0] == q[0]: a positive diagonal cell
                k = max(1, len(t) // 8)
                t[rng.integers(1, len(t), k)] = rng.integers(0, v, k)
            ts.append(t)
    else:
        ts = [rng.integers(0, v, rng.integers(lo, hi)).astype(np.int8)
              for _ in range(n)]
    return qs, ts


def _run_both(monkeypatch, fn, *args, **kw):
    monkeypatch.setenv("ALIGNER_DEVICE_WALK", "1")
    dev = fn(*args, **kw)
    monkeypatch.setenv("ALIGNER_DEVICE_WALK", "0")
    host = fn(*args, **kw)
    return dev, host


def _assert_pairs_equal(dev, host):
    assert len(dev) == len(host)
    for a, b in zip(dev, host):
        if b is None:
            assert a is None
            continue
        assert np.array_equal(a.alignment.query, b.alignment.query)
        assert np.array_equal(a.alignment.target, b.alignment.target)
        assert a.alignment.coords == b.alignment.coords
        assert a.alignment.f == b.alignment.f


@pytest.mark.parametrize("mode", ["global", "local"])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_device_walk_matches_host(rng, monkeypatch, mode, backend):
    m = at.blosum62()
    qs, ts = _rand_batch(rng, 17, related=(mode == 'local'))
    dev, host = _run_both(
        monkeypatch, batch_align, qs, ts, m, 11.0, 2.0,
        mode=mode, backend=backend, with_alignments=True,
    )
    _assert_pairs_equal(dev, host)


@pytest.mark.parametrize("mode", ["global", "local"])
def test_device_walk_skip_and_pad(rng, monkeypatch, mode):
    m = at.blosum62()
    qs, ts = _rand_batch(rng, 9, related=(mode == 'local'))
    skip = np.zeros(9, bool)
    skip[[1, 4, 7]] = True
    dev, host = _run_both(
        monkeypatch, batch_align, qs, ts, m, 11.0, 2.0,
        mode=mode, backend="xla", with_alignments=True,
        pad_to=16, skip=skip,
    )
    _assert_pairs_equal(dev, host)
    for i in (1, 4, 7):
        assert dev[i] is None


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_device_walk_pwm_matches_host(rng, monkeypatch, backend):
    pwm = rng.normal(2.0, 3.0, (4, 12))
    qs = [rng.integers(0, 4, rng.integers(3, 40)).astype(np.int8)
          for _ in range(13)]
    monkeypatch.setenv("ALIGNER_DEVICE_WALK", "1")
    dev = batch_align_pwm(qs, pwm, 3.0, 1.0, backend=backend,
                          with_alignments=True)
    monkeypatch.setenv("ALIGNER_DEVICE_WALK", "0")
    host = batch_align_pwm(qs, pwm, 3.0, 1.0, backend=backend,
                           with_alignments=True)
    assert len(dev) == len(host)
    for a, b in zip(dev, host):
        assert np.array_equal(a.alignment.numbered, b.alignment.numbered)
        assert np.array_equal(a.alignment.query, b.alignment.query)
        assert a.alignment.coords == b.alignment.coords
        assert a.alignment.f == b.alignment.f


def test_device_walk_empty_local_returns_none(monkeypatch):
    """A local problem with no positive-scoring cell yields None for
    that entry (not a batch-wide ResultIsEmpty), identically on the
    device and host walk paths."""
    m = np.full((24, 24), -5.0)
    qs = [np.arange(8, dtype=np.int8)]
    ts = [np.arange(8, dtype=np.int8)[::-1].copy()]
    for flag in ("1", "0"):
        monkeypatch.setenv("ALIGNER_DEVICE_WALK", flag)
        out = batch_align(qs, ts, m, 11.0, 2.0, mode="local",
                          backend="xla", with_alignments=True)
        assert out == [None]


def test_device_walk_long_pairs(rng, monkeypatch):
    """Walk length S = R + C + 1 covers the worst case (all-gap corner
    walks) on asymmetric shapes."""
    m = at.blosum62()
    qs = [rng.integers(0, 24, 300).astype(np.int8),
          rng.integers(0, 24, 3).astype(np.int8)]
    ts = [rng.integers(0, 24, 5).astype(np.int8),
          rng.integers(0, 24, 290).astype(np.int8)]
    dev, host = _run_both(
        monkeypatch, batch_align, qs, ts, m, 11.0, 2.0,
        mode="global", backend="xla", with_alignments=True,
    )
    _assert_pairs_equal(dev, host)


@pytest.mark.gpu
def test_device_walk_hardware_spot(gpu, rng, monkeypatch):
    """On the card (compiled kernel + packed-word gathers, not
    interpret mode): device walk vs host walk bit-equal for both modes,
    plus the PWM walk (CLAUDE.md engine-change invariant)."""
    from aligner_tpu.ops import pallas_dp

    monkeypatch.setattr(pallas_dp, "INTERPRET", False)
    m = at.blosum62()
    for mode in ("global", "local"):
        qs, ts = _rand_batch(rng, 64, lo=20, hi=90,
                             related=(mode == "local"))
        dev, host = _run_both(
            monkeypatch, batch_align, qs, ts, m, 11.0, 2.0,
            mode=mode, backend="pallas", with_alignments=True,
        )
        _assert_pairs_equal(dev, host)
    pwm = rng.integers(-3, 9, (4, 12)).astype(np.float64)
    qs4 = [rng.integers(0, 4, rng.integers(8, 40)).astype(np.int8)
           for _ in range(64)]
    monkeypatch.setenv("ALIGNER_DEVICE_WALK", "1")
    dev = batch_align_pwm(qs4, pwm, 3.0, 1.0, backend="pallas",
                          with_alignments=True)
    monkeypatch.setenv("ALIGNER_DEVICE_WALK", "0")
    hst = batch_align_pwm(qs4, pwm, 3.0, 1.0, backend="pallas",
                          with_alignments=True)
    for a, b in zip(dev, hst):
        assert np.array_equal(a.alignment.query, b.alignment.query)
        assert np.array_equal(a.alignment.numbered, b.alignment.numbered)
        assert a.alignment.coords == b.alignment.coords
        assert a.alignment.f == b.alignment.f


def test_decode_batch_matches_per_problem(rng):
    """decode_pair_batch / decode_pwm_batch (the vectorized decode tail)
    are bit-identical to the per-problem decoders on random step
    streams."""
    from aligner_tpu.ops.device_walk import (
        decode_pair, decode_pair_batch, decode_pwm, decode_pwm_batch,
    )

    B, S, L = 13, 40, 48
    steps = rng.integers(0, 4, (S, B)).astype(np.uint8)
    # force every stream to terminate (BEG tail) and count real steps
    lens = rng.integers(0, S, B).astype(np.int32)
    sy = rng.integers(np.maximum(lens, 1), L + 1).astype(np.int32)
    sx = rng.integers(np.maximum(lens, 1), L + 1).astype(np.int32)
    q = rng.integers(0, 24, (B, L)).astype(np.int32)
    t = rng.integers(0, 24, (B, L)).astype(np.int32)
    qa_all, ta_all = decode_pair_batch(steps, lens, sy, sx, q, t)
    for b in range(B):
        qa, ta = decode_pair(steps, lens, sy, sx, b, q[b], t[b])
        assert np.array_equal(qa_all[b], qa)
        assert np.array_equal(ta_all[b], ta)
    qa_all, num_all = decode_pwm_batch(steps, lens, sy, sx, q)
    for b in range(B):
        qa, num = decode_pwm(steps, lens, sy, sx, b, q[b])
        assert np.array_equal(qa_all[b], qa)
        assert np.array_equal(num_all[b], num)


def test_batch_align_pwm_pad_and_skip(rng, monkeypatch):
    """batch_align_pwm pad_to/skip: padded problems are free and not
    returned; skipped problems return None (score 0 in scores-only
    mode); survivors are bit-equal to an unpadded run — the repeat
    engine's survivor-bucket contract (engine/calc.rs:88-147)."""
    pwm = rng.integers(-3, 9, (4, 12)).astype(np.float64)
    qs4 = [rng.integers(0, 4, rng.integers(8, 40)).astype(np.int8)
           for _ in range(5)]
    for flag in ("1", "0"):
        monkeypatch.setenv("ALIGNER_DEVICE_WALK", flag)
        plain = batch_align_pwm(qs4, pwm, 3.0, 1.0, backend="xla",
                                with_alignments=True)
        skip = np.array([False, True, False, False, True])
        padded = batch_align_pwm(qs4, pwm, 3.0, 1.0, backend="xla",
                                 with_alignments=True, pad_to=8, skip=skip)
        assert len(padded) == 5
        for a, b, s in zip(padded, plain, skip):
            if s:
                assert a is None
                continue
            assert np.array_equal(a.alignment.query, b.alignment.query)
            assert np.array_equal(a.alignment.numbered, b.alignment.numbered)
            assert a.alignment.coords == b.alignment.coords
            assert a.alignment.f == b.alignment.f
    scores = batch_align_pwm(qs4, pwm, 3.0, 1.0, backend="xla",
                             with_alignments=False, pad_to=8, skip=skip)
    ref = batch_align_pwm(qs4, pwm, 3.0, 1.0, backend="xla",
                          with_alignments=False)
    assert scores.fmax.shape == (5,)
    assert np.array_equal(scores.fmax[~skip], ref.fmax[~skip])
    assert np.all(scores.fmax[skip] == 0)
