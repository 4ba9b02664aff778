"""Memory-bounded streaming LOCAL engine (native checkpoint-and-replay).

The local fill is serial by the reference's penalty-state chaining
(simple/mod.rs:185-205; SURVEY §2.3.3), so huge single LOCAL pairs get a
native scalar streaming engine instead of a wavefront: O(tn) live state,
column checkpoints, block replays for the walk.  Everything here pins it
bit-identical to the materializing host engine."""

import numpy as np
import pytest

import aligner_tpu as at
from aligner_tpu import host, native
from aligner_tpu.align import align_local, local_max_score
from aligner_tpu.errors import ResultIsEmpty, ValidationError

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native runtime unavailable"
)


@pytest.fixture
def rng():
    return np.random.default_rng(7)


M62 = np.asarray(at.blosum62())


def _assert_stream_matches_host(q, t, M, del_, ext, cb):
    ref = host.align_local(q, t, M, del_, ext)
    f, qa, ta, coords = native.align_local_stream(q, t, M, del_, ext, cb=cb)
    assert f == ref.f
    np.testing.assert_array_equal(qa, ref.query_aligned)
    np.testing.assert_array_equal(ta, ref.target_aligned)
    assert coords == ref.coords


@pytest.mark.parametrize("cb", [1, 3, 16, 10_000])
def test_stream_parity_random(rng, cb):
    """Bit-equal strings/coords/f across checkpoint cadences, including
    cb=1 (every column a block boundary — maximal pen-state handoffs)
    and cb larger than the pair (single block)."""
    for qn, tn in [(50, 37), (128, 211), (300, 190)]:
        q = rng.integers(0, 24, qn).astype(np.int8)
        t = rng.integers(0, 24, tn).astype(np.int8)
        _assert_stream_matches_host(q, t, M62, 11.0, 2.0, cb)


def test_stream_parity_ties(rng):
    """Duplicate maxima: repeated motifs make the plane maximum appear
    at several cells; the streaming online argmax must pick the same
    first-in-row-major cell the materialized argmax does."""
    motif = rng.integers(0, 24, 25).astype(np.int8)
    q = np.concatenate([motif, rng.integers(0, 24, 30).astype(np.int8),
                        motif, motif])
    t = np.concatenate([rng.integers(0, 24, 10).astype(np.int8), motif,
                        rng.integers(0, 24, 5).astype(np.int8), motif])
    ref = host.align_local(q, t, M62, 11.0, 2.0)
    f, qa, ta, coords = native.align_local_stream(q, t, M62, 11.0, 2.0, cb=13)
    assert f == ref.f and coords == ref.coords
    np.testing.assert_array_equal(qa, ref.query_aligned)
    np.testing.assert_array_equal(ta, ref.target_aligned)
    fm, my, mx = native.local_max_score_stream(q, t, M62, 11.0, 2.0)
    iy, ix = native.argmax_first_rowmajor(ref.score)
    assert (fm, my, mx) == (float(ref.score[iy, ix]), iy, ix)


def test_stream_no_positive_cell(rng):
    q = rng.integers(0, 24, 40).astype(np.int8)
    t = rng.integers(0, 24, 30).astype(np.int8)
    with pytest.raises(ResultIsEmpty):
        native.align_local_stream(q, t, np.full((24, 24), -1.0), 11.0, 2.0)
    # forward-only variant reports the border argmax instead of raising
    f, my, mx = native.local_max_score_stream(
        q, t, np.full((24, 24), -1.0), 11.0, 2.0
    )
    assert (f, my, mx) == (0.0, 0, 0)


def test_stream_pen_state_across_blocks(rng):
    """del != ext makes the walk sensitive to the penalty state entering
    each replayed block; zero-floored regions (Beginning cells) reset
    the penalty to del mid-plane, so a harsh matrix exercises both
    states across block boundaries."""
    M = np.where(np.eye(24, dtype=bool), 9.0, -7.0)
    q = rng.integers(0, 24, 220).astype(np.int8)
    t = rng.integers(0, 24, 180).astype(np.int8)
    for cb in (2, 7, 32):
        _assert_stream_matches_host(q, t, M, 12.0, 1.0, cb)


def test_align_local_explicit_stream_backend(rng):
    q = rng.integers(0, 24, 120).astype(np.int8)
    t = rng.integers(0, 24, 90).astype(np.int8)
    a = align_local(q, t, M62, 11.0, 2.0, backend="stream")
    b = align_local(q, t, M62, 11.0, 2.0, backend="oracle")
    assert a.alignment.f == b.alignment.f
    np.testing.assert_array_equal(a.alignment.query, b.alignment.query)
    np.testing.assert_array_equal(a.alignment.target, b.alignment.target)
    assert a.alignment.coords == b.alignment.coords
    with pytest.raises(ValidationError, match="keep_planes"):
        align_local(q, t, M62, 11.0, 2.0, backend="stream",
                    keep_planes=True)


def test_huge_local_routes_to_stream_without_plane(rng, monkeypatch):
    """A local pair past the direct-plane budget must stream — no
    engine may allocate an O(R*C) plane (the LOCAL sibling of the
    align_global huge-pair guard)."""
    from aligner_tpu import align as align_mod
    from aligner_tpu.parallel import wavefront_sp

    monkeypatch.setattr(wavefront_sp, "DIRECT_PLANE_CELLS", 1000)
    called = []
    real = native.align_local_stream

    def spy(*a, **kw):
        called.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(native, "align_local_stream", spy)

    def forbid(*a, **kw):  # any batched fill would materialize planes
        raise AssertionError("huge local pair fell through to a plane")

    monkeypatch.setattr(align_mod, "_fill", forbid)
    q = rng.integers(0, 24, 60).astype(np.int8)
    t = rng.integers(0, 24, 50).astype(np.int8)
    a = align_local(q, t, M62, 11.0, 2.0)
    assert called
    b = host.align_local(q, t, M62, 11.0, 2.0)
    assert a.alignment.f == b.f


def test_local_max_score_api(rng):
    q = rng.integers(0, 24, 140).astype(np.int8)
    t = rng.integers(0, 24, 170).astype(np.int8)
    ref = host.align_local(q, t, M62, 11.0, 2.0)
    f, (my, mx) = local_max_score(q, t, M62, 11.0, 2.0)
    iy, ix = native.argmax_first_rowmajor(ref.score)
    assert f == float(ref.score[iy, ix])
    assert (my, mx) == (iy, ix)


def test_default_stream_cb_balance():
    cb = native.default_stream_cb(200_000)
    assert 256 <= cb <= 65536
    # memory terms within 4x of each other at the chosen cadence
    qn, tn = 200_000, 1
    ck = (qn / cb) * 8.0
    replay = float(cb)
    assert max(ck, replay) / min(ck, replay) < 4.0
