"""Cross-device sequence-parallel wavefront (parallel/wavefront_sp.py):
bit-parity with the oracle on one device and on the 8-virtual-device mesh.

This is the SURVEY §7a capability — one huge global pair tiled across
devices with boundary halo exchange over the mesh (ppermute pipeline);
on one device the same program is the huge-pair route of align_global.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

import aligner_tpu as at
from aligner_tpu import host
from aligner_tpu.parallel.wavefront_sp import (
    range_ok,
    sharded_global_align,
    sharded_global_end_score,
)


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()).reshape(-1), ("data",))


def _mesh(n_dev):
    return Mesh(np.array(jax.devices()[:n_dev]), ("data",))


@pytest.mark.parametrize("n_dev", [1, 8])
def test_parity_vs_oracle(rng, n_dev):
    M = np.asarray(at.blosum62())
    for C, R in [(1000, 700), (333, 190), (1024, 257)]:
        q = rng.integers(0, 24, C).astype(np.int8)
        t = rng.integers(0, 24, R).astype(np.int8)
        ref = host.align_global(q, t, M, 11.0, 2.0)
        end = sharded_global_end_score(_mesh(n_dev), q, t, M, 11.0, 2.0,
                                       tr=64)
        assert end == ref.score[R, C]


def test_degenerate_shapes(mesh, rng):
    """Narrower than the device count (idle devices), single row-block,
    and block-boundary-straddling shapes."""
    M = np.asarray(at.blosum62())
    for C, R in [(7, 500), (64, 64), (129, 65), (8, 8)]:
        q = rng.integers(0, 24, C).astype(np.int8)
        t = rng.integers(0, 24, R).astype(np.int8)
        ref = host.align_global(q, t, M, 7.0, 3.0)
        end = sharded_global_end_score(mesh, q, t, M, 7.0, 3.0, tr=32)
        assert end == ref.score[R, C]


def test_matches_single_chip_wavefront(mesh, rng):
    """The 8-device pipeline and the one-device route agree."""
    M = np.asarray(at.blosum62())
    q = rng.integers(0, 24, 300).astype(np.int8)
    t = rng.integers(0, 24, 450).astype(np.int8)
    end_sp = sharded_global_end_score(mesh, q, t, M, 11.0, 2.0)
    end_1 = sharded_global_end_score(_mesh(1), q, t, M, 11.0, 2.0)
    assert end_sp == end_1


def test_non_integral_rejected(mesh):
    with pytest.raises(ValueError):
        sharded_global_end_score(
            mesh, np.zeros(8, np.int8), np.zeros(8, np.int8),
            np.full((24, 24), 0.5), 11.0, 2.0,
        )


@pytest.mark.parametrize("n_dev", [1, 8])
def test_sharded_align_matches_oracle(rng, n_dev):
    """Exact ALIGNMENTS: the checkpoint-and-replay traceback over the
    pipeline is bit-equal to the oracle — strings, coords, and end
    score — on tile-straddling shapes."""
    M = np.asarray(at.blosum62())
    # shapes chosen to straddle row-block (tb), column-block (Cb), and
    # checkpoint boundaries, incl. a pair whose path crosses devices
    for C, R in [(1000, 700), (333, 190), (129, 257), (64, 64)]:
        q = rng.integers(0, 24, C).astype(np.int8)
        t = rng.integers(0, 24, R).astype(np.int8)
        ref = host.align_global(q, t, M, 11.0, 2.0)
        end, qa, ta, coords = sharded_global_align(
            _mesh(n_dev), q, t, M, 11.0, 2.0, tr=32, tb_rows=64
        )
        assert end == ref.score[R, C]
        np.testing.assert_array_equal(qa, ref.query_aligned)
        np.testing.assert_array_equal(ta, ref.target_aligned)
        assert coords == ((1, C), (1, R))


def test_sharded_align_degenerate_shapes(mesh, rng):
    """Narrower than the device count (fully idle devices) and
    single-block pairs still produce exact alignments."""
    M = np.asarray(at.blosum62())
    for C, R in [(7, 500), (8, 8), (500, 30)]:
        q = rng.integers(0, 24, C).astype(np.int8)
        t = rng.integers(0, 24, R).astype(np.int8)
        ref = host.align_global(q, t, M, 7.0, 3.0)
        end, qa, ta, _ = sharded_global_align(
            mesh, q, t, M, 7.0, 3.0, tr=32, tb_rows=32
        )
        assert end == ref.score[R, C]
        np.testing.assert_array_equal(qa, ref.query_aligned)
        np.testing.assert_array_equal(ta, ref.target_aligned)


def test_sharded_align_matches_single_chip_chunked(mesh, rng):
    """Cross-path agreement: the 8-device traceback and the one-device
    traceback (other tile sizes) give identical strings."""
    M = np.asarray(at.blosum62())
    q = rng.integers(0, 24, 300).astype(np.int8)
    t = rng.integers(0, 24, 450).astype(np.int8)
    e1, qa1, ta1, c1 = sharded_global_align(mesh, q, t, M, 11.0, 2.0,
                                            tr=64, tb_rows=128)
    e2, qa2, ta2, c2 = sharded_global_align(_mesh(1), q, t, M, 11.0, 2.0,
                                            tr=16, tb_rows=128)
    assert e1 == e2 and c1 == c2
    np.testing.assert_array_equal(qa1, qa2)
    np.testing.assert_array_equal(ta1, ta2)


def test_range_guard_rejects_overflow(mesh):
    """int32-exactness guard: absurdly long pairs whose scores could
    wrap are refused, not silently corrupted."""
    M = np.asarray(at.blosum62())
    assert range_ok(1000, 1000, 11.0, 2.0)
    assert not range_ok(1000, 2**30 // 11, 11.0, 2.0)
    q = np.zeros(8, np.int8)
    # zero-copy huge target: the guard reads only len(t), and raises
    # before any per-element work touches the array
    t_huge = np.broadcast_to(np.int8(0), (2**30 // 11,))
    with pytest.raises(ValueError, match="int32"):
        sharded_global_align(mesh, q, t_huge, M, 11.0, 2.0)


def test_wide_entry_matrix_exact(mesh, rng):
    """Integral matrices beyond int8 are exact (int32 arithmetic)."""
    M = rng.integers(-200, 200, (24, 24)).astype(np.float64)
    q = rng.integers(0, 24, 300).astype(np.int8)
    t = rng.integers(0, 24, 200).astype(np.int8)
    ref = host.align_global(q, t, M, 11.0, 2.0)
    end = sharded_global_end_score(mesh, q, t, M, 11.0, 2.0)
    assert end == ref.score[200, 300]
    end, qa, ta, _ = sharded_global_align(mesh, q, t, M, 11.0, 2.0, tr=32,
                                          tb_rows=64)
    assert end == ref.score[200, 300]
    np.testing.assert_array_equal(qa, ref.query_aligned)
    np.testing.assert_array_equal(ta, ref.target_aligned)


def test_oversized_rejection_is_o1(mesh, monkeypatch):
    """Validation precedes operand conversion: rejecting an oversized
    pair must not first materialize an int32 copy of it (review r3 #9)."""
    import aligner_tpu.parallel.wavefront_sp as wavefront_sp

    M = np.asarray(at.blosum62())
    called = []
    real_asarray = np.asarray

    def spy(a, *args, **kw):
        if getattr(a, "nbytes", 0) > 2**20:
            called.append(a.shape)
        return real_asarray(a, *args, **kw)

    monkeypatch.setattr(wavefront_sp.np, "asarray", spy)
    t_huge = np.broadcast_to(np.int8(0), (2**30 // 11,))
    with pytest.raises(ValueError, match="int32"):
        sharded_global_align(mesh, np.zeros(8, np.int8), t_huge, M,
                             11.0, 2.0)
    assert not called


@pytest.mark.parametrize("n_dev", [1, 8])
def test_compile_bucket_reuse_sharded(rng, n_dev):
    """Distinct real lengths inside one padded bucket (Cb columns ×
    J row-blocks) reuse the SAME cached pipeline — the lengths ride in
    as a replicated runtime operand, so no rebuild and no retrace."""
    from aligner_tpu.parallel import wavefront_sp

    M = np.asarray(at.blosum62())
    mesh = _mesh(n_dev)
    size0 = None
    # both pairs land in the Cb/J bucket of (1000, 700) at tr=64
    for C, R in [(1000, 700), (999, 660)]:
        q = rng.integers(0, 24, C).astype(np.int8)
        t = rng.integers(0, 24, R).astype(np.int8)
        ref = host.align_global(q, t, M, 11.0, 2.0)
        end = sharded_global_end_score(mesh, q, t, M, 11.0, 2.0, tr=64)
        assert end == ref.score[R, C]
        size = wavefront_sp._build_pipeline.cache_info().currsize
        if size0 is None:
            size0 = size
    assert size == size0  # the second pair added no pipeline build


@pytest.mark.parametrize("n_dev", [1, 8])
def test_sharded_align_device_walk_matches_host_walk(rng, n_dev, monkeypatch):
    """The fused on-device tile replay+walk (default) is bit-identical
    to the host per-cell walk over downloaded tiles, including
    tile-boundary crossings in both axes."""
    M = np.asarray(at.blosum62())
    for C, R in [(300, 150), (128 * 8, 100), (70, 260)]:
        q = rng.integers(0, 24, C).astype(np.int8)
        t = rng.integers(0, 24, R).astype(np.int8)
        monkeypatch.setenv("ALIGNER_DEVICE_WALK", "1")
        dev = sharded_global_align(_mesh(n_dev), q, t, M, 11.0, 2.0, tr=32,
                                   tb_rows=64)
        monkeypatch.setenv("ALIGNER_DEVICE_WALK", "0")
        hst = sharded_global_align(_mesh(n_dev), q, t, M, 11.0, 2.0, tr=32,
                                   tb_rows=64)
        assert dev[0] == hst[0]
        np.testing.assert_array_equal(dev[1], hst[1])
        np.testing.assert_array_equal(dev[2], hst[2])
        assert dev[3] == hst[3]


# --- align_global's huge-pair route (the pipeline on the local devices)


def _ref_matrix(kind, rng):
    M = np.asarray(at.blosum62(), np.float64)
    if kind == "int16":
        return rng.integers(-300, 300, (24, 24)).astype(np.float64)
    return M


@pytest.mark.parametrize(
    "C,R,matrix,del_,ext",
    [
        (257, 131, "blosum", 11.0, 2.0),  # ragged tails vs tr/tb
        (1, 90, "blosum", 11.0, 2.0),  # one column: far corner row 0
        (90, 1, "blosum", 11.0, 2.0),  # one row: far corner column 0
        (513, 129, "blosum", 7.0, 3.0),
        (200, 300, "int16", 11.0, 2.0),  # entries past int8
        (150, 150, "blosum", 1.0, 1.0),
    ],
)
def test_huge_global_route_matches_host(rng, monkeypatch, C, R, matrix,
                                        del_, ext):
    """With the direct-plane budget lowered, align_global and
    global_end_score route the pair through the pipeline on the local
    devices and return the host engine's end score and strings."""
    from aligner_tpu import align as align_mod
    from aligner_tpu.parallel import wavefront_sp

    monkeypatch.setattr(wavefront_sp, "DIRECT_PLANE_CELLS", 64)
    monkeypatch.setattr(
        align_mod, "_fill",
        lambda *a, **k: pytest.fail("huge pair fell through to a plane"),
    )
    M = _ref_matrix(matrix, rng)
    q = rng.integers(0, 24, C).astype(np.int8)
    t = rng.integers(0, 24, R).astype(np.int8)
    ref = host.align_global(q, t, M, del_, ext)
    got = at.align_global(q, t, M, del_, ext)
    np.testing.assert_array_equal(got.alignment.query,
                                  ref.query_aligned)
    np.testing.assert_array_equal(got.alignment.target,
                                  ref.target_aligned)
    assert got.alignment.coords == ((1, C), (1, R))
    assert at.global_end_score(q, t, M, del_, ext) == ref.score[R, C]


def test_huge_global_route_refuses_int32_overflow(monkeypatch):
    """Past the int32-exact range the huge route refuses instead of
    wrapping (and no plane engine is tried)."""
    from aligner_tpu.parallel import wavefront_sp

    monkeypatch.setattr(wavefront_sp, "range_ok", lambda *a: False)
    q = np.zeros(30_000, np.int8)
    with pytest.raises(at.ValidationError, match="int32|plane"):
        at.align_global(q, q, at.blosum62(), 11.0, 2.0)
    with pytest.raises(at.ValidationError, match="int32|integral"):
        at.global_end_score(q[:10], q[:10], at.blosum62(), 11.0, 2.0,
                            backend="diag")
