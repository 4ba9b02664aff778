"""Cross-engine differential fuzzing.

Every engine implements the same exact semantics; this hammers them
against each other on randomized inputs (sizes, penalties, alphabets,
integer and real-valued matrices).  The native C++ engine makes the
oracle side cheap, so the trial count can be high.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from aligner_tpu import native, oracle
from aligner_tpu.matrices import blosum62, transform_matrix, transform_matrix_jax
from aligner_tpu.ops.pallas_dp import fill_batch_pallas
from aligner_tpu.ops.scan_engine import fill_batch

# the GPU kernel ("pallas") runs in Pallas interpret mode on the CPU
pytestmark = pytest.mark.usefixtures("pallas_interpret")


def _ref_fill(q, t, m, d, e, mode):
    if native.available():
        return native.fill(q, t, m, d, e, mode)
    fn = oracle.fill_local if mode == "local" else oracle.fill_global
    return fn(q, t, m, d, e)


def test_differential_scan_engine_100(rng):
    M = np.asarray(blosum62())
    B = 25
    for trial in range(4):
        Cmax = int(rng.integers(4, 32))
        Rmax = int(rng.integers(4, 32))
        vol = 24 if trial % 2 == 0 else 4
        mat = M if vol == 24 else rng.integers(-4, 8, (4, 4)).astype(np.float64)
        if trial == 3:
            mat = mat + rng.normal(size=mat.shape)  # non-integral
        d, e = float(rng.integers(1, 20)), float(rng.integers(1, 8))
        q = np.zeros((B, Cmax), np.int32)
        t = np.zeros((B, Rmax), np.int32)
        ql = rng.integers(1, Cmax + 1, B).astype(np.int32)
        tl = rng.integers(1, Rmax + 1, B).astype(np.int32)
        for b in range(B):
            q[b, : ql[b]] = rng.integers(0, vol, ql[b])
            t[b, : tl[b]] = rng.integers(0, vol, tl[b])
        mode = "local" if trial % 2 == 0 else "global"
        r = fill_batch(q, ql, t, tl, jnp.asarray(mat), d, e,
                       mode=mode, dtype=jnp.float64)
        plane = np.asarray(r.plane)
        dirs = np.asarray(r.dirs)
        for b in range(B):
            p_o, d_o = _ref_fill(
                q[b, : ql[b]].astype(np.int8), t[b, : tl[b]].astype(np.int8),
                mat, d, e, mode,
            )
            assert np.array_equal(p_o, plane[b, : tl[b] + 1, : ql[b] + 1]), (trial, b)
            assert np.array_equal(d_o, dirs[b, : tl[b] + 1, : ql[b] + 1]), (trial, b)


def test_differential_pallas_interpret(rng):
    M = np.asarray(blosum62())
    B = 10
    for trial in range(2):
        L = int(rng.integers(5, 20))
        d, e = float(rng.integers(1, 15)), float(rng.integers(1, 5))
        q = rng.integers(0, 24, (B, L)).astype(np.int32)
        t = rng.integers(0, 24, (B, L)).astype(np.int32)
        ql = np.full(B, L, np.int32)
        tl = rng.integers(1, L + 1, B).astype(np.int32)
        mode = "local" if trial == 0 else "global"
        r = fill_batch_pallas(q, ql, t, tl, M, d, e, mode=mode, dtype=jnp.float64)
        rx = fill_batch(q, ql, t, tl, jnp.asarray(M), d, e,
                        mode=mode, dtype=jnp.float64)
        assert np.array_equal(np.asarray(r.dirs), np.asarray(rx.dirs))
        for k in ("fmax", "fy", "fx", "end"):
            assert np.array_equal(np.asarray(getattr(r, k)),
                                  np.asarray(getattr(rx, k)))


def test_transform_matrix_jax_matches_numpy(rng):
    import jax

    for _ in range(20):
        m = rng.normal(size=(24, 24)) * 3
        freqs = rng.dirichlet(np.ones(24))
        k_d = float(rng.normal())
        r2 = float(rng.uniform(50, 500))
        try:
            ref = transform_matrix(m, k_d, r2, freqs)
        except Exception:
            out = np.asarray(jax.jit(transform_matrix_jax)(m, k_d, r2, freqs))
            assert np.isnan(out).any()  # NaN instead of raising
            continue
        out = np.asarray(jax.jit(transform_matrix_jax)(m, k_d, r2, freqs))
        np.testing.assert_allclose(out, ref, rtol=1e-10, atol=1e-10)


def test_differential_chunked_device_walk(rng):
    """Checkpoint-and-replay + on-device walk (the row-scan pipeline on a
    one-device mesh) vs the host full-plane alignment on random shapes,
    penalties, alphabets, and checkpoint cadences (global mode)."""
    import jax
    from jax.sharding import Mesh

    from aligner_tpu import host
    from aligner_tpu.parallel.wavefront_sp import sharded_global_align

    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    M = np.asarray(blosum62())
    for trial in range(6):
        vol = 24 if trial % 2 == 0 else 4
        mat = (
            M if vol == 24
            else rng.integers(-4, 8, (4, 4)).astype(np.float64)
        )
        d = float(rng.integers(1, 20))
        e = float(rng.integers(1, 8))
        C = int(rng.integers(1, 180))
        R = int(rng.integers(1, 180))
        q = rng.integers(0, vol, C).astype(np.int8)
        t = rng.integers(0, vol, R).astype(np.int8)
        tb = 16 * int(rng.integers(1, 5))
        ref = host.align_global(q, t, mat, d, e)
        end, qa, ta, coords = sharded_global_align(
            mesh, q, t, mat, d, e, tr=16, tb_rows=tb
        )
        assert end == ref.score[R, C], (trial, C, R, d, e, tb)
        np.testing.assert_array_equal(qa, ref.query_aligned)
        np.testing.assert_array_equal(ta, ref.target_aligned)
        assert coords == ((1, C), (1, R))


def test_differential_pipeline_end_score_wide_matrices(rng):
    """The row-scan pipeline's end score against the reference fill over
    randomized shapes, penalties and alphabets, including matrices whose
    entries leave the int8 range (the pipeline takes any integral
    matrix in int32-exact range)."""
    import jax
    from jax.sharding import Mesh

    from aligner_tpu.parallel.wavefront_sp import sharded_global_end_score

    mesh = Mesh(np.array(jax.devices()).reshape(-1), ("data",))
    M24 = np.asarray(blosum62())
    for trial in range(10):
        vol = 24 if trial % 2 == 0 else 4
        if trial % 3 == 0:
            mat = M24 if vol == 24 else rng.integers(-4, 9, (4, 4)).astype(np.float64)
        else:
            mat = rng.integers(-300, 300, (vol, vol)).astype(np.float64)
        d = float(rng.integers(1, 25))
        e = float(rng.integers(1, max(int(d), 2)))
        C = int(rng.integers(1, 200))
        R = int(rng.integers(1, 200))
        q = rng.integers(0, vol, C).astype(np.int8)
        t = rng.integers(0, vol, R).astype(np.int8)
        plane, _ = _ref_fill(q, t, mat, d, e, "global")
        got = sharded_global_end_score(mesh, q, t, mat, d, e, tr=32)
        assert got == plane[R, C], (trial, C, R, d, e)


def test_differential_full_mode_nonintegral_penalties(rng):
    """Full-mode (direction-plane) parity with NON-integral penalties:
    the kernel must leave its exact int32 path (the eps tie test in the
    float dtype) and stay bit-identical to the reference fill."""
    M = np.asarray(blosum62())
    for trial in range(4):
        d = float(rng.integers(1, 20)) + 0.5
        e = float(rng.integers(1, 8)) + 0.25
        C = int(rng.integers(2, 40))
        R = int(rng.integers(2, 40))
        q = rng.integers(0, 24, (1, C)).astype(np.int32)
        t = rng.integers(0, 24, (1, R)).astype(np.int32)
        ql = np.array([C], np.int32)
        tl = np.array([R], np.int32)
        plane, dirs = _ref_fill(q[0], t[0], M, d, e, "local")
        res = fill_batch_pallas(q, ql, t, tl, M, d, e, mode="local",
                                with_planes=True, dtype=jnp.float64)
        np.testing.assert_array_equal(res.dirs[0], dirs)
        assert float(res.fmax[0]) == plane.max()
