"""Heuristic matrix-free aligners and Karlin-Altschul statistics."""

import numpy as np
import pytest

import aligner_tpu as at
from aligner_tpu.heuristic import (
    Heuristics,
    HeuristicAligner,
    HeuristicPWMAligner,
    heuristic_align,
    heuristic_align_population,
    heuristic_align_pwm,
)
from aligner_tpu.statistics import (
    DistributionParams,
    calculate_distribution_params,
    calculate_p_value,
    shuffle_and_randomize_sequence,
)

# the GPU kernel ("pallas") runs in Pallas interpret mode on the CPU
pytestmark = pytest.mark.usefixtures("pallas_interpret")


def _heur(rng, vol=24):
    freqs = rng.random(vol)
    freqs /= freqs.sum()
    return Heuristics(kd=2.0, r_squared=1e4, frequencies=freqs)


def test_heuristic_align_backends_agree(rng):
    h = _heur(rng)
    q = rng.integers(0, 24, 30).astype(np.int8)
    t = rng.integers(0, 24, 35).astype(np.int8)
    a = heuristic_align(q, t, at.blosum62(), 7.0, 3.0, h, backend="oracle")
    b = heuristic_align(q, t, at.blosum62(), 7.0, 3.0, h, backend="xla")
    assert a.alignment.f == b.alignment.f
    assert np.array_equal(a.alignment.query, b.alignment.query)
    assert np.array_equal(a.matrix, b.matrix)
    assert a.matrix is not None


def test_heuristic_missing_argument():
    with pytest.raises(at.MissingArgument):
        heuristic_align("HEAGAWGHEE", "PAWHEAE", at.blosum62(), 7.0, 3.0, None)


def test_heuristic_r_squared_default(rng):
    """r²==0 → rows*cols (heuristic/mod.rs:48-50)."""
    h = _heur(rng)
    h.kd = 0.0
    h.r_squared = 0.0
    q = rng.integers(0, 24, 20).astype(np.int8)
    t = rng.integers(0, 24, 20).astype(np.int8)
    res = heuristic_align(q, t, at.blosum62(), 7.0, 3.0, h, backend="oracle")
    assert np.isclose(float((np.asarray(res.matrix) ** 2).sum()), 24 * 24)


def test_heuristic_population_matches_singles(rng):
    h = _heur(rng)
    q = rng.integers(0, 24, 25).astype(np.int8)
    t = rng.integers(0, 24, 25).astype(np.int8)
    mats = np.stack(
        [np.asarray(at.blosum62()) + rng.integers(-2, 3, (24, 24)) for _ in range(4)]
    ).astype(np.float64)
    pop = heuristic_align_population(q, t, mats, 7.0, 3.0, h, backend="xla")
    for m in range(4):
        single = heuristic_align(q, t, mats[m], 7.0, 3.0, h, backend="oracle")
        assert pop[m].alignment.f == single.alignment.f
        assert np.array_equal(pop[m].alignment.query, single.alignment.query)
        assert np.allclose(pop[m].matrix, single.matrix)


def test_heuristic_pwm(rng):
    freqs = rng.random(4)
    freqs /= freqs.sum()
    h = Heuristics(kd=0.0, r_squared=21.0, frequencies=freqs)
    q = rng.integers(0, 4, 60).astype(np.int8)
    pwm = at.random_pwm(10, rng)
    res = heuristic_align_pwm(q, pwm, 3.0, 1.0, h, backend="oracle")
    res2 = heuristic_align_pwm(q, pwm, 3.0, 1.0, h, backend="xla")
    assert res.alignment.f == res2.alignment.f
    assert res.matrix.shape == (4, 10)
    al = HeuristicPWMAligner.from_seqs(q)
    res3 = al.perform_alignment(3.0, 1.0, pwm, h, backend="oracle")
    assert res3.alignment.f == res.alignment.f


def test_heuristic_class_wrapper(rng):
    h = _heur(rng)
    al = HeuristicAligner.from_str_seqs("HEAGAWGHEE", "PAWHEAE")
    res = al.perform_alignment(7.0, 3.0, at.blosum62(), h, backend="oracle")
    assert res.matrix is not None


def test_shuffle_drops_tail(rng):
    seq = np.arange(50, dtype=np.int8)
    for _ in range(20):
        out = shuffle_and_randomize_sequence(seq, rng)
        assert 44 <= len(out) <= 50
        assert set(out).issubset(set(range(50)))


def test_distribution_params_and_p_value(rng):
    # synthetic Gumbel-ish scores
    lengths = np.full(400, 300)
    scores = rng.gumbel(30, 8, size=400)
    params = calculate_distribution_params(250, lengths, scores)
    assert np.isfinite(params.k) and np.isfinite(params.lambda_) and np.isfinite(params.h)
    p_low = params.get_p_value(250, 300, 80.0)
    p_high = params.get_p_value(250, 300, 20.0)
    assert 0.0 <= p_low <= 1.0
    assert p_low < p_high


def test_calculate_p_value_end_to_end(rng):
    q = rng.integers(0, 24, 40).astype(np.int8)
    t = rng.integers(0, 24, 40).astype(np.int8)
    res = at.align.align_local(q, t, at.blosum62(), 11.0, 2.0, backend="xla")
    p = calculate_p_value(
        q, t, res.alignment.f, 11.0, 2.0, at.blosum62(),
        rng=np.random.default_rng(1), backend="xla", n_sequences=200,
    )
    assert 0.0 <= p <= 1.0
    # deterministic with the same seed
    p2 = calculate_p_value(
        q, t, res.alignment.f, 11.0, 2.0, at.blosum62(),
        rng=np.random.default_rng(1), backend="xla", n_sequences=200,
    )
    assert p == p2


def test_heuristic_max_iters_attaches_producing_matrix(rng):
    """On max_iters exhaustion the attached matrix is the one that
    PRODUCED the returned alignment, not the post-update transform;
    max_iters < 1 is rejected (review r3)."""
    from aligner_tpu.errors import ValidationError
    from aligner_tpu.heuristic import Heuristics, heuristic_align

    q = rng.integers(0, 24, 16).astype(np.int8)
    t = q.copy()
    seed = rng.integers(-1, 2, (24, 24)).astype(np.float64)
    h = Heuristics(kd=0.0, r_squared=30.0, frequencies=np.full(24, 1 / 24))
    res1 = heuristic_align(q, t, seed, 4.0, 2.0, h, backend="xla",
                           max_iters=1)
    # re-aligning with the attached matrix must reproduce the result
    from aligner_tpu.align import align_local
    again = align_local(q, t, res1.matrix, 4.0, 2.0, backend="xla")
    assert again.alignment.f == res1.alignment.f
    assert np.array_equal(again.alignment.query, res1.alignment.query)
    with pytest.raises(ValidationError):
        heuristic_align(q, t, seed, 4.0, 2.0, h, max_iters=0)


def test_matrix_from_csv_rejects_empty_and_ragged():
    from aligner_tpu.errors import ValidationError
    from aligner_tpu.io.matrix_io import matrix_from_csv

    with pytest.raises(ValidationError):
        matrix_from_csv("", dim=(24, 24))
    with pytest.raises(ValidationError):
        matrix_from_csv("1 2 3\n4 5\n")


def test_population_device_loop_first_iter_bitexact(rng):
    """The fused device loop's measurement machinery — fill + device
    walk + frequency scatter-add + transform_matrix_jax in one dispatch
    (_population_device_loop) — is bit-equal to the host path on
    integral matrices: same f, and the post-iteration matrix equals
    transform_matrix_jax applied to the host-computed frequency matrix
    in the same dtype."""
    import jax.numpy as jnp

    from aligner_tpu.align import batch_align
    from aligner_tpu.heuristic import _population_device_loop
    from aligner_tpu.matrices import transform_matrix_jax

    q = rng.integers(0, 24, 33).astype(np.int8)
    t = q.copy()
    t[rng.integers(1, 33, 5)] = rng.integers(0, 24, 5)
    M = 4
    mats = np.stack(
        [np.asarray(at.blosum62()) + rng.integers(-2, 3, (24, 24))
         for _ in range(M)]
    ).astype(np.float64)
    freqs = rng.random(24)
    freqs /= freqs.sum()
    kd, r2 = 2.0, 1e4

    pad8 = lambda n: -(-n // 8) * 8
    q2 = np.zeros((M, pad8(len(q))), np.int32)
    q2[:, : len(q)] = q
    t2 = np.zeros((M, pad8(len(t))), np.int32)
    t2[:, : len(t)] = t
    for backend in ("xla", "pallas"):
        it, done, dead, max_f, trans, prod = _population_device_loop(
            q2, np.full(M, len(q), np.int32), t2,
            np.full(M, len(t), np.int32),
            jnp.asarray(mats, jnp.float32), jnp.asarray(freqs, jnp.float32),
            jnp.float32(kd), jnp.float32(r2), jnp.int32(1),
            backend=backend, del_=7.0, ext=3.0,
        )
        ref = batch_align([q] * M, [t] * M, mats, 7.0, 3.0, mode="local",
                          backend=backend, with_alignments=True)
        max_f = np.asarray(max_f)
        trans = np.asarray(trans)
        for m in range(M):
            assert max_f[m] == np.float32(ref[m].alignment.f)
            fm = ref[m].alignment.frequency_matrix()
            want = np.asarray(transform_matrix_jax(
                jnp.asarray(fm, jnp.float32), jnp.float32(kd),
                jnp.float32(r2), jnp.asarray(freqs, jnp.float32),
            ))
            # the transform itself is compared to ULP-level tolerance:
            # XLA may schedule the reduction sums differently inside the
            # fused while-loop body than in a standalone jit, so exact
            # bit-equality holds for the fill/walk/count chain (max_f
            # above) but not across jit contexts for f32 reductions
            assert np.allclose(trans[m], want, rtol=1e-5, atol=1e-5), (backend, m)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_population_device_loop_matches_host(rng, backend):
    """Full fused run vs the host loop: identical alignments and
    convergence pattern; f and matrices agree to f32-transform rounding
    (the documented distribution-equality regime — in-loop transforms
    round in the device dtype)."""
    q = rng.integers(0, 24, 48).astype(np.int8)
    t = q.copy()
    t[rng.integers(1, 48, 7)] = rng.integers(0, 24, 7)
    mats = rng.integers(-1, 2, (5, 24, 24)).astype(np.float64)
    freqs = rng.random(24)
    freqs /= freqs.sum()
    h = Heuristics(kd=0.0, r_squared=120.0, frequencies=freqs)
    host = heuristic_align_population(q, t, mats, 5.0, 2.0, h,
                                      backend=backend, device_loop=False)
    fused = heuristic_align_population(q, t, mats, 5.0, 2.0, h,
                                       backend=backend, device_loop=True)
    assert len(host) == len(fused)
    for a, b in zip(host, fused):
        assert (a is None) == (b is None)
        if a is None:
            continue
        assert np.array_equal(a.alignment.query, b.alignment.query)
        assert np.array_equal(a.alignment.target, b.alignment.target)
        assert a.alignment.coords == b.alignment.coords
        assert abs(a.alignment.f - b.alignment.f) <= 1e-3 * max(1.0, abs(a.alignment.f))
        assert np.allclose(a.matrix, b.matrix, rtol=1e-4, atol=1e-4)


def test_population_device_loop_dead_members(rng):
    """A member whose matrix admits no alignment returns None on both
    paths (the reference would panic the whole process there)."""
    q = np.zeros(10, np.int8)
    t = np.full(10, 5, np.int8)
    mats = np.zeros((2, 24, 24))
    mats[:, 5, 0] = -3.0
    freqs = rng.random(24)
    freqs /= freqs.sum()
    h = Heuristics(kd=0.0, r_squared=10.0, frequencies=freqs)
    for flag in (False, True):
        out = heuristic_align_population(q, t, mats, 5.0, 2.0, h,
                                         backend="xla", device_loop=flag)
        assert out == [None, None]


def test_population_fused_surfaces_nan_transform(rng, monkeypatch):
    """An in-loop transform with no real roots propagates NaN on device;
    the fused path must raise WrongMatrixSpecified like the host path —
    INCLUDING when the NaN fill subsequently marked the member dead (a
    NaN matrix admits no alignment, so fy/fx land on 0 and the member
    looks 'dead', which used to exclude it from the NaN check).  The
    condition is a borderline-rounding regime (disc sign is
    matrix-independent up to fp error: (p·base) == 0 exactly), so the
    final loop state is stubbed rather than constructed from inputs."""
    import aligner_tpu.heuristic as H
    from aligner_tpu.errors import WrongMatrixSpecified

    q = rng.integers(0, 24, 16).astype(np.int8)
    t = q.copy()
    M, V = 3, 24

    def fake_loop(q2, ql0, t2, tl0, transformed, *a, **kw):
        trans = np.asarray(transformed, np.float64).copy()
        trans[1] = np.nan  # member 1 accepted a no-real-roots transform
        dead = np.zeros(M, bool)
        dead[1] = True  # ...and the NaN fill then marked it dead
        return (np.int32(2), np.ones(M, bool), dead,
                np.zeros(M), trans, np.asarray(transformed, np.float64))

    monkeypatch.setattr(H, "_population_device_loop", fake_loop)
    freqs = rng.random(V)
    freqs /= freqs.sum()
    h = Heuristics(kd=0.0, r_squared=120.0, frequencies=freqs)
    mats = rng.integers(-1, 2, (M, V, V)).astype(np.float64)
    with pytest.raises(WrongMatrixSpecified):
        heuristic_align_population(q, t, mats, 5.0, 2.0, h,
                                   backend="xla", device_loop=True)


@pytest.mark.parametrize("flag", [False, True])
def test_population_max_iters_attaches_producing_matrix(rng, flag):
    """heuristic_align's exhaustion rule, at population scale: a member
    that hits max_iters while still improving returns its LAST ACCEPTED
    alignment with the matrix that PRODUCED it — verified by re-aligning
    with res.matrix and getting the identical alignment back (the old
    behavior launched the never-evaluated fresh transform instead)."""
    from aligner_tpu.align import batch_align
    from aligner_tpu.heuristic import heuristic_align_population

    q = rng.integers(0, 24, 40).astype(np.int8)
    t = q.copy()
    t[rng.integers(1, 40, 6)] = rng.integers(0, 24, 6)
    mats = rng.integers(-1, 2, (3, 24, 24)).astype(np.float64)
    freqs = rng.random(24)
    freqs /= freqs.sum()
    h = Heuristics(kd=0.0, r_squared=120.0, frequencies=freqs)
    out = heuristic_align_population(q, t, mats, 5.0, 2.0, h,
                                     backend="xla", device_loop=flag,
                                     max_iters=2)
    assert any(r is not None for r in out)
    for m, res in enumerate(out):
        if res is None:
            continue
        redo = batch_align([q], [t], res.matrix[None], 5.0, 2.0,
                           mode="local", backend="xla",
                           with_alignments=True)[0]
        assert redo.alignment.f == res.alignment.f, m
        assert np.array_equal(redo.alignment.query, res.alignment.query)
        assert np.array_equal(redo.alignment.target, res.alignment.target)
    with pytest.raises(at.ValidationError):
        heuristic_align_population(q, t, mats, 5.0, 2.0, h,
                                   backend="xla", device_loop=flag,
                                   max_iters=0)
