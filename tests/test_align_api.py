"""End-to-end API tests: xla backend vs the scalar oracle backend."""

import numpy as np
import pytest

import aligner_tpu as at
from aligner_tpu.align import (
    PWMAligner,
    SimpleGlobalAligner,
    SimpleLocalAligner,
    align_global,
    align_local,
    align_pwm,
    batch_align,
    batch_align_pwm,
)
from aligner_tpu.io import read_fasta_file

# the GPU kernel ("pallas") runs in Pallas interpret mode on the CPU
pytestmark = pytest.mark.usefixtures("pallas_interpret")

EXAMPLES = "examples"


def _pairs_equal(a, b):
    assert np.array_equal(a.alignment.query, b.alignment.query)
    assert np.array_equal(a.alignment.target, b.alignment.target)
    assert a.alignment.coords == b.alignment.coords
    assert a.alignment.f == b.alignment.f


@pytest.mark.parametrize("mode", ["global", "local"])
def test_book_example_xla_matches_oracle(mode):
    recs = read_fasta_file(f"{EXAMPLES}/book_example_1.fasta")
    q, t = recs[0].seq.decode(), recs[1].seq.decode()
    fn = align_global if mode == "global" else align_local
    m = at.blosum62()
    a = fn(q, t, m, 11.0, 2.0, backend="xla")
    b = fn(q, t, m, 11.0, 2.0, backend="oracle")
    _pairs_equal(a, b)
    qa, ta = a.alignment.render()
    assert "_" in qa + ta or len(qa) == len(ta)


def test_protein_example_local_and_global():
    recs = read_fasta_file(f"{EXAMPLES}/protein.fasta")
    q, t = recs[0].seq.decode(), recs[1].seq.decode()
    m = at.blosum62()
    for fn in (align_local, align_global):
        a = fn(q, t, m, 11.0, 2.0, backend="xla")
        b = fn(q, t, m, 11.0, 2.0, backend="oracle")
        _pairs_equal(a, b)


def test_fuzz_simple_xla_vs_oracle(rng):
    m = at.blosum62()
    for trial in range(10):
        ql, tl = rng.integers(1, 40, size=2)
        q = rng.integers(0, 24, ql).astype(np.int8)
        t = rng.integers(0, 24, tl).astype(np.int8)
        del_, ext = float(rng.integers(1, 15)), float(rng.integers(1, 5))
        for fn in (align_local, align_global):
            try:
                a = fn(q, t, m, del_, ext, backend="xla", keep_planes=True)
            except at.ResultIsEmpty:
                with pytest.raises(at.ResultIsEmpty):
                    fn(q, t, m, del_, ext, backend="oracle")
                continue
            b = fn(q, t, m, del_, ext, backend="oracle", keep_planes=True)
            _pairs_equal(a, b)
            assert np.array_equal(a.score, b.score)
            assert np.array_equal(a.directions, b.directions)


def test_batch_align_scores_match_oracle(rng):
    m = at.blosum62()
    qs = [rng.integers(0, 24, rng.integers(5, 30)).astype(np.int8) for _ in range(12)]
    ts = [rng.integers(0, 24, rng.integers(5, 30)).astype(np.int8) for _ in range(12)]
    res = batch_align(qs, ts, m, 11.0, 2.0, mode="local", backend="xla")
    from aligner_tpu import oracle

    for b in range(12):
        a, _ = oracle.fill_local(qs[b], ts[b], m, 11.0, 2.0)
        assert float(res.fmax[b]) == a.max()
        my, mx = oracle.argmax_first_rowmajor(a)
        assert (int(res.fy[b]), int(res.fx[b])) == (my, mx)


def test_batch_align_with_alignments_matches_singles(rng):
    m = at.blosum62()
    qs = [rng.integers(0, 24, rng.integers(5, 25)).astype(np.int8) for _ in range(6)]
    ts = [rng.integers(0, 24, rng.integers(5, 25)).astype(np.int8) for _ in range(6)]
    batch = batch_align(qs, ts, m, 11.0, 2.0, mode="local",
                        backend="xla", with_alignments=True)
    for b, res in enumerate(batch):
        single = align_local(qs[b], ts[b], m, 11.0, 2.0, backend="oracle")
        _pairs_equal(res, single)


def test_pwm_xla_vs_oracle(rng):
    pwm = at.random_pwm(12, rng)
    for _ in range(5):
        q = rng.integers(0, 4, rng.integers(5, 40)).astype(np.int8)
        a = align_pwm(q, pwm, 3.0, 1.0, backend="xla")
        b = align_pwm(q, pwm, 3.0, 1.0, backend="oracle")
        assert np.array_equal(a.alignment.query, b.alignment.query)
        assert np.array_equal(a.alignment.numbered, b.alignment.numbered)
        assert a.alignment.coords == b.alignment.coords
        assert a.alignment.f == b.alignment.f


def test_batch_pwm_batched_matrices(rng):
    pwms = np.stack([at.random_pwm(10, rng) for _ in range(8)])
    qs = [rng.integers(0, 4, 20).astype(np.int8) for _ in range(8)]
    res = batch_align_pwm(qs, pwms, 3.0, 1.0, backend="xla")
    from aligner_tpu import oracle

    for b in range(8):
        a, _ = oracle.fill_pwm(qs[b], pwms[b], 3.0, 1.0)
        assert float(res.fmax[b]) == a.max()


def test_class_wrappers_and_errors():
    al = SimpleLocalAligner.from_str_seqs("HEAGAWGHEE", "PAWHEAE")
    res = al.perform_alignment(11.0, 2.0, at.blosum62(), backend="oracle")
    assert res.alignment.f > 0
    with pytest.raises(at.UnnecessaryArgument):
        al.perform_alignment(11.0, 2.0, at.blosum62(), heuristics=object())
    ga = SimpleGlobalAligner.from_str_seqs("HEAGAWGHEE", "PAWHEAE")
    assert ga.perform_alignment(11.0, 2.0, at.blosum62(), backend="oracle").alignment.f == 0.0
    pa = PWMAligner.from_str_seqs("ATCGATCG")
    with pytest.raises(at.MatrixShapeError):
        pa.perform_alignment(3.0, 1.0, np.zeros((5, 4)))


# --- huge-pair dispatch (VERDICT r2 #3: huge pairs route to the
# cross-device wavefront, never a materialized O(R*C) plane) ---


def _capture_sharded(monkeypatch):
    """Patch the sharded entry point to record its call and return a
    recognizable dummy alignment."""
    from aligner_tpu.parallel import wavefront_sp

    calls = []

    def fake(mesh, q, t, matrix, del_, ext, **kw):
        calls.append((len(q), len(t)))
        return 0.0, np.array([0], np.int16), np.array([0], np.int16), (
            (1, len(q)), (1, len(t)))

    monkeypatch.setattr(wavefront_sp, "sharded_global_align", fake)
    return calls


def test_wide_pair_routes_to_sharded(monkeypatch):
    """A pair past the direct-plane budget dispatches to the
    column-sharded pipeline — not a plane fill (which would OOM)."""
    from aligner_tpu.parallel import wavefront_sp

    calls = _capture_sharded(monkeypatch)
    monkeypatch.setattr(wavefront_sp, "DIRECT_PLANE_CELLS", 64 * 64)
    rng = np.random.default_rng(0)
    q = rng.integers(0, 24, 4096 + 64).astype(np.int8)
    t = rng.integers(0, 24, 64).astype(np.int8)
    align_global(q, t, at.blosum62(), 11.0, 2.0)
    assert calls == [(4096 + 64, 64)]


def test_huge_pair_multi_device_routes_to_sharded(monkeypatch):
    """A chromosome-scale pair with several devices visible uses all of
    them via the sharded pipeline (8 virtual CPU devices here)."""
    calls = _capture_sharded(monkeypatch)
    rng = np.random.default_rng(1)
    q = rng.integers(0, 24, 10_000).astype(np.int8)
    t = rng.integers(0, 24, 10_000).astype(np.int8)  # 1e8 cells > 2^26
    align_global(q, t, at.blosum62(), 11.0, 2.0)
    assert calls == [(10_000, 10_000)]


def test_huge_pair_no_wavefront_raises(monkeypatch):
    """Huge pairs that no exact wavefront engine can take (non-integral
    penalties) fail with a clear error instead of allocating a plane."""
    rng = np.random.default_rng(2)
    q = rng.integers(0, 24, 10_000).astype(np.int8)
    t = rng.integers(0, 24, 10_000).astype(np.int8)
    with pytest.raises(at.ValidationError, match="plane"):
        align_global(q, t, at.blosum62(), 11.5, 2.25)
    # keep_planes at huge scale is an explicit OOM request — refused too
    with pytest.raises(at.ValidationError, match="plane"):
        align_global(q, t, at.blosum62(), 11.0, 2.0, keep_planes=True)


def test_backend_wavefront_sp_end_to_end():
    """Explicit backend="wavefront_sp" produces oracle-identical
    alignments through the public API (small pair, real pipeline)."""
    rng = np.random.default_rng(3)
    q = rng.integers(0, 24, 200).astype(np.int8)
    t = rng.integers(0, 24, 150).astype(np.int8)
    a = align_global(q, t, at.blosum62(), 11.0, 2.0, backend="wavefront_sp")
    b = align_global(q, t, at.blosum62(), 11.0, 2.0, backend="oracle")
    _pairs_equal(a, b)


def test_global_end_score_rejects_unknown_backend():
    """Typo'd backends must raise, not silently run the host O(R*C)
    fill (review r3 #6)."""
    from aligner_tpu.errors import ValidationError

    q = np.zeros(8, np.int8)
    with pytest.raises(ValidationError, match="unknown backend"):
        at.global_end_score(q, q, at.blosum62(), 11.0, 2.0,
                            backend="diagg")


def test_explicit_wavefront_sp_validation():
    """backend='wavefront_sp' the pipeline cannot honor raises the
    documented ValidationError (not a bare ValueError from deep inside),
    and keep_planes is rejected rather than silently ignored (review
    r3 #7)."""
    from aligner_tpu.errors import ValidationError

    q = np.zeros(8, np.int8)
    with pytest.raises(ValidationError, match="integral"):
        align_global(q, q, np.full((24, 24), 0.5), 11.0, 2.0,
                     backend="wavefront_sp")
    with pytest.raises(ValidationError, match="integral"):
        at.global_end_score(q, q, at.blosum62(), 11.5, 2.25,
                            backend="wavefront_sp")
    with pytest.raises(ValidationError, match="keep_planes"):
        align_global(q, q, at.blosum62(), 11.0, 2.0,
                     backend="wavefront_sp", keep_planes=True)


def test_sharded_route_uses_local_data_mesh(monkeypatch):
    """The huge-pair route must build its mesh from the shared
    _data_mesh helper (local devices under multi-controller), not
    global jax.devices() (review r3 #1)."""
    from aligner_tpu import align as align_mod
    from aligner_tpu.parallel import wavefront_sp

    monkeypatch.setattr(wavefront_sp, "DIRECT_PLANE_CELLS", 64 * 64)
    seen = []

    def fake(mesh, q, t, matrix, del_, ext, **kw):
        seen.append(mesh)
        return 0.0, np.array([0], np.int16), np.array([0], np.int16), (
            (1, len(q)), (1, len(t)))

    monkeypatch.setattr(wavefront_sp, "sharded_global_align", fake)
    monkeypatch.setattr(wavefront_sp, "sharded_global_end_score",
                        lambda mesh, *a, **kw: seen.append(mesh) or 0.0)
    rng = np.random.default_rng(2)
    q = rng.integers(0, 24, 4096 + 64).astype(np.int8)
    t = rng.integers(0, 24, 64).astype(np.int8)
    align_global(q, t, at.blosum62(), 11.0, 2.0)
    at.global_end_score(q, t, at.blosum62(), 11.0, 2.0)
    assert len(seen) == 2
    assert all(m is align_mod._data_mesh() for m in seen)


def test_batch_global_end_scores_argmax_off(rng):
    """track_argmax=False must not zero global end scores on any
    backend (the pallas kernel captures end inside the argmax
    machinery; batch_align forces tracking for global mode)."""
    m = np.asarray(at.blosum62())
    qs = [rng.integers(0, 24, 12).astype(np.int8) for _ in range(5)]
    ts = [rng.integers(0, 24, 15).astype(np.int8) for _ in range(5)]
    rx = batch_align(qs, ts, m, 2.0, 1.0, mode="global", backend="xla",
                     track_argmax=False)
    rp = batch_align(qs, ts, m, 2.0, 1.0, mode="global", backend="pallas",
                     track_argmax=False)
    assert np.array_equal(rx.end, rp.end)
    ref = align_global(qs[0], ts[0], m, 2.0, 1.0, backend="oracle",
                       keep_planes=True)
    assert rx.end[0] == ref.score[15, 12]


def test_batch_local_dead_problem_returns_none(rng):
    """One problem with no positive-scoring cell yields None for THAT
    entry; the rest of the batch aligns normally (previously the whole
    batch raised ResultIsEmpty)."""
    good = np.asarray(at.blosum62())
    bad = np.full((24, 24), -5.0)
    mats = np.stack([good, bad, good])
    q = rng.integers(0, 24, 20).astype(np.int8)
    t = q.copy()
    out = batch_align([q, q, q], [t, t, t], mats, 11.0, 2.0, mode="local",
                      with_alignments=True)
    assert out[1] is None
    ref = align_local(q, t, good, 11.0, 2.0, backend="oracle")
    for b in (0, 2):
        assert out[b].alignment.f == ref.alignment.f
        assert np.array_equal(out[b].alignment.query, ref.alignment.query)


def test_batch_empty_sequence_raises_result_is_empty(rng):
    m = np.asarray(at.blosum62())
    q2 = rng.integers(0, 24, 4).astype(np.int8)
    for mode in ("global", "local"):
        with pytest.raises(at.ResultIsEmpty):
            batch_align([np.zeros(0, np.int8), q2], [q2, q2], m, 1.0, 0.5,
                        mode=mode, with_alignments=True)


def test_local_max_score_without_native(rng, monkeypatch):
    from aligner_tpu import native
    from aligner_tpu.align import local_max_score

    q = rng.integers(0, 24, 60).astype(np.int8)
    t = rng.integers(0, 24, 80).astype(np.int8)
    m = np.asarray(at.blosum62())
    want = local_max_score(q, t, m, 11.0, 2.0)
    monkeypatch.setattr(native, "available", lambda: False)
    got = local_max_score(q, t, m, 11.0, 2.0)
    assert got == want


def test_align_pwm_empty_query_is_reference_empty():
    """Reference parity: the PWM traceback on an empty query returns an
    EMPTY alignment with coords ((1,1),(1,1)) and f=0
    (pwm/mod.rs:105-125) — not ResultIsEmpty like the pair aligners."""
    res = align_pwm(np.zeros(0, np.int8), np.ones((4, 3)), 1.0, 0.5)
    assert res.alignment.f == 0.0
    assert res.alignment.coords == ((1, 1), (1, 1))
    assert len(res.alignment.query) == 0
    assert len(res.alignment.numbered) == 0


def test_heuristic_population_survives_dead_member(rng):
    """A candidate matrix that admits no alignment returns None for its
    slot without aborting the other members or forcing max_iters."""
    from aligner_tpu.heuristic import Heuristics, heuristic_align_population

    q = rng.integers(0, 24, 18).astype(np.int8)
    t = q.copy()
    good = rng.integers(-1, 2, (24, 24)).astype(np.float64)
    h = Heuristics(kd=0.0, r_squared=22.0,
                   frequencies=np.full(24, 1.0 / 24))
    # a strongly negative seed stays negative through transform_matrix
    dead = np.full((24, 24), -60.0)
    mats = np.stack([good, dead, good])
    out = heuristic_align_population(q, t, mats, 4.0, 2.0, h,
                                     max_iters=12)
    assert out[0] is not None and out[2] is not None
    assert out[0].alignment.f > 0


def test_search_database_survives_dead_hits(rng):
    """Top-k hits with no positive-scoring cell (or empty targets) keep
    score-only form instead of crashing the whole search (review r3)."""
    from aligner_tpu.search import search_database

    m = np.asarray(at.blosum62())
    q = "AAAA"
    hits = search_database(q, ["WWWW", "WWWW", "AAAA"], m, 11.0, 2.0, k=3)
    assert hits[0].score > 0 and hits[0].query_aligned is not None
    assert all(h.coords is None for h in hits if h.score <= 0)


def test_native_rejects_special_codes():
    """Codec-legal BLANK/POS codes are not alignable symbols: the
    native engine must raise, not read the matrix out of bounds."""
    from aligner_tpu import native

    if not native.available():
        pytest.skip("native runtime unavailable")
    m = np.asarray(at.blosum62())
    q = at.Protein.encode("A_AR")  # '_' -> BLANK=98
    t = at.Protein.encode("AARA")
    with pytest.raises(at.ValidationError):
        native.fill(q, t, m, 11.0, 2.0, "local")
    with pytest.raises(at.ValidationError):
        native.local_max_score_stream(q, t, m, 11.0, 2.0)


def test_length_buckets_width_ratio_capped(rng):
    from aligner_tpu.search import length_buckets

    lengths = [100] * 63 + [50_000]
    buckets = length_buckets(lengths, growth=1.3, min_size=64)
    for b in buckets:
        ls = [max(lengths[i], 1) for i in b]
        assert max(ls) <= min(ls) * 1.3 * 2


def test_pad_to_smaller_than_batch_raises(rng):
    """pad_to exists to keep compiled shapes constant — an undersized
    bucket must raise, not silently ship the raw batch size (which would
    compile a fresh kernel per distinct oversize)."""
    from aligner_tpu.align import batch_align, batch_align_pwm

    qs = ["HEAGAWGHEE"] * 5
    ts = ["PAWHEAE"] * 5
    with pytest.raises(at.ValidationError):
        batch_align(qs, ts, at.blosum62(), 11.0, 2.0, mode="local",
                    backend="xla", pad_to=4)
    pwm = rng.integers(-1, 2, (4, 16)).astype(float)
    with pytest.raises(at.ValidationError):
        batch_align_pwm(["ATCG", "GGTA", "ATAT"], pwm, 5.0, 2.0,
                        alphabet=at.DNA, backend="xla", pad_to=2)
