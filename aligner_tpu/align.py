"""Public alignment API.

Functional entry points (``align_global``, ``align_local``, ``align_pwm``,
``batch_align``, ``batch_align_pwm``) plus class wrappers mirroring the
reference's ``AlignerTrait`` surface (``SimpleGlobalAligner``,
``SimpleLocalAligner``, ``PWMAligner`` — aligner-core/src/lib.rs:27-40,
simple/mod.rs, pwm/mod.rs).

Backends: ``oracle`` (scalar host engine), ``xla`` (batched lax.scan), and
``pallas`` (GPU batch kernel).  ``backend=None`` picks by platform
(``backend.PLATFORMS``).  All backends implement the exact reference semantics; f32 is
bit-exact for integer-valued matrices (every score is a small sum of
matrix entries), while heuristic-transformed matrices may differ from the
f64 oracle in ties — use ``dtype=jnp.float64`` on CPU for strict parity.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Sequence

import numpy as np

from . import host, oracle
from .alphabet import DNA, Alphabet, Protein
from .backend import default_dtype, pick_backend
from .errors import MatrixShapeError, ResultIsEmpty, UnnecessaryArgument, ValidationError
from .result import Alignment, AlignmentResult, PWMAlignment
from .traceback import traceback_global, traceback_local, traceback_pwm


# ---------------------------------------------------------------------------
# Automatic data-parallel sharding.  When more than one device is visible
# (several GPUs, or the CPU test mesh), every batched fill shards its
# problem axis over a 1-D device mesh — this is how the reference's
# thread fan-outs (statistics/mod.rs:253-291, engine/calc.rs:45-75) and
# Kafka worker pool (node/main.rs) scale past one chip.  Per-problem
# fills are independent, so sharded results are bit-identical to
# single-device runs.  ALIGNER_AUTO_SHARD=0 disables (used by the
# equality tests).
# ---------------------------------------------------------------------------

_DATA_MESH = None


def _auto_shard_devices() -> int:
    if os.environ.get("ALIGNER_AUTO_SHARD", "1") == "0":
        return 1
    import jax

    if jax.process_count() > 1:
        # multi-controller: batches here are per-process (hosts scale via
        # the work queue / multihost.shard_local_batch), so the implicit
        # single-controller sharding must stay local
        return len(jax.local_devices())
    return len(jax.devices())


def _data_mesh():
    global _DATA_MESH
    import jax
    from jax.sharding import Mesh

    devs = (
        jax.local_devices() if jax.process_count() > 1 else jax.devices()
    )
    if _DATA_MESH is None or _DATA_MESH.devices.size != len(devs):
        _DATA_MESH = Mesh(np.array(devs), ("data",))
    return _DATA_MESH


def _pad_batch_rows(arrs, B: int, Bp: int):
    """Right-pad the batch axis of each array with zeros to Bp rows."""
    out = []
    for a in arrs:
        if a is None or len(a) == Bp:
            out.append(a)
        else:
            pad = [(0, Bp - B)] + [(0, 0)] * (a.ndim - 1)
            out.append(np.pad(a, pad))
    return out


def _assemble_sharded_fill(outs, B, R_orig, backend, with_planes,
                           device_dirs, unpack_args):
    """Shared tail of the sharded fill paths (pair AND PWM): slice the
    batch off the shard_map outputs, route device-dirs mode (planes
    stay on device), or unpack the packed planes host-side.
    ``unpack_args`` are forwarded to ``dirs_from_packed`` — the only
    point where the pair and PWM variants differ."""
    from .ops.scan_engine import FillResult

    fmax, fy, fx, end = (o[:B] for o in outs[:4])
    if with_planes and device_dirs:
        res = FillResult(plane=None, dirs=None, fmax=fmax, fy=fy, fx=fx,
                         end=end)
        return res, outs[4][:B], "packed" if backend == "pallas" else "dense"
    dirs = None
    if with_planes:
        if backend == "pallas":
            from .ops.pallas_dp import dirs_from_packed

            dirs = dirs_from_packed(np.asarray(outs[4])[:B], *unpack_args)
            dirs = dirs[:, : R_orig + 1]  # drop the unroll padding rows
        else:
            dirs = np.asarray(outs[4])[:B]
    return FillResult(plane=None, dirs=dirs, fmax=fmax, fy=fy, fx=fx, end=end)


@functools.lru_cache(maxsize=64)
def _sharded_step(mesh, mode, with_planes, backend, dtype, track_argmax,
                  del_, ext, batched_mat):
    """The jitted shard_map program of one sharded fill configuration,
    built once: a fresh shard_map per call would retrace and recompile
    the whole per-shard fill (kernel included) on every batch.  ``mode``
    is "local"/"global" (operands q, qlen, t, tlen, matrix) or "pwm"
    (operands q, qlen, pwm)."""
    import jax
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from .ops import scan_engine

    def pair_fn(qs, qls, ts, tls, mat):
        if backend == "pallas":
            from .ops.pallas_dp import fill_full_traced, fill_scores_traced

            if with_planes:
                return fill_full_traced(
                    qs, qls, ts, tls, mat, del_, ext, mode=mode, dtype=dtype,
                )
            return fill_scores_traced(
                qs, qls, ts, tls, mat, del_, ext, mode=mode, dtype=dtype,
                track_argmax=track_argmax,
            )
        r = scan_engine.fill_batch(
            qs, qls, ts, tls, mat, del_, ext,
            mode=mode, with_planes=with_planes, dtype=dtype,
        )
        return (r.fmax, r.fy, r.fx, r.end) + ((r.dirs,) if with_planes else ())

    def pwm_fn(qs, qls, mat):
        if backend == "pallas":
            from .ops.pallas_dp import (
                fill_pwm_full_traced,
                fill_pwm_scores_traced,
            )

            if with_planes:
                return fill_pwm_full_traced(qs, qls, mat, del_, ext,
                                            dtype=dtype)
            return fill_pwm_scores_traced(
                qs, qls, mat, del_, ext, dtype=dtype,
                track_argmax=track_argmax,
            )
        r = scan_engine.fill_pwm_batch(
            qs, qls, mat, del_, ext, with_planes=with_planes, dtype=dtype
        )
        return (r.fmax, r.fy, r.fx, r.end) + ((r.dirs,) if with_planes else ())

    mat_spec = P("data") if batched_mat else P()
    if mode == "pwm":
        fn, in_specs = pwm_fn, (P("data"), P("data"), mat_spec)
    else:
        fn = pair_fn
        in_specs = (P("data"), P("data"), P("data"), P("data"), mat_spec)
    return jax.jit(shard_map(
        fn, mesh=mesh, in_specs=in_specs,
        out_specs=tuple([P("data")] * (5 if with_planes else 4)),
        check_vma=False,
    ))


def _fill_sharded(q, ql, t, tl, matrix, del_, ext, mode, with_planes,
                  backend, dtype, track_argmax, ndev, device_dirs=False):
    """Data-sharded batched fill (scores-only or direction-plane mode).

    Pads the batch to a device multiple with zero-length problems, runs
    one per-shard kernel under shard_map, and reassembles a FillResult
    identical to the single-device one (plane is never materialized —
    batch consumers read only directions/scores).

    ``device_dirs``: keep the direction planes ON the device and return
    ``(FillResult(dirs=None), dirs_dev, fmt)`` for the on-device walk
    (ops/device_walk.py) — fmt "packed" (pallas 2-bit words) or "dense"
    (lax bordered plane).
    """
    import jax.numpy as jnp

    B = q.shape[0]
    Bp = -(-B // ndev) * ndev
    matrix = np.asarray(matrix)
    batched_mat = matrix.ndim == 3
    q, ql, t, tl = _pad_batch_rows([q, ql, t, tl], B, Bp)
    if batched_mat:
        (matrix,) = _pad_batch_rows([matrix], B, Bp)
    step = _sharded_step(_data_mesh(), mode, with_planes, backend, dtype,
                         track_argmax, float(del_), float(ext), batched_mat)
    outs = step(
        jnp.asarray(q, jnp.int32), jnp.asarray(ql, jnp.int32),
        jnp.asarray(t, jnp.int32), jnp.asarray(tl, jnp.int32),
        _matrix_arg(matrix, dtype, del_, ext, backend),
    )
    return _assemble_sharded_fill(
        outs, B, t.shape[1], backend, with_planes, device_dirs,
        (ql[:B], tl[:B], mode),
    )


def _fill_pwm_sharded(q, ql, pwm, del_, ext, with_planes, backend, dtype,
                      ndev, device_dirs=False, track_argmax=True):
    """Data-sharded PWM fill — the window-scan axis of the repeat search
    (engine/calc.rs:45-75) sharded over the device mesh.
    ``device_dirs`` as in :func:`_fill_sharded`."""
    import jax.numpy as jnp

    B = q.shape[0]
    Bp = -(-B // ndev) * ndev
    pwm = np.asarray(pwm)
    batched_mat = pwm.ndim == 3
    q, ql = _pad_batch_rows([q, ql], B, Bp)
    if batched_mat:
        (pwm,) = _pad_batch_rows([pwm], B, Bp)
    step = _sharded_step(_data_mesh(), "pwm", with_planes, backend, dtype,
                         track_argmax, float(del_), float(ext), batched_mat)
    outs = step(
        jnp.asarray(q, jnp.int32), jnp.asarray(ql, jnp.int32),
        _matrix_arg(pwm, dtype, del_, ext, backend),
    )
    return _assemble_sharded_fill(
        outs, B, q.shape[1], backend, with_planes, device_dirs,
        (np.full(B, pwm.shape[-1], np.int32), ql[:B], "local"),
    )


def _matrix_arg(matrix, dtype, del_, ext, backend):
    """Device matrix operand: the GPU kernel computes in int32 when the
    matrix and penalties are integral; the XLA engine in ``dtype``."""
    import jax.numpy as jnp

    if backend == "pallas":
        from .ops.pallas_dp import matrix_operand

        return matrix_operand(matrix, dtype, del_, ext)
    return jnp.asarray(matrix, dtype)


def _encode(seq, alphabet: type[Alphabet]) -> np.ndarray:
    if isinstance(seq, (str, bytes)):
        return alphabet.encode(seq)
    return np.asarray(seq, dtype=np.int8)


def pad_batch(
    seqs: Sequence[np.ndarray], multiple: int = 8
) -> tuple[np.ndarray, np.ndarray]:
    """Right-pad code arrays to a shared length (rounded up to ``multiple``
    to bound the number of distinct compiled shapes)."""
    if not seqs:
        raise ValidationError("empty batch")
    lens = np.array([len(s) for s in seqs], dtype=np.int32)
    width = max(int(lens.max()), 1)
    width = -(-width // multiple) * multiple
    out = np.zeros((len(seqs), width), dtype=np.int32)
    for i, s in enumerate(seqs):
        out[i, : len(s)] = s
    return out, lens


def _fill(q, ql, t, tl, matrix, del_, ext, mode, with_planes, backend, dtype,
          track_argmax=True, scores_plane=False, device_dirs=False):
    import jax.numpy as jnp

    from .observability import measure

    cells = int((np.asarray(ql, np.int64) * np.asarray(tl, np.int64)).sum())
    if scores_plane:
        backend = "xla"  # only the XLA engine materializes the score plane
    ndev = _auto_shard_devices()
    if ndev > 1 and len(ql) > 1 and not scores_plane:
        with measure(f"{backend}x{ndev}/{mode}", cells, len(ql)):
            res = _fill_sharded(
                q, ql, t, tl, matrix, del_, ext, mode, with_planes,
                backend, dtype, track_argmax or with_planes, ndev,
                device_dirs=device_dirs,
            )
            (res[0] if device_dirs and with_planes else res).fmax.block_until_ready()
        return res
    with measure(f"{backend}/{mode}", cells, len(ql)):
        if device_dirs and with_planes:
            from .ops.scan_engine import FillResult

            if backend == "pallas":
                from .ops.pallas_dp import fill_full_traced

                fmax, fy, fx, end, words = fill_full_traced(
                    q, ql, t, tl, _matrix_arg(matrix, dtype, del_, ext, backend),
                    del_, ext, mode=mode, dtype=dtype,
                )
                fmax.block_until_ready()
                return (
                    FillResult(plane=None, dirs=None, fmax=fmax, fy=fy,
                               fx=fx, end=end),
                    words, "packed",
                )
            from .ops.scan_engine import fill_batch

            r = fill_batch(
                q, ql, t, tl, jnp.asarray(matrix, dtype), del_, ext,
                mode=mode, with_planes=True, dtype=dtype,
            )
            r.fmax.block_until_ready()
            return (
                FillResult(plane=None, dirs=None, fmax=r.fmax, fy=r.fy,
                           fx=r.fx, end=r.end),
                r.dirs, "dense",
            )
        if backend == "pallas":
            from .ops.pallas_dp import fill_batch_pallas

            res = fill_batch_pallas(
                q, ql, t, tl, matrix, del_, ext, mode=mode,
                with_planes=with_planes, dtype=dtype,
                track_argmax=track_argmax,
            )
        else:
            from .ops.scan_engine import fill_batch

            res = fill_batch(
                q, ql, t, tl, jnp.asarray(matrix, dtype), del_, ext,
                mode=mode, with_planes=with_planes, dtype=dtype,
            )
        res.fmax.block_until_ready()
    return res


def _fill_pwm(q, ql, pwm, del_, ext, with_planes, backend, dtype,
              scores_plane=False, device_dirs=False, track_argmax=True):
    import jax.numpy as jnp

    from .observability import measure

    width = np.asarray(pwm).shape[-1]
    cells = int(np.asarray(ql, np.int64).sum()) * int(width)
    if scores_plane:
        backend = "xla"  # only the XLA engine materializes the score plane
    ndev = _auto_shard_devices()
    if ndev > 1 and len(ql) > 1 and not scores_plane:
        with measure(f"{backend}x{ndev}/pwm", cells, len(ql)):
            res = _fill_pwm_sharded(
                q, ql, pwm, del_, ext, with_planes, backend, dtype, ndev,
                device_dirs=device_dirs, track_argmax=track_argmax,
            )
            (res[0] if device_dirs and with_planes else res).fmax.block_until_ready()
        return res
    with measure(f"{backend}/pwm", cells, len(ql)):
        if device_dirs and with_planes:
            from .ops.scan_engine import FillResult

            if backend == "pallas":
                from .ops.pallas_dp import fill_pwm_full_traced

                fmax, fy, fx, end, words = fill_pwm_full_traced(
                    q, ql, _matrix_arg(pwm, dtype, del_, ext, backend),
                    del_, ext, dtype=dtype,
                )
                fmax.block_until_ready()
                return (
                    FillResult(plane=None, dirs=None, fmax=fmax, fy=fy,
                               fx=fx, end=end),
                    words, "packed",
                )
            from .ops.scan_engine import fill_pwm_batch

            r = fill_pwm_batch(
                q, ql, jnp.asarray(pwm, dtype), del_, ext,
                with_planes=True, dtype=dtype,
            )
            r.fmax.block_until_ready()
            return (
                FillResult(plane=None, dirs=None, fmax=r.fmax, fy=r.fy,
                           fx=r.fx, end=r.end),
                r.dirs, "dense",
            )
        if backend == "pallas":
            from .ops.pallas_dp import fill_pwm_batch_pallas

            res = fill_pwm_batch_pallas(
                q, ql, pwm, del_, ext, with_planes=with_planes, dtype=dtype,
                track_argmax=track_argmax,
            )
        else:
            from .ops.scan_engine import fill_pwm_batch

            res = fill_pwm_batch(
                q, ql, jnp.asarray(pwm, dtype), del_, ext,
                with_planes=with_planes, dtype=dtype,
            )
        res.fmax.block_until_ready()
    return res


def _integral_params(matrix_np, del_, ext) -> bool:
    return bool(
        np.all(matrix_np == np.round(matrix_np))
        and float(del_) == int(del_)
        and float(ext) == int(ext)
    )


# explicit backend names of the huge-pair pipeline
# (parallel/wavefront_sp.py): full alignments and end scores
PAIR_PIPELINE_BACKENDS = ("wavefront", "wavefront_sp", "diag")


def _use_pair_pipeline(qlen, tlen, matrix_np, del_, ext, *, backend, huge,
                       keep_planes):
    """Huge-pair dispatch: should this single global pair run on the
    row-scan pipeline over the local devices?  Raises ValidationError
    for an explicit pipeline backend it cannot honor; the auto path
    declines non-huge pairs.  One definition so align_global and
    global_end_score route identically."""
    from .parallel.wavefront_sp import range_ok

    ok = (
        _integral_params(matrix_np, del_, ext)
        and range_ok(qlen, tlen, del_, ext)
        and not keep_planes
    )
    if backend in PAIR_PIPELINE_BACKENDS:
        if not ok:
            raise ValidationError(
                f"backend {backend!r} requires an integral matrix/penalties "
                "with scores in the int32-exact range, and no keep_planes"
            )
        return True
    if huge and backend in (None, "auto"):
        if not ok:
            # every remaining engine materializes O(R*C) planes — at this
            # scale a silent fallthrough is an OOM, not an alignment; an
            # explicitly requested engine is honored
            raise ValidationError(
                f"global pair of {tlen}x{qlen} = {qlen * tlen} cells needs "
                "a materialized plane under the requested options; huge "
                "pairs require an integral matrix/penalties in int32 range "
                "and keep_planes=False"
            )
        return True
    return False


@dataclasses.dataclass
class BatchScores:
    """Scores-only batched result (no planes, no traceback).

    ``fmax``: local max score per problem; ``fy``/``fx``: its plane coords
    (first maximum in row-major order); ``end``: a[tlen, qlen].
    """

    fmax: np.ndarray
    fy: np.ndarray
    fx: np.ndarray
    end: np.ndarray


def align_global(
    query,
    target,
    matrix,
    del_: float,
    ext: float,
    *,
    alphabet: type[Alphabet] = Protein,
    backend: str | None = None,
    dtype=None,
    keep_planes: bool = False,
) -> AlignmentResult:
    """Global (NW-style) alignment of one pair (simple/mod.rs:42-144).

    Huge single pairs (past the direct-plane budget) route to the exact
    int32 row-scan pipeline over the local devices
    (:func:`aligner_tpu.parallel.sharded_global_align`) when the matrix
    and penalties are integral — exact in global mode because the
    penalty is constant ``ext`` after cell (1,1) (SURVEY.md §2.3.3);
    force it with ``backend="wavefront"``.
    """
    q = _encode(query, alphabet)
    t = _encode(target, alphabet)
    if len(q) == 0 or len(t) == 0:
        raise ResultIsEmpty("empty sequence")
    cells = len(q) * len(t)
    from .parallel.wavefront_sp import DIRECT_PLANE_CELLS

    matrix_np = np.asarray(matrix)
    if _use_pair_pipeline(
        len(q), len(t), matrix_np, del_, ext, backend=backend,
        huge=cells > DIRECT_PLANE_CELLS, keep_planes=keep_planes,
    ):
        from .parallel.wavefront_sp import sharded_global_align

        # _data_mesh: LOCAL devices under a multi-controller runtime —
        # a single process must not shard_map over non-addressable devices
        _, qa, ta, coords = sharded_global_align(
            _data_mesh(), q, t, matrix_np, del_, ext
        )
        aln = Alignment(qa, ta, coords, 0.0, alphabet)
        return AlignmentResult(aln)
    backend = pick_backend(backend, cells=cells)
    if backend == "oracle":
        r = host.align_global(q, t, np.asarray(matrix), del_, ext)
        aln = Alignment(r.query_aligned, r.target_aligned, r.coords, r.f, alphabet)
        return AlignmentResult(
            aln,
            score=r.score if keep_planes else None,
            directions=r.directions if keep_planes else None,
        )
    dtype = dtype or default_dtype()
    res = _fill(
        q[None].astype(np.int32), np.array([len(q)]),
        t[None].astype(np.int32), np.array([len(t)]),
        matrix, del_, ext, "global", True, backend, dtype,
        scores_plane=keep_planes,
    )
    dirs = np.asarray(res.dirs[0])
    qa, ta, coords = traceback_global(dirs[: len(t) + 1, : len(q) + 1], q, t)
    aln = Alignment(qa, ta, coords, 0.0, alphabet)
    return AlignmentResult(
        aln,
        score=np.asarray(res.plane[0])[: len(t) + 1, : len(q) + 1]
        if keep_planes
        else None,
        directions=dirs[: len(t) + 1, : len(q) + 1] if keep_planes else None,
    )


def global_end_score(
    query,
    target,
    matrix,
    del_: float,
    ext: float,
    *,
    alphabet: type[Alphabet] = Protein,
    backend: str | None = None,
) -> float:
    """Exact global end score ``H[tlen, qlen]`` of ONE pair — no plane,
    no traceback (an extension; the reference always builds the full
    alignment, simple/mod.rs:42-98, but serving end scores is the cheap
    half of that DP).

    Dispatch mirrors :func:`align_global`: pairs past the direct-plane
    budget use the row-scan pipeline over the local devices, everything
    else the host fill.  Force with ``backend`` in
    ``{"diag", "wavefront", "wavefront_sp", "host"}``.
    """
    q = _encode(query, alphabet)
    t = _encode(target, alphabet)
    if len(q) == 0 or len(t) == 0:
        raise ResultIsEmpty("empty sequence")
    from .parallel.wavefront_sp import DIRECT_PLANE_CELLS

    matrix_np = np.asarray(matrix)
    if backend not in (None, "auto", "host", *PAIR_PIPELINE_BACKENDS):
        raise ValidationError(
            f"unknown backend {backend!r} for global_end_score "
            "(choose auto, diag, wavefront, wavefront_sp, or host)"
        )
    if _use_pair_pipeline(
        len(q), len(t), matrix_np, del_, ext, backend=backend,
        huge=len(q) * len(t) > DIRECT_PLANE_CELLS, keep_planes=False,
    ):
        from .parallel.wavefront_sp import sharded_global_end_score

        return float(
            sharded_global_end_score(
                _data_mesh(), q, t, matrix_np, del_, ext
            )
        )
    r = host.align_global(q, t, matrix_np, del_, ext)
    return float(r.score[len(t), len(q)])


def local_max_score(
    query,
    target,
    matrix,
    del_: float,
    ext: float,
    *,
    alphabet: type[Alphabet] = Protein,
) -> tuple[float, tuple[int, int]]:
    """Maximum local score and its cell, without a traceback — the
    LOCAL-mode sibling of :func:`global_end_score` (the reference's
    ``f`` field, simple/mod.rs:247, and the value every p-value /
    service workload consumes).  Returns ``(f, (my, mx))`` with the
    plane argmax in first-row-major order (simple/mod.rs:212).

    Runs the native streaming fill in O(tn) memory at any size (the
    local fill is serial per SURVEY §2.3.3 — batches, not wavefronts,
    are LOCAL mode's parallel axis); without the native runtime it
    falls back to the device scores-only fill (same outputs, no plane,
    any size)."""
    from . import native

    q = _encode(query, alphabet)
    t = _encode(target, alphabet)
    if len(q) == 0 or len(t) == 0:
        raise ResultIsEmpty("empty sequence")
    if native.available():
        f, my, mx = native.local_max_score_stream(
            q, t, np.asarray(matrix), del_, ext
        )
        return f, (my, mx)
    # no native runtime: the batched scores-only fill returns exactly
    # (fmax, argmax) without materializing a plane — O(C) live state in
    # the scan and ~1000x the Python oracle's cell rate, so even pairs
    # past the direct-plane budget stay practical
    res = batch_align(
        [q], [t], np.asarray(matrix), del_, ext, mode="local",
        alphabet=alphabet, with_alignments=False,
    )
    return float(res.fmax[0]), (int(res.fy[0]), int(res.fx[0]))


def align_local(
    query,
    target,
    matrix,
    del_: float,
    ext: float,
    *,
    alphabet: type[Alphabet] = Protein,
    backend: str | None = None,
    dtype=None,
    keep_planes: bool = False,
) -> AlignmentResult:
    """Local (SW-style) alignment of one pair (simple/mod.rs:147-264).

    Huge pairs (area past the direct-plane budget) auto-route to the
    native streaming engine — exact, memory-bounded O(tn·(qn/cb + cb))
    checkpoint-and-replay instead of a materialized O(qn·tn) plane.
    The local fill is inherently serial (the gap-penalty state chains
    through every cell, SURVEY §2.3.3), so unlike GLOBAL mode there is
    no wavefront/device path for a single pair; ``backend="stream"``
    forces the streaming engine at any size."""
    from .parallel.wavefront_sp import DIRECT_PLANE_CELLS

    q = _encode(query, alphabet)
    t = _encode(target, alphabet)
    if len(q) == 0 or len(t) == 0:
        raise ResultIsEmpty("empty sequence")
    cells = len(q) * len(t)
    huge = cells > DIRECT_PLANE_CELLS
    if backend == "stream" or (backend in (None, "auto") and huge):
        from . import native

        if backend == "stream" and keep_planes:
            raise ValidationError(
                "stream cannot materialize planes (keep_planes)"
            )
        if native.available() and not keep_planes:
            f, qa, ta, coords = native.align_local_stream(
                q, t, np.asarray(matrix), del_, ext
            )
            aln = Alignment(qa, ta, coords, f, alphabet)
            return AlignmentResult(aln)
        if backend == "stream":
            raise ValidationError(
                "backend='stream' requires the native runtime "
                "(ALIGNER_NO_NATIVE unset and a working g++)"
            )
        if huge:
            raise ValidationError(
                f"local pair of {cells} cells needs a materialized "
                "O(R*C) plane under the requested options; huge pairs "
                "require the native streaming engine (default route) "
                "without keep_planes"
            )
    backend = pick_backend(backend, cells=cells)
    if backend == "oracle":
        r = host.align_local(q, t, np.asarray(matrix), del_, ext)
        aln = Alignment(r.query_aligned, r.target_aligned, r.coords, r.f, alphabet)
        return AlignmentResult(
            aln,
            score=r.score if keep_planes else None,
            directions=r.directions if keep_planes else None,
        )
    dtype = dtype or default_dtype()
    res = _fill(
        q[None].astype(np.int32), np.array([len(q)]),
        t[None].astype(np.int32), np.array([len(t)]),
        matrix, del_, ext, "local", True, backend, dtype,
        scores_plane=keep_planes,
    )
    dirs = np.asarray(res.dirs[0])
    my, mx = int(res.fy[0]), int(res.fx[0])
    qa, ta, coords = traceback_local(dirs, my, mx, q, t)
    aln = Alignment(qa, ta, coords, float(res.fmax[0]), alphabet)
    return AlignmentResult(
        aln,
        score=np.asarray(res.plane[0])[: len(t) + 1, : len(q) + 1]
        if keep_planes
        else None,
        directions=dirs[: len(t) + 1, : len(q) + 1] if keep_planes else None,
    )


def align_pwm(
    query,
    pwm: np.ndarray,
    del_: float,
    ext: float,
    *,
    alphabet: type[Alphabet] = DNA,
    backend: str | None = None,
    dtype=None,
) -> AlignmentResult:
    """Query-vs-PWM local alignment (pwm/mod.rs:29-126).

    Unlike the pair aligners, an empty query is NOT an error: the
    reference's PWM traceback walks from the all-zero plane's (0, 0)
    argmax and returns an empty ``PWMAlignment`` with coords
    ((1, 1), (1, 1)) and f = 0 (pwm/mod.rs:105-125) — this function
    reproduces that, deliberately diverging from align_global/
    align_local's ResultIsEmpty."""
    pwm = np.asarray(pwm)
    if pwm.shape[0] != 4:
        raise MatrixShapeError(f"PWM must have 4 rows, got {pwm.shape[0]}")
    q = _encode(query, alphabet)
    backend = pick_backend(backend, cells=len(q) * pwm.shape[1])
    if backend == "oracle":
        r = host.align_pwm(q, pwm, del_, ext)
        aln = PWMAlignment(
            r.target_aligned.astype(np.int32), r.query_aligned,
            pwm.shape[1], r.coords, r.f, alphabet,
        )
        return AlignmentResult(aln)
    dtype = dtype or default_dtype()
    res = _fill_pwm(
        q[None].astype(np.int32), np.array([len(q)]), pwm, del_, ext,
        True, backend, dtype,
    )
    dirs = np.asarray(res.dirs[0])
    my, mx = int(res.fy[0]), int(res.fx[0])
    qa, numbered, coords = traceback_pwm(dirs, my, mx, q)
    aln = PWMAlignment(numbered, qa, pwm.shape[1], coords, float(res.fmax[0]), alphabet)
    return AlignmentResult(aln)


def batch_align(
    queries: Sequence,
    targets: Sequence,
    matrix,
    del_: float,
    ext: float,
    *,
    mode: str = "local",
    alphabet: type[Alphabet] = Protein,
    backend: str | None = None,
    dtype=None,
    with_alignments: bool = False,
    track_argmax: bool = True,
    pad_to: int | None = None,
    skip: np.ndarray | None = None,
):
    """Batched alignment of N independent (query, target) pairs.

    ``matrix`` may be one (V, V) matrix shared by the batch or (B, V, V)
    per-problem matrices.  Without ``with_alignments`` this is scores-only
    (no direction planes leave the device) and returns :class:`BatchScores`;
    with it, a list of :class:`AlignmentResult` (the batched equivalent
    of the reference's thread fan-outs, statistics/mod.rs:253-291).

    ``pad_to`` pads the batch with inactive problems to a fixed size so
    chunked callers reuse one compiled kernel; ``skip`` marks problems
    inactive (zero-length — effectively free) so iterative drivers can
    retire problems without changing the compiled shape.  Skipped /
    padded entries return score 0 and (with alignments) ``None``.
    """
    def _pair_result(mode, walk_q, walk_t, q_b, t_b, ql_b, tl_b,
                     sy_b, sx_b, end_y_b, end_x_b, fmax_b, alphabet):
        # one definition of the seed-append/coords/f assembly for BOTH
        # walkers (device stream decode and native batch walk) so the
        # two cannot drift; the seeded character pair lands *after* the
        # reversed walk (simple/mod.rs:99-106/213-218)
        if mode == "global":
            qa = np.append(walk_q, np.int16(q_b[-1]))
            ta = np.append(walk_t, np.int16(t_b[-1]))
            coords = ((1, ql_b), (1, tl_b))
            f = 0.0
        else:
            qa = np.append(walk_q, np.int16(q_b[sx_b - 1]))
            ta = np.append(walk_t, np.int16(t_b[sy_b - 1]))
            coords = ((end_x_b + 1, sx_b + 1), (end_y_b + 1, sy_b + 1))
            f = fmax_b
        return AlignmentResult(Alignment(qa, ta, coords, f, alphabet))

    qs = [_encode(s, alphabet) for s in queries]
    ts = [_encode(s, alphabet) for s in targets]
    if len(qs) != len(ts):
        raise ValidationError("queries and targets must have the same length")
    n_real = len(qs)
    q, ql = pad_batch(qs)
    t, tl = pad_batch(ts)
    if skip is not None:
        ql = np.where(np.asarray(skip, bool), 0, ql).astype(np.int32)
        tl = np.where(np.asarray(skip, bool), 0, tl).astype(np.int32)
    if pad_to is not None:
        if len(qs) > pad_to:
            # silently ignoring an undersized bucket would ship the raw
            # batch size and compile a fresh kernel per distinct size —
            # the very thing pad_to exists to prevent (CLAUDE.md:
            # constant compiled shapes)
            raise ValidationError(
                f"pad_to={pad_to} is smaller than the batch ({len(qs)})"
            )
        extra = pad_to - len(qs)
        q = np.pad(q, ((0, extra), (0, 0)))
        t = np.pad(t, ((0, extra), (0, 0)))
        ql = np.pad(ql, (0, extra))
        tl = np.pad(tl, (0, extra))
        if matrix is not None and np.asarray(matrix).ndim == 3:
            matrix = np.pad(
                np.asarray(matrix), ((0, extra), (0, 0), (0, 0))
            )
    backend = pick_backend(backend)
    if backend == "oracle":
        backend = "xla"  # the batch path is device-only; oracle covers singles
    dtype = dtype or default_dtype()
    # device walk by default: the direction planes stay in HBM and only
    # the 2-bit step streams transfer (~200x less than the packed
    # planes); ALIGNER_DEVICE_WALK=0 restores the host walks
    use_dev = (
        with_alignments
        and os.environ.get("ALIGNER_DEVICE_WALK", "1") != "0"
    )
    skip_mask = (
        np.zeros(n_real, bool) if skip is None else np.asarray(skip, bool)[:n_real]
    )
    if with_alignments:
        # empty sequences cannot seed a traceback (the q[-1] seed char);
        # reject BEFORE the batched fill (the check only needs lengths —
        # failing after would waste the whole launch and, on a fresh
        # shape, a compile) like the single-pair APIs do
        if (((ql[:n_real] == 0) | (tl[:n_real] == 0)) & ~skip_mask).any():
            raise ResultIsEmpty("empty sequence")
    # global mode: the pallas kernel captures the end score H[tlen,qlen]
    # inside the argmax machinery, so honoring track_argmax=False there
    # would return end=0 on pallas but real scores on xla — force
    # tracking instead of silently diverging between backends
    filled = _fill(q, ql, t, tl, matrix, del_, ext, mode, with_alignments,
                   backend, dtype,
                   track_argmax=(track_argmax or with_alignments
                                 or mode == "global"),
                   device_dirs=use_dev)
    if use_dev:
        res, dirs_dev, fmt = filled
    else:
        res = filled
    if not with_alignments:
        return BatchScores(
            fmax=np.asarray(res.fmax)[:n_real], fy=np.asarray(res.fy)[:n_real],
            fx=np.asarray(res.fx)[:n_real], end=np.asarray(res.end)[:n_real],
        )
    fmax_np = np.asarray(res.fmax)  # one transfer, not B scalars
    if mode == "local":
        fy_np = np.asarray(res.fy, np.int32)
        fx_np = np.asarray(res.fx, np.int32)
        # a problem with no positive-scoring cell has no alignment (the
        # reference would panic on its 0-index seed, simple/mod.rs:213-218;
        # the single-pair API raises ResultIsEmpty): return None for JUST
        # that problem instead of failing the whole batch
        skip_mask = skip_mask | (fy_np[:n_real] == 0) | (fx_np[:n_real] == 0)
    if use_dev:
        from .ops.device_walk import decode_pair_batch, walk_batch

        if mode == "global":
            sy_full = tl.astype(np.int32)
            sx_full = ql.astype(np.int32)
        else:
            sy_full = fy_np
            sx_full = fx_np
        steps, lens, ey, ex = walk_batch(
            dirs_dev, fmt, mode, sy_full, sx_full, t.shape[1], q.shape[1]
        )
        qa_ws, ta_ws = decode_pair_batch(steps, lens, sy_full, sx_full, q, t)
        out = []
        for b in range(n_real):
            if skip_mask[b]:
                out.append(None)
                continue
            out.append(_pair_result(
                mode, qa_ws[b], ta_ws[b], qs[b], ts[b], int(ql[b]), int(tl[b]),
                int(sy_full[b]), int(sx_full[b]), int(ey[b]), int(ex[b]),
                float(fmax_np[b]), alphabet,
            ))
        return out
    dirs = np.asarray(res.dirs[:n_real])  # slice device-side: padded planes never transfer
    from . import native

    if native.available() and not skip_mask.any():
        # one C call walks the whole batch (native/aligner_native.cpp);
        # everything is sliced to n_real so pad_to padding (ql=tl=0,
        # fy=fx=0) cannot trip the empty-result check
        if mode == "global":
            sy = tl[:n_real].astype(np.int64)
            sx = ql[:n_real].astype(np.int64)
        else:
            sy = fy_np[:n_real].astype(np.int64)
            sx = fx_np[:n_real].astype(np.int64)
        q8 = q[:n_real].astype(np.int8)
        t8 = t[:n_real].astype(np.int8)
        walks_q, walks_t, end_y, end_x = native.traceback_batch(
            dirs, sy, sx, q8, t8, pwm_mode=False
        )
        return [
            _pair_result(
                mode, walks_q[b], walks_t[b], qs[b], ts[b],
                int(ql[b]), int(tl[b]), int(sy[b]), int(sx[b]),
                int(end_y[b]), int(end_x[b]), float(fmax_np[b]), alphabet,
            )
            for b in range(len(qs))
        ]

    out = []
    for b in range(n_real):
        if skip_mask[b]:
            out.append(None)
            continue
        d = dirs[b, : tl[b] + 1, : ql[b] + 1]
        if mode == "global":
            qa, ta, coords = traceback_global(d, qs[b], ts[b])
            f = 0.0
        else:
            qa, ta, coords = traceback_local(
                d, int(fy_np[b]), int(fx_np[b]), qs[b], ts[b]
            )
            f = float(fmax_np[b])
        out.append(AlignmentResult(Alignment(qa, ta, coords, f, alphabet)))
    return out


def batch_align_pwm(
    queries: Sequence,
    pwm: np.ndarray,
    del_: float,
    ext: float,
    *,
    alphabet: type[Alphabet] = DNA,
    backend: str | None = None,
    dtype=None,
    with_alignments: bool = False,
    track_argmax: bool = True,
    pad_to: int | None = None,
    skip: np.ndarray | None = None,
):
    """Batched query-vs-PWM alignment (one PWM shared or (B, 4, W) batched).

    This is the window-scan primitive of the latent-repeat search
    (engine/calc.rs:45-75): all windows become one launch.
    ``track_argmax=False`` (scores-only mode only): skip per-cell argmax
    bookkeeping when the caller consumes just ``fmax`` — the returned
    fy/fx/end are then backend-dependent filler (the window-scan
    z-filter path).

    ``pad_to``/``skip`` as in :func:`batch_align`: padding problems are
    zero-length (free — no duplicated fills/walks) and not returned;
    skipped real problems return ``None`` (score 0 in scores-only mode).
    """
    pwm = np.asarray(pwm)
    if pwm.shape[-2] != 4:
        raise MatrixShapeError(f"PWM must have 4 rows, got {pwm.shape[-2]}")
    qs = [_encode(s, alphabet) for s in queries]
    n_real = len(qs)
    q, ql = pad_batch(qs)
    if skip is not None:
        ql = np.where(np.asarray(skip, bool), 0, ql).astype(np.int32)
    if pad_to is not None:
        if n_real > pad_to:
            raise ValidationError(
                f"pad_to={pad_to} is smaller than the batch ({n_real})"
            )
        extra = pad_to - n_real
        q = np.pad(q, ((0, extra), (0, 0)))
        ql = np.pad(ql, (0, extra))
        if pwm.ndim == 3:
            pwm = np.pad(pwm, ((0, extra), (0, 0), (0, 0)))
    skip_mask = (
        np.zeros(n_real, bool) if skip is None else np.asarray(skip, bool)[:n_real]
    )
    backend = pick_backend(backend)
    if backend == "oracle":
        backend = "xla"
    dtype = dtype or default_dtype()
    use_dev = (
        with_alignments
        and os.environ.get("ALIGNER_DEVICE_WALK", "1") != "0"
    )
    filled = _fill_pwm(q, ql, pwm, del_, ext, with_alignments, backend,
                       dtype, device_dirs=use_dev,
                       track_argmax=track_argmax or with_alignments)
    if use_dev:
        res, dirs_dev, fmt = filled
    else:
        res = filled
    if not with_alignments:
        return BatchScores(
            fmax=np.asarray(res.fmax)[:n_real], fy=np.asarray(res.fy)[:n_real],
            fx=np.asarray(res.fx)[:n_real], end=np.asarray(res.end)[:n_real],
        )
    width = pwm.shape[-1]
    if use_dev:
        from .ops.device_walk import decode_pwm_batch, walk_batch

        sy = np.asarray(res.fy, np.int32)
        sx = np.asarray(res.fx, np.int32)
        # PWM planes are (qlen+1, W+1): rows = query positions
        steps, lens, ey, ex = walk_batch(
            dirs_dev, fmt, "local", sy, sx, q.shape[1], width
        )
        fmax_np = np.asarray(res.fmax)  # one transfer, not B scalars
        qa_ws, num_ws = decode_pwm_batch(steps, lens, sy, sx, q)
        out = []
        for b in range(n_real):
            if skip_mask[b]:
                out.append(None)
                continue
            coords = (
                (int(ex[b]) + 1, int(sx[b]) + 1),
                (int(ey[b]) + 1, int(sy[b]) + 1),
            )
            out.append(
                AlignmentResult(
                    PWMAlignment(num_ws[b], qa_ws[b], width, coords,
                                 float(fmax_np[b]), alphabet)
                )
            )
        return out
    # slice off pad_to padding BEFORE the device->host transfer — the
    # padded problems' planes are never read (mirrors batch_align)
    dirs = np.asarray(res.dirs[:n_real])
    fmax_np = np.asarray(res.fmax)  # one transfer, not B scalars
    fy_np = np.asarray(res.fy)
    fx_np = np.asarray(res.fx)
    out = []
    for b in range(n_real):
        if skip_mask[b]:
            out.append(None)
            continue
        d = dirs[b, : ql[b] + 1, : width + 1]
        qa, numbered, coords = traceback_pwm(d, int(fy_np[b]), int(fx_np[b]), qs[b])
        out.append(
            AlignmentResult(
                PWMAlignment(numbered, qa, width, coords, float(fmax_np[b]), alphabet)
            )
        )
    return out


# ---------------------------------------------------------------------------
# Class wrappers mirroring the reference's AlignerTrait (lib.rs:27-40).
# ---------------------------------------------------------------------------


class _SimpleAligner:
    _mode: str

    def __init__(self, query: np.ndarray, target: np.ndarray, alphabet):
        self.query = query
        self.target = target
        self.alphabet = alphabet

    @classmethod
    def from_str_seqs(cls, query: str, target: str, alphabet=Protein):
        return cls(alphabet.encode(query, strict=True), alphabet.encode(target, strict=True), alphabet)

    @classmethod
    def from_seqs(cls, query, target, alphabet=Protein):
        return cls(_encode(query, alphabet), _encode(target, alphabet), alphabet)

    def perform_alignment(
        self, del_: float, ext: float, matrix, heuristics=None, **kw
    ) -> AlignmentResult:
        if heuristics is not None:
            raise UnnecessaryArgument(
                "simple aligners take no heuristics (lib.rs Error::UnnecessaryArgument)"
            )
        fn = align_global if self._mode == "global" else align_local
        kw.setdefault("keep_planes", True)
        return fn(self.query, self.target, matrix, del_, ext, alphabet=self.alphabet, **kw)


class SimpleGlobalAligner(_SimpleAligner):
    """Equivalent of aligner-core SimpleGlobalAligner (simple/mod.rs:9-145)."""

    _mode = "global"


class SimpleLocalAligner(_SimpleAligner):
    """Equivalent of aligner-core SimpleLocalAligner (simple/mod.rs:147-265)."""

    _mode = "local"


class PWMAligner:
    """Equivalent of aligner-core PWMAligner (pwm/mod.rs)."""

    def __init__(self, query: np.ndarray, alphabet=DNA):
        self.query = query
        self.alphabet = alphabet

    @classmethod
    def from_str_seqs(cls, query: str, alphabet=DNA):
        return cls(alphabet.encode(query), alphabet)

    @classmethod
    def from_seqs(cls, query, alphabet=DNA):
        return cls(_encode(query, alphabet), alphabet)

    def perform_alignment(
        self, del_: float, ext: float, pwm, heuristics=None, **kw
    ) -> AlignmentResult:
        if heuristics is not None:
            raise UnnecessaryArgument("PWM aligner takes no heuristics")
        return align_pwm(self.query, pwm, del_, ext, alphabet=self.alphabet, **kw)
