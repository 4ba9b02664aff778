"""Heuristic (matrix-free) aligners.

Equivalent of aligner-core/src/heuristic/mod.rs: derive a scoring matrix
iteratively — align locally with a transformed matrix, take the
alignment's substitution-frequency matrix, project it back onto the
(kd, r²) constraint surface, realign — until the local score stops
strictly improving (heuristic/mod.rs:58-77).  The returned result is the
first *non-improving* alignment with the matrix that produced it attached
(heuristic/mod.rs:73-76).

Batched addition: :func:`heuristic_align_population` iterates a whole
population of candidate starting matrices as one problem batch (the
aligner-web service ships one Kafka job per matrix, node/main.rs:61-74;
here the population is the batch axis of a single kernel launch per
iteration, with converged problems masked out).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from .align import align_local, align_pwm, batch_align
from .alphabet import DNA, Alphabet, Protein
from .errors import MissingArgument, ValidationError, WrongMatrixSpecified
from .matrices import transform_matrix
from .result import AlignmentResult


@dataclasses.dataclass
class Heuristics:
    """Matrix-derivation parameters (lib.rs:21-25)."""

    kd: float
    r_squared: float
    frequencies: np.ndarray


def heuristic_align(
    query,
    target,
    matrix,
    del_: float,
    ext: float,
    heuristics: Heuristics | None,
    *,
    alphabet: type[Alphabet] = Protein,
    backend: str | None = None,
    max_iters: int = 1000,
) -> AlignmentResult:
    """Pairwise heuristic local alignment (heuristic/mod.rs:36-78).

    ``r_squared == 0`` defaults to rows*cols of the seed matrix
    (heuristic/mod.rs:48-50).  ``max_iters`` is a safety bound absent in
    the reference (whose loop is unbounded).
    """
    if heuristics is None:
        raise MissingArgument("heuristic aligner requires Heuristics")
    matrix = np.asarray(matrix, dtype=np.float64)
    r_squared = heuristics.r_squared
    if abs(r_squared) < np.finfo(np.float64).eps:
        r_squared = float(matrix.shape[0] * matrix.shape[1])

    transformed = transform_matrix(
        matrix, heuristics.kd, r_squared, heuristics.frequencies
    )
    if max_iters < 1:
        raise ValidationError("max_iters must be >= 1")
    max_f = 0.0
    for _ in range(max_iters):
        current = transformed  # the matrix THIS iteration aligns with
        result = align_local(
            query, target, current, del_, ext,
            alphabet=alphabet, backend=backend,
        )
        if result.alignment.f > max_f:
            max_f = result.alignment.f
            transformed = transform_matrix(
                result.alignment.frequency_matrix(),
                heuristics.kd, r_squared, heuristics.frequencies,
            )
        else:
            result.matrix = current
            return result
    # max_iters exhausted while still improving: attach the matrix that
    # PRODUCED the returned alignment (not the freshly transformed one)
    result.matrix = current
    return result


def heuristic_align_pwm(
    query,
    pwm,
    del_: float,
    ext: float,
    heuristics: Heuristics | None,
    *,
    alphabet: type[Alphabet] = DNA,
    backend: str | None = None,
    max_iters: int = 1000,
) -> AlignmentResult:
    """Query-vs-PWM heuristic alignment (heuristic/mod.rs:103-141).

    Note the PWM variant does *not* apply the r_squared==0 default.
    """
    if heuristics is None:
        raise MissingArgument("heuristic aligner requires Heuristics")
    pwm = np.asarray(pwm, dtype=np.float64)
    transformed = transform_matrix(
        pwm, heuristics.kd, heuristics.r_squared, heuristics.frequencies
    )
    if max_iters < 1:
        raise ValidationError("max_iters must be >= 1")
    max_f = 0.0
    for _ in range(max_iters):
        current = transformed
        result = align_pwm(
            query, current, del_, ext, alphabet=alphabet, backend=backend
        )
        if result.alignment.f > max_f:
            max_f = result.alignment.f
            transformed = transform_matrix(
                result.alignment.frequency_matrix(),
                heuristics.kd, heuristics.r_squared, heuristics.frequencies,
            )
        else:
            result.matrix = current
            return result
    result.matrix = current
    return result


_POP_LOOP_JIT = None


def _population_device_loop(*args, **kw):
    """Lazily-jitted wrapper for :func:`_population_device_loop_impl`
    (jax is imported on first use, and the jit cache is shared across
    calls so one compile covers every task with the same shapes)."""
    global _POP_LOOP_JIT
    if _POP_LOOP_JIT is None:
        import jax

        _POP_LOOP_JIT = jax.jit(
            _population_device_loop_impl,
            static_argnames=("backend", "del_", "ext"),
        )
    return _POP_LOOP_JIT(*args, **kw)


def _population_device_loop_impl(q2, ql0, t2, tl0, transformed, freqs, kd,
                                 r2, max_iters, *, backend, del_, ext):
    """The WHOLE heuristic population loop as one device dispatch.

    A ``lax.while_loop`` whose body runs fill → traceback walk →
    frequency-matrix scatter-add → ``transform_matrix_jax`` for every
    still-improving member (SURVEY C5's device scatter-add mandate; the
    reference's service hot loop is node/main.rs:61-74 around
    heuristic/mod.rs:58-77).  Converged members are masked to
    zero-length problems (constant compiled shapes); the host reads back
    only the final (done, dead, max_f, transformed) state.

    Semantics per member follow :func:`heuristic_align` exactly except
    that in-loop matrix transforms round in the device dtype (f32 on
    the GPU) instead of host f64 — the fill/walk/count pipeline itself is
    bit-exact (counts are small integers), pinned by
    tests/test_heuristic_stats.py; a transform with no real roots
    propagates NaN instead of raising and is surfaced by the caller.
    """
    import jax
    import jax.numpy as jnp

    from .matrices import transform_matrix_jax
    from .ops.device_walk import DIAG, LEFT, TOP, _walk_device

    M, V = transformed.shape[0], transformed.shape[-1]
    Cq, Rt = q2.shape[1], t2.shape[1]
    S = Rt + Cq + 1
    dtype = transformed.dtype

    def fill(trans, ql, tl):
        if backend == "pallas":
            from .ops.pallas_dp import fill_full_traced

            fmax, fy, fx, end, words = fill_full_traced(
                q2, ql, t2, tl, trans, del_, ext, mode="local", dtype=dtype
            )
            return fmax, fy, fx, words.reshape(M, -1), "packed", 0
        from .ops.scan_engine import fill_batch

        r = fill_batch(q2, ql, t2, tl, trans, del_, ext, mode="local",
                       with_planes=True, dtype=dtype)
        return r.fmax, r.fy, r.fx, r.dirs.reshape(M, -1), "dense", Cq + 1

    def body(state):
        it, done, dead, max_f, trans, prod = state
        ql = jnp.where(done, 0, ql0)
        tl = jnp.where(done, 0, tl0)
        fmax, fy, fx, flat, fmt, w1 = fill(trans, ql, tl)
        fy = jnp.asarray(fy, jnp.int32)
        fx = jnp.asarray(fx, jnp.int32)
        packed, n, ey, ex = _walk_device(
            flat, fy, fx, S=S, fmt=fmt, mode="local", C=Cq, W1=w1
        )
        # unpack the 2-bit step stream on device: (S, M) codes
        shifts = jnp.arange(16, dtype=jnp.int32) * 2
        d = (packed[:, None, :] >> shifts[None, :, None]) & 3
        steps = d.reshape(-1, M)[:S]
        up = (steps == TOP) | (steps == DIAG)
        lf = (steps == LEFT) | (steps == DIAG)
        z = jnp.zeros((1, M), jnp.int32)
        y_at = fy[None, :] - jnp.concatenate(
            [z, jnp.cumsum(up[:-1], axis=0, dtype=jnp.int32)]
        )
        x_at = fx[None, :] - jnp.concatenate(
            [z, jnp.cumsum(lf[:-1], axis=0, dtype=jnp.int32)]
        )
        # frequency matrices: count (t_char, q_char) on DIAG steps (the
        # TOP/LEFT steps emit a blank on one side and are excluded by
        # alignment.rs:13-23) + the seeded argmax-cell pair
        valid = (jnp.arange(S)[:, None] < n[None, :]) & (steps == DIAG)
        tc = jnp.take_along_axis(t2.T, jnp.clip(y_at - 1, 0, Rt - 1), axis=0)
        qc = jnp.take_along_axis(q2.T, jnp.clip(x_at - 1, 0, Cq - 1), axis=0)
        bidx = jnp.broadcast_to(
            jnp.arange(M, dtype=jnp.int32)[None, :], (S, M)
        )
        flat_idx = (bidx * (V * V) + tc * V + qc).ravel()
        freq = jnp.zeros((M * V * V), dtype).at[flat_idx].add(
            valid.ravel().astype(dtype)
        )
        seed_t = jnp.take_along_axis(
            t2, jnp.clip(fy - 1, 0, Rt - 1)[:, None], axis=1
        )[:, 0]
        seed_q = jnp.take_along_axis(
            q2, jnp.clip(fx - 1, 0, Cq - 1)[:, None], axis=1
        )[:, 0]
        alive = ~done
        seed_ok = alive & (fy > 0) & (fx > 0)
        sidx = jnp.arange(M, dtype=jnp.int32) * (V * V) + seed_t * V + seed_q
        freq = freq.at[sidx].add(seed_ok.astype(dtype)).reshape(M, V, V)

        newt = jax.vmap(
            lambda f: transform_matrix_jax(f, kd, r2, freqs)
        )(freq)
        newly_dead = alive & ((fy == 0) | (fx == 0))
        improved = alive & ~newly_dead & (fmax > max_f)
        # the matrix that PRODUCED each member's last accepted alignment
        # (this iteration's fill matrix) — what a max_iters-exhausted
        # member must report, matching heuristic_align's exhaustion rule
        prod = jnp.where(improved[:, None, None], trans, prod)
        trans = jnp.where(improved[:, None, None], newt, trans)
        max_f = jnp.where(improved, fmax, max_f)
        done = done | (alive & ~improved)
        dead = dead | newly_dead
        return it + 1, done, dead, max_f, trans, prod

    def cond(state):
        it, done, *_ = state
        return (it < max_iters) & ~done.all()

    init = (
        jnp.int32(0),
        jnp.zeros(M, bool),
        jnp.zeros(M, bool),
        jnp.zeros(M, dtype),
        transformed,
        transformed,
    )
    return jax.lax.while_loop(cond, body, init)


def _use_device_loop(backend: str) -> bool:
    """The fused population loop is ON where the platform table says so
    (the per-iteration host round-trip is what it removes); the host
    loop stays the strict-f64-transform reference path.
    ALIGNER_POP_DEVICE_LOOP=0/1 overrides."""
    env = os.environ.get("ALIGNER_POP_DEVICE_LOOP")
    if env is not None:
        return env != "0"
    if backend == "oracle":
        return False
    from .backend import platform

    return platform().fused_population


def _tile_pair(q, t, M):
    """Tile one encoded (q, t) pair into the (M, len-padded-to-8) int32
    batch operands of the fused population loop — the SAME padding
    multiple as align.pad_batch, so the loop's compiled shapes match the
    final batch_align launch (one place to change if that multiple ever
    moves)."""
    pad8 = lambda n: -(-n // 8) * 8
    q2 = np.zeros((M, pad8(len(q))), np.int32)
    q2[:, : len(q)] = q
    t2 = np.zeros((M, pad8(len(t))), np.int32)
    t2[:, : len(t)] = t
    ql0 = np.full(M, len(q), np.int32)
    tl0 = np.full(M, len(t), np.int32)
    return q2, ql0, t2, tl0


def _population_fused(
    q: np.ndarray,
    t: np.ndarray,
    transformed: np.ndarray,  # (M, V, V) f64, already host-transformed
    del_: float,
    ext: float,
    heuristics: Heuristics,
    r_squared: float,
    *,
    alphabet: type[Alphabet],
    backend: str,
    max_iters: int,
) -> list[AlignmentResult]:
    """Fused-device population driver (see _population_device_loop_impl).

    The whole improve-until-stall loop runs as ONE dispatch; a final
    with-alignments launch (one more dispatch) recomputes each member's
    stopping alignment from its stopping matrix — deterministic fills
    make it identical to the loop's last accepted alignment."""
    import jax.numpy as jnp

    from .backend import default_dtype

    M, V = transformed.shape[0], transformed.shape[-1]
    dtype = default_dtype()
    q2, ql0, t2, tl0 = _tile_pair(q, t, M)

    it, done, dead, max_f, trans, prod = _population_device_loop(
        q2, ql0, t2, tl0, jnp.asarray(transformed, dtype),
        jnp.asarray(heuristics.frequencies, dtype),
        jnp.asarray(heuristics.kd, dtype), jnp.asarray(r_squared, dtype),
        jnp.asarray(int(max_iters), jnp.int32),
        backend=backend, del_=float(del_), ext=float(ext),
    )
    final = np.asarray(trans, np.float64)
    dead_np = np.asarray(dead)
    done_np = np.asarray(done)
    # a member that EXHAUSTED max_iters while still improving reports its
    # last accepted alignment with the matrix that produced it (prod) —
    # heuristic_align's exhaustion rule; converged members' stopping
    # alignment was produced by the final trans (never updated again)
    # a transform with no real roots propagates NaN on device where the
    # host path raises (matrices.py transform_matrix) — surface the same
    # error for the same condition.  The check covers EVERY member and
    # runs BEFORE the prod substitution below: the starting matrices were
    # host-transformed (finite or already raised) and the loop only
    # stores a transform for improving members, so NaN anywhere in the
    # final state ⟺ an in-loop no-real-roots transform — including
    # members the NaN fill marked dead/done, and a last-iteration
    # transform an exhausted loop never evaluated (the sequential host
    # loop raises there too: the transform precedes the bound check).
    if np.isnan(final).any():
        raise WrongMatrixSpecified("no real roots for the scaling quadratic")
    if not done_np.all():
        exhausted = ~done_np & ~dead_np
        final = np.where(exhausted[:, None, None],
                         np.asarray(prod, np.float64), final)
    batch = batch_align(
        [q] * M, [t] * M, final, del_, ext, mode="local",
        alphabet=alphabet, backend=backend, with_alignments=True,
        skip=dead_np,
    )
    out: list[AlignmentResult | None] = []
    for m, res in enumerate(batch):
        if res is None:
            out.append(None)
            continue
        res.matrix = final[m].copy()
        out.append(res)
    return out  # type: ignore[return-value]


def warmup_population(
    query,
    target,
    n_matrices: int,
    del_: float,
    ext: float,
    *,
    alphabet: type[Alphabet] = Protein,
    backend: str | None = None,
) -> None:
    """Precompile the population kernel set for these shapes WITHOUT
    doing any work (the worker ``--warmup`` path): traces the fused
    device loop with a zero-iteration budget (full while-loop body
    compiled, zero iterations executed) plus the final with-alignments
    launch with every problem skipped (zero-length — free)."""
    from .align import _encode
    from .backend import default_dtype, pick_backend

    resolved = pick_backend(backend)
    # consult the guard BEFORE the oracle->xla remap (mirror of
    # heuristic_align_population's resolution so warmup precompiles the
    # path the worker will actually run)
    use_dev = _use_device_loop(resolved)
    if resolved == "oracle":
        resolved = "xla"
    q = _encode(query, alphabet)
    t = _encode(target, alphabet)
    M, V = int(n_matrices), alphabet.volume()
    if len(q) == 0 or len(t) == 0 or M == 0:
        return
    if use_dev:
        import jax.numpy as jnp

        dtype = default_dtype()
        q2, ql0, t2, tl0 = _tile_pair(q, t, M)
        _population_device_loop(
            q2, ql0, t2, tl0,
            jnp.zeros((M, V, V), dtype),
            jnp.full((V,), 1.0 / V, dtype),
            jnp.asarray(0.0, dtype), jnp.asarray(1.0, dtype),
            jnp.asarray(0, jnp.int32),
            backend=resolved, del_=float(del_), ext=float(ext),
        )
    batch_align(
        [q] * M, [t] * M, np.zeros((M, V, V)), del_, ext, mode="local",
        alphabet=alphabet, backend=resolved, with_alignments=True,
        skip=np.ones(M, bool),
    )


def heuristic_align_population(
    query,
    target,
    matrices: np.ndarray,  # (M, V, V) candidate starting matrices
    del_: float,
    ext: float,
    heuristics: Heuristics | None,
    *,
    alphabet: type[Alphabet] = Protein,
    backend: str | None = None,
    max_iters: int = 1000,
    device_loop: bool | None = None,
    dtype=None,
) -> list[AlignmentResult]:
    """Run the heuristic loop for a whole matrix population at once.

    One batched kernel launch per iteration covers every still-improving
    candidate, following :func:`heuristic_align`'s iteration rule per
    member.  NOTE the engines differ at the margin: this path always
    runs the batched device fill (default dtype), while single-pair
    heuristic_align may route small problems to the f64 host engine —
    heuristic-transformed matrices are non-integral, so f32 ties can
    resolve differently there.  Passing ``dtype=jnp.float64`` (CPU
    backends) runs the fills in f64 for strict agreement; an explicit
    dtype forces the host loop (strict mode implies host-f64 transforms
    too).  Returns one AlignmentResult per input matrix (with
    ``.matrix`` set).

    A member whose transformed matrix admits NO positive-scoring cell
    has no local alignment; its entry is ``None`` (the reference would
    panic the whole process on the 0-index traceback seed there,
    simple/mod.rs:213-218 — one dead candidate must not take down the
    other M-1).
    """
    if heuristics is None:
        raise MissingArgument("heuristic aligner requires Heuristics")
    matrices = np.asarray(matrices, dtype=np.float64)
    M = matrices.shape[0]
    r_squared = heuristics.r_squared
    if abs(r_squared) < np.finfo(np.float64).eps:
        r_squared = float(matrices.shape[1] * matrices.shape[2])

    transformed = np.stack(
        [
            transform_matrix(matrices[m], heuristics.kd, r_squared, heuristics.frequencies)
            for m in range(M)
        ]
    )
    max_f = np.zeros(M)
    results: list[AlignmentResult | None] = [None] * M
    # constant-shape iteration: converged problems are masked inactive
    # (zero-length — effectively free) instead of shrinking the batch, so
    # every iteration reuses one compiled kernel
    done = np.zeros(M, bool)
    dead = np.zeros(M, bool)  # members whose matrix admits no alignment

    from .align import _encode

    q = _encode(query, alphabet)
    t = _encode(target, alphabet)

    from .backend import pick_backend

    if max_iters < 1:
        raise ValidationError("max_iters must be >= 1")
    resolved = pick_backend(backend)
    if device_loop is None:
        # consult the guard with the UN-remapped backend: an explicit
        # backend="oracle" request means the strict-f64 host loop, even
        # on an accelerator platform.  An explicit dtype likewise means
        # strict mode — the fused loop's in-loop transforms run in the
        # device dtype, not the requested one.
        device_loop = dtype is None and _use_device_loop(resolved)
    if resolved == "oracle":
        resolved = "xla"  # the batch fills are device-only
    if device_loop and len(q) > 0 and len(t) > 0:
        return _population_fused(
            q, t, transformed, del_, ext, heuristics, r_squared,
            alphabet=alphabet, backend=resolved, max_iters=max_iters,
        )

    # matrix that produced + the alignment of each member's last ACCEPTED
    # iteration: a max_iters-exhausted member reports these, matching
    # heuristic_align's exhaustion rule (no extra launch, no fresh
    # never-evaluated transform)
    last_res: list[AlignmentResult | None] = [None] * M
    producing = transformed.copy()
    for _ in range(max_iters):
        if done.all():
            break
        batch = batch_align(
            [q] * M, [t] * M, transformed,
            del_, ext, mode="local", alphabet=alphabet,
            backend=backend, with_alignments=True, skip=done,
            dtype=dtype,
        )
        for m, res in enumerate(batch):
            if res is None:
                if not done[m]:
                    # no positive-scoring cell under the current
                    # matrix: dead member (docstring) — retire it so it
                    # doesn't force every remaining iteration
                    dead[m] = True
                    done[m] = True
                continue
            if res.alignment.f > max_f[m]:
                max_f[m] = res.alignment.f
                producing[m] = transformed[m].copy()
                last_res[m] = res
                transformed[m] = transform_matrix(
                    res.alignment.frequency_matrix(),
                    heuristics.kd, r_squared, heuristics.frequencies,
                )
            else:
                res.matrix = transformed[m].copy()
                results[m] = res
                done[m] = True
    for m in range(M):
        if results[m] is None and not dead[m] and last_res[m] is not None:
            # hit max_iters while still improving
            res = last_res[m]
            res.matrix = producing[m]
            results[m] = res
    return results  # type: ignore[return-value]


# --- class wrappers mirroring the reference API ---


class HeuristicAligner:
    """Equivalent of aligner-core HeuristicAligner (heuristic/mod.rs:10-79)."""

    def __init__(self, query, target, alphabet=Protein):
        self.query = query
        self.target = target
        self.alphabet = alphabet

    @classmethod
    def from_str_seqs(cls, query: str, target: str, alphabet=Protein):
        return cls(alphabet.encode(query, strict=True),
                   alphabet.encode(target, strict=True), alphabet)

    @classmethod
    def from_seqs(cls, query, target, alphabet=Protein):
        return cls(np.asarray(query, np.int8), np.asarray(target, np.int8), alphabet)

    def perform_alignment(self, del_, ext, matrix, heuristics=None, **kw):
        return heuristic_align(
            self.query, self.target, matrix, del_, ext, heuristics,
            alphabet=self.alphabet, **kw,
        )


class HeuristicPWMAligner:
    """Equivalent of aligner-core HeuristicPWMAligner (heuristic/mod.rs:81-142)."""

    def __init__(self, query, alphabet=DNA):
        self.query = query
        self.alphabet = alphabet

    @classmethod
    def from_str_seqs(cls, query: str, alphabet=DNA):
        return cls(alphabet.encode(query), alphabet)

    @classmethod
    def from_seqs(cls, query, alphabet=DNA):
        return cls(np.asarray(query, np.int8), alphabet)

    def perform_alignment(self, del_, ext, pwm, heuristics=None, **kw):
        return heuristic_align_pwm(
            self.query, pwm, del_, ext, heuristics, alphabet=self.alphabet, **kw
        )
