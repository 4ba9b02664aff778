"""Batched exact DP fill as an XLA ``lax.scan`` — the portable engine.

Design note (SURVEY.md §2.3.3, §7 "hard parts"): the reference's
single mutable gap-penalty state couples every cell to its fill-order
predecessor, and the first cell of each column to the *last* cell of the
previous column (aligner-core/src/simple/mod.rs:72,88-92).  That makes each
DP problem inherently sequential cell-by-cell, so the parallel axis of this
framework is the *batch*: every vector lane carries one independent problem
and the scan walks cells in the reference's column-major fill order.  All
hot reference workloads are batched — 5,000 shuffled alignments for
p-values (statistics/mod.rs:253-291), chromosome window scans
(engine/calc.rs:45-75) and candidate-matrix populations (aligner-web) —
so this maps the reference's thread fan-outs onto vector lanes instead
of translating them.

Variable lengths: problems are right-padded to (R, C); a cell is *active*
when ``x <= qlen`` and ``y <= tlen``.  Skipping inactive cells preserves
each problem's own column-major order, and the penalty state is carried
unchanged across skipped cells, so padded execution is bit-identical to
per-problem execution.

Semantics implemented exactly (validated against the scalar oracle):

* tie priority top > left > diagonal with dtype-epsilon compare
  (enums.rs:18-46); ``max == 0`` → Beginning in local/PWM mode;
* penalty := ext after any non-Beginning cell, del after Beginning
  (simple/mod.rs:88-92);
* global border ``-(i)*del`` with far corners ``-(len+1)*del``
  (simple/mod.rs:59-70);
* local argmax = first maximum in row-major order over the full plane
  (simple/mod.rs:212), tracked online as (value desc, y asc, x asc).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import jax
import jax.numpy as jnp
from jax import lax

# Direction codes (enums.rs:9-15) — ONE definition, in the oracle;
# every engine re-exports from here or there so the cross-engine
# bit-contract cannot drift
from ..oracle import BEG, DIAG, LEFT, TOP  # noqa: E402,F401


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class FillResult:
    """Outputs of a batched fill.

    ``plane``/``dirs`` are (B, R+1, C+1) and present only when
    ``with_planes=True``.  ``fmax``/``fy``/``fx`` track the local argmax
    (first maximum in row-major order, borders included); ``end`` is
    ``a[tlen, qlen]`` per problem (the global end score).
    """

    plane: Any | None
    dirs: Any | None
    fmax: Any
    fy: Any
    fx: Any
    end: Any


def _score_simple(matrix, batched_matrix: bool, vol: int):
    """s[b] = matrix[t_char, q_char] (simple/mod.rs:83)."""
    if batched_matrix:
        flat = matrix.reshape(matrix.shape[0], vol * vol)

        def fn(x1, qx, y1, ty):
            idx = ty * vol + qx
            return jnp.take_along_axis(flat, idx[:, None], axis=1)[:, 0]

    else:
        flat = matrix.reshape(vol * vol)

        def fn(x1, qx, y1, ty):
            return flat[ty * vol + qx]

    return fn


def _score_pwm(pwm, batched_matrix: bool, width: int):
    """s[b] = pwm[query_char, x-1] (pwm/mod.rs:59-63); rows are the query."""
    if batched_matrix:
        flat = pwm.reshape(pwm.shape[0], pwm.shape[1] * width)

        def fn(x1, qx, y1, ty):
            idx = ty * width + (x1 - 1)
            return jnp.take_along_axis(flat, idx[:, None], axis=1)[:, 0]

    else:

        def fn(x1, qx, y1, ty):
            return pwm[:, x1 - 1][ty]

    return fn


def _fill_core(
    qT,  # (C, B) int32 column chars (zeros in pwm mode)
    qlen,  # (B,) int32
    tT,  # (R, B) int32 row chars
    tlen,  # (B,) int32
    score_fn,
    del_,
    ext,
    *,
    is_global: bool,
    dtype,
    with_planes: bool,
):
    C, B = qT.shape
    R = tT.shape[0]
    del_ = jnp.asarray(del_, dtype)
    ext = jnp.asarray(ext, dtype)
    # int-dtype analog of "tiny positive" is 1 (m - top < 1 ⟺ m == top)
    # — mirrors the pallas kernel so dtype support cannot differ by
    # backend (finfo raises on integer dtypes)
    eps = (
        jnp.asarray(jnp.finfo(dtype).eps, dtype)
        if jnp.issubdtype(jnp.dtype(dtype), jnp.floating)
        else jnp.asarray(1, dtype)
    )
    qlen = qlen.astype(jnp.int32)
    tlen = tlen.astype(jnp.int32)

    ys = jnp.arange(1, R + 1, dtype=jnp.int32)
    xs = jnp.arange(1, C + 1, dtype=jnp.int32)

    if is_global:
        # a[y,0] = -y*del, overwritten at y == tlen with -(tlen+1)*del
        # (simple/mod.rs:59-70).
        yy = jnp.arange(R + 1, dtype=jnp.int32)[:, None]
        prev0 = jnp.where(
            yy == tlen[None, :],
            -(tlen[None, :].astype(dtype) + 1) * del_,
            -yy.astype(dtype) * del_,
        )
        border_row = jnp.where(
            xs[:, None] == qlen[None, :],
            -(qlen[None, :].astype(dtype) + 1) * del_,
            -xs[:, None].astype(dtype) * del_,
        )  # (C, B): a[0, x] for x = 1..C
    else:
        prev0 = jnp.zeros((R + 1, B), dtype)
        border_row = jnp.zeros((C, B), dtype)

    best0 = (
        jnp.zeros(B, dtype),
        jnp.zeros(B, jnp.int32),
        jnp.zeros(B, jnp.int32),
    )
    end0 = jnp.zeros(B, dtype)

    def outer(carry, ox):
        prev_col, pen, best, end = carry
        x1, qx, border0 = ox
        x_active = x1 <= qlen  # (B,)

        def inner(icarry, ix):
            a_up, pen, best, end = icarry
            y1, ty, left_prev, diag_prev = ix
            s = score_fn(x1, qx, y1, ty).astype(dtype)
            top = a_up - pen
            left = left_prev - pen
            diag = diag_prev + s
            m = jnp.maximum(jnp.maximum(top, left), diag)
            d = jnp.where(
                m - top < eps,
                jnp.uint8(TOP),
                jnp.where(m - left < eps, jnp.uint8(LEFT), jnp.uint8(DIAG)),
            )
            if not is_global:
                d = jnp.where(m == 0, jnp.uint8(BEG), d)
            active = x_active & (y1 <= tlen)
            pen = jnp.where(active, jnp.where(d == BEG, del_, ext), pen)
            val = jnp.where(active, m, jnp.zeros((), dtype))
            dcode = jnp.where(active, d, jnp.uint8(BEG))

            bv, by, bx = best
            better = active & (
                (m > bv)
                | ((m == bv) & ((y1 < by) | ((y1 == by) & (x1 < bx))))
            )
            best = (
                jnp.where(better, m, bv),
                jnp.where(better, y1, by),
                jnp.where(better, x1, bx),
            )
            end = jnp.where(active & (y1 == tlen) & (x1 == qlen), m, end)
            return (val, pen, best, end), (val, dcode)

        (_, pen, best, end), (vals, dcodes) = lax.scan(
            inner,
            (border0, pen, best, end),
            (ys, tT, prev_col[1:], prev_col[:-1]),
        )
        cur_col = jnp.concatenate([border0[None, :], vals], axis=0)
        out = (vals, dcodes) if with_planes else None
        return (cur_col, pen, best, end), out

    pen0 = jnp.full((B,), del_, dtype)
    (_, _, best, end), outs = lax.scan(
        outer, (prev0, pen0, best0, end0), (xs, qT, border_row)
    )

    plane = dirs = None
    if with_planes:
        vals_all, dirs_all = outs  # (C, R, B)
        plane = jnp.zeros((B, R + 1, C + 1), dtype)
        plane = plane.at[:, 1:, 0].set(prev0[1:].T)
        plane = plane.at[:, 0, 1:].set(border_row.T)
        plane = plane.at[:, 1:, 1:].set(jnp.transpose(vals_all, (2, 1, 0)))
        dirs = jnp.full((B, R + 1, C + 1), jnp.uint8(BEG))
        if is_global:
            # border directions Left/Top (simple/mod.rs:61,66).
            dirs = dirs.at[:, 0, 1:].set(
                jnp.where(xs[None, :] <= qlen[:, None], jnp.uint8(LEFT), jnp.uint8(BEG))
            )
            dirs = dirs.at[:, 1:, 0].set(
                jnp.where(ys[None, :] <= tlen[:, None], jnp.uint8(TOP), jnp.uint8(BEG))
            )
        dirs = dirs.at[:, 1:, 1:].set(jnp.transpose(dirs_all, (2, 1, 0)))
    bv, by, bx = best
    return FillResult(plane=plane, dirs=dirs, fmax=bv, fy=by, fx=bx, end=end)


@functools.partial(
    jax.jit,
    static_argnames=("mode", "with_planes", "dtype"),
)
def fill_batch(
    q,
    qlen,
    t,
    tlen,
    matrix,
    del_,
    ext,
    *,
    mode: str = "local",
    with_planes: bool = True,
    dtype=jnp.float32,
) -> FillResult:
    """Batched global/local fill.

    ``q``: (B, C) int32 query codes (columns), ``t``: (B, R) target codes
    (rows), ``matrix``: (V, V) shared or (B, V, V) per-problem.
    """
    if mode not in ("local", "global"):
        raise ValueError(f"mode must be local|global, got {mode!r}")
    q = jnp.asarray(q, jnp.int32)
    t = jnp.asarray(t, jnp.int32)
    matrix = jnp.asarray(matrix, dtype)
    batched = matrix.ndim == 3
    vol = matrix.shape[-1]
    return _fill_core(
        q.T,
        jnp.asarray(qlen),
        t.T,
        jnp.asarray(tlen),
        _score_simple(matrix, batched, vol),
        del_,
        ext,
        is_global=(mode == "global"),
        dtype=dtype,
        with_planes=with_planes,
    )


@functools.partial(jax.jit, static_argnames=("with_planes", "dtype"))
def fill_pwm_batch(
    q,
    qlen,
    pwm,
    del_,
    ext,
    *,
    with_planes: bool = True,
    dtype=jnp.float32,
) -> FillResult:
    """Batched query-vs-PWM fill (pwm/mod.rs:44-74).

    Plane dims are (qlen+1, W+1): rows are query positions, columns PWM
    positions; every column is active (W is shared by the batch).
    """
    q = jnp.asarray(q, jnp.int32)
    pwm = jnp.asarray(pwm, dtype)
    batched = pwm.ndim == 3
    width = pwm.shape[-1]
    B = q.shape[0]
    return _fill_core(
        jnp.zeros((width, B), jnp.int32),
        jnp.full((B,), width, jnp.int32),
        q.T,
        jnp.asarray(qlen),
        _score_pwm(pwm, batched, width),
        del_,
        ext,
        is_global=False,
        dtype=dtype,
        with_planes=with_planes,
    )
