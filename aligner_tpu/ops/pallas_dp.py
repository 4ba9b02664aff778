"""Pallas GPU kernel (Triton route) for the batched exact DP fill.

Design (see ops/scan_engine.py for why the batch is the parallel axis):

* One DP problem per GPU thread.  A program owns ``BLOCK`` problems
  (one warp) and walks the whole plane itself: a loop over columns in
  the reference's column-major fill order with the row loop inside, so
  the single mutable gap-penalty state, the running max/argmax and the
  end score stay in registers across cells and columns
  (simple/mod.rs:72,88-92).  Programs are independent; nothing is
  carried between them.
* The previous column (R+1 values per problem) lives in a device buffer
  laid out (R+1, B): each row step is one coalesced load and one
  coalesced store per warp, and the buffer stays in L1/L2.  Each cell
  reads its left neighbour before overwriting it and carries it as the
  next cell's diagonal.  The row loop is unrolled by 8: the eight
  loads are issued before the dependent max/penalty chain of the block.
* Score lookup is one gather per cell from the substitution matrix
  (shared (V, V), per-problem (B, V, V), or a PWM), which stays in L1.
* Integral matrices with integral penalties run in int32, which is
  exact; anything else runs in the float dtype with the XLA engine's
  ``eps`` tie test (scan_engine.py).  The caller picks by passing the
  matrix operand from :func:`matrix_operand`.
* Directions leave as 2-bit codes, eight rows per int32 word, in the
  problem-major ``(B, R8/8, C)`` layout that ``ops/device_walk.py``
  reads (fmt ``"packed"``).  Scores-only mode writes only the per-problem
  max/argmax/end.

Semantics are bit-identical to the scalar oracle; the kernel runs in
Pallas interpret mode for the CPU tests (``INTERPRET``) and compiled for
the GPU everywhere else.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from .scan_engine import BEG, DIAG, LEFT, TOP, FillResult

# problems per program: one warp, one problem per thread.  Small
# programs spread a few-thousand-problem batch over every SM.
BLOCK = 32
UNROLL = 8  # rows per direction word and per unrolled row block

# Pallas interpret mode, for running the kernel without a GPU.  Only
# tests turn it on; the library never picks it by platform.
INTERPRET = False

# byte → its four 2-bit direction codes (for host-side plane unpacking)
_UNPACK_LUT = np.array(
    [[(b >> (2 * k)) & 3 for k in range(4)] for b in range(256)], dtype=np.uint8
)


def _cdiv(a, b):
    return -(-a // b)


def matrix_operand(matrix, dtype, del_, ext):
    """Device operand for a concrete (V, V) / (B, V, V) / PWM matrix:
    int32 when the entries and both penalties are integral (the kernel
    then runs exact int32 arithmetic), else ``dtype``."""
    m = np.asarray(matrix)
    integral = bool(
        np.all(m == np.round(m))
        and np.abs(m).max(initial=0) < 2**24
        and float(del_) == int(del_)
        and float(ext) == int(ext)
    )
    if integral:
        return jnp.asarray(np.round(m).astype(np.int32))
    return jnp.asarray(m, dtype)


def _kernel(*refs, C, R8, V, W, mode, batched_mat, with_dirs, track_argmax,
            del_, ext):
    if mode == "pwm":
        t_ref, tlen_ref, mat_ref = refs[:3]
        refs = refs[3:]
        q_ref = qlen_ref = None
    else:
        q_ref, t_ref, qlen_ref, tlen_ref, mat_ref = refs[:5]
        refs = refs[5:]
    fmax_ref, fy_ref, fx_ref, end_ref, col_ref = refs[:5]
    dirs_ref = refs[5] if with_dirs else None

    cdt = col_ref.dtype
    is_global = mode == "global"
    DEL = jnp.asarray(del_, cdt)
    EXT = jnp.asarray(ext, cdt)
    # tie test m - top < eps with m >= top always; the int32 analog of
    # "tiny positive" is 1 (m - top < 1 ⟺ m == top)
    eps = (
        jnp.asarray(jnp.finfo(cdt).eps, cdt)
        if jnp.issubdtype(cdt, jnp.floating)
        else jnp.asarray(1, cdt)
    )
    zero = jnp.zeros((BLOCK,), cdt)
    izero = jnp.zeros((BLOCK,), jnp.int32)
    lanes = lax.broadcasted_iota(jnp.int32, (BLOCK,), 0)

    tlen = tlen_ref[...]
    qlen = jnp.full((BLOCK,), C, jnp.int32) if mode == "pwm" else qlen_ref[...]

    # column 0: a[y, 0] = -y*del with the far-corner overwrite
    # (simple/mod.rs:59-70), zeros in local/PWM mode
    def init_row(y, c):
        if is_global:
            col_ref[y, :] = jnp.where(
                y == tlen, -(tlen.astype(cdt) + 1) * DEL,
                jnp.full((BLOCK,), -y.astype(cdt) * DEL),
            )
        else:
            col_ref[y, :] = zero
        return c

    lax.fori_loop(0, R8 + 1, init_row, jnp.int32(0))

    def score(x, qx, ty):
        if mode == "pwm":
            idx = ty * W + x
        else:
            idx = ty * V + qx
        if batched_mat:
            return mat_ref[idx, lanes].astype(cdt)
        return mat_ref[idx].astype(cdt)

    def column(x, carry):
        pen, bv, by, bx, ev = carry
        x1 = x + 1
        if is_global:
            border0 = jnp.where(
                x1 == qlen, -(qlen.astype(cdt) + 1) * DEL,
                jnp.full((BLOCK,), -x1.astype(cdt) * DEL),
            )
        else:
            border0 = zero
        qx = None if mode == "pwm" else q_ref[x, :]
        active_x = x1 <= qlen
        diag0 = col_ref[0, :]
        col_ref[0, :] = border0

        def block(w, c):
            a_up, pen, diag_prev, bv, by, bx, ev = c
            base = w * UNROLL
            # every load of the block before the dependent chain
            lefts = [col_ref[base + 1 + j, :] for j in range(UNROLL)]
            scores = [score(x, qx, t_ref[base + j, :]) for j in range(UNROLL)]
            word = izero
            for j in range(UNROLL):
                y1 = base + 1 + j
                left_v = lefts[j]
                top = a_up - pen
                left = left_v - pen
                diag = diag_prev + scores[j]
                m = jnp.maximum(jnp.maximum(top, left), diag)
                active = active_x & (y1 <= tlen)
                if with_dirs:
                    d = jnp.where(
                        m - top < eps, TOP,
                        jnp.where(m - left < eps, LEFT, DIAG),
                    )
                    if not is_global:
                        d = jnp.where(m == 0, BEG, d)
                    d = jnp.where(active, d, BEG)
                    word = word | (d << (2 * j))
                    nxt = jnp.where(d == BEG, DEL, EXT)
                elif is_global:
                    nxt = EXT  # dir == Beginning never happens in global
                else:
                    nxt = jnp.where(m == 0, DEL, EXT)
                pen = jnp.where(active, nxt, pen)
                val = jnp.where(active, m, zero)
                col_ref[y1, :] = val
                if track_argmax:
                    # first max in row-major order (value desc, y asc,
                    # x asc; simple/mod.rs:212).  Cells arrive in
                    # (x asc, y asc) order, so a tied stored best always
                    # has bx <= x1 and bx == x1 implies by < y1: the
                    # x tie clause can never fire.
                    better = active & ((m > bv) | ((m == bv) & (y1 < by)))
                    bv = jnp.where(better, m, bv)
                    by = jnp.where(better, y1, by)
                    bx = jnp.where(better, x1, bx)
                    ev = jnp.where(active & (y1 == tlen) & (x1 == qlen), m, ev)
                else:
                    bv = jnp.maximum(bv, val)
                a_up = val
                diag_prev = left_v
            if with_dirs:
                dirs_ref[x, w, :] = word
            return a_up, pen, diag_prev, bv, by, bx, ev

        _, pen, _, bv, by, bx, ev = lax.fori_loop(
            0, R8 // UNROLL, block, (border0, pen, diag0, bv, by, bx, ev)
        )
        return pen, bv, by, bx, ev

    pen0 = jnp.full((BLOCK,), DEL)
    _, bv, by, bx, ev = lax.fori_loop(
        0, C, column, (pen0, zero, izero, izero, zero)
    )
    fmax_ref[...] = bv
    fy_ref[...] = by
    fx_ref[...] = bx
    end_ref[...] = ev


@functools.partial(
    jax.jit,
    static_argnames=("mode", "with_dirs", "track_argmax", "del_", "ext",
                     "interpret"),
)
def _run(qT, tT, qlen, tlen, mat, *, mode, with_dirs, track_argmax, del_,
         ext, interpret):
    """One launch over (Bp,) problems, Bp a multiple of BLOCK.

    ``qT``: (C, Bp) query codes (None in PWM mode), ``tT``: (R8, Bp) row
    codes, ``mat``: (V*V,) / (V*V, Bp) pair matrices or (4*W,) /
    (4*W, Bp) PWMs.  The matrix dtype is the compute dtype.
    Returns fmax, fy, fx, end (Bp,) and, with ``with_dirs``, the packed
    words (C, R8/8, Bp)."""
    R8, Bp = tT.shape
    cdt = mat.dtype
    batched_mat = mat.ndim == 2
    if mode == "pwm":
        C = W = mat.shape[0] // 4
        V = 4
    else:
        C = qT.shape[0]
        V = int(round(np.sqrt(mat.shape[0])))
        W = 0
    NB = Bp // BLOCK
    col = lambda rows: pl.BlockSpec((rows, BLOCK), lambda i: (0, i))  # noqa: E731
    vec = pl.BlockSpec((BLOCK,), lambda i: (i,))
    if batched_mat:
        mat_spec = col(mat.shape[0])
    else:
        mat_spec = pl.BlockSpec(mat.shape, lambda i: (0,))
    if mode == "pwm":
        in_specs = [col(R8), vec, mat_spec]
        operands = [tT, tlen, mat]
    else:
        in_specs = [col(C), col(R8), vec, vec, mat_spec]
        operands = [qT, tT, qlen, tlen, mat]
    out_shape = [
        jax.ShapeDtypeStruct((Bp,), cdt),  # fmax
        jax.ShapeDtypeStruct((Bp,), jnp.int32),  # fy
        jax.ShapeDtypeStruct((Bp,), jnp.int32),  # fx
        jax.ShapeDtypeStruct((Bp,), cdt),  # end
        jax.ShapeDtypeStruct((R8 + 1, Bp), cdt),  # column buffer
    ]
    out_specs = [vec, vec, vec, vec, col(R8 + 1)]
    if with_dirs:
        out_shape.append(
            jax.ShapeDtypeStruct((C, R8 // UNROLL, Bp), jnp.int32)
        )
        out_specs.append(
            pl.BlockSpec((C, R8 // UNROLL, BLOCK), lambda i: (0, 0, i))
        )
    kernel = functools.partial(
        _kernel, C=C, R8=R8, V=V, W=W, mode=mode, batched_mat=batched_mat,
        with_dirs=with_dirs, track_argmax=track_argmax, del_=del_, ext=ext,
    )
    outs = pl.pallas_call(
        kernel,
        grid=(NB,),
        in_specs=in_specs,
        out_specs=out_specs,
        out_shape=out_shape,
        interpret=interpret,
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=1, num_stages=1),
        name="dp_fill_" + mode,
    )(*operands)
    return outs[:4] + ((outs[5],) if with_dirs else ())


def _fill_traced(q, qlen, t, tlen, mat, del_, ext, *, mode, dtype, with_dirs,
                 track_argmax):
    """Shared traced wrapper: (B, C) / (B, R) operands → kernel layout,
    launch, and back to per-problem outputs (fmax, fy, fx, end[, words])
    with ``words`` problem-major (B, R8/8, C)."""
    t = jnp.asarray(t, jnp.int32)
    B, R = t.shape
    R8 = _cdiv(max(R, 1), UNROLL) * UNROLL
    Bp = _cdiv(B, BLOCK) * BLOCK
    pad_b = Bp - B
    tT = jnp.pad(t, ((0, pad_b), (0, R8 - R))).T
    # length 0 for padding problems → fully inactive
    tlen = jnp.pad(jnp.asarray(tlen, jnp.int32), (0, pad_b))
    mat = jnp.asarray(mat)
    if mat.ndim == 3:
        mat = jnp.pad(mat.reshape(B, -1), ((0, pad_b), (0, 0))).T
    else:
        mat = mat.reshape(-1)
    if mode == "pwm":
        qT = qlen_p = None
    else:
        q = jnp.asarray(q, jnp.int32)
        qT = jnp.pad(q, ((0, pad_b), (0, 0))).T
        qlen_p = jnp.pad(jnp.asarray(qlen, jnp.int32), (0, pad_b))
    outs = _run(
        qT, tT, qlen_p, tlen, mat, mode=mode, with_dirs=with_dirs,
        track_argmax=track_argmax, del_=float(del_), ext=float(ext),
        interpret=INTERPRET,
    )
    fmax, fy, fx, end = (o[:B] for o in outs[:4])
    res = (fmax.astype(dtype), fy, fx, end.astype(dtype))
    if with_dirs:
        res += (jnp.transpose(outs[4], (2, 1, 0))[:B],)
    return res


def fill_scores_traced(q, qlen, t, tlen, matrix, del_: float, ext: float, *,
                       mode: str = "local", dtype=jnp.float32,
                       track_argmax: bool = True):
    """Scores-only fill, traceable inside jit/shard_map/while_loop.

    ``matrix`` is (V, V) shared or (B, V, V) per-problem; its dtype is
    the compute dtype (see :func:`matrix_operand`).  Returns (fmax, fy,
    fx, end) of shape (B,); with ``track_argmax=False`` fy/fx/end come
    back zero except in global mode, where the end score is always
    tracked so the engines cannot diverge."""
    return _fill_traced(
        q, qlen, t, tlen, matrix, del_, ext, mode=mode, dtype=dtype,
        with_dirs=False, track_argmax=track_argmax or mode == "global",
    )


def fill_full_traced(q, qlen, t, tlen, matrix, del_: float, ext: float, *,
                     mode: str = "local", dtype=jnp.float32):
    """Direction-plane fill, traceable.  Returns (fmax, fy, fx, end,
    words) with ``words`` the problem-major 2-bit packed direction
    stream (B, R8/8, C) int32, R8 = R rounded up to 8; unpack host-side
    with :func:`dirs_from_packed`."""
    return _fill_traced(
        q, qlen, t, tlen, matrix, del_, ext, mode=mode, dtype=dtype,
        with_dirs=True, track_argmax=True,
    )


def fill_pwm_scores_traced(q, qlen, pwm, del_: float, ext: float, *,
                           dtype=jnp.float32, track_argmax: bool = True):
    """Scores-only query-vs-PWM fill (shared (4, W) or (B, 4, W) PWMs),
    traceable.  Plane dims (qlen+1, W+1): rows are query positions
    (pwm/mod.rs:44-74)."""
    return _fill_traced(
        None, None, q, qlen, pwm, del_, ext, mode="pwm", dtype=dtype,
        with_dirs=False, track_argmax=track_argmax,
    )


def fill_pwm_full_traced(q, qlen, pwm, del_: float, ext: float, *,
                         dtype=jnp.float32):
    """Direction-plane query-vs-PWM fill, traceable; outputs as
    :func:`fill_full_traced` with plane dims (qlen+1, W+1)."""
    return _fill_traced(
        None, None, q, qlen, pwm, del_, ext, mode="pwm", dtype=dtype,
        with_dirs=True, track_argmax=True,
    )


def _unpack_words_pm(w: np.ndarray, R: int, C: int) -> np.ndarray:
    """Problem-major packed words (B, R//8, C) int32 → (B, R, C) uint8
    direction codes.  Each packed word uses its low 2 bytes (8 codes × 2
    bits); LUT256 maps a byte to its 4 codes in one gather."""
    B = w.shape[0]
    w8 = np.ascontiguousarray(w).view(np.uint8).reshape(B, R // 8, C, 4)[..., :2]
    d = _UNPACK_LUT[w8]  # (B, R//8, C, 2, 4) u8
    return np.transpose(d, (0, 1, 3, 4, 2)).reshape(B, R, C)


def dirs_from_packed(w: np.ndarray, qlen, tlen, mode: str) -> np.ndarray:
    """Problem-major packed direction words → (B, R8+1, C+1) uint8
    planes with the reference border directions (simple/mod.rs:61,66)."""
    w = np.asarray(w)
    B, R8w, C = w.shape
    R = R8w * 8
    d = _unpack_words_pm(w, R, C)
    qlen = np.asarray(qlen)
    tlen = np.asarray(tlen)
    dirs = np.full((B, R + 1, C + 1), np.uint8(BEG))
    if mode == "global":
        xs = np.arange(1, C + 1, dtype=np.int32)
        ys = np.arange(1, R + 1, dtype=np.int32)
        dirs[:, 0, 1:] = np.where(
            xs[None, :] <= qlen[:, None], np.uint8(LEFT), np.uint8(BEG)
        )
        dirs[:, 1:, 0] = np.where(
            ys[None, :] <= tlen[:, None], np.uint8(TOP), np.uint8(BEG)
        )
    dirs[:, 1:, 1:] = d
    return dirs


def fill_batch_pallas(q, qlen, t, tlen, matrix, del_, ext, *,
                      mode: str = "local", with_planes: bool = True,
                      dtype=jnp.float32, track_argmax: bool = True
                      ) -> FillResult:
    """Host-array counterpart of scan_engine.fill_batch (no score
    plane: ``keep_planes`` callers use the XLA engine).  ``dirs`` are
    the unpacked (B, R+1, C+1) direction planes."""
    if mode not in ("local", "global"):
        raise ValueError(f"mode must be local|global, got {mode!r}")
    R = np.asarray(t).shape[1]
    mat = matrix_operand(matrix, dtype, del_, ext)
    if with_planes:
        fmax, fy, fx, end, words = fill_full_traced(
            q, qlen, t, tlen, mat, del_, ext, mode=mode, dtype=dtype
        )
        dirs = dirs_from_packed(np.asarray(words), qlen, tlen, mode)
        return FillResult(plane=None, dirs=dirs[:, : R + 1], fmax=fmax,
                          fy=fy, fx=fx, end=end)
    fmax, fy, fx, end = fill_scores_traced(
        q, qlen, t, tlen, mat, del_, ext, mode=mode, dtype=dtype,
        track_argmax=track_argmax,
    )
    return FillResult(plane=None, dirs=None, fmax=fmax, fy=fy, fx=fx, end=end)


def fill_pwm_batch_pallas(q, qlen, pwm, del_, ext, *,
                          with_planes: bool = True, dtype=jnp.float32,
                          track_argmax: bool = True) -> FillResult:
    """Host-array counterpart of scan_engine.fill_pwm_batch."""
    R = np.asarray(q).shape[1]
    W = np.asarray(pwm).shape[-1]
    mat = matrix_operand(pwm, dtype, del_, ext)
    if with_planes:
        fmax, fy, fx, end, words = fill_pwm_full_traced(
            q, qlen, mat, del_, ext, dtype=dtype
        )
        dirs = dirs_from_packed(
            np.asarray(words), np.full(len(qlen), W), qlen, "local"
        )
        return FillResult(plane=None, dirs=dirs[:, : R + 1], fmax=fmax,
                          fy=fy, fx=fx, end=end)
    fmax, fy, fx, end = fill_pwm_scores_traced(
        q, qlen, mat, del_, ext, dtype=dtype, track_argmax=track_argmax
    )
    return FillResult(plane=None, dirs=None, fmax=fmax, fy=fy, fx=fx, end=end)
