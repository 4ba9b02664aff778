"""Cross-device sequence-parallel wavefront for one huge global pair.

SURVEY.md §5/§7a: the reference's answer to long sequences is the
windowed scan; for a *single* huge pairwise problem the device-side
equivalent is a column-sharded DP with halo exchange of the block
boundary between devices.  Global mode makes this exact: the direction
is never Beginning (enums.rs:18-28), so the penalty is ``del`` for cell
(1,1) only and ``ext`` everywhere else (simple/mod.rs:72,88-92).  Each
row is then a linear-gap recurrence whose horizontal chain is a
max-prefix scan,

    H[y,x] = max_{j<=x} (M'[j] - (x-j)*ext)
           = cummax(M' + j*ext)[x] - x*ext,

with ``M'[x] = max(H[y-1,x-1] + s[x], H[y-1,x] - ext)`` and cell (1,1)
plus the left-boundary fold patched in before the scan.  Directions are
re-derived from the finished values with the exact tie policy
(top > left > diagonal), so the fill is cell-for-cell the reference's.

Layout: the query (columns) is sharded over the mesh axis; the target
(rows) is walked in blocks of ``tr`` rows, software-pipelined so device
d processes row-block ``k - d`` at pipeline step k while its right
neighbour works one block behind.  After each step the (tr,)
right-boundary vector hops one device (``lax.ppermute``).  With J row
blocks the pipeline runs J + n - 1 steps: efficiency J/(J+n-1) → 1 for
long targets.  On one device the same program is a plain row scan.
Arithmetic is int32, bit-identical to the float64 oracle.

Exact alignments (not just end scores): the forward pipeline
additionally records (a) one H-row checkpoint every ``tb_rows`` rows
per device and (b) every left-boundary vector each device consumed —
O(R·n + R·C/tb) ints instead of an O(R·C) plane.  The traceback then
replays one (tb_rows × column-block) tile at a time *with* directions;
the replayed tile is the identical DP restricted to that tile, so the
backward walk follows exactly the directions a full-plane reference
traceback would (no tie-break divergence by construction).  Cites:
simple/mod.rs:42-144 (fill + borders), simple/mod.rs:99-127 (traceback
semantics), engine/calc.rs thread fan-out (what this replaces at
single-problem scale).
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax, shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.scan_engine import BEG, DIAG, LEFT, TOP

# plain int (NOT a jnp scalar): importing this module must not touch
# the XLA backend — jax.distributed.initialize() may run after import
NEG = -(2**30) // 2

# above this many cells align_global switches from a materialized
# direction plane to this pipeline's checkpoint-and-replay traceback
# (2-bit words of a direct plane at this size ≈ 16 MB host-side)
DIRECT_PLANE_CELLS = 1 << 26

# column-block bucket; range_ok's slack covers the padded width
_RANGE_PAD = 128


def _cdiv(a, b):
    return -(-a // b)


def range_ok(qlen: int, tlen: int, del_, ext) -> bool:
    """int32-exactness guard: the fill's arithmetic must stay well
    inside int32.  |H| is bounded by the deeper of the gap ramp
    (-(R+C+2)·max(del,ext) along the borders) and the match ramp
    (min(R,C)·127 down the diagonal); the row scan's prefix terms
    a + x·ext add up to (C + R + 2·pad)·ext + del.  Beyond this
    (≈97M rows at del=11) scores would silently wrap — refuse
    instead."""
    pen = max(int(del_), int(ext), 1)
    h_abs = max((qlen + tlen + 2) * pen, min(qlen, tlen) * 127)
    slack = (qlen + tlen + 2 * _RANGE_PAD + 2) * max(int(ext), 1) + int(del_)
    return h_abs + slack < 2**30


def walk_tile_inner(get_d, y, x, n, buf):
    """Device-side backward walk WITHIN one replayed tile.

    ``get_d(r, c)`` yields the int32 direction of the 0-based interior
    cell (r, c) relative to the tile.  Walks from the 1-based
    tile-relative entry ``(y, x)`` until the cursor leaves the tile's
    top (y == 0) or left (x == 0) edge, appending one 2-bit code per
    step into ``buf`` at the running count ``n`` (BEG cannot occur in
    global interiors, so every code moves the cursor and the loop
    terminates).  The outer tile loop carries (n, buf) through
    successive tiles.

    Returns the updated (y, x, n, buf)."""

    def cond(c):
        y, x, _, _ = c
        return (y > 0) & (x > 0)

    def body(c):
        y, x, n, buf = c
        d = get_d(y - 1, x - 1)
        up = (d == TOP) | (d == DIAG)
        lf = (d == LEFT) | (d == DIAG)
        return (
            y - up.astype(jnp.int32),
            x - lf.astype(jnp.int32),
            n + 1,
            buf.at[n].set(d),
        )

    return lax.while_loop(cond, body, (y, x, n, buf))


def pack_walk_steps(buf):
    """(BUD16,) int32 step codes → (BUD16/16,) packed 16-codes-per-word."""
    shifts = jnp.arange(16, dtype=jnp.int32) * 2
    return (
        (buf.reshape(-1, 16) << shifts[None, :])
        .sum(axis=1)
        .astype(jnp.int32)
    )


def _unpack_step_words(packed: np.ndarray, n: int) -> np.ndarray:
    """(W,) int32 packed 2-bit step codes → (n,) uint8."""
    k = np.arange(16, dtype=np.int32) * 2
    d = (packed[:, None] >> k[None, :]) & 3
    return d.reshape(-1)[:n].astype(np.uint8)


def steps_to_chunks(packed, n, cy, cx, q, t):
    """Host-side decode of one device walk's step stream.

    ``(cy, cx)`` is the absolute 1-based entry cell; returns the
    (qa, ta) int16 chunk pair in walk (reverse-alignment) order by
    cursor replay — position BEFORE each step via cumulative sums, no
    plane access (same scheme as ops/device_walk.decode_pair)."""
    from ..alphabet import BLANK
    from ..ops.device_walk import _cursor_replay

    ds = _unpack_step_words(np.asarray(packed), n)
    y_at, x_at = _cursor_replay(ds, cy, cx)
    qa = np.where(ds == TOP, BLANK, q[x_at - 1]).astype(np.int16)
    ta = np.where(ds == LEFT, BLANK, t[y_at - 1]).astype(np.int16)
    return qa, ta


def _prep_sharded(mesh, q, t, matrix, del_, ext, tr, axis, tb_rows=None):
    """Shared operand prep + validation for the sharded entry points."""
    axis = axis or mesh.axis_names[0]
    n = mesh.shape[axis]
    if len(q) == 0 or len(t) == 0:
        # guard BOTH sharded entries (align re-checks later): a
        # zero-length operand reaches dynamic_slice/reshape with
        # zero-size shapes and fails at trace time with an opaque error
        raise ValueError("empty sequence")
    # validate BEFORE any per-element conversion: rejection of an
    # oversized pair must be O(1), not preceded by a giant int32 copy
    matrix = np.asarray(matrix)
    if not (
        np.all(matrix == np.round(matrix))
        and float(del_) == int(del_)
        and float(ext) == int(ext)
    ):
        raise ValueError("sharded wavefront requires integral matrix/penalties")
    if not range_ok(len(q), len(t), del_, ext):
        raise ValueError(
            "sharded wavefront: scores would exceed the int32-exact range "
            "(see range_ok)"
        )
    if tr is None:
        tr = 128
    q = np.asarray(q, np.int32)
    t = np.asarray(t, np.int32)
    V = matrix.shape[0]
    C_real, R_real = len(q), len(t)
    # 128-column buckets: distinct query lengths share one compiled
    # pipeline (padded columns score NEG and never reach column C_real)
    Cb = _cdiv(_cdiv(C_real, n), _RANGE_PAD) * _RANGE_PAD
    C_pad = Cb * n
    qp = np.full(C_pad, V, np.int32)
    qp[:C_real] = q
    J = _cdiv(R_real, tr)
    stride = n_ck = None
    if tb_rows is not None:
        # checkpoint cadence must divide into whole tr-blocks, and the
        # padded row count into whole checkpoints, so replays are uniform
        stride = max(tb_rows // tr, 1)
        J = _cdiv(J, stride) * stride
        n_ck = J // stride
    R_pad = J * tr
    tp = np.zeros(R_pad, np.int32)
    tp[:R_real] = t
    mat_i32 = jnp.asarray(np.round(matrix).astype(np.int32))
    return dict(
        axis=axis, n=n, q=q, t=t, V=V, C_real=C_real, R_real=R_real,
        Cb=Cb, C_pad=C_pad, qp=qp, J=J, R_pad=R_pad, tp=tp, mi=mat_i32,
        tr=tr, DEL=np.int32(int(del_)), EXT=np.int32(int(ext)),
        stride=stride, n_ck=n_ck,
    )


def _pipeline(mesh, pp, with_trace: bool):
    """Build (cached) + run the jitted shard_map pipeline.  Returns
    ``end`` or ``(end, lb_hist (n, R_pad), ckpts (n_ck, C_pad))``.

    On a multi-controller mesh the trace records are all-gathered inside
    the pipeline (``replicate_trace``) so every process holds the full
    O(R·n + R·C/tb) history; the replay/walk then runs
    process-locally."""
    multiproc = len({d.process_index for d in mesh.devices.flat}) > 1
    run = _build_pipeline(
        mesh, pp["axis"], pp["n"], pp["V"], pp["Cb"], pp["J"], pp["R_pad"],
        int(pp["DEL"]), int(pp["EXT"]), pp["stride"], pp["n_ck"], pp["tr"],
        with_trace, with_trace and multiproc,
    )
    lens = jnp.asarray([pp["C_real"], pp["R_real"]], jnp.int32)
    if not multiproc:
        return run(jnp.asarray(pp["qp"]), jnp.asarray(pp["tp"]), pp["mi"],
                   lens)
    # multi-controller mesh (the halo ppermute hops cross process
    # boundaries): every process holds the same full host
    # operands, so each just materializes its own addressable shards
    from jax.sharding import NamedSharding

    def place(a, spec):
        a = np.asarray(a)
        return jax.make_array_from_callback(
            a.shape, NamedSharding(mesh, spec), lambda idx: a[idx]
        )

    return run(
        place(pp["qp"], P(pp["axis"])),
        place(pp["tp"], P()),
        place(pp["mi"], P()),
        place(lens, P()),
    )


@functools.lru_cache(maxsize=64)
def _build_pipeline(mesh, axis, n, V, Cb, J, R_pad, del_i, ext_i, stride,
                    n_ck, tr, with_trace, replicate_trace=False):
    """The jitted shard_map program, cached on its static parameters —
    rebuilding the jit wrapper per call would retrace the whole J-step
    pipeline every time.  The REAL pair lengths ride in as a replicated
    (2,) operand, so one compiled pipeline serves every pair whose
    padded bucket (Cb, J) matches."""
    DEL = np.int32(del_i)
    EXT = np.int32(ext_i)

    in_specs = (P(axis), P(), P(), P())
    if with_trace:
        # replicate_trace (multi-controller meshes): all_gather the
        # records inside the pipeline so every process can replay/walk
        # locally; otherwise leave them mesh-sharded (no extra traffic)
        out_specs = (
            (P(), P(), P()) if replicate_trace
            else (P(), P(axis, None), P(None, axis))
        )
    else:
        out_specs = P()

    @jax.jit  # one compiled program per device; an eager shard_map
    # dispatches op-by-op
    @functools.partial(
        shard_map, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        check_vma=False,
    )
    def run(q_local, t_full, mat, lens):
        C_real = lens[0]
        R_real = lens[1]
        d = lax.axis_index(axis)
        x0 = d * Cb  # global 0-based index of this device's first column
        xg = x0 + jnp.arange(Cb, dtype=jnp.int32)  # global x-1 per lane

        def border(y):
            # H[y, 0] = -y*del with the far-corner overwrite
            # (simple/mod.rs:59-70)
            return jnp.where(
                y == R_real, -(jnp.int32(R_real) + 1) * DEL, -y * DEL
            )

        # H[0, x] for local columns (global border row)
        x1 = xg + 1
        h0 = jnp.where(x1 == C_real, -(jnp.int32(C_real) + 1) * DEL, -x1 * DEL)
        xp = x1 * EXT

        def row_fill(carry, inputs):
            prev, end = carry
            ty, bl_prev, bl_cur, y = inputs
            srow = mat[ty][jnp.clip(q_local, 0, V - 1)]
            srow = jnp.where(q_local >= V, NEG, srow)  # padded columns
            diag = jnp.concatenate([bl_prev[None], prev[:-1]]) + srow
            m0 = jnp.maximum(diag, prev - EXT)
            # left-boundary fold; cell (1,1) (device 0, row 1) takes del
            is11 = (y == 1) & (d == 0)
            pen1 = jnp.where(is11, DEL, EXT)
            a0 = jnp.where(
                is11,
                jnp.maximum(diag[0], prev[0] - DEL),
                m0[0],
            )
            a0 = jnp.maximum(a0, bl_cur - pen1)
            a = m0.at[0].set(a0)
            h = lax.cummax(a + xp) - xp
            # capture the end cell when this device owns column C_real
            c_local = jnp.int32(C_real - 1) - x0
            owns = (c_local >= 0) & (c_local < Cb) & (y == R_real)
            val = lax.dynamic_slice(h, (jnp.clip(c_local, 0, Cb - 1),), (1,))[0]
            end = jnp.where(owns, val, end)
            return (h, end), h[-1]

        def pipe_step(k, state):
            prev, end, bound_in, last_bound, lb_acc, ck_acc = state
            j = k - d  # this device's row block this step
            active = (j >= 0) & (j < J)
            jc = jnp.clip(j, 0, J - 1)
            t_rows = lax.dynamic_slice(t_full, (jc * tr,), (tr,))
            ys = jc * tr + 1 + jnp.arange(tr, dtype=jnp.int32)
            # left boundaries per row: device 0 uses the global border,
            # others the vector received from the left neighbor; the
            # first row's diagonal needs the previous block's last
            # boundary (carried in last_bound)
            borders = border(ys)
            bl_cur = jnp.where(d == 0, borders, bound_in)
            bl_prev = jnp.concatenate([last_bound[None], bl_cur[:-1]])
            (new_prev, new_end), rights = lax.scan(
                row_fill, (prev, end), (t_rows, bl_prev, bl_cur, ys)
            )
            prev = jnp.where(active, new_prev, prev)
            end = jnp.where(active, new_end, end)
            rights = jnp.where(active, rights, jnp.zeros_like(rights))
            new_last = jnp.where(active, bl_cur[-1], last_bound)
            if with_trace:
                # record the consumed left boundary and (every stride-th
                # block) the finished H row.  Inactive steps write to the
                # trash slot at the end of each accumulator — in-place
                # dynamic_update_slice on the loop carry, no O(R) where
                lb_at = jnp.where(active, jc * tr, jnp.int32(R_pad))
                lb_acc = lax.dynamic_update_slice(lb_acc, bl_cur, (lb_at,))
                is_ck = active & ((jc + 1) % stride == 0)
                ck_at = jnp.where(
                    is_ck, (jc + 1) // stride - 1, jnp.int32(n_ck)
                )
                ck_acc = lax.dynamic_update_slice(
                    ck_acc, prev[None], (ck_at, jnp.int32(0))
                )
            # ship this block's right boundary one device over
            bound_next = lax.ppermute(
                rights, axis, [(i, (i + 1) % n) for i in range(n)]
            )
            return (prev, end, bound_next, new_last, lb_acc, ck_acc)

        # seed last_bound with H[0, x0] (1-based column x0 = this
        # device's left-neighbor column) — a border-ROW value, closed
        # form for every device: -(x0)*del with the far-corner overwrite
        lb0 = jnp.where(
            x0 == C_real, -(jnp.int32(C_real) + 1) * DEL, -x0 * DEL
        )
        if with_trace:
            lb_acc0 = jnp.zeros(R_pad + tr, jnp.int32)
            ck_acc0 = jnp.zeros((n_ck + 1, Cb), jnp.int32)
        else:
            lb_acc0 = jnp.zeros((), jnp.int32)
            ck_acc0 = jnp.zeros((), jnp.int32)
        init = (
            h0,
            jnp.int32(NEG),
            jnp.zeros(tr, jnp.int32),
            lb0,
            lb_acc0,
            ck_acc0,
        )
        prev, end, _, _, lb_acc, ck_acc = lax.fori_loop(
            0, J + n - 1,
            pipe_step,
            init,
        )
        del prev
        end = jax.lax.psum(jnp.where(end == NEG, 0, end), axis)
        if with_trace:
            if replicate_trace:
                return (
                    end,
                    lax.all_gather(lb_acc[:R_pad], axis),
                    lax.all_gather(ck_acc[:n_ck], axis, axis=1, tiled=True),
                )
            return end, lb_acc[None, :R_pad], ck_acc[:n_ck]
        return end

    return run


def sharded_global_end_score(
    mesh: Mesh,
    q: np.ndarray,
    t: np.ndarray,
    matrix: np.ndarray,
    del_: float,
    ext: float,
    *,
    tr: int | None = None,
    axis: str | None = None,
) -> float:
    """Exact global end score H[tlen, qlen] of one pair, columns sharded
    over the mesh axis.  Requires an integral matrix and penalties
    (int32 arithmetic — bit-exact vs the oracle)."""
    pp = _prep_sharded(mesh, q, t, matrix, del_, ext, tr, axis)
    out = _pipeline(mesh, pp, with_trace=False)
    return float(np.asarray(out))


def _lax_tile_dirs(q_codes, mat, t_rows, h0, lb, x0, y_base,
                   DEL, EXT, V):
    """Direction tile (TB, Cb) of one replayed block — the replay
    engine matching the pipeline's forward fill.  Bit-identical
    recurrence; dirs by the exact tie policy (top > left > diagonal).

    NOTE: this recurrence intentionally exists twice (the pipeline's
    ``row_fill`` and this replay) because each runs in a different
    execution context (shard_map scan / replay inside the walk loop).
    Any edit to one MUST be mirrored in the other; the parity suite
    pins both bit-for-bit against the f64 oracle (test_wavefront_sp:
    forward end scores AND replayed-walk alignments)."""
    Cb = q_codes.shape[0]
    xg = x0 + jnp.arange(Cb, dtype=jnp.int32)
    xp = (xg + 1) * EXT

    def row(carry, inputs):
        prev = carry
        ty, bl_prev, bl_cur, y = inputs
        srow = mat[ty][jnp.clip(q_codes, 0, V - 1)]
        srow = jnp.where(q_codes >= V, NEG, srow)
        diag = jnp.concatenate([bl_prev[None], prev[:-1]]) + srow
        m0 = jnp.maximum(diag, prev - EXT)
        is11 = (y == 1) & (x0 == 0)
        pen1 = jnp.where(is11, DEL, EXT)
        a0 = jnp.where(is11, jnp.maximum(diag[0], prev[0] - DEL), m0[0])
        a0 = jnp.maximum(a0, bl_cur - pen1)
        a = m0.at[0].set(a0)
        h = lax.cummax(a + xp) - xp
        first = jnp.arange(Cb) == 0
        pen_d = jnp.where(is11 & first, DEL, EXT)
        top = prev - pen_d
        leftv = jnp.concatenate([bl_cur[None], h[:-1]]) - pen_d
        dr = jnp.where(
            h <= top,
            jnp.uint8(TOP),
            jnp.where(h <= leftv, jnp.uint8(LEFT), jnp.uint8(DIAG)),
        )
        return h, dr

    TB = t_rows.shape[0]
    ys = y_base + 1 + jnp.arange(TB, dtype=jnp.int32)
    bl_prev = lb[:-1]
    bl_cur = lb[1:]
    _, dirs = lax.scan(row, h0, (t_rows, bl_prev, bl_cur, ys))
    return dirs


_lax_tile_dirs_jit = jax.jit(
    _lax_tile_dirs,
    static_argnames=("V",),
)


@functools.partial(
    jax.jit, static_argnames=("TB", "V", "del_", "ext", "NCK", "n", "Cb"),
)
def _replay_walk_all_sharded(
    qp_dev, mat_i32, tp_dev, ckpts_dev, lb_hist_dev,
    *, TB, V, C_real, R_real, del_, ext, NCK, n, Cb,
):
    """Replay and walk the ENTIRE sharded traceback in one dispatch.

    An outer ``while_loop`` visits the (tb-row × device-column) tiles
    the walk crosses, refilling each from its forward H-row checkpoint
    + left-boundary history on device (``_lax_tile_dirs``) and walking
    it in place — the host sees one launch and the 2-bit step stream
    for the whole traceback instead of one dispatch + direction tile
    per crossed tile.

    ``ckpts_dev`` is (NCK, n·Cb) with ckpts[k] = H[(k+1)·TB];
    ``lb_hist_dev`` is (n, NCK·TB) with lb_hist[d, y-1] = H[y, d·Cb].

    Returns (packed steps — 16/word, BEG-padded; n steps; final cy;
    final cx) with the final cursor on a border.
    """
    DEL = jnp.int32(del_)
    C_tot = n * Cb
    BUD16 = _cdiv(NCK * TB + C_tot + 1, 16) * 16

    def outer_cond(c):
        cy, cx, _, _ = c
        return (cy > 0) & (cx > 0)

    def outer_body(c):
        cy, cx, nn, buf = c
        j = (cy - 1) // TB
        d = (cx - 1) // Cb
        x0 = d * Cb
        # checkpoint row (or the closed-form border row for j == 0,
        # incl. the far-corner overwrite, simple/mod.rs:59-70)
        xg1 = x0 + 1 + jnp.arange(Cb, dtype=jnp.int32)
        border_h0 = jnp.where(xg1 == C_real, -(C_real + 1) * DEL,
                              -xg1 * DEL)
        ck_row = lax.dynamic_slice(
            ckpts_dev, (jnp.maximum(j - 1, 0), x0), (1, Cb)
        )[0]
        h0 = jnp.where(j == 0, border_h0, ck_row).astype(jnp.int32)
        # left-boundary column for the tile (lb[0] = H[j·TB, x0])
        lb0_border = jnp.where(x0 == C_real, -(C_real + 1) * DEL,
                               -x0 * DEL)
        lb_prev = lax.dynamic_slice(
            lb_hist_dev, (d, jnp.maximum(j * TB - 1, 0)), (1, 1)
        )[0, 0]
        lb0 = jnp.where(j == 0, lb0_border, lb_prev).astype(jnp.int32)
        lb = jnp.concatenate([
            lb0[None],
            lax.dynamic_slice(lb_hist_dev, (d, j * TB), (1, TB))[0],
        ])
        t_rows = lax.dynamic_slice(tp_dev, (j * TB,), (TB,))
        q_codes = lax.dynamic_slice(qp_dev, (x0,), (Cb,))
        dirs = _lax_tile_dirs(
            q_codes, mat_i32, t_rows, h0, lb, x0, j * TB,
            DEL, jnp.int32(ext), V,
        )

        def get_d(r, c):
            return dirs[r, c].astype(jnp.int32)

        y, x, nn, buf = walk_tile_inner(
            get_d, cy - j * TB, cx - x0, nn, buf
        )
        return (j * TB + y, x0 + x, nn, buf)

    init = (
        jnp.int32(R_real),
        jnp.int32(C_real),
        jnp.int32(0),
        jnp.full((BUD16,), BEG, jnp.int32),
    )
    cy, cx, nn, buf = lax.while_loop(outer_cond, outer_body, init)
    return pack_walk_steps(buf), nn, cy, cx


def sharded_global_align(
    mesh: Mesh,
    q: np.ndarray,
    t: np.ndarray,
    matrix: np.ndarray,
    del_: float,
    ext: float,
    *,
    tr: int | None = None,
    tb_rows: int = 512,
    axis: str | None = None,
):
    """Exact global ALIGNMENT of one huge pair, columns sharded over the
    mesh axis — checkpoint-and-replay traceback on top of the pipeline.

    Returns ``(end_score, qa, ta, coords)`` with the reference's
    traceback semantics (seeded last characters, simple/mod.rs:99-127),
    bit-equal to the oracle.  ``tb_rows`` is the checkpoint cadence
    (rounded to a multiple of ``tr``): forward extra memory is
    O(R·n + R·C/tb_rows) ints; traceback replays one
    (tb_rows × column-block) tile per block the path crosses (~2x fill
    cost total).
    """
    from ..alphabet import BLANK

    pp = _prep_sharded(mesh, q, t, matrix, del_, ext, tr, axis,
                       tb_rows=tb_rows)
    C_real, R_real = pp["C_real"], pp["R_real"]
    if C_real == 0 or R_real == 0:
        raise ValueError("empty sequence")
    q_np, t_np = pp["q"], pp["t"]
    Cb, n = pp["Cb"], pp["n"]
    stride = pp["stride"]
    TB = stride * pp["tr"]

    end_dev, lb_hist_dev, ckpts_dev = _pipeline(mesh, pp, with_trace=True)
    end = float(np.asarray(end_dev))
    multiproc = len({d.process_index for d in mesh.devices.flat}) > 1
    if multiproc:
        # the pipeline all-gathered the trace records (replicate_trace),
        # so each process reads the fully-replicated arrays and re-hosts
        # them as process-LOCAL arrays — the replay/walk below is then an
        # ordinary single-controller computation, run redundantly (and
        # identically: same records, same walk) on every process
        lb_hist_dev = jnp.asarray(np.asarray(lb_hist_dev))
        ckpts_dev = jnp.asarray(np.asarray(ckpts_dev))
    # the trace records stay ON DEVICE for the default fused walk; only
    # the host-walk path materializes numpy copies
    use_device_walk = os.environ.get("ALIGNER_DEVICE_WALK", "1") != "0"
    lb_hist = ckpts = None
    if not use_device_walk:
        lb_hist = np.asarray(lb_hist_dev)  # (n, R_pad): H[y, x0_d]
        ckpts = np.asarray(ckpts_dev)  # (n_ck, C_pad): H[(k+1)*TB, ...]

    DEL_i, EXT_i = int(pp["DEL"]), int(pp["EXT"])
    V = pp["V"]
    tp = pp["tp"]

    def border_row_vals(xg1):
        # H[0, x] closed form with the far-corner overwrite
        out = -xg1 * DEL_i
        out[xg1 == C_real] = -(C_real + 1) * DEL_i
        return out

    def _tile_inputs(j: int, d: int):
        """(x0, h0, lb, t_rows) replay operands for tile (j, d)."""
        x0 = d * Cb
        xg1 = x0 + 1 + np.arange(Cb)
        if j == 0:
            h0 = border_row_vals(xg1.copy()).astype(np.int32)
        else:
            h0 = ckpts[j - 1, x0 : x0 + Cb].astype(np.int32)
        lb = np.empty(TB + 1, np.int32)
        if j == 0:
            lb[0] = (
                -(C_real + 1) * DEL_i if x0 == C_real else -x0 * DEL_i
            )
        else:
            lb[0] = lb_hist[d, j * TB - 1]
        lb[1:] = lb_hist[d, j * TB : (j + 1) * TB]
        t_rows = tp[j * TB : (j + 1) * TB]
        return x0, h0, lb, t_rows

    def replay_tile(j: int, d: int) -> np.ndarray:
        """uint8 dirs (TB, Cb) for rows j*TB+1..(j+1)*TB, device-d cols."""
        x0, h0, lb, t_rows = _tile_inputs(j, d)
        dirs = _lax_tile_dirs_jit(
            jnp.asarray(pp["qp"][x0 : x0 + Cb]), pp["mi"],
            jnp.asarray(t_rows), jnp.asarray(h0), jnp.asarray(lb),
            jnp.int32(x0), jnp.int32(j * TB),
            DEL=jnp.int32(DEL_i), EXT=jnp.int32(EXT_i), V=V,
        )
        return np.asarray(dirs)

    # --- backward walk (simple/mod.rs:99-127 semantics, tiled) ---
    # default: the WHOLE traceback (every crossed tile's replay + walk)
    # runs in one device dispatch; only the 2-bit step stream returns.
    # ALIGNER_DEVICE_WALK=0 restores the host per-cell walk
    qa_chunks = [np.array([q_np[-1]], np.int16)]
    ta_chunks = [np.array([t_np[-1]], np.int16)]
    cy, cx = R_real, C_real
    if use_device_walk:
        packed, nn, cy_f, cx_f = _replay_walk_all_sharded(
            jnp.asarray(pp["qp"]), pp["mi"],
            jnp.asarray(tp), ckpts_dev, lb_hist_dev,
            TB=TB, V=V, C_real=C_real, R_real=R_real, del_=DEL_i, ext=EXT_i,
            NCK=ckpts_dev.shape[0], n=n, Cb=Cb,
        )
        qa_c, ta_c = steps_to_chunks(packed, int(nn), cy, cx, q_np, t_np)
        qa_chunks.append(qa_c)
        ta_chunks.append(ta_c)
        cy, cx = int(cy_f), int(cx_f)
    else:
        cur_tile = None
        tile = None
        while cy > 0 and cx > 0:
            j, d = (cy - 1) // TB, (cx - 1) // Cb
            if (j, d) != cur_tile:
                tile = replay_tile(j, d)
                cur_tile = (j, d)
            dr = tile[cy - 1 - j * TB, cx - 1 - d * Cb]
            if dr == TOP:
                qa_chunks.append(np.array([BLANK], np.int16))
                ta_chunks.append(np.array([t_np[cy - 1]], np.int16))
                cy -= 1
            elif dr == LEFT:
                qa_chunks.append(np.array([q_np[cx - 1]], np.int16))
                ta_chunks.append(np.array([BLANK], np.int16))
                cx -= 1
            else:  # DIAG (BEG cannot occur in global interiors)
                qa_chunks.append(np.array([q_np[cx - 1]], np.int16))
                ta_chunks.append(np.array([t_np[cy - 1]], np.int16))
                cy -= 1
                cx -= 1
    if cx > 0:
        # border row: LEFT until (0, 0) (simple/mod.rs:61)
        qa_chunks.append(q_np[:cx][::-1].astype(np.int16))
        ta_chunks.append(np.full(cx, BLANK, np.int16))
    if cy > 0:
        # border column: TOP until (0, 0) (simple/mod.rs:66)
        qa_chunks.append(np.full(cy, BLANK, np.int16))
        ta_chunks.append(t_np[:cy][::-1].astype(np.int16))
    qa = np.concatenate(qa_chunks)[::-1]
    ta = np.concatenate(ta_chunks)[::-1]
    return (
        end,
        np.ascontiguousarray(qa),
        np.ascontiguousarray(ta),
        ((1, C_real), (1, R_real)),
    )
