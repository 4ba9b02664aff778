"""Device meshes and sharded alignment steps.

Replaces the reference's concurrency structures with mesh-parallel XLA:

* ``sharded_scores`` — the 10-thread shuffle fan-out
  (statistics/mod.rs:253-291) and window-scan threads (engine/calc.rs:45-75)
  become a problem batch sharded over the ``data`` axis.
* ``window_scan_step`` — one latent-repeat-search scan cycle
  (engine/calc.rs:88-147): sharded window scores, global mean/variance via
  ``psum``, z-values computed in place.
* ``matrix_population_step`` — the aligner-web fan-out of one job per
  candidate matrix (handlers.rs:238-250) + best-subtask promotion
  (queries.rs:74-80): matrices shard over the ``matrix`` axis, each device
  scores its shard against the (replicated) pair batch, and the best
  matrix per problem is reduced with a max over the ``matrix`` axis.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..backend import platform
from ..errors import ValidationError
from ..ops.scan_engine import fill_batch, fill_pwm_batch


def _resolve_engine(engine: str | None) -> str:
    if engine in (None, "auto"):
        return platform().engine
    return engine


def make_mesh(
    n_devices: int | None = None, axes: tuple[str, str] = ("data", "matrix")
) -> Mesh:
    """A 2-D mesh over the first ``n_devices`` devices.

    The ``data`` axis gets the larger factor (problem batches are the
    bigger dimension in every reference workload).
    """
    devs = jax.devices()
    n = len(devs) if n_devices is None else n_devices
    if n > len(devs):
        raise ValidationError(
            f"make_mesh: {n} devices requested but only "
            f"{len(devs)} visible"
        )
    devs = devs[:n]
    m = 1
    for cand in range(int(np.sqrt(n)), 0, -1):
        if n % cand == 0:
            m = cand
            break
    d = n // m
    return Mesh(np.array(devs).reshape(d, m), axes)


def sharded_scores(
    mesh: Mesh,
    q,
    qlen,
    t,
    tlen,
    matrix,
    del_: float,
    ext: float,
    *,
    mode: str = "local",
    dtype=jnp.float32,
    engine: str | None = None,
):
    """Scores-only batched fill with problems sharded over ``data``.

    The matrix is replicated; per-problem outputs come back sharded the
    same way.  Batch size must be divisible by the data-axis size (pad
    with zero-length problems).  ``engine`` picks the per-device kernel
    (default: the platform's engine, ``backend.PLATFORMS``).
    """
    data_ax = mesh.axis_names[0]
    engine = _resolve_engine(engine)
    if engine == "pallas":
        from ..ops.pallas_dp import matrix_operand

        matrix = matrix_operand(matrix, dtype, del_, ext)
    else:
        matrix = jnp.asarray(matrix, dtype)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(data_ax), P(data_ax), P(data_ax), P(data_ax), P()),
        out_specs=(P(data_ax), P(data_ax), P(data_ax), P(data_ax)),
        check_vma=False,
    )
    def step(qs, qls, ts, tls, mat):
        if engine == "pallas":
            from ..ops.pallas_dp import fill_scores_traced

            return fill_scores_traced(
                qs, qls, ts, tls, mat, del_, ext, mode=mode, dtype=dtype,
            )
        r = fill_batch(
            qs, qls, ts, tls, mat, del_, ext,
            mode=mode, with_planes=False, dtype=dtype,
        )
        return r.fmax, r.fy, r.fx, r.end

    return step(
        jnp.asarray(q, jnp.int32), jnp.asarray(qlen, jnp.int32),
        jnp.asarray(t, jnp.int32), jnp.asarray(tlen, jnp.int32), matrix,
    )


def window_scan_step(
    mesh: Mesh,
    windows,  # (B, L) int32 window sequences, sharded over data
    wlen,  # (B,) int32
    pwm,  # (4, W) replicated
    del_: float,
    ext: float,
    *,
    dtype=jnp.float32,
    engine: str | None = None,
):
    """One repeat-search scan: PWM-align every window, z-score globally.

    Returns (scores, z, mean, std) with mean/std computed over all active
    windows via ``psum`` (engine/calc.rs:72-86 computes them from the
    streamed thread results; here it is one collective).
    """
    data_ax = mesh.axis_names[0]
    engine = _resolve_engine(engine)
    pwm = jnp.asarray(pwm, dtype)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(data_ax), P(data_ax), P()),
        out_specs=(P(data_ax), P(data_ax), P(), P()),
        check_vma=False,
    )
    def step(ws, wls, mat):
        if engine == "pallas":
            from ..ops.pallas_dp import fill_pwm_scores_traced

            fmax, fy, fx, end = fill_pwm_scores_traced(
                ws, wls, mat, del_, ext, dtype=dtype
            )
        else:
            r = fill_pwm_batch(
                ws, wls, mat, del_, ext, with_planes=False, dtype=dtype
            )
            fmax = r.fmax
        active = (wls > 0).astype(dtype)
        n = jax.lax.psum(jnp.sum(active), data_ax)
        # an all-padded launch (the skip-mask pattern) must yield 0/0/0
        # stats, not NaN z-scores that silently select nothing
        n = jnp.maximum(n, jnp.asarray(1.0, dtype))
        s1 = jax.lax.psum(jnp.sum(fmax * active), data_ax)
        s2 = jax.lax.psum(jnp.sum(fmax * fmax * active), data_ax)
        mean = s1 / n
        var = s2 / n - mean * mean
        std = jnp.sqrt(jnp.maximum(var, 0.0))
        z = (fmax - mean) / jnp.maximum(std, jnp.finfo(dtype).tiny)
        return fmax, z, mean[None], std[None]

    scores, z, mean, std = step(
        jnp.asarray(windows, jnp.int32), jnp.asarray(wlen, jnp.int32), pwm
    )
    return scores, z, mean[0], std[0]


def matrix_population_step(
    mesh: Mesh,
    q,  # (Bq, C) int32 pair queries, sharded over data
    qlen,
    t,
    tlen,
    matrices,  # (M, V, V) sharded over matrix axis
    del_: float,
    ext: float,
    *,
    dtype=jnp.float32,
    engine: str | None = None,
):
    """Score every (pair, candidate matrix) combination; reduce best matrix.

    Each device holds a (data-shard × matrix-shard) tile of the cross
    product, aligns it as one batch, and the best f per pair is reduced
    with ``pmax`` over the matrix axis — the mesh replacement for
    one-Kafka-job-per-matrix + SQL best-row promotion (handlers.rs:238-250,
    queries.rs:74-80, fixing the reference's ORDER BY ASC bug by actually
    taking the max).

    Returns (best_f, best_matrix_index) per pair, sharded over data.
    """
    data_ax, mat_ax = mesh.axis_names
    engine = _resolve_engine(engine)
    matrices = jnp.asarray(matrices, dtype)
    M = matrices.shape[0]
    if M % mesh.shape[mat_ax]:
        # fail clearly up front instead of with a cryptic shard_map
        # partition error later
        raise ValidationError(
            f"{M} candidate matrices do not shard evenly over the "
            f"{mesh.shape[mat_ax]}-device {mat_ax!r} axis — pad the "
            "population to a multiple (zero matrices are free)"
        )

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(data_ax), P(data_ax), P(data_ax), P(data_ax), P(mat_ax)),
        out_specs=(P(data_ax), P(data_ax)),
        check_vma=False,
    )
    def step(qs, qls, ts, tls, mats):
        bq = qs.shape[0]
        m_local = mats.shape[0]
        # cross product: tile pairs over local matrices
        qs2 = jnp.tile(qs, (m_local, 1))
        qls2 = jnp.tile(qls, m_local)
        ts2 = jnp.tile(ts, (m_local, 1))
        tls2 = jnp.tile(tls, m_local)
        mats2 = jnp.repeat(mats, bq, axis=0)
        if engine == "pallas":
            from ..ops.pallas_dp import fill_scores_traced

            fmax = fill_scores_traced(
                qs2, qls2, ts2, tls2, mats2, del_, ext, mode="local",
                dtype=dtype, track_argmax=False,
            )[0]
        else:
            fmax = fill_batch(
                qs2, qls2, ts2, tls2, mats2, del_, ext,
                mode="local", with_planes=False, dtype=dtype,
            ).fmax
        f = fmax.reshape(m_local, bq)  # (m_local, bq)
        local_best = jnp.max(f, axis=0)
        local_arg = jnp.argmax(f, axis=0)
        mat_idx = jax.lax.axis_index(mat_ax)
        global_idx = mat_idx * m_local + local_arg
        best = jax.lax.pmax(local_best, mat_ax)
        # index of the winning matrix: take the index where f == best,
        # smallest global index wins on ties
        cand = jnp.where(local_best == best, global_idx, M)
        win = jax.lax.pmin(cand, mat_ax)
        return best, win.astype(jnp.int32)

    return step(
        jnp.asarray(q, jnp.int32), jnp.asarray(qlen, jnp.int32),
        jnp.asarray(t, jnp.int32), jnp.asarray(tlen, jnp.int32), matrices,
    )
