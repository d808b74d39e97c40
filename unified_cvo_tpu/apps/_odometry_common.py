"""Shared pipelined frame-to-frame odometry loop for the app drivers.

The reference drivers (e.g. main_cvo_gpu_align_raw_image.cpp:73-163) run
front-end and registration strictly serialized. Here JAX's async dispatch
pipelines them: while the device runs the align for pair (i-1, i), the CPU
builds the cloud for frame i+1; the constant-velocity warm start chains on
device (the inverse of the previous result, update_tf convention
CvoGPU.cu:94-112) with no host round-trip on the guess path.

Results are fetched in BATCHES of `fetch_depth` frames with a single
`jax.device_get` of the whole (transform, ret, info) pytree list: every
blocking fetch waits for the device and stalls the dispatch queue, and a
per-frame loop would pay several (the pose, the ret code, then each info
field the caller logged). Trajectory rows are therefore flushed
every `fetch_depth` frames instead of every frame — the reference's
resume-from-any-index contract holds at that granularity.
"""

from __future__ import annotations

import time

import numpy as np

import jax
import jax.numpy as jnp

from unified_cvo_tpu.models.align import align
from unified_cvo_tpu.ops import lie


@jax.jit
def _inv44(T):
    R, t = lie.mat44_to_rt(T)
    return lie.rt_to_mat44(*lie.invert_rt(R, t))


def run_pipelined(
    source,
    frame_indices,
    read_target,
    params,
    first_params,
    on_result,
    chunk: int = 4096,
    max_iter=None,
    log=print,
    align_kwargs=None,
    fetch_depth: int = 8,
):
    """Drive the odometry pipeline.

    source: cloud of the first frame.
    frame_indices: iterable of pair indices i (align frame i -> i+1).
    read_target(i): advance the handler and return (PointCloud, aux) for
        frame i+1, or None at end of sequence.
    on_result(i, result_f64, ret, info, aux, t_frontend, t_block): called in
        frame order once each alignment's result is fetched. `info` arrives
        as HOST values (fetched in the batch) — field reads cost nothing.
    fetch_depth: results fetched (and trajectory rows flushed) every this
        many frames, in ONE device_get.

    Returns (n_aligned, total_block_seconds): the blocking time is the wall
    time actually spent waiting on the device beyond the front-end work —
    the pipelined cost of registration.
    """
    align_kwargs = align_kwargs or {}
    guess = jnp.eye(4, dtype=jnp.float32)
    pending = []
    n_aligned = 0
    total_block = 0.0
    first_i = None

    def resolve_batch():
        nonlocal n_aligned, total_block
        if not pending:
            return
        t0 = time.time()
        fetched = jax.device_get([(p[1], p[2], p[3]) for p in pending])
        t_block = time.time() - t0
        per = t_block / len(pending)
        total_block += t_block
        for (i, _, _, _, t_frontend, aux), (T, ret, info) in zip(
                pending, fetched):
            n_aligned += 1
            on_result(i, np.asarray(T, np.float64), int(ret), info, aux,
                      t_frontend, per)
        pending.clear()

    for i in frame_indices:
        if first_i is None:
            first_i = i
        t0 = time.time()
        ta = read_target(i)
        if ta is None:
            break
        target, aux = ta
        t_frontend = time.time() - t0
        p = first_params if i == first_i else params
        T_dev, ret_dev, info = align(
            source, target, guess, p, chunk=chunk, max_iter=max_iter,
            **align_kwargs)
        guess = _inv44(T_dev)  # device-resident constant-velocity warm start
        pending.append((i, T_dev, ret_dev, info, t_frontend, aux))
        if len(pending) >= max(fetch_depth, 1):
            resolve_batch()
        source = target
    resolve_batch()
    return n_aligned, total_block
