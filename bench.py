"""Headline benchmark: frame-to-frame CVO registration throughput on a GPU.

Prints ONE JSON line:
  {"metric": "f2f_registration_fps", "value": N, "unit": "frames/s",
   "vs_baseline": R, "device": {"platform": ..., "kind": ..., "count": ...}}

Workload: KITTI-scale stereo odometry steady state — a sequence of synthetic
frames (16384 points each, ~55 m range envelope mimicking the reference's
stereo point selection, CvoPointCloud.cpp:39-57; utils/odometry_scene.py)
registered consecutively with the geometric KITTI preset
(cvo_geometric_params_img_gpu0) and a constant-velocity initial guess,
exactly the hot path of the reference's cvo_align_gpu_img driver
(main_cvo_gpu_align_raw_image.cpp:73-163, init guess at :125). Each full
pairwise registration (kernel + flow + quartic step + lengthscale schedule
to convergence) runs inside a single jitted while-loop; the pose chain stays
on device across frames, as a production pipeline would run it (the
per-frame result feeds the next frame's initial guess without a host round
trip).

Baseline: the reference CUDA CvoGPU registers a KITTI stereo frame pair in
~0.5 s on its desktop GPU ("Average registration time", printed by
main_cvo_gpu_align_raw_image.cpp:165; repo stores no numbers — BASELINE.md),
i.e. ~2 frames/s. vs_baseline = fps / 2.0.

The bench measures the card: without a GPU it exits non-zero. Supplementary
numbers go to stderr so stdout stays a single JSON line.
"""

import json
import os
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import jax
    import jax.numpy as jnp

    from unified_cvo_tpu.config import load_preset
    from unified_cvo_tpu.models.align import align
    from unified_cvo_tpu.ops import lie
    from unified_cvo_tpu.utils.odometry_scene import (
        XI_GUESS_ERROR, XI_BASE, odometry_sequence, pose_errors, se3_exp)
    from unified_cvo_tpu.utils.pointcloud import make_pointcloud

    dev = jax.devices()[0]
    log(f"devices: {jax.devices()}")
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures the GPU; JAX found platform "
                         f"{dev.platform!r}")
    n = int(os.environ.get("BENCH_N", 16384))
    # 50 frames ~ steady-state odometry (amortizes per-align dispatch the
    # way a real long sequence does)
    n_frames = int(os.environ.get("BENCH_FRAMES", 50))
    params = load_preset("cvo_geometric_params_img_gpu0")
    seq = odometry_sequence(n=n, n_frames=n_frames)
    frames = [make_pointcloud(f, bucket=n) for f in seq.frames]
    jax.block_until_ready(frames[-1].xyz)

    chunk = int(os.environ.get("BENCH_CHUNK", 4096))
    backend = os.environ.get("BENCH_BACKEND", "auto")
    nl_builder = os.environ.get("BENCH_NL_BUILDER") or None
    nl_k = int(os.environ["BENCH_NL_K"]) if "BENCH_NL_K" in os.environ else None
    nl_per_cell = (int(os.environ["BENCH_NL_PER_CELL"])
                   if "BENCH_NL_PER_CELL" in os.environ else None)
    # hard iteration cap: a registration that never converges must not hold
    # the card for minutes
    max_iter = int(os.environ.get("BENCH_MAX_ITER", 1500))
    kw = dict(chunk=chunk, max_iter=max_iter, backend=backend,
              nl_builder=nl_builder, nl_k=nl_k, nl_per_cell=nl_per_cell)

    def run_sequence(guess):
        """Register all consecutive pairs; the pose chain stays on device
        (result k is the constant-velocity init guess for pair k+1)."""
        results, infos = [], []
        for k in range(n_frames):
            T_rel, ret, info = align(frames[k], frames[k + 1], guess, params,
                                     **kw)
            # align returns the target->source map and takes the inverse
            # convention as its guess (models/align.py docstring)
            Ri, Ti = lie.mat44_to_rt(T_rel)
            guess = lie.rt_to_mat44(*lie.invert_rt(Ri, Ti))
            results.append(T_rel)
            infos.append(info)
        jax.block_until_ready(results)
        return results, infos

    def guess_rep(rep):
        """Distinct warm start per repetition, so no caching layer can
        elide a rerun of an identical sequence."""
        g = se3_exp((XI_BASE + XI_GUESS_ERROR) * (1.0 + 1e-4 * rep))
        return jax.block_until_ready(jnp.asarray(g, jnp.float32))

    t0 = time.perf_counter()
    results, infos = run_sequence(guess_rep(0))  # includes compile
    log(f"warmup (with compile): {time.perf_counter() - t0:.2f}s")

    times = []
    for rep in range(3):
        guess_r = guess_rep(rep + 1)
        t0 = time.perf_counter()
        results, infos = run_sequence(guess_r)
        times.append(time.perf_counter() - t0)
    t_seq = min(times)
    iters = [int(i.iterations) for i in infos]
    log(f"sequence: {t_seq*1e3:.3f} ms for {n_frames} frames, "
        f"{t_seq/n_frames*1e3:.3f} ms/frame, iters/frame={iters}")

    errs = pose_errors([np.asarray(T) for T in results], seq.T_true)
    log(f"pose error |xi|: max={errs.max():.5f} mean={errs.mean():.5f}")
    if errs.max() > 0.05:
        raise SystemExit("pose error above the 0.05 sanity bound")

    fps = n_frames / t_seq
    print(json.dumps({
        "metric": "f2f_registration_fps",
        "value": round(fps, 3),
        "unit": "frames/s",
        "vs_baseline": round(fps / 2.0, 3),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
