#!/usr/bin/env python3
"""Chip smoke: run the system's main path once on a GPU and check it.

    python chip_smoke.py                # one card
    python chip_smoke.py --four-cards   # the multi-card modes, 4 cards

One card, in one process:
  1. device check: JAX version and devices, the card's name and power limit
     (nvidia-smi); no GPU is an error, there is no CPU fallback;
  2. odometry: 20 consecutive 16,384-point KITTI-scale frames registered
     through models.align.align (auto backend 'ell', grid builder, the
     geometric preset), pose error against ground truth;
  3. parity at real width: the ELL consume and the dense blocked-jnp passes
     at 16,384 x 16,384 against the float64 NumPy oracle (tests/oracle.py);
  4. bundle adjustment: one models.irls.make_irls_solver solve, 5 frames,
     7 edges, 8,192 points a frame;
  5. device stereo frontend: frontend.device.device_pointcloud_from_stereo
     on a rendered 1241x376 pair, disparity against the renderer's ground
     truth, then two frontend clouds aligned.

--four-cards runs only the parallel modes on a flat 4-card mesh, each
beside the same work on one card: DP batch align, point-sharded and ring
full align, sharded IRLS.

Times are for information, taken warm with block_until_ready; compile time
is reported as set-up. Any failed check raises, and the process exits
non-zero. The last line of standard output is one JSON object:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "tests"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from oracle import oracle_dense_moments  # noqa: E402
from unified_cvo_tpu.config import load_preset  # noqa: E402
from unified_cvo_tpu.frontend.device import (  # noqa: E402
    device_gray_and_gradients, device_pointcloud_from_stereo)
from unified_cvo_tpu.models import irls  # noqa: E402
from unified_cvo_tpu.models.align import (  # noqa: E402
    align, align_core, resolve_backend, resolve_nl_builder)
from unified_cvo_tpu.ops import kernels, lie, sgm  # noqa: E402
from unified_cvo_tpu.ops import neighbors as nbr  # noqa: E402
from unified_cvo_tpu.utils import odometry_scene as scene  # noqa: E402
from unified_cvo_tpu.utils import synth  # noqa: E402
from unified_cvo_tpu.utils.pointcloud import make_pointcloud  # noqa: E402

f32 = jnp.float32

# ---- bounds (every one states the precision it assumes) -------------------
# The package pins float32 matmuls to HIGHEST (no TF32), so every sum below
# is plain f32 arithmetic in the GPU's reduction order.
POSE_ERR_MAX = 0.05      # |xi| per pair vs ground truth (the bench's bound)
A_SUM_RTOL = 1e-4        # f32 sum of <= N*K = 524k positive terms
NEAR_REL = 1e-3          # kernel values this close (relative) to sp_thres
#                          may gate either way in f32: the target is moved
#                          in f32 at up to 55 m (~1e-5 m rounding), which
#                          shifts d^2 at the gate by ~3e-4 of the kernel
#                          value at ell ~ 0.12 (measured: one such pair
#                          flipped at 16k x 16k)
TWIST_ATOL = 1e-3        # of |twist| = 1, or TWIST_COND times the flow's
TWIST_COND = 1e-8        # condition (flow_mag / |flow|, tests/oracle.py):
#                          the f32 moments are differences of terms
#                          flow_mag large and normalizing divides by |flow|;
#                          measured 2.8e-9 x condition at a converged 4096-
#                          point pair on the CPU, where condition is 4e5
STEP_RTOL = 1e-3         # B..E: f32 sums of mixed-sign polynomial terms,
STEP_MAG = 1e-5          # or this fraction of sum A|term|: a sum of N
#                          terms in another order is off by ~sqrt(N) eps
#                          sum|term| (~1e-5 at N = 35k pairs), so a
#                          coefficient that cancels to a small value keeps
#                          an absolute bound (D measured 8e-4 relative)
BA_POSE_ERR_MAX = 0.01   # |xi| per frame after the solve (init ~0.05-0.1)
# disparity against the renderer's exact depth: tests/test_sgm.py holds the
# device matcher to >95% within 1 px and 0.35 px mean of the native matcher;
# against exact truth the host matchers are held to 0.5 px mean
# (tests/test_e2e_accuracy.py), and this matcher measured 0.356 px at half
# KITTI size on the CPU, so the mean bound is the latter's 0.5 px
DISP_WITHIN_1PX = 0.95   # share of co-valid pixels within 1 px
DISP_MEAN_EPE = 0.5      # px, mean end-point error on co-valid pixels
FRONTEND_POSE_ERR_MAX = 0.05  # |xi| of the frontend pair vs the trajectory


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
        return "; ".join(ln.strip() for ln in out.splitlines() if ln.strip())
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"


def device_check(n_cards: int = 1) -> dict:
    devs = jax.devices()
    log(f"jax {jax.__version__}; devices: {devs}")
    for d in devs:
        log(f"  device {d.id}: platform={d.platform} kind={d.device_kind}")
    log(f"card: {card_line()}")
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: JAX found no GPU (platform {devs[0].platform!r}); "
            "this script checks the card and has no CPU fallback")
    if len(devs) < n_cards:
        raise SystemExit(f"chip_smoke: {n_cards} cards needed, "
                         f"JAX sees {len(devs)}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def _timed(fn, *args, reps=5):
    """(result, median warm seconds) of fn(*args) ending in
    block_until_ready; the first call compiles and is not counted."""
    out = jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return out, float(np.median(ts))


def _peak_bytes() -> str:
    stats = jax.devices()[0].memory_stats()
    return "not reported" if not stats else str(stats.get("peak_bytes_in_use"))


# ---- phase 2: odometry -----------------------------------------------------


def phase_odometry(n=16384, n_frames=20, max_iter=1500, chunk=4096,
                   timed=True):
    params = load_preset("cvo_geometric_params_img_gpu0")
    seq = scene.odometry_sequence(n=n, n_frames=n_frames)
    frames = [make_pointcloud(f, bucket=n) for f in seq.frames]
    backend = resolve_backend(params, n, n)
    builder = resolve_nl_builder(params, n, n)
    log(f"[odometry] {n_frames} pairs x {n} points, backend={backend}, "
        f"builder={builder}")
    assert backend == "ell" and builder == "grid", (backend, builder)
    guess0 = jnp.asarray(seq.guess0, f32)

    def run(guess):
        out = []
        for k in range(n_frames):
            T, ret, info = align(frames[k], frames[k + 1], guess, params,
                                 chunk=chunk, max_iter=max_iter)
            Ri, Ti = lie.mat44_to_rt(T)
            guess = lie.rt_to_mat44(*lie.invert_rt(Ri, Ti))
            out.append((T, ret, info))
        return jax.block_until_ready(out)

    t0 = time.perf_counter()
    out = run(guess0)
    t_first = time.perf_counter() - t0
    T_rel = [np.asarray(o[0]) for o in out]
    iters = [int(o[2].iterations) for o in out]
    for k, (_, ret, info) in enumerate(out):
        log(f"[odometry] pair {k:2d}: iterations={int(info.iterations)} "
            f"nl_rebuilds={int(info.nl_rebuilds)} "
            f"nl_overflow={int(info.nl_overflow)} ret={int(ret)}")
    errs = scene.pose_errors(T_rel, seq.T_true)
    log(f"[odometry] pose error |xi|: max={errs.max():.6f} "
        f"mean={errs.mean():.6f} (bound {POSE_ERR_MAX})")
    assert all(np.isfinite(T).all() for T in T_rel)
    assert all(int(o[1]) == 0 for o in out)
    assert errs.max() < POSE_ERR_MAX, errs

    mem = align_core.lower(
        frames[0], frames[1], guess0, params, chunk=chunk, max_iter=max_iter,
        backend=backend).compile().memory_analysis()
    log(f"[odometry] align_core memory_analysis: {mem}")
    log(f"[odometry] peak_bytes_in_use: {_peak_bytes()}")
    if timed:
        t0 = time.perf_counter()
        run(guess0)
        t = time.perf_counter() - t0
        log(f"[odometry] set-up (first run, compile included): {t_first:.3f} s;"
            f" warm: {1e3 * t / n_frames:.4f} ms/frame, "
            f"{1e3 * t / sum(iters):.5f} ms/iteration over {sum(iters)} "
            f"iterations [card: {card_line()}]")
    return dict(params=params, seq=seq, frames=frames, results=out,
                errors=errs, chunk=chunk)


# ---- phase 3: parity at real width ----------------------------------------


def _compare(tag, got, ref, which):
    """One GPU path's (a_sum, nonzeros, twist, (B, C, D, E)) against the
    oracle; B..E are compared with the oracle's step at the same twist.
    Pairs whose kernel value sits within NEAR_REL of sp_thres may be gated
    either way by f32, so each bound adds what those pairs can move."""
    a_sum, nz, twist, steps = got
    log(f"[parity] {tag}: a_sum {float(a_sum):.9g} vs {ref['a_sum']:.9g}; "
        f"nonzeros {int(nz)} vs {ref['nonzeros']} ({ref['near']} near the "
        f"threshold); twist max|diff| "
        f"{np.abs(np.asarray(twist) - ref['twist']).max():.3e}")
    assert abs(float(a_sum) - ref["a_sum"]) <= (
        A_SUM_RTOL * ref["a_sum"] + ref["near_a"])
    assert abs(int(nz) - ref["nonzeros"]) <= ref["near"], (int(nz), ref)
    cond = ref["flow_mag"] / ref["joint_norm"]
    bound = (max(TWIST_ATOL, TWIST_COND * cond)
             + ref["near_flow"] / ref["joint_norm"])
    log(f"[parity] {tag}: flow condition {cond:.3g}, twist bound {bound:.3g}")
    np.testing.assert_allclose(np.asarray(twist, np.float64), ref["twist"],
                               atol=bound)
    for name, g, r, mag, near in zip(
            "BCDE", steps, ref["steps"][which], ref["steps_abs"][which],
            ref["steps_near"][which]):
        bound = max(STEP_RTOL * abs(r), STEP_MAG * mag) + near
        log(f"[parity] {tag}: {name} {float(g):.9g} vs {r:.9g} "
            f"(|diff| {abs(float(g) - r):.3g}, bound {bound:.3g})")
        assert abs(float(g) - r) <= bound, (tag, name, float(g), r, bound)


@functools.partial(jax.jit, static_argnames="params")
def _consume_ell(params, ell, src, nl, R, t):
    stats, a, yts = nbr.flow_stats_ell(params, ell, src, nl, R, t)
    twist, _ = kernels.flow_from_stats(params, src, stats)
    return (stats.a_sum, stats.nonzeros, twist,
            nbr.step_coeffs_ell(params, ell, src, a, yts, twist))


@functools.partial(jax.jit, static_argnames=("params", "chunk"))
def _consume_dense(params, chunk, ell, src, tgt, R, t):
    y_t = tgt.transformed(R, t)
    stats = kernels.flow_stats(params, ell, src, y_t, chunk)
    twist, _ = kernels.flow_from_stats(params, src, stats)
    return (stats.a_sum, stats.nonzeros, twist,
            kernels.step_coeffs(params, ell, src, y_t, twist, chunk))


def _per_call(fn, n, ell, *args):
    """Warm seconds per call of fn(ell, *args), over n calls chained inside
    one jitted fori_loop: one dispatch for all n, so the figure is device
    time plus the gaps between its kernels, as inside the align loop.
    ell is nudged every call so that no call can be hoisted out."""

    def loop(ell, *a):
        def body(i, acc):
            out = fn(ell * (1.0 + 1e-6 * i.astype(f32)), *a)
            return acc + sum(jnp.sum(v.astype(f32))
                             for v in jax.tree.leaves(out))
        return lax.fori_loop(0, n, body, f32(0.0))

    run = jax.jit(loop)
    jax.block_until_ready(run(ell, *args))
    t0 = time.perf_counter()
    jax.block_until_ready(run(ell, *args))
    return (time.perf_counter() - t0) / n


def phase_parity(odo, pair=0, rows=256, timed=True, reps=50):
    params, chunk = odo["params"], odo["chunk"]
    src, tgt = odo["frames"][pair], odo["frames"][pair + 1]
    T = np.asarray(odo["results"][pair][0])
    # align returns the map taking target points into the source frame,
    # which is the (R_inv, T_inv) the passes apply to the target
    Rinv, Tinv = jnp.asarray(T[:3, :3]), jnp.asarray(T[:3, 3])
    ell = f32(odo["results"][pair][2].final_ell)
    log(f"[parity] pair {pair} at its converged pose, ell={float(ell):.6g}, "
        f"{src.capacity} x {tgt.capacity} points")

    # the list is built with caps wide enough that nothing is dropped, so
    # the ELL consume must see exactly the dense support
    nl = nbr.build_neighbor_list(params, ell, src, tgt, Rinv, Tinv, k=128,
                                 per_cell_cap=64)
    assert int(nl.overflow) == 0, int(nl.overflow)
    got_ell = jax.block_until_ready(
        _consume_ell(params, ell, src, nl, Rinv, Tinv))
    got_dense = jax.block_until_ready(
        _consume_dense(params, chunk, ell, src, tgt, Rinv, Tinv))

    x = np.asarray(odo["seq"].frames[pair], np.float64)
    y = np.asarray(odo["seq"].frames[pair + 1], np.float64)
    y = y @ T[:3, :3].astype(np.float64).T + T[:3, 3].astype(np.float64)
    t0 = time.perf_counter()
    ref = oracle_dense_moments(
        params, float(ell), x, y, twists=[np.asarray(got_ell[2]),
                                          np.asarray(got_dense[2])],
        rows=rows, near_rel=NEAR_REL)
    log(f"[parity] float64 oracle on the host: {time.perf_counter() - t0:.1f} s")
    _compare("ell", got_ell, ref, 0)
    _compare("dense", got_dense, ref, 1)

    if timed:
        # the plain-JAX replacements' device times at this width, with the
        # production list caps (K and per-cell cap defaults)
        def build(e, s, t, R, tr):
            return nbr.build_neighbor_list(params, e, s, t, R, tr)

        nl32 = jax.jit(build)(ell, src, tgt, Rinv, Tinv)
        t_build = _per_call(build, max(2, reps // 5), ell, src, tgt, Rinv,
                            Tinv)
        t_ell = _per_call(lambda e, *a: _consume_ell(params, e, *a), reps,
                          ell, src, nl32, Rinv, Tinv)
        t_dense = _per_call(lambda e, *a: _consume_dense(params, chunk, e, *a),
                            max(2, reps // 10), ell, src, tgt, Rinv, Tinv)
        log(f"[parity] per call, chained in one jit: neighbor build "
            f"(K={nbr.DEFAULT_K}, per-cell {nbr.PER_CELL_CAP}) "
            f"{1e3 * t_build:.4f} ms; ELL consume {1e3 * t_ell:.4f} ms/"
            f"iteration; dense jnp flow+step {1e3 * t_dense:.4f} ms "
            f"[card: {card_line()}]")


# ---- phase 4: bundle adjustment -------------------------------------------


def ba_problem(n=8192, F=5, seed=0):
    """Seeded windowed-BA problem: F frames of one scene along a short
    trajectory, noisy initial poses, the chain-plus-skip covisibility graph
    (j - i <= 2: 7 edges at F = 5)."""
    params = load_preset("cvo_intensity_params_irls_tum")
    rng = np.random.default_rng(seed)
    world = scene.synthetic_kitti_scene(n, seed)
    feats = np.repeat(np.abs(np.sin(world * 1.3))[:, :1], 5, axis=1)
    step = scene.se3_exp([0.0, 0.01, 0.0, 0.06, 0.0, 0.5])
    poses = [np.eye(4)]
    for _ in range(F - 1):
        poses.append(poses[-1] @ step)
    clouds, init = [], []
    for k, Tw in enumerate(poses):
        local = (world - Tw[:3, 3]) @ Tw[:3, :3]          # world -> frame k
        local = local + rng.normal(scale=0.01, size=local.shape)
        clouds.append(make_pointcloud(local.astype(np.float32),
                                      features=feats.astype(np.float32),
                                      bucket=n))
        noise = scene.se3_exp(np.concatenate(
            [rng.normal(scale=0.01, size=3), rng.normal(scale=0.05, size=3)]))
        init.append((Tw @ noise if k else Tw)[:3].astype(np.float32))
    edges = [(i, j) for i in range(F) for j in range(i + 1, F) if j - i <= 2]
    return dict(params=params, clouds=irls.stack_clouds(clouds),
                init=np.stack(init), poses=np.stack(poses), edges=edges,
                pivot=np.asarray([1.0] + [0.0] * (F - 1), np.float32), n=n)


def ba_errors(poses_est, poses_true):
    out = []
    for P, Tw in zip(np.asarray(poses_est, np.float64), poses_true):
        Tm = np.eye(4)
        Tm[:3] = P
        out.append(np.linalg.norm(scene.se3_log(np.linalg.inv(Tm) @ Tw)))
    return np.asarray(out)


def phase_ba(n=8192, F=5, backend="auto", timed=True):
    prob = ba_problem(n, F)
    params = prob["params"]
    solve = irls.make_irls_solver(params, cloud_capacity=n, backend=backend)
    ei = jnp.asarray([e[0] for e in prob["edges"]], jnp.int32)
    ej = jnp.asarray([e[1] for e in prob["edges"]], jnp.int32)
    args = (prob["clouds"], jnp.asarray(prob["init"]), ei, ej,
            jnp.asarray(prob["pivot"]))
    t0 = time.perf_counter()
    poses, info = jax.block_until_ready(solve(*args))
    t_first = time.perf_counter() - t0
    before = ba_errors(prob["init"], prob["poses"])
    after = ba_errors(poses, prob["poses"])
    log(f"[ba] {F} frames, {len(prob['edges'])} edges, {n} points/frame: "
        f"outer iterations {int(info['it'])}, ell {float(info['ell']):.4g} "
        f"(from {params.multiframe_ell_init}), nonzeros {int(info['nonzeros'])}")
    log(f"[ba] pose error |xi| per frame before {np.round(before, 5).tolist()}"
        f" after {np.round(after, 6).tolist()} (bound {BA_POSE_ERR_MAX})")
    assert np.isfinite(np.asarray(poses)).all()
    assert float(info["ell"]) < params.multiframe_ell_init   # ell decayed
    assert after.max() < BA_POSE_ERR_MAX, after
    if timed:
        _, t = _timed(solve, *args, reps=3)
        log(f"[ba] set-up (first solve, compile included) {t_first:.3f} s; "
            f"warm {1e3 * t:.3f} ms/solve [card: {card_line()}]")
    return dict(prob=prob, poses=np.asarray(poses), info=info, args=args)


# ---- phase 5: device stereo frontend --------------------------------------


def phase_frontend(width=1241, height=376, fx=718.856, capacity=16384,
                   max_disp=128, timed=True):
    calib = synth.kitti_calibration(W=width, H=height, fx=fx, baseline=0.54)
    world = synth.corridor_scene(3)
    traj = synth.corridor_trajectory(2)
    views = [synth.render_stereo(world, calib, T) for T in traj]
    left, right, depth = views[0]

    def right_gray(im):
        return np.asarray(device_gray_and_gradients(im)[0]).astype(np.uint8)

    disp_fn = jax.jit(lambda l, r: sgm.sgm_disparity_device(
        device_gray_and_gradients(l)[0], r, max_disp=max_disp))
    disp = np.asarray(disp_fn(left, right_gray(right)))
    gt = synth.gt_disparity(depth, calib)
    both = (disp > 0) & (gt > 0) & (gt < max_disp - 1)
    epe = np.abs(disp - gt)[both]
    log(f"[frontend] {width}x{height}: {both.mean():.4f} of pixels co-valid; "
        f"{(epe <= 1.0).mean():.5f} within 1 px (bound {DISP_WITHIN_1PX}); "
        f"mean EPE {epe.mean():.5f} px (bound {DISP_MEAN_EPE})")
    assert both.mean() > 0.3, both.mean()
    assert (epe <= 1.0).mean() > DISP_WITHIN_1PX
    assert epe.mean() < DISP_MEAN_EPE

    # the reference's sky/hood crop (rows 100 .. H-30 at KITTI's 376 rows),
    # scaled with the image height
    crop = dict(v_min=round(100 * height / 376),
                v_bottom_margin=round(30 * height / 376))

    def cloud(view):
        return device_pointcloud_from_stereo(view[0], right_gray(view[1]),
                                             calib, capacity=capacity,
                                             max_disp=max_disp, **crop)

    clouds = [jax.block_until_ready(cloud(v)) for v in views]
    nvalid = [int(c.num_valid) for c in clouds]
    log(f"[frontend] cloud points: {nvalid} of capacity {capacity}")
    assert min(nvalid) > 0.1 * capacity
    # the first pair of a sequence: identity warm start and the
    # first-frame parameter swap, as apps/kitti_odometry runs it
    params = load_preset("cvo_intensity_params_img_gpu0").first_frame()
    # camera-to-world poses: frame 1 points = inv(T1) T0 . frame 0 points
    T_true = np.linalg.inv(traj[1]) @ traj[0]
    T, ret, info = align(clouds[0], clouds[1], jnp.eye(4, dtype=f32), params,
                         max_iter=500)
    err = float(scene.pose_errors([np.asarray(T)], [T_true])[0])
    log(f"[frontend] aligned pair: {int(info.iterations)} iterations, pose "
        f"error |xi| {err:.6f} (bound {FRONTEND_POSE_ERR_MAX})")
    assert np.isfinite(np.asarray(T)).all() and err < FRONTEND_POSE_ERR_MAX
    if timed:
        _, t = _timed(cloud, views[1], reps=5)
        log(f"[frontend] warm {1e3 * t:.3f} ms/frame (host render excluded, "
            f"image upload included) [card: {card_line()}]")


# ---- --four-cards ----------------------------------------------------------


def _xi_err(A, B):
    return float(np.linalg.norm(scene.se3_log(
        np.asarray(A, np.float64) @ np.linalg.inv(np.asarray(B, np.float64)))))


def four_card_modes(n=16384, n_devices=4, max_iter=300, chunk=4096,
                    ba_points=8192):
    from jax.sharding import Mesh

    from unified_cvo_tpu.parallel.batch_align import (make_batch_align,
                                                      stack_pairs)
    from unified_cvo_tpu.parallel.ring import make_ring_full_align
    from unified_cvo_tpu.parallel.sharded import make_sharded_full_align
    from unified_cvo_tpu.parallel.sharded_irls import (
        make_sharded_irls_solver, pad_edges, pad_frames)

    devices = jax.devices()[:n_devices]
    assert len(devices) == n_devices
    params = load_preset("cvo_geometric_params_img_gpu0")
    seq = scene.odometry_sequence(n=n, n_frames=n_devices)
    frames = [make_pointcloud(f, bucket=n) for f in seq.frames]
    guess = jnp.asarray(seq.guess0, f32)

    def spans(arr):
        got = {d.id for d in arr.sharding.device_set}
        assert got == {d.id for d in devices}, (got, devices)
        return len(got)

    # DP batch align: pair k on card k
    mesh = Mesh(np.asarray(devices), ("dp",))
    src_b, tgt_b = stack_pairs(frames[:-1], frames[1:])
    init_b = jnp.tile(guess[None], (n_devices, 1, 1))
    batch = make_batch_align(params, mesh=mesh, chunk=chunk,
                             max_iter=max_iter)
    Tb, rets, iters = jax.block_until_ready(batch(src_b, tgt_b, init_b))
    log(f"[four] batch align: output spans {spans(Tb)} devices, "
        f"iterations {np.asarray(iters).tolist()}")
    for k in range(n_devices):
        T1, _, info1 = align(frames[k], frames[k + 1], guess, params,
                             chunk=chunk, max_iter=max_iter)
        d = _xi_err(Tb[k], T1)
        log(f"[four] batch pair {k}: |xi(T_batch T_single^-1)| {d:.3e}, "
            f"iterations {int(iters[k])} vs {int(info1.iterations)}")
        assert d < 1e-2, d

    # point-sharded and ring full align vs single-card dense align
    sp_mesh = Mesh(np.asarray(devices), ("sp",))
    T_ref, _, info_ref = align(frames[0], frames[1], guess, params,
                               backend="jnp", chunk=chunk, max_iter=max_iter)
    for name, make in (("sharded", make_sharded_full_align),
                       ("ring", make_ring_full_align)):
        full = make(params, sp_mesh, chunk=chunk // n_devices,
                    max_iter=max_iter)
        T_sh, _, info_sh = jax.block_until_ready(
            full(frames[0], frames[1], guess))
        d = _xi_err(T_sh, T_ref)
        log(f"[four] {name} full align: iterations "
            f"{int(info_sh['iterations'])} vs {int(info_ref.iterations)}, "
            f"|xi(T_{name} T_single^-1)| {d:.3e}")
        assert d < 1e-2, d

    # sharded IRLS vs the single-card solve with the same dense moments
    ref = phase_ba(n=ba_points, backend="dense", timed=False)
    prob = ref["prob"]
    solver = make_sharded_irls_solver(prob["params"], mesh, chunk=1024,
                                      frame_sharded=True)
    ei, ej, valid = pad_edges(np.asarray([e[0] for e in prob["edges"]]),
                              np.asarray([e[1] for e in prob["edges"]]),
                              n_devices)
    poses_sh, info = jax.block_until_ready(solver(
        pad_frames(prob["clouds"], n_devices), jnp.asarray(prob["init"]),
        jnp.asarray(ei, jnp.int32), jnp.asarray(ej, jnp.int32),
        jnp.asarray(valid), jnp.asarray(prob["pivot"])))
    d = np.abs(np.asarray(poses_sh) - ref["poses"]).max()
    log(f"[four] sharded IRLS: outer iterations {int(info['it'])} vs "
        f"{int(ref['info']['it'])}, max |pose diff| {d:.3e}")
    assert d < 5e-3, d


# ---- entry point -------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the parallel modes on a 4-card mesh")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    device = device_check(4 if args.four_cards else 1)
    if args.four_cards:
        four_card_modes()
    else:
        odo = phase_odometry()
        phase_parity(odo)
        phase_ba()
        phase_frontend()
    log(f"total {time.perf_counter() - t_start:.1f} s; card: {card_line()}")
    if args.four_cards:
        device["count"] = 4
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
