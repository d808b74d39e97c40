"""Real-data rehearsal harness — ONE command for the accuracy north star.

The accuracy rehearsal: KITTI 00-10 / TUM fr1 within the reference's
ATE (BASELINE.md: 4.55 % translational, geometric preset) has never been
measurable here because the real datasets are not bundled. This script
makes the run REHEARSAL-READY: point it at real data when available and
it runs the full pipeline + devkit evaluation; without real data it
renders the hardest available synthetic proxies (long textured KITTI
-layout sequence with yaw curves; TUM-layout loop room with occluding
pillars and sensor depth noise) and pushes them through the SAME drivers,
presets, and evaluators — proving the command path end to end.

Usage:
    python scripts/rehearsal.py OUT_DIR [--kitti-root DIR] [--tum-root DIR]
        [--frames N] [--capacity C]

With --kitti-root: runs scripts/run_kitti_all_sequences semantics over
real sequences (expects DIR/<seq>/image_2 + cvo_calib.txt, ground truth
in DIR/poses/<seq>.txt if present). With --tum-root: runs tum_odometry
over the real sequence. Without either: synthetic proxies.

Targets printed against BASELINE.md: KITTI devkit translational error
<= 4.55 % (reference cvo_geometric_img_gpu0_oct23 recomputation), TUM
ATE comparable to the reference's fr1 runs (sub-5 cm on proxy scale).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from unified_cvo_tpu.config import preset_path  # noqa: E402



def rehearse_kitti_synthetic(out_dir: str, frames: int, capacity: int):
    from unified_cvo_tpu.apps.kitti_odometry import run_sequence
    from unified_cvo_tpu.datasets.kitti import read_kitti_poses
    from unified_cvo_tpu.utils import synth
    from unified_cvo_tpu.utils.metrics import ate_rmse, kitti_seq_error

    seq_dir = os.path.join(out_dir, "synth_kitti")
    calib = synth.kitti_calibration()
    scene = synth.corridor_scene(3, length=20.0 + 0.35 * frames)
    traj = synth.corridor_trajectory(frames, step=0.3, yaw_rate=0.012,
                                    bob=0.01)
    print(f"[kitti-proxy] rendering {frames} stereo frames ...")
    synth.write_kitti_sequence(seq_dir, scene, traj, calib)
    out = os.path.join(out_dir, "kitti_proxy_traj.txt")
    # the intensity preset is the proxy-proven configuration
    # (tests/test_e2e_accuracy.py); the geometric preset is the real-data
    # north-star preset — the renderer's noise textures carry most of
    # their signal photometrically, so geometry-only underconstrains here
    run_sequence(seq_dir,
                 preset_path("cvo_intensity_params_img_gpu0"),
                 out, denoise=False, capacity=capacity, max_iter=300,
                 log=lambda *a: None)
    est = read_kitti_poses(out)
    t_err, r_err = kitti_seq_error(traj, est, step=1, lengths=(2.0, 4.0))
    ate = ate_rmse(traj, est)
    print(f"[kitti-proxy] devkit trans err {100 * t_err:.2f} % "
          f"(target <= 4.55 %), rot {r_err:.5f} rad/m, ATE {ate:.4f} m")
    return 100 * t_err <= 4.55


def rehearse_tum_synthetic(out_dir: str, frames: int, capacity: int):
    from unified_cvo_tpu.apps.tum_odometry import run_sequence
    from unified_cvo_tpu.utils import synth
    from unified_cvo_tpu.utils.metrics import ate_rmse

    seq_dir = os.path.join(out_dir, "synth_tum")
    calib = synth.tum_calibration()
    scene = synth.room_scene(7, half=6.0, n_pillars=3)
    frames = max(frames, 64)   # keep per-step loop motion trackable
    traj = synth.loop_trajectory(frames, radius=2.5)
    print(f"[tum-proxy] rendering {frames}-frame loop with occluders ...")
    synth.write_tum_sequence(seq_dir, scene, traj, calib, depth_noise=0.005)
    out = os.path.join(out_dir, "tum_proxy_traj.txt")
    # derived preset: the rgbd yaml sets ell_init_first_frame == ell_init
    # (0.15), but the loop's first pair has no constant-velocity prior and
    # ~0.25 m of motion — the reference's own first-frame mechanism exists
    # precisely for this, so the rehearsal preset coarsens it (its bash
    # scripts edit the yaml per experiment the same way)
    import re
    with open(preset_path("cvo_rgbd_params")) as f:
        text = re.sub(r"^%YAML[^\n]*\n", "", f.read())
    preset = os.path.join(out_dir, "tum_rehearsal.yaml")
    with open(preset, "w") as f:
        f.write(text + "\nell_init_first_frame: 0.5\nell_max: 1.0\n")
    poses, _ = run_sequence(seq_dir, preset,
                            out, denoise=False, capacity=capacity,
                            max_iter=300, log=lambda *a: None)
    ate = ate_rmse(traj, poses)
    print(f"[tum-proxy] ATE {ate:.4f} m over {frames} frames "
          f"(loop with occlusion + 5 mm depth noise)")
    return ate < 0.05


def rehearse_semantic_synthetic(out_dir: str, frames: int, capacity: int):
    """Semantic-stereo leg: the kitti proxy plus view-consistent 19-class
    per-pixel distributions derived from scene height (the real-data twin
    reads image_semantic/*.bin, datasets/kitti.py:87-97)."""
    from unified_cvo_tpu.apps.kitti_odometry import run_sequence
    from unified_cvo_tpu.datasets.kitti import read_kitti_poses
    from unified_cvo_tpu.utils import synth
    from unified_cvo_tpu.utils.metrics import ate_rmse, kitti_seq_error

    seq_dir = os.path.join(out_dir, "synth_kitti_sem")
    calib = synth.kitti_calibration()
    scene = synth.corridor_scene(3, length=20.0 + 0.35 * frames)
    traj = synth.corridor_trajectory(frames, step=0.3, yaw_rate=0.012,
                                     bob=0.01)
    print(f"[semantic-proxy] rendering {frames} stereo frames ...")
    depths = []
    synth.write_kitti_sequence(seq_dir, scene, traj, calib,
                               depths_out=depths)
    C = 19
    sem_dir = os.path.join(seq_dir, "image_semantic")
    os.makedirs(sem_dir, exist_ok=True)
    h, w = depths[0].shape
    vv = np.arange(h, dtype=np.float32)[:, None]
    for i, (T, depth) in enumerate(zip(traj, depths)):
        # camera height of each pixel's 3D point -> world height (bob is
        # small), quantized into class bands: view-consistent semantics
        # that genuinely constrain the registration, skipping the
        # reference's excluded class 10 (CvoPointCloud.cpp:716-722)
        y_cam = (vv - calib.cy) / calib.fy * depth
        bands = np.clip(((y_cam + 4.0) / 8.0 * 8).astype(np.int64), 0, 7)
        cls = np.where(bands >= 5, bands + 6, bands)   # classes 0..4, 11..13
        onehot = np.full((h, w, C), 0.2 / C, np.float32)
        np.put_along_axis(onehot, cls[..., None], 0.8 + 0.2 / C, axis=2)
        onehot.tofile(os.path.join(sem_dir, f"{i:06d}.bin"))
    out = os.path.join(out_dir, "kitti_semantic_traj.txt")
    run_sequence(seq_dir,
                 preset_path("cvo_semantic_params_img_gpu0"),
                 out, denoise=False, capacity=capacity, max_iter=300,
                 semantic=True, num_classes=C, log=lambda *a: None)
    est = read_kitti_poses(out)
    t_err, r_err = kitti_seq_error(traj, est, step=1, lengths=(2.0, 4.0))
    ate = ate_rmse(traj, est)
    print(f"[semantic-proxy] devkit trans err {100 * t_err:.2f} % "
          f"(target <= 4.55 %), rot {r_err:.5f} rad/m, ATE {ate:.4f} m")
    return 100 * t_err <= 4.55


def rehearse_lidar_synthetic(out_dir: str, frames: int, capacity: int):
    """Lidar leg: ray-cast velodyne scans -> kitti_lidar_odometry
    (tests/test_e2e_accuracy.py::test_kitti_lidar_odometry_e2e scaled up)."""
    from unified_cvo_tpu.apps.kitti_lidar_odometry import run_sequence
    from unified_cvo_tpu.datasets.kitti import read_kitti_poses
    from unified_cvo_tpu.utils import synth
    from unified_cvo_tpu.utils.metrics import ate_rmse, rpe_rmse

    seq_dir = os.path.join(out_dir, "synth_lidar")
    scene = synth.room_scene(11, half=8.0, floor_y=1.8, ceil_y=-3.0,
                             n_pillars=4)
    frames = min(frames, 24)   # room-scale loop; range caps useful length
    traj = synth.corridor_trajectory(frames, step=0.15, yaw_rate=0.02,
                                     bob=0.0)
    print(f"[lidar-proxy] ray-casting {frames} velodyne scans ...")
    synth.write_kitti_lidar_sequence(seq_dir, scene, traj, n_beams=32,
                                     n_az=720, noise=0.005)
    preset = os.path.join(out_dir, "lidar_rehearsal.yaml")
    with open(preset, "w") as f:
        f.write("ell_init: 0.5\nell_init_first_frame: 0.8\nell_min: 0.05\n"
                "ell_max: 1.2\nis_using_intensity: 1\n")
    out = os.path.join(out_dir, "lidar_proxy_traj.txt")
    run_sequence(seq_dir, preset, out, capacity=capacity, max_iter=300,
                 log=lambda *a: None)
    est = read_kitti_poses(out)
    ate = ate_rmse(traj, est)
    rpe = rpe_rmse(traj, est)
    print(f"[lidar-proxy] ATE {ate:.4f} m (target <= 0.08 on proxy scale), "
          f"RPE {rpe:.4f} m/frame")
    return ate <= 0.08


def rehearse_irls_synthetic(out_dir: str, frames: int, capacity: int):
    """Multiframe IRLS BA leg — the cvo_irls_tum.bash contract: ATE after
    BA must improve on ATE before (reference scripts/cvo_irls_tum.bash
    evaluation block)."""
    from unified_cvo_tpu.apps.irls_tum import main as irls_main
    from unified_cvo_tpu.datasets.graph import write_graph_file
    from unified_cvo_tpu.datasets.tum import read_tum_trajectory
    from unified_cvo_tpu.utils import synth
    from unified_cvo_tpu.utils.metrics import ate_rmse

    seq_dir = os.path.join(out_dir, "synth_tum_irls")
    calib = synth.tum_calibration()
    # the proven BA fixture geometry (tests/test_e2e_accuracy.py tum_seq):
    # slow corridor motion keeps consecutive-keyframe overlap high enough
    # that no edge is gated out by multiframe_min_nonzeros
    scene = synth.corridor_scene(5, half_width=2.5, floor_y=1.2,
                                 ceil_y=-1.2, length=30.0)
    traj = synth.corridor_trajectory(16, step=0.08, yaw_rate=0.015,
                                     bob=0.005)
    print("[irls-proxy] rendering 16-frame BA corridor ...")
    synth.write_tum_sequence(seq_dir, scene, traj, calib)
    yaml_path = os.path.join(out_dir, "irls_rehearsal.yaml")
    with open(yaml_path, "w") as f:
        f.write("ell_init: 0.1\nell_min: 0.05\nsigma: 0.1\nsp_thres: 0.003\n"
                "c: 7.0\nd: 7.0\nc_ell: 0.025\nc_sigma: 1.0\n"
                "is_using_intensity: 1\nis_using_geometric_type: 1\n"
                "multiframe_max_iters: 60\nmultiframe_ell_init: 0.4\n"
                "multiframe_ell_min: 0.1\nmultiframe_ell_decay_rate: 0.85\n"
                "multiframe_iterations_per_ell: 10\n")
    frame_inds = [0, 2, 4, 6, 8, 10, 12, 14]
    gt = traj[frame_inds]
    # rotation + translation perturbations (translation-only initial error
    # lets a small-cloud BA converge at its start point; rotations create
    # genuine residual signal — the e2e test's _perturbed recipe)
    rng = np.random.default_rng(1)
    init = gt.copy()
    for k in range(1, len(init)):
        init[k] = init[k].copy()
        init[k][:3, 3] += rng.normal(0, 0.03, 3)
        w = rng.normal(0, 0.015, 3)
        th = np.linalg.norm(w)
        K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]],
                      [-w[1], w[0], 0]])
        dR = (np.eye(3) + np.sin(th) / th * K
              + (1 - np.cos(th)) / th ** 2 * (K @ K))
        init[k][:3, :3] = init[k][:3, :3] @ dR
    edges = [(i, i + 1) for i in range(len(frame_inds) - 1)] + \
            [(i, i + 2) for i in range(len(frame_inds) - 2)]
    graph = os.path.join(out_dir, "irls_graph.txt")
    write_graph_file(graph, frame_inds, edges, init)
    prefix = os.path.join(out_dir, "irls_ba")
    rc = irls_main([seq_dir, graph, yaml_path, prefix])
    if rc != 0:
        print("[irls-proxy] driver failed")
        return False
    _, before = read_tum_trajectory(prefix + "_before.txt")
    _, after = read_tum_trajectory(prefix + "_after.txt")
    ate_b, ate_a = ate_rmse(gt, before), ate_rmse(gt, after)
    print(f"[irls-proxy] before BA ate: {ate_b:.4f} m, after BA ate: "
          f"{ate_a:.4f} m (contract: after < 0.6 * before)")
    return ate_a < 0.6 * ate_b


def rehearse_kitti_real(root: str, out_dir: str, capacity: int):
    from run_kitti_all_sequences import main as kitti_main

    gt = os.path.join(root, "poses")
    argv = [root, preset_path("cvo_geometric_params_img_gpu0"),
            os.path.join(out_dir, "kitti_real")]
    if os.path.isdir(gt):
        argv += ["--gt", gt]
    return kitti_main(argv) == 0


def rehearse_tum_real(root: str, out_dir: str, capacity: int):
    from unified_cvo_tpu.apps.tum_odometry import run_sequence

    out = os.path.join(out_dir, "tum_real_traj.txt")
    run_sequence(root, preset_path("cvo_rgbd_params"),
                 out, capacity=capacity)
    gt = os.path.join(root, "groundtruth.txt")
    if os.path.exists(gt):
        from unified_cvo_tpu.apps.evaluate_ate import main as ate_main

        ate_main([gt, out])
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir")
    ap.add_argument("--kitti-root", default=None)
    ap.add_argument("--tum-root", default=None)
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--capacity", type=int, default=8192)
    ap.add_argument("--all", action="store_true",
                    help="run all 5 legs (stereo, rgbd, semantic, lidar, "
                         "IRLS BA) so one real-data session exercises "
                         "every scored pipeline")
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    results = {}
    if args.kitti_root:
        results["kitti"] = rehearse_kitti_real(args.kitti_root, args.out_dir,
                                               args.capacity)
    else:
        results["kitti"] = rehearse_kitti_synthetic(args.out_dir, args.frames,
                                                    args.capacity)
    if args.tum_root:
        results["tum"] = rehearse_tum_real(args.tum_root, args.out_dir,
                                           args.capacity)
    else:
        results["tum"] = rehearse_tum_synthetic(args.out_dir, args.frames,
                                                args.capacity)
    if args.all:
        results["semantic"] = rehearse_semantic_synthetic(
            args.out_dir, args.frames, args.capacity)
        results["lidar"] = rehearse_lidar_synthetic(
            args.out_dir, args.frames, args.capacity)
        results["irls"] = rehearse_irls_synthetic(
            args.out_dir, args.frames, args.capacity)
    ok = all(results.values())
    for name, passed in results.items():
        print(f"[rehearsal] {name}: {'PASS' if passed else 'FAIL'}")
    print("[rehearsal]", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
