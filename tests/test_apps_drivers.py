"""End-to-end smoke tests for the remaining reference app twins on synthetic
datasets: TartanAir odometry/IRLS/covis, KITTI IRLS + depth filtering, Lyft
lidar odometry, and semantic stereo odometry."""

import os

import numpy as np
import pytest

import cv2


def _texture(h, w, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (h // 8, w // 8), np.uint8)
    img = np.kron(base, np.ones((8, 8), np.uint8))
    return np.stack([img] * 3, axis=-1)


# ---------------------------------------------------------------- TartanAir


@pytest.fixture(scope="module")
def tartan_dir(tmp_path_factory):
    """3-frame constant-depth (z=3) textured scene; camera translates +x by
    5 px/frame => tx = 5 * 3 / fx(=320) = 0.046875 m per frame."""
    d = tmp_path_factory.mktemp("tartan")
    (d / "image_left").mkdir()
    (d / "depth_left").mkdir()
    img = _texture(480, 640, seed=11)
    depth = np.full((480, 640), 3.0, np.float32)
    for i in range(3):
        cv2.imwrite(str(d / "image_left" / f"{i:06d}_left.png"),
                    np.roll(img, -5 * i, axis=1))
        np.save(str(d / "depth_left" / f"{i:06d}_left_depth.npy"), depth)
    return str(d)


def _write_yaml(path, voxel):
    path.write_text(
        "ell_init: 0.5\nell_init_first_frame: 0.5\nell_min: 0.05\n"
        "ell_max: 1.0\nmax_iter: 60\nis_using_intensity: 1\n"
        "multiframe_ell_init: 0.5\nmultiframe_ell_min: 0.15\n"
        "multiframe_ell_decay_rate: 0.7\nmultiframe_max_iters: 10\n"
        "multiframe_iterations_per_solve: 4\nmultiframe_min_nonzeros: 10\n"
        f"multiframe_downsample_voxel_size: {voxel}\n"
    )
    return str(path)


@pytest.fixture(scope="module")
def fast_params_yaml(tmp_path_factory):
    return _write_yaml(tmp_path_factory.mktemp("params") / "fast.yaml", 0.3)


@pytest.fixture(scope="module")
def coarse_params_yaml(tmp_path_factory):
    """Coarser voxel for the drivers whose edge leaf is voxel/10 (covis) or
    whose synthetic scene has ~0.06 m pixel spacing (KITTI fixtures)."""
    return _write_yaml(tmp_path_factory.mktemp("params") / "coarse.yaml", 1.2)


def test_tartan_odometry_synthetic(tartan_dir, fast_params_yaml, tmp_path):
    from unified_cvo_tpu.apps.tartan_odometry import run_sequence

    out = str(tmp_path / "traj.txt")
    poses = run_sequence(tartan_dir, fast_params_yaml, out, max_iter=60,
                         capacity=2048, chunk=1024, log=lambda *a: None)
    assert poses.shape[0] == 3
    rows = np.loadtxt(out)
    assert rows.shape == (3, 7)
    # ~0.047 m x-translation per frame, recovered within a loose factor
    t1 = poses[1][:3, 3]
    assert 0.01 < np.linalg.norm(t1) < 0.15, t1


def test_irls_tartan_translation_only(tartan_dir, fast_params_yaml, tmp_path):
    from unified_cvo_tpu.apps.irls_tartan import main
    from unified_cvo_tpu.datasets.graph import write_graph_file

    graph = str(tmp_path / "graph.txt")
    # mildly wrong init translations; rotations identity
    init = np.tile(np.eye(3, 4, dtype=np.float64), (3, 1, 1))
    init[1, 0, 3] = 0.03
    init[2, 0, 3] = 0.07
    write_graph_file(graph, [0, 1, 2], [(0, 1), (1, 2), (0, 2)],
                     np.concatenate([init, np.tile([[[0, 0, 0, 1.0]]], (3, 1, 1))], 1))
    prefix = str(tmp_path / "ba")
    rc = main([tartan_dir, fast_params_yaml, graph, prefix, "--translation-only"])
    assert rc == 0
    before = np.loadtxt(prefix + "_before.txt")
    after = np.loadtxt(prefix + "_after.txt")
    assert before.shape == after.shape == (3, 7)
    # rotations must be untouched (identity quaternion) in translation-only mode
    np.testing.assert_allclose(after[:, 3:6], 0.0, atol=1e-6)
    np.testing.assert_allclose(after[:, 6], 1.0, atol=1e-6)
    # pivot frame fixed
    np.testing.assert_allclose(after[0, :3], 0.0, atol=1e-8)


def test_covis_tartan(tartan_dir, coarse_params_yaml, tmp_path):
    from unified_cvo_tpu.apps.covis_tartan import main
    from unified_cvo_tpu.datasets.graph import write_graph_file

    graph = str(tmp_path / "graph.txt")
    write_graph_file(graph, [0, 1, 2], [(0, 1), (1, 2)])
    out_dir = str(tmp_path / "covis")
    rc = main([tartan_dir, coarse_params_yaml, graph, "1", out_dir])
    assert rc == 0
    for f in ["before_BA.pcd", "after_BA.pcd", "traj_before.txt",
              "traj_after.txt", "0.pcd", "1.pcd", "2.pcd"]:
        assert os.path.exists(os.path.join(out_dir, f)), f


# ------------------------------------------------------------------- KITTI


@pytest.fixture(scope="module")
def kitti_dir(tmp_path_factory):
    """3 stereo frames: constant-disparity 8 px (depth 6.25 at fx=100,
    b=0.5); frame-to-frame +2 px shift => tx = 2 * 6.25 / 100 = 0.125 m."""
    d = tmp_path_factory.mktemp("kitti")
    (d / "image_2").mkdir()
    (d / "image_3").mkdir()
    (d / "cvo_calib.txt").write_text("100.0 100.0 128.0 110.0 0.5 256 220")
    img = _texture(220, 256, seed=7)
    for i in range(3):
        left = np.roll(img, -2 * i, axis=1)
        cv2.imwrite(str(d / "image_2" / f"{i:06d}.png"), left)
        cv2.imwrite(str(d / "image_3" / f"{i:06d}.png"), np.roll(left, -8, axis=1))
    return str(d)


def test_irls_kitti_synthetic(kitti_dir, coarse_params_yaml, tmp_path):
    from unified_cvo_tpu.apps.irls_kitti import main
    from unified_cvo_tpu.datasets.graph import write_graph_file

    graph = str(tmp_path / "graph.txt")
    write_graph_file(graph, [0, 1, 2], [(0, 1), (1, 2), (0, 2)])
    # tracking trajectory: close-to-truth x translations
    track = str(tmp_path / "track.txt")
    rows = []
    for i in range(3):
        T = np.eye(3, 4)
        T[0, 3] = 0.11 * i
        rows.append(T.ravel())
    np.savetxt(track, np.asarray(rows))
    gt = str(tmp_path / "gt.txt")
    rows = []
    for i in range(3):
        T = np.eye(3, 4)
        T[0, 3] = 0.125 * i
        rows.append(T.ravel())
    np.savetxt(gt, np.asarray(rows))

    prefix = str(tmp_path / "ba")
    rc = main([kitti_dir, coarse_params_yaml, graph, prefix, track, gt])
    assert rc == 0
    before = np.loadtxt(prefix + "_before.txt")
    after = np.loadtxt(prefix + "_after.txt")
    gt_sub = np.loadtxt(prefix + "_gt.txt")
    assert before.shape == after.shape == gt_sub.shape == (3, 12)
    np.testing.assert_allclose(gt_sub[2, 3], 0.25)
    # BA should not blow up: poses stay near the tracking init
    assert np.abs(after[:, 3] - before[:, 3]).max() < 0.2


def test_depth_filtering_synthetic(kitti_dir, coarse_params_yaml, tmp_path):
    from unified_cvo_tpu.apps.depth_filtering import run
    from unified_cvo_tpu.datasets.pcd import read_pcd

    track = str(tmp_path / "track.txt")
    rows = []
    for i in range(3):
        T = np.eye(3, 4)
        T[0, 3] = 0.125 * i
        rows.append(T.ravel())
    np.savetxt(track, np.asarray(rows))
    out_dir = str(tmp_path / "df")
    rc = run(kitti_dir, coarse_params_yaml, track, 0, 3, 1.0, 0.1, out_dir,
             frame_capacity=4096, top_k=32)
    assert rc == 0
    before_xyz, _ = read_pcd(os.path.join(out_dir, "before_depth_filtering.pcd"))
    after_xyz, _ = read_pcd(os.path.join(out_dir, "after_depth_filtering.pcd"))
    assert len(after_xyz) > 0
    # the scene is a constant-depth plane: fused depths stay near 6.25
    z = after_xyz[:, 2]
    assert np.median(np.abs(z - 6.25)) < 1.0, np.median(z)
    assert len(after_xyz) <= len(before_xyz)


def test_kitti_odometry_semantic(kitti_dir, fast_params_yaml, tmp_path):
    from unified_cvo_tpu.apps.kitti_odometry import run_sequence

    # synthetic 4-class semantic maps: quadrant labels
    sem_dir = os.path.join(kitti_dir, "image_semantic")
    os.makedirs(sem_dir, exist_ok=True)
    h, w = cv2.imread(os.path.join(kitti_dir, "image_2", "000000.png")).shape[:2]
    C = 4
    yy, xx = np.mgrid[0:h, 0:w]
    labels = (2 * (yy > h // 2) + (xx > w // 2)).astype(int)
    onehot = np.eye(C, dtype=np.float32)[labels]
    for i in range(3):
        np.roll(onehot, -2 * i, axis=1).astype(np.float32).tofile(
            os.path.join(sem_dir, f"{i:06d}.bin")
        )

    out = str(tmp_path / "sem_traj.txt")
    poses = run_sequence(
        kitti_dir, fast_params_yaml, out, semantic=True, num_classes=C,
        max_iter=40, capacity=2048, chunk=1024, log=lambda *a: None,
    )
    assert poses.shape[0] == 3
    assert np.isfinite(poses).all()


# -------------------------------------------------------------------- Lyft


def test_lyft_odometry_synthetic(tmp_path, fast_params_yaml):
    from unified_cvo_tpu.apps.lyft_lidar_odometry import run_sequence

    rng = np.random.default_rng(3)
    lidar_dir = tmp_path / "lyft" / "lidar"
    lidar_dir.mkdir(parents=True)
    n = 2048
    ground = np.stack(
        [rng.uniform(2, 40, n // 2), rng.uniform(-15, 15, n // 2),
         np.full(n // 2, -1.7)], axis=1)
    wall = np.stack(
        [rng.uniform(2, 40, n // 2), np.full(n // 2, 8.0),
         rng.uniform(-1.5, 3.0, n // 2)], axis=1)
    pts = np.concatenate([ground, wall]).astype(np.float32)
    inten = rng.uniform(0, 1, (n, 1)).astype(np.float32)
    ring = np.zeros((n, 1), np.float32)
    for i in range(3):
        moved = pts.copy()
        moved[:, 0] -= 0.4 * i  # sensor advances +x (pre-rotation frame)
        np.concatenate([moved, inten, ring], axis=1).astype(np.float32).tofile(
            str(lidar_dir / f"{i:06d}.bin")
        )

    out = str(tmp_path / "lyft_traj.txt")
    poses = run_sequence(str(tmp_path / "lyft"), fast_params_yaml, out,
                         max_iter=60, capacity=2048, chunk=1024,
                         log=lambda *a: None)
    assert poses.shape[0] == 3
    rows = np.loadtxt(out)
    assert rows.shape == (3, 12)
    assert np.isfinite(rows).all()


def test_gicp_baseline_recovers_rigid_motion():
    """GICP cross-check app (reference gicp_align_two twin) on a synthetic
    rigid motion."""
    import numpy as np
    from unified_cvo_tpu.apps.gicp_align_two import gicp_align

    rng = np.random.default_rng(3)
    xyz = rng.uniform(-4, 4, (400, 3)).astype(np.float64)
    xyz[:, 2] = 0.2 * np.sin(xyz[:, 0]) + 0.1 * xyz[:, 1]  # a surface
    th = 0.05
    R = np.array([[np.cos(th), -np.sin(th), 0],
                  [np.sin(th), np.cos(th), 0], [0, 0, 1.0]])
    t = np.array([0.1, -0.05, 0.02])
    tgt = (xyz - t) @ R  # so that R @ tgt + t == xyz
    T, iters, rmse = gicp_align(xyz, tgt, max_iter=40, k=12, max_corr=1.0)
    np.testing.assert_allclose(T[:3, :3], R, atol=5e-3)
    np.testing.assert_allclose(T[:3, 3], t, atol=2e-2)


# ---------------------------------------------------------- semantic lidar


@pytest.fixture(scope="module")
def semantic_kitti_lidar_dir(tmp_path_factory):
    """3 synthetic velodyne scans + SemanticKITTI .label files: a ground
    plane (raw id 40 -> road), a wall (raw id 50 -> building), some
    unlabeled (raw 0) and moving-car (raw 252 -> collapses onto car)
    points; sensor advances +x per frame."""
    d = tmp_path_factory.mktemp("semkitti")
    (d / "velodyne").mkdir()
    (d / "labels").mkdir()
    rng = np.random.default_rng(3)
    n = 2048
    ground = np.stack(
        [rng.uniform(2, 40, n // 2), rng.uniform(-15, 15, n // 2),
         np.full(n // 2, -1.7)], axis=1)
    wall = np.stack(
        [rng.uniform(2, 40, n // 2), np.full(n // 2, 8.0),
         rng.uniform(-1.5, 3.0, n // 2)], axis=1)
    pts = np.concatenate([ground, wall]).astype(np.float32)
    raw_ids = np.concatenate(
        [np.full(n // 2, 40, np.uint32), np.full(n // 2, 50, np.uint32)])
    raw_ids[:40] = 0          # unlabeled -> must be dropped
    raw_ids[40:60] = 252      # moving car -> collapses to class 1 (car)
    labels32 = raw_ids | (np.uint32(7) << 16)  # instance bits must be masked
    inten = rng.uniform(0, 1, (n, 1)).astype(np.float32)
    for i in range(3):
        moved = pts.copy()
        moved[:, 0] -= 0.4 * i
        np.concatenate([moved, inten], axis=1).astype(np.float32).tofile(
            str(d / "velodyne" / f"{i:06d}.bin"))
        labels32.tofile(str(d / "labels" / f"{i:06d}.label"))
    return str(d)


def test_kitti_semantic_label_loading(semantic_kitti_lidar_dir):
    from unified_cvo_tpu.datasets.kitti import KittiHandler

    kitti = KittiHandler(semantic_kitti_lidar_dir, "lidar")
    pts, labels = kitti.read_next_lidar_semantic()
    assert pts.shape[1] == 4 and labels.shape == (pts.shape[0],)
    # raw 40 -> train 9 -> 0-based 8; raw 50 -> 13 -> 12; raw 0 -> -1;
    # raw 252 (moving car) -> 1 -> 0 (create_label_map semantics)
    assert (labels[:40] == -1).all()
    assert (labels[40:60] == 0).all()
    assert (labels[60:1024] == 8).all()
    assert (labels[1024:] == 12).all()


def test_local_mapping_driver(tmp_path):
    """The L6/L7 driver (apps/local_mapping.py): online odometry +
    keyframing + per-keyframe BKI fusion, and offline mapping along a
    given trajectory, both on a rendered TUM sequence."""
    from unified_cvo_tpu.apps import local_mapping
    from unified_cvo_tpu.datasets.tum import write_tum_pose_row
    from unified_cvo_tpu.utils import synth

    d = str(tmp_path / "seq")
    calib = synth.tum_calibration()
    scene = synth.corridor_scene(5, half_width=2.5, floor_y=1.2,
                                 ceil_y=-1.2, length=30.0)
    traj = synth.corridor_trajectory(5, step=0.08, yaw_rate=0.015, bob=0.005)
    synth.write_tum_sequence(d, scene, traj, calib)
    from unified_cvo_tpu.config import preset_path

    params = preset_path("cvo_rgbd_params")

    out = str(tmp_path / "on")
    k, nkf, nvox = local_mapping.run_sequence(
        d, params, out, max_frames=5, resolution=0.1, capacity=4096,
        num_classes=3, keyframe_function_angle=0.99, denoise=False,
        log=lambda *a: None)
    assert k == 5 and nkf >= 2 and nvox > 1000
    m = np.load(out + "_map.npz")
    assert m["centers"].shape == (nvox, 3)
    assert np.isfinite(m["centers"]).all()
    rows = np.loadtxt(out + "_traj.txt")
    assert rows.shape == (5, 8)
    # the online trajectory must be metrically ACCURATE, not just present
    # (round 4 found a pose-accumulation inversion this would have caught)
    from unified_cvo_tpu.datasets.tum import read_tum_trajectory
    from unified_cvo_tpu.utils.metrics import ate_rmse

    _, est = read_tum_trajectory(out + "_traj.txt")
    assert ate_rmse(traj, est) < 0.05, f"online ATE {ate_rmse(traj, est)}"

    gt = str(tmp_path / "gt.txt")
    with open(gt, "w") as f:
        for i, T in enumerate(traj):
            write_tum_pose_row(f, f"{1000.0 + 0.1 * i:.4f}", T)
    out2 = str(tmp_path / "off")
    k2, nkf2, nvox2 = local_mapping.run_sequence(
        d, params, out2, trajectory=gt, max_frames=5, resolution=0.1,
        capacity=4096, num_classes=3, log=lambda *a: None)
    assert k2 == 5 and nvox2 > 1000


def test_kitti_lidar_odometry_semantic(semantic_kitti_lidar_dir, tmp_path):
    yaml = tmp_path / "sem_lidar.yaml"
    yaml.write_text(
        "ell_init: 0.5\nell_init_first_frame: 0.5\nell_min: 0.05\n"
        "ell_max: 1.0\nmax_iter: 60\nis_using_intensity: 1\n"
        "is_using_semantics: 1\ns_ell: 0.5\ns_sigma: 0.8\n"
    )
    out = str(tmp_path / "sem_lidar_traj.txt")
    from unified_cvo_tpu.apps.kitti_lidar_odometry import run_sequence

    poses = run_sequence(semantic_kitti_lidar_dir, str(yaml), out,
                         semantic=True, capacity=2048, chunk=1024,
                         max_iter=60, log=lambda *a: None)
    assert poses.shape[0] == 3
    rows = np.loadtxt(out)
    assert rows.shape == (3, 12)
    assert np.isfinite(rows).all()


def test_kitti_odometry_device_frontend(kitti_dir, fast_params_yaml, tmp_path):
    """The --device-frontend driver glue (census-SGM + DSO on device, one
    jit per frame) on the constant-disparity fixture: +2 px/frame shift at
    8 px disparity => tx = 0.125 m/frame."""
    from unified_cvo_tpu.apps.kitti_odometry import run_sequence

    out = str(tmp_path / "dev_traj.txt")
    poses = run_sequence(
        kitti_dir, fast_params_yaml, out, 0, 3, max_iter=150, capacity=2048,
        chunk=1024, frontend="device", log=lambda *a: None,
    )
    assert poses.shape[0] == 3
    assert np.isfinite(poses).all()
    # translation magnitude per frame near 0.125 m along x
    step = poses[2][:3, 3] - poses[1][:3, 3]
    assert abs(abs(step[0]) - 0.125) < 0.05, step
