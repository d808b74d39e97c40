"""Seeded stand-ins for the reference's data artifacts (demo PCDs, KITTI
pose files), generated into a test's tmp_path."""

from __future__ import annotations

import os

import numpy as np

from unified_cvo_tpu.datasets.pcd import write_pcd
from unified_cvo_tpu.utils.odometry_scene import se3_exp

# the demo pair's relative motion: a ~25 deg yaw plus a metre-scale shift,
# which puts the target centroid ~5.8 m from the source centroid
DEMO_XI = np.array([0.05, 0.42, -0.03, 1.8, 1.0, 2.6])


def demo_cloud_pair(seed: int = 0, n_src: int = 523, n_tgt: int = 935):
    """A colored outdoor-looking cloud pair at the demo's sizes (source 523,
    target 935 points): ground, a wall, and boxes, each surface with its own
    colour, target = T(DEMO_XI) . source-scene + noise. Returns
    (src_xyz, src_rgb, tgt_xyz, tgt_rgb, T) with rgb in [0, 1] and T mapping
    source-frame points into the target frame."""
    rng = np.random.default_rng(seed)

    def scene(n):
        # a compact ~4 m scene (ground patch, wall, box face, post) so that
        # the demo motion moves the target well away from the source
        k = n // 4
        parts = [
            (np.stack([rng.uniform(-2, 2, k), np.full(k, -1.5),
                       rng.uniform(6, 10, k)], 1), (0.35, 0.35, 0.30)),
            (np.stack([np.full(k, -2.0), rng.uniform(-1.5, 1.0, k),
                       rng.uniform(6, 10, k)], 1), (0.80, 0.20, 0.15)),
            (np.stack([rng.uniform(-1, 1, k), rng.uniform(-1.5, 0.5, k),
                       np.full(k, 9.0)], 1), (0.15, 0.30, 0.85)),
        ]
        m = n - 3 * k
        parts.append((np.stack([np.full(m, 1.5), rng.uniform(-1.5, 1.5, m),
                                rng.uniform(7, 8, m)], 1), (0.20, 0.75, 0.25)))
        xyz = np.concatenate([p for p, _ in parts]).astype(np.float32)
        rgb = np.concatenate([np.tile(c, (len(p), 1)) for p, c in parts])
        rgb = rgb + rng.normal(scale=0.02, size=rgb.shape)
        xyz += rng.normal(scale=0.01, size=xyz.shape).astype(np.float32)
        return xyz, np.clip(rgb, 0, 1).astype(np.float32)

    T = se3_exp(DEMO_XI)
    sx, sc = scene(n_src)
    tx, tc = scene(n_tgt)
    tx = (tx @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    return sx, sc, tx, tc, T


def write_demo_pcds(directory, seed: int = 0):
    """Write the demo pair as ASCII PCD; returns (source_path, target_path)."""
    sx, sc, tx, tc, _ = demo_cloud_pair(seed)
    src = os.path.join(str(directory), "source.pcd")
    tgt = os.path.join(str(directory), "target.pcd")
    write_pcd(src, sx, sc)
    write_pcd(tgt, tx, tc)
    return src, tgt


def kitti_trajectory(n: int = 300, seed: int = 0) -> np.ndarray:
    """[n, 4, 4] camera-to-world poses of a car-like path: ~1 m/frame
    forward (+z), turning left and right every ~125 m, with a little
    pitch/height bob."""
    rng = np.random.default_rng(seed)
    poses = [np.eye(4)]
    phase = rng.uniform(0, 2 * np.pi)
    yaw_rate = 0.0
    for k in range(1, n):
        yaw_rate = 0.9 * yaw_rate + rng.normal(scale=0.004)
        turn = 0.03 * np.sin(k / 40.0 + phase)
        xi = np.array([rng.normal(scale=0.0005), yaw_rate + turn,
                       rng.normal(scale=0.0005), 0.0,
                       rng.normal(scale=0.01), 1.0 + 0.1 * np.sin(k / 20)])
        poses.append(poses[-1] @ se3_exp(xi))
    return np.stack(poses)


def drifted(poses: np.ndarray, seed: int, t_sigma: float, r_sigma: float):
    """An odometry-like estimate: compose the ground-truth relative motions
    with small random errors, so the error grows along the path."""
    rng = np.random.default_rng(seed)
    out = [poses[0].copy()]
    for k in range(1, len(poses)):
        rel = np.linalg.inv(poses[k - 1]) @ poses[k]
        err = se3_exp(np.concatenate([rng.normal(scale=r_sigma, size=3),
                                      rng.normal(scale=t_sigma, size=3)]))
        out.append(out[-1] @ rel @ err)
    return np.stack(out)


def write_kitti_poses(path, poses: np.ndarray):
    np.savetxt(str(path), poses[:, :3, :].reshape(len(poses), 12))
