"""Seeded KITTI-scale frame-to-frame odometry workload.

A structured outdoor scene (ground plane, two walls, posts; ~55 m range
envelope, the reference's stereo point selection, CvoPointCloud.cpp:39-57)
seen from a camera that moves ~1 m/frame with per-frame variation in speed
and steering (KITTI's 10 Hz scale). Points that recede past the envelope
wrap back to near range, like new points entering view on a forward-moving
sequence, so the workload stays stationary and consecutive frames overlap
only partly (~2% of points per frame have no correspondence).

Everything here is NumPy on the host: `bench.py` and `chip_smoke.py` build
the sequence once, put the frames on the device, and register consecutive
pairs through `models.align.align`.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np

# per-frame twist [omega, v] of the base motion and the amplitude of its
# per-frame variation (cos-modulated), in the convention
# frame_{k+1} points = R_k . frame_k points + t_k
XI_BASE = np.array([0.0, 0.006, 0.0, 0.04, 0.01, 1.0])
XI_VARIATION = np.array([0.0006, -0.0009, 0.0006, 0.006, -0.006, 0.024])
# the constant-velocity warm start for the first pair is off by this much
XI_GUESS_ERROR = 0.3 * np.array([0.002, -0.003, 0.002, 0.02, -0.02, 0.08])


def synthetic_kitti_scene(n: int = 16384, seed: int = 0) -> np.ndarray:
    """[n, 3] float32 scene points: ground, two walls, posts."""
    rng = np.random.default_rng(seed)
    k = n // 4
    ground = np.stack(
        [rng.uniform(-12, 12, k), rng.uniform(-1.75, -1.6, k),
         rng.uniform(2, 55, k)], axis=1)
    wall_l = np.stack(
        [rng.uniform(-10, -8, k), rng.uniform(-1.5, 3.0, k),
         rng.uniform(2, 55, k)], axis=1)
    wall_r = np.stack(
        [rng.uniform(7, 9, k), rng.uniform(-1.5, 3.0, k),
         rng.uniform(2, 55, k)], axis=1)
    m = n - 3 * k
    posts = np.stack(
        [rng.uniform(-8, 8, m), rng.uniform(-1.5, 2.5, m),
         rng.uniform(2, 40, m)], axis=1)
    xyz = np.concatenate([ground, wall_l, wall_r, posts]).astype(np.float32)
    xyz += rng.normal(scale=0.01, size=xyz.shape).astype(np.float32)
    return xyz


def _skew(w):
    return np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]],
                     [-w[1], w[0], 0.0]])


def se3_exp(xi) -> np.ndarray:
    """4x4 float64 transform of the twist xi = [omega, v] (the convention
    of ops.lie.se3_exp with dt = 1: R = exp(omega^), t = J_l(omega) v)."""
    xi = np.asarray(xi, np.float64)
    w, v = xi[:3], xi[3:]
    th = np.linalg.norm(w)
    A = _skew(w)
    if th < 1e-8:
        k1, k2, k3 = 1.0, 0.5, 1.0 / 6.0
    else:
        k1 = np.sin(th) / th
        k2 = (1.0 - np.cos(th)) / th**2
        k3 = (th - np.sin(th)) / th**3
    T = np.eye(4)
    T[:3, :3] = np.eye(3) + k1 * A + k2 * A @ A
    T[:3, 3] = (np.eye(3) + k2 * A + k3 * A @ A) @ v
    return T


def se3_log(T) -> np.ndarray:
    """Twist [omega, v] of a 4x4 transform (inverse of se3_exp)."""
    T = np.asarray(T, np.float64)
    R, t = T[:3, :3], T[:3, 3]
    c = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    th = np.arccos(c)
    W = (R - R.T) / 2.0
    s = 1.0 if th < 1e-8 else th / np.sin(th)
    w = s * np.array([W[2, 1], W[0, 2], W[1, 0]])
    A = _skew(w)
    if th < 1e-8:
        coef = 1.0 / 12.0
    else:
        coef = (1.0 - th * np.sin(th) / (2.0 * (1.0 - np.cos(th)))) / th**2
    v = (np.eye(3) - 0.5 * A + coef * A @ A) @ t
    return np.concatenate([w, v])


class OdometrySequence(NamedTuple):
    frames: List[np.ndarray]    # n_frames + 1 clouds, [n, 3] float32
    T_true: List[np.ndarray]    # pair k: frame_{k+1} = T_true[k] . frame_k
    guess0: np.ndarray          # warm start of pair 0 (align's convention)


def odometry_sequence(n: int = 16384, n_frames: int = 50, seed: int = 0,
                      motion_seed: int = 7) -> OdometrySequence:
    """Consecutive frames of the moving scene plus ground-truth motion.

    align() returns the map taking target-frame points into the source
    frame, i.e. ~inv(T_true[k]), and takes the inverse convention as its
    initial guess, so the warm start of pair k+1 is inv(result of pair k)
    and the first one is guess0 ~ T_true[0]."""
    rng = np.random.default_rng(motion_seed)
    xyz_k = synthetic_kitti_scene(n, seed)
    frames, T_true = [], []
    for k in range(n_frames + 1):
        frames.append(
            xyz_k + rng.normal(scale=0.005, size=xyz_k.shape).astype(np.float32))
        if k == n_frames:
            break
        T_k = se3_exp(XI_BASE + XI_VARIATION * (np.cos(0.9 * k + 0.4) * 2.0))
        xyz_k = (xyz_k @ T_k[:3, :3].T + T_k[:3, 3]).astype(np.float32)
        xyz_k[:, 2] = 2.0 + np.mod(xyz_k[:, 2] - 2.0, 53.0)
        T_true.append(T_k)
    return OdometrySequence(frames, T_true, se3_exp(XI_BASE + XI_GUESS_ERROR))


def pose_errors(T_rel, T_true) -> np.ndarray:
    """|xi| of T_rel[k] . T_true[k] (zero when align recovered pair k)."""
    return np.asarray([np.linalg.norm(se3_log(np.asarray(a, np.float64) @ b))
                       for a, b in zip(T_rel, T_true)])
