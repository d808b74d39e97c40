"""Fixed-capacity padded SoA point clouds (the static-shape CvoPointCloud).

The reference's CvoPointCloud is a dynamic SoA container with compile-time
feature/class dimensions (reference: include/UnifiedCvo/utils/CvoPointCloud.hpp:35-209,
PointSegmentedDistribution.hpp:17-99). Under jit all shapes are static, so a
cloud is a padded pytree: `xyz [N,3]`, `features [N,F]`, `labels [N,C]`,
`geometric_types [N,2]`, plus a validity `mask [N]`. F and C are static shape
parameters (the reference's FEATURE_DIMENSIONS / NUM_CLASSES template args);
N is rounded up to a bucket size so jit traces are reused across frames.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


class PointCloud(NamedTuple):
    """Padded point cloud. Invalid (padding) rows have mask == 0."""

    xyz: jax.Array               # [N, 3] float32
    mask: jax.Array              # [N] float32, 1.0 valid / 0.0 padding
    features: Optional[jax.Array] = None        # [N, F] float32 (color/intensity/gradients)
    labels: Optional[jax.Array] = None          # [N, C] float32 (semantic distribution)
    geometric_types: Optional[jax.Array] = None  # [N, 2] float32 (edge, surface)

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def num_valid(self) -> jax.Array:
        return jnp.sum(self.mask)

    @property
    def feature_dim(self) -> int:
        return 0 if self.features is None else self.features.shape[-1]

    @property
    def num_classes(self) -> int:
        return 0 if self.labels is None else self.labels.shape[-1]

    def transformed(self, R, t) -> "PointCloud":
        """Rigid transform of positions only (reference
        transform_pointcloud_thrust, CvoGPU_impl.cu:164-173)."""
        return self._replace(xyz=self.xyz @ jnp.swapaxes(R, -1, -2) + t)


def make_pointcloud(
    xyz: np.ndarray,
    features: Optional[np.ndarray] = None,
    labels: Optional[np.ndarray] = None,
    geometric_types: Optional[np.ndarray] = None,
    bucket: int = 256,
    capacity: Optional[int] = None,
) -> PointCloud:
    """Build a padded PointCloud from host arrays.

    `bucket` quantizes the padded capacity so repeated frames of similar sizes
    hit the same compiled trace. Padding rows get xyz=0 and mask=0; kernels
    mask them out explicitly.
    """
    xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
    n = xyz.shape[0]
    cap = capacity if capacity is not None else max(round_up(n, bucket), bucket)
    if cap < n:
        raise ValueError(f"capacity {cap} < num points {n}")

    def pad(a, width):
        a = np.asarray(a, np.float32).reshape(n, -1)
        out = np.zeros((cap, a.shape[1]), np.float32)
        out[:n] = a
        return jnp.asarray(out)

    mask = np.zeros((cap,), np.float32)
    mask[:n] = 1.0
    if geometric_types is None:
        # reference default for plain/colored clouds: surface type (0, 1)
        # (CvoPointCloud.cpp:590-592)
        geometric_types = np.tile(np.array([[0.0, 1.0]], np.float32), (n, 1))
    return PointCloud(
        xyz=pad(xyz, 3),
        mask=jnp.asarray(mask),
        features=None if features is None else pad(features, None),
        labels=None if labels is None else pad(labels, None),
        geometric_types=pad(geometric_types, 2),
    )


def concatenate(a: PointCloud, b: PointCloud) -> PointCloud:
    """Concatenate two clouds (reference operator+, CvoPointCloud.cpp:916-962)."""

    def cat(x, y):
        if x is None or y is None:
            return None
        return jnp.concatenate([x, y], axis=0)

    return PointCloud(
        xyz=jnp.concatenate([a.xyz, b.xyz], axis=0),
        mask=jnp.concatenate([a.mask, b.mask], axis=0),
        features=cat(a.features, b.features),
        labels=cat(a.labels, b.labels),
        geometric_types=cat(a.geometric_types, b.geometric_types),
    )


def to_numpy_valid(pc: PointCloud):
    """Strip padding; returns dict of numpy arrays for IO/visualization."""
    mask = np.asarray(pc.mask) > 0.5
    out = {"xyz": np.asarray(pc.xyz)[mask]}
    for name in ("features", "labels", "geometric_types"):
        v = getattr(pc, name)
        if v is not None:
            out[name] = np.asarray(v)[mask]
    return out
