"""Per-point neighborhood covariance + eigenvalues.

Reference: src/utils/CvoPointCovariance.cu:122-233 — per-point 3x3
covariance over the K nearest neighbors (K = KDTREE_K_SIZE = 32) with
eigenvalues, feeding the dense/Mahalanobis kernel variant and ellipse
visualization. Two implementations:

- `point_covariances`: host-side (cKDTree KNN + batched eigh), used by
  the front-end at cloud-construction time like the reference.
- `point_covariances_device`: on-device jnp version — blocked brute-force
  KNN (`lax.top_k` per source block, the static-shape analogue of the
  reference's cuKdTree NearestKSearch) + closed-form symmetric 3x3 eigenvalues, for
  covariance recomputation inside jitted pipelines.
"""

from __future__ import annotations

import functools

import numpy as np
from scipy.spatial import cKDTree


def point_covariances(xyz: np.ndarray, k: int = 32):
    """Returns (cov [N,3,3], eigenvalues [N,3] ascending, degenerate [N]).

    Degenerate = fewer than 4 distinct neighbors or near-zero spread
    (the is_cov_degenerate flag in the reference)."""
    xyz = np.asarray(xyz, np.float64).reshape(-1, 3)
    n = len(xyz)
    if n == 0:
        return np.zeros((0, 3, 3)), np.zeros((0, 3)), np.zeros(0, bool)
    k = min(k, n)
    tree = cKDTree(xyz)
    _, idx = tree.query(xyz, k=k)
    idx = idx.reshape(n, k)
    nbrs = xyz[idx]                       # [N,k,3]
    mean = nbrs.mean(axis=1, keepdims=True)
    centered = nbrs - mean
    cov = np.einsum("nki,nkj->nij", centered, centered) / max(k - 1, 1)
    eigvals = np.linalg.eigvalsh(cov)     # ascending
    degenerate = (eigvals[:, 2] < 1e-10) | (k < 4)
    return cov.astype(np.float32), eigvals.astype(np.float32), degenerate


@functools.partial(
    __import__("jax").jit, static_argnames=("k", "block")
)
def point_covariances_device(xyz, mask, k: int = 32, block: int = 256):
    """On-device per-point KNN covariance (reference CvoPointCovariance.cu:
    compute_covariance with cuKdTree K=32 neighbors, :122-233), on device:
    blocked brute-force [block, N] distance tiles + `lax.top_k`, batched
    covariance, and closed-form symmetric 3x3 eigenvalues (no eigh inside
    jit). Invalid (masked) points yield zero covariance.

    Args: xyz [N,3] float32 (padded), mask [N] {0,1}. Returns
    (cov [N,3,3], eigvals [N,3] ascending, degenerate [N] bool)."""
    import jax
    import jax.numpy as jnp

    xyz = jnp.asarray(xyz, jnp.float32)
    mask = jnp.asarray(mask, jnp.float32)
    n = xyz.shape[0]
    k = min(k, n)
    sq = jnp.sum(xyz * xyz, axis=-1)

    def one_block(xb):
        # xb: [block,3] query points
        d2 = (
            jnp.sum(xb * xb, -1)[:, None] + sq[None, :]
            - 2.0 * xb @ xyz.T
        )
        d2 = jnp.where(mask[None, :] > 0, d2, jnp.inf)
        neg, idx = jax.lax.top_k(-d2, k)          # [block,k]
        valid = jnp.isfinite(neg)                  # masked-out -> -inf
        nbr = xyz[idx]                             # [block,k,3]
        w = valid.astype(jnp.float32)[..., None]
        cnt = jnp.maximum(jnp.sum(w, axis=1), 1.0)  # [block,1]
        mean = jnp.sum(nbr * w, axis=1, keepdims=True) / cnt[:, None]
        cen = (nbr - mean) * w
        cov = jnp.einsum("bki,bkj->bij", cen, cen) / jnp.maximum(
            cnt - 1.0, 1.0
        )[..., None]
        return cov, jnp.sum(w[..., 0], axis=1)

    nb = -(-n // block)
    pad = nb * block - n
    xp = jnp.pad(xyz, ((0, pad), (0, 0)))
    covs, cnts = jax.lax.map(one_block, xp.reshape(nb, block, 3))
    cov = covs.reshape(nb * block, 3, 3)[:n]
    cnts = cnts.reshape(nb * block)[:n]
    cov = cov * mask[:, None, None]
    eig = sym3_eigenvalues(cov)
    degenerate = (eig[:, 2] < 1e-10) | (cnts < 4) | (mask <= 0)
    return cov, eig, degenerate


def sym3_eigenvalues(A):
    """Closed-form ascending eigenvalues of symmetric 3x3 matrices [.,3,3]
    (trigonometric method — Smith 1961), jit friendly (no complex, no
    iterative eigh)."""
    import jax.numpy as jnp

    q = jnp.trace(A, axis1=-2, axis2=-1) / 3.0
    I = jnp.eye(3, dtype=A.dtype)
    B = A - q[..., None, None] * I
    p2 = jnp.sum(B * B, axis=(-2, -1)) / 6.0
    p = jnp.sqrt(jnp.maximum(p2, 1e-30))
    detB = jnp.linalg.det(B)
    r = detB / (2.0 * p**3)
    r = jnp.clip(r, -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    e1 = q + 2.0 * p * jnp.cos(phi)
    e3 = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    eig = jnp.stack([e3, e2, e1], axis=-1)       # ascending
    # exactly-isotropic matrices (p ~ 0): all eigenvalues = q
    iso = p2 < 1e-24
    qq = jnp.stack([q, q, q], axis=-1)
    return jnp.where(iso[..., None], qq, eig)
