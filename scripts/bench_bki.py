"""BKI insert benchmark — the semantic-mapping workload.

20k-point surface scan (ground + two walls + posts, ~20 m range), free-
space rays, 19 semantic classes, res 0.1 m, ell 0.3 m. Prints warm
per-scan insert wall time (the keyframe-rate target is < 1 s).
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from unified_cvo_tpu.models.bki import SemanticBKIMap  # noqa: E402


def surface_scan(n=20000, seed=0, zmax=20.0):
    rng = np.random.default_rng(seed)
    k = n // 4
    ground = np.stack([rng.uniform(-10, 10, k), np.full(k, -1.7),
                       rng.uniform(2, zmax, k)], 1)
    wall_l = np.stack([np.full(k, -9.0), rng.uniform(-1.5, 3.0, k),
                       rng.uniform(2, zmax, k)], 1)
    wall_r = np.stack([np.full(k, 8.0), rng.uniform(-1.5, 3.0, k),
                       rng.uniform(2, zmax, k)], 1)
    m = n - 3 * k
    posts = np.stack([np.round(rng.uniform(-8, 8, m)),
                      rng.uniform(-1.5, 2.5, m),
                      np.round(rng.uniform(2, zmax, m))], 1)
    pts = np.concatenate([ground, wall_l, wall_r, posts])
    return pts + rng.normal(scale=0.01, size=pts.shape)


def main():
    import os
    # 100 m = the reference caller's setting (Frame.cpp:166 passes
    # free_res=100 -> essentially no free samples at KITTI ranges);
    # BKI_FREE_RES=0.5 benches the dense free-space variant
    free_res = float(os.environ.get("BKI_FREE_RES", 100.0))
    rng = np.random.default_rng(1)
    pts = surface_scan()
    labels = np.eye(19)[rng.integers(0, 19, len(pts))]
    m = SemanticBKIMap(resolution=0.1, num_classes=19, ell=0.3,
                       free_resolution=free_res)
    t0 = time.perf_counter()
    m.insert_pointcloud(pts, labels, origin=np.zeros(3))
    print(f"scan 1 (with compile): {time.perf_counter()-t0:.2f}s "
          f"voxels={len(m)}")
    times = []
    for s in range(2, 6):
        pts2 = surface_scan(seed=s) + np.array([0.0, 0.0, 0.5 * s])
        t0 = time.perf_counter()
        m.insert_pointcloud(pts2, labels,
                            origin=np.array([0.0, 0.0, 0.5 * s]))
        dt = time.perf_counter() - t0
        times.append(dt)
        print(f"scan {s}: {dt:.2f}s voxels={len(m)}")
    print(f"warm per-scan insert: min {min(times):.2f}s "
          f"median {sorted(times)[len(times)//2]:.2f}s")


if __name__ == "__main__":
    main()
