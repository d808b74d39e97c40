"""Two-colored-PCD alignment demo — the cvo_align_gpu_two_color_pcd twin.

Usage (reference README.md:58-73):
    python -m unified_cvo_tpu.apps.align_two_pcd SOURCE.pcd TARGET.pcd PARAMS.yaml [ELL_INIT]

Mirrors src/experiments/main_cvo_gpu_align_two_color_pcd.cpp: loads two
XYZRGB clouds, sets ell_init to the cloud-mean distance (unless given),
swaps in the first-frame decay schedule, aligns from identity, writes
before_align.pcd / after_align.pcd and prints the transform + timing.
"""

from __future__ import annotations

import sys
import time

import numpy as np

import jax.numpy as jnp

from unified_cvo_tpu.config import read_cvo_params_yaml
from unified_cvo_tpu.datasets.pcd import load_demo_cloud, read_pcd, write_pcd
from unified_cvo_tpu.models.align import align, function_angle


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 3:
        print(__doc__)
        return 1
    source_file, target_file, param_file = argv[:3]
    ell = float(argv[3]) if len(argv) > 3 else -1.0
    max_iter = int(argv[4]) if len(argv) > 4 else None

    src = load_demo_cloud(source_file)
    tgt = load_demo_cloud(target_file)
    sx, sc = read_pcd(source_file)
    tx, tc = read_pcd(target_file)

    params = read_cvo_params_yaml(param_file)
    dist = float(np.linalg.norm(sx.mean(0) - tx.mean(0)))
    print(f"source mean {sx.mean(0)}, target mean {tx.mean(0)}, dist {dist:.3f}")
    params = params.replace(
        ell_init=dist if ell < 0 else ell,
        ell_decay_rate=params.ell_decay_rate_first_frame,
        ell_decay_start=params.ell_decay_start_first_frame,
    )
    print(f"ell init is {params.ell_init}")
    print(f"Start align... num_fixed is {len(sx)}, num_moving is {len(tx)}")

    # cold call = one-time jit compilation (per new shape) + solve; the
    # warm re-run isolates the actual
    # registration cost, matching the reference's "Average registration
    # time" semantics (its CUDA kernels have no per-shape compile step)
    t0 = time.time()
    T, ret, info = align(src, tgt, jnp.eye(4), params, max_iter=max_iter)
    T = np.asarray(T)
    cold = time.time() - t0
    t0 = time.time()
    T2, ret, info = align(src, tgt, jnp.eye(4), params, max_iter=max_iter)
    T = np.asarray(T2)
    elapsed = time.time() - t0
    print(f"cvo # of iterations is {int(info.iterations)}")
    print(f"final ell is {float(info.final_ell):.4f}, ret={int(ret)}")
    print("Transform is\n", T)
    print(f"first call {cold:.3f} s (includes {cold - elapsed:.3f} s "
          "one-time jit compilation)")
    print(f"Average registration time is {elapsed:.3f} s")

    # function_angle applies the INVERSE of its transform to the moving cloud
    # (inner_product_impl convention, CvoGPU.cu:1719-1778); the align result
    # maps target->source directly, so pass its inverse.
    cos_before = float(function_angle(src, tgt, jnp.eye(4), 0.5, params))
    cos_after = float(
        function_angle(src, tgt, jnp.asarray(np.linalg.inv(T)), 0.5, params)
    )
    print(f"function_angle(ell=0.5): before {cos_before:.4f} after {cos_after:.4f}")

    tx_new = tx @ T[:3, :3].T + T[:3, 3]
    both_rgb = np.concatenate([sc, tc]) if sc is not None and tc is not None else None
    write_pcd("before_align.pcd", np.concatenate([sx, tx]), both_rgb)
    write_pcd("after_align.pcd", np.concatenate([sx, tx_new]), both_rgb)
    print("wrote before_align.pcd / after_align.pcd")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
