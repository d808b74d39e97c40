"""End-to-end KITTI driver throughput: host frontend vs device frontend.

Renders a synthetic KITTI-layout stereo sequence (512x320) and runs
apps.kitti_odometry.run_sequence twice on the accelerator: once with the
host frontend (SGBM + adaptive FAST on the host CPU) and once with the
device frontend (census-SGM + DSO + backprojection in one jit). Reports
warm fps and the devkit translational error for both.

Usage: timeout 1800 python scripts/bench_driver.py [N_FRAMES]
"""
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from unified_cvo_tpu.config import preset_path  # noqa: E402
from unified_cvo_tpu.frontend.calibration import Calibration  # noqa: E402
from unified_cvo_tpu.utils import synth  # noqa: E402
from unified_cvo_tpu.utils.metrics import kitti_seq_error  # noqa: E402

N_FRAMES = int(sys.argv[1]) if len(sys.argv) > 1 else 40
PARAMS = preset_path("cvo_intensity_params_img_gpu0")


def main():
    K = np.array([[260.0, 0, 256.0], [0, 260.0, 160.0], [0, 0, 1]],
                 np.float32)
    calib = Calibration(K, baseline=0.54, cols=512, rows=320)
    scene = synth.corridor_scene(seed=3)
    traj = synth.corridor_trajectory(N_FRAMES, step=0.35)
    d = tempfile.mkdtemp(prefix="kitti_drv_")
    gt = synth.write_kitti_sequence(d, scene, traj, calib)

    from unified_cvo_tpu.apps.kitti_odometry import run_sequence

    results = {}
    for fe in ("host", "device"):
        out = os.path.join(d, f"poses_{fe}.txt")
        # warm pass: first frames pay jit compiles; run twice and time the
        # second (the PERF.md full-driver numbers are warm throughput)
        for attempt in range(2):
            t0 = time.time()
            poses = run_sequence(
                d, PARAMS, out, 0, N_FRAMES, denoise=False,
                log=lambda *a, **k: None, frontend=fe, capacity=16384)
            dt = time.time() - t0
        fps = (N_FRAMES - 1) / dt
        t_err, r_err = kitti_seq_error(gt[:len(poses)], np.asarray(poses),
                                       step=2, lengths=(5, 10))
        results[fe] = (fps, t_err)
        print(f"{fe:6s} frontend: {fps:.1f} fps warm   "
              f"trans err {100 * t_err:.2f}%  rot err {r_err:.5f} rad/m",
              flush=True)
    print(f"device/host speedup: "
          f"{results['device'][0] / results['host'][0]:.2f}x")


if __name__ == "__main__":
    main()
