"""KITTI stereo frame-to-frame odometry — the cvo_align_gpu_img twin.

Usage:
    python -m unified_cvo_tpu.apps.kitti_odometry SEQ_DIR PARAMS.yaml OUT.txt \
        [START_FRAME] [MAX_FRAMES] [--semantic]

Mirrors src/experiments/main_cvo_gpu_align_raw_image.cpp:22-169: per frame,
build a stereo point cloud (FAST-adaptive selection + SGM disparity), align
against the previous frame with the previous relative motion as the initial
guess (constant velocity), accumulate, and stream KITTI-format rows to OUT.
The first pair uses the *_first_frame parameter swap (main:40-46,156-161).

With --semantic, per-pixel 19-class distributions are read alongside the
stereo pair and attached to the clouds — the cvo_align_gpu_semantic_img
twin (main_cvo_semantic_gpu_align_raw_image.cpp: read_next_stereo with
num_classes + semantic CvoPointCloud).
"""

from __future__ import annotations

import sys

import numpy as np

from unified_cvo_tpu.apps._odometry_common import run_pipelined
from unified_cvo_tpu.config import read_cvo_params_yaml
from unified_cvo_tpu.datasets.kitti import KittiHandler, write_kitti_pose_row
from unified_cvo_tpu.frontend.pipeline import pointcloud_from_stereo

CAPACITY = 32768  # one jit trace for all frames (28k max FAST budget + pad)


def run_sequence(
    seq_dir: str,
    param_file: str,
    out_path: str,
    start_frame: int = 0,
    max_frames: int = 100000,
    denoise: bool = True,
    chunk: int = 4096,
    max_iter: int | None = None,
    log=print,
    metrics_path: str | None = None,
    semantic: bool = False,
    num_classes: int = 19,
    capacity: int = CAPACITY,
    stereo_backend: str = "auto",
    frontend: str = "host",
    device_max_disp: int | None = None,
):
    from unified_cvo_tpu.utils.logging import MetricsLogger

    metrics = MetricsLogger(metrics_path)
    kitti = KittiHandler(seq_dir, "stereo")
    calib = kitti.calibration()
    params = read_cvo_params_yaml(param_file)
    first_params = params.first_frame()
    kitti.set_start_index(start_frame)

    out = open(out_path, "w")
    out.write("1 0 0 0 0 1 0 0 0 0 1 0\n")
    out.flush()

    def read_frame():
        if semantic:
            return kitti.read_next_stereo_semantic(num_classes)
        pair = kitti.read_next_stereo()
        return None if pair is None else (*pair, None)

    if frontend == "device":
        # whole measurement chain on the accelerator: census-SGM disparity + DSO selection + backprojection
        # in one jit, no host CPU in the per-frame path. Semantics stay on
        # the host pipeline (no device semantic reader).
        if semantic:
            raise ValueError("frontend='device' does not take --semantic")
        from unified_cvo_tpu.frontend.device import (
            device_pointcloud_from_stereo)

        # disparity search range scales with image width (KITTI full-res
        # 1241 px needs the reference's 128; half-scale imagery halves it,
        # and SGM cost is linear in it)
        md = device_max_disp
        if md is None:
            md = 128 if calib.cols >= 900 or calib.cols == 0 else 64

        def build_cloud(left, right, sem):
            return device_pointcloud_from_stereo(
                left, right, calib, capacity=capacity, max_disp=md,
                denoise=False)
    else:
        def build_cloud(left, right, sem):
            return pointcloud_from_stereo(
                left, right, calib, semantics=sem, denoise=denoise,
                capacity=capacity, stereo_backend=stereo_backend,
            )

    frame = read_frame()
    if frame is None:
        raise RuntimeError("empty sequence")
    source = build_cloud(*frame)

    accum = np.eye(4, dtype=np.float64)
    n_frames = min(len(kitti), start_frame + max_frames)
    poses = [accum.copy()]

    def read_target(i):
        kitti.next()
        frame = read_frame()
        return None if frame is None else (build_cloud(*frame), None)

    def on_result(i, result, ret, info, aux, t_frontend, t_block):
        nonlocal accum
        accum = accum @ result
        poses.append(accum.copy())
        write_kitti_pose_row(out, accum)
        log(
            f"frame {i}->{i+1}: iters={int(info.iterations)} "
            f"ell={float(info.final_ell):.3f} ret={int(ret)} "
            f"frontend={t_frontend:.2f}s wait={t_block:.2f}s"
        )
        metrics.log(
            frame=i + 1, iterations=int(info.iterations), ret=int(ret),
            final_ell=float(info.final_ell), nonzeros=int(info.nonzeros),
            frontend_seconds=t_frontend, align_wait_seconds=t_block,
        )

    n_aligned, total_block = run_pipelined(
        source, range(start_frame, n_frames - 1), read_target, params,
        first_params, on_result, chunk=chunk, max_iter=max_iter, log=log,
    )
    metrics.close()
    out.close()
    log(f"Average registration time is {total_block / max(n_aligned, 1):.3f}")
    return np.asarray(poses)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 3:
        print(__doc__)
        return 1
    semantic = "--semantic" in argv
    device_fe = "--device-frontend" in argv
    argv = [a for a in argv if a not in ("--semantic", "--device-frontend")]
    seq_dir, param_file, out_path = argv[:3]
    start = int(argv[3]) if len(argv) > 3 else 0
    max_frames = int(argv[4]) if len(argv) > 4 else 100000
    run_sequence(seq_dir, param_file, out_path, start, max_frames,
                 semantic=semantic,
                 frontend="device" if device_fe else "host")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
