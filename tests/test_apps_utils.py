"""App-level utilities: eval CLI, viewers, logging, IRLS checkpoint/resume."""

import json
import os

import numpy as np
import pytest

from unified_cvo_tpu.utils.logging import MetricsLogger, phase_timer


def _write_artifacts(root):
    """KITTI-layout stand-ins for the reference's stored artifacts:
    ground_truth/00/00.txt, ground_truth/03/03.txt and a geometric-CVO-like
    result directory (tests/fixtures.py drift levels)."""
    from fixtures import drifted, kitti_trajectory, write_kitti_poses
    from test_metrics import METHODS

    res = root / "results" / "cvo_geometric"
    res.mkdir(parents=True)
    for seq, n in (("00", 1000), ("03", 300)):
        gt = kitti_trajectory(n, seed=int(seq))
        (root / "ground_truth" / seq).mkdir(parents=True)
        write_kitti_poses(root / "ground_truth" / seq / f"{seq}.txt", gt)
        write_kitti_poses(res / f"{seq}.txt",
                          drifted(gt, 0, *METHODS["geometric"]))
    return str(root / "ground_truth"), str(res)


def test_evaluate_odometry_on_reference_artifacts(capsys, tmp_path):
    from unified_cvo_tpu.apps.evaluate_odometry import main

    gt_dir, res_dir = _write_artifacts(tmp_path)
    rc = main([gt_dir, res_dir, "00"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "00" in out and "avg" in out
    # the seq-00 stand-in carries the geometric drift level (~4 %)
    line = [l for l in out.splitlines() if l.strip().startswith("00")][0]
    t_err = float(line.split()[1])
    assert 3.5 < t_err < 4.5, line


def test_traj_viewer(tmp_path):
    from unified_cvo_tpu.apps.viewer import plot_trajectories

    gt_dir, res_dir = _write_artifacts(tmp_path)
    out = plot_trajectories(
        str(tmp_path / "traj.png"),
        [os.path.join(gt_dir, "03", "03.txt"), os.path.join(res_dir, "03.txt")],
        labels=["gt", "cvo"],
    )
    assert os.path.getsize(out) > 10000


def test_pcd_viewer(tmp_path):
    from fixtures import write_demo_pcds
    from unified_cvo_tpu.apps.viewer import plot_pcds

    out = plot_pcds(str(tmp_path / "pcd.png"), list(write_demo_pcds(tmp_path)))
    assert os.path.getsize(out) > 10000


def test_metrics_logger(tmp_path):
    path = str(tmp_path / "m.jsonl")
    lg = MetricsLogger(path)
    lg.log(frame=3, iters=17, ell=0.1)
    with phase_timer("align", lg):
        pass
    lg.close()
    rows = [json.loads(l) for l in open(path)]
    assert rows[0]["frame"] == 3
    assert rows[1]["phase"] == "align" and rows[1]["seconds"] >= 0


def test_irls_checkpoint_resume(tmp_path, rng):
    import jax.numpy as jnp

    from unified_cvo_tpu.models import irls
    from unified_cvo_tpu.utils.pointcloud import make_pointcloud
    from test_irls import _params, _bunnyish

    p = _params().replace(multiframe_max_iters=6)
    base = _bunnyish(rng, 128)
    clouds = irls.stack_clouds(
        [make_pointcloud(base, bucket=128),
         make_pointcloud(base + 0.05, bucket=128)]
    )
    init = np.tile(np.eye(3, 4, dtype=np.float32), (2, 1, 1))
    ckpt = str(tmp_path / "ba.npz")
    poses1, _ = irls.irls_solve(
        clouds, init, [(0, 1)], [True, False], p, chunk=128,
        checkpoint_path=ckpt,
    )
    assert os.path.exists(ckpt)
    # resume continues (max_iters reached, so poses should be stable)
    p2 = p.replace(multiframe_max_iters=8)
    poses2, _ = irls.irls_solve(
        clouds, init, [(0, 1)], [True, False], p2, chunk=128,
        checkpoint_path=ckpt, resume=True,
    )
    assert np.isfinite(poses2).all()
    np.testing.assert_array_equal(poses2[0], init[0])


def test_evaluate_ate_cli(tmp_path, capsys):
    """The evaluate_ate_scale.py twin (apps/evaluate_ate): TUM + KITTI
    inputs, plain and scale-aligned."""
    from unified_cvo_tpu.apps.evaluate_ate import main
    from unified_cvo_tpu.datasets.tum import write_tum_pose_row

    rng = np.random.default_rng(0)
    n = 10
    gt = np.tile(np.eye(4), (n, 1, 1))
    gt[:, 0, 3] = np.arange(n) * 0.5
    est = gt.copy()
    est[:, :3, 3] *= 1.1          # pure scale error
    gt_p, est_p = str(tmp_path / "gt.txt"), str(tmp_path / "est.txt")
    for path, traj in ((gt_p, gt), (est_p, est)):
        with open(path, "w") as f:
            for i, T in enumerate(traj):
                write_tum_pose_row(f, f"{i:.1f}", T)
    assert main([gt_p, est_p]) == 0
    plain = float(capsys.readouterr().out.split()[2])
    assert main([gt_p, est_p, "--scale"]) == 0
    scaled = float(capsys.readouterr().out.split()[2])
    # scale alignment removes the 10% scale error entirely
    assert plain > 0.05 and scaled < 1e-6, (plain, scaled)

    # KITTI 12-column input path
    kit = str(tmp_path / "kitti.txt")
    np.savetxt(kit, gt[:, :3, :].reshape(n, 12))
    assert main([kit, kit, "--rpe"]) == 0
    out = capsys.readouterr().out
    assert "ate rmse: 0.000000" in out and "rpe rmse" in out


def test_evaluate_semantics_devkit_twin(tmp_path, capsys):
    """The pixel-level semantic evaluator (devkit/evaluation twin):
    hand-checkable confusion matrix -> IoU, ignored labels excluded."""
    from unified_cvo_tpu.apps.evaluate_semantics import (confusion_matrix,
                                                         evaluate, main)

    gt = np.array([0, 0, 1, 1, 2, 2, 2, 3])
    pred = np.array([0, 1, 1, 1, 2, 0, 2, 3])
    r = evaluate(gt, pred, num_classes=4)
    # class 0: tp=1 fp=1 fn=1 -> 1/3; class 1: tp=2 fp=1 fn=0 -> 2/3
    # class 2: tp=2 fp=0 fn=1 -> 2/3; class 3: tp=1 -> 1
    np.testing.assert_allclose(r["iou"], [1 / 3, 2 / 3, 2 / 3, 1.0])
    np.testing.assert_allclose(r["accuracy"], 6 / 8)
    # ignoring class 3 drops its row entirely
    conf = confusion_matrix(gt, pred, 4, ignore=[3])
    assert conf[3].sum() == 0
    # an INVALID prediction on a valid-GT pixel counts as an error (extra
    # column), not an excluded pixel — a 255-spamming predictor must score 0
    r255 = evaluate(np.array([0, 1, 2]), np.array([255, 255, 255]),
                    num_classes=3)
    assert r255["accuracy"] == 0.0
    np.testing.assert_allclose(r255["iou"], [0.0, 0.0, 0.0])
    # CLI on npy files
    g, p = str(tmp_path / "g.npy"), str(tmp_path / "p.npy")
    np.save(g, gt.reshape(2, 4))
    np.save(p, pred.reshape(2, 4))
    assert main([g, p, "--num-classes", "4"]) == 0
    out = capsys.readouterr().out
    assert "mean IoU: 0.6667" in out
