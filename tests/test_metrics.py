"""Trajectory metrics tests on seeded synthetic KITTI-like trajectories
(tests/fixtures.py): a car-like ground-truth path and odometry-like
estimates whose drift is set by per-frame error levels."""

import numpy as np
import pytest

from fixtures import drifted, kitti_trajectory, write_kitti_poses
from unified_cvo_tpu.datasets.kitti import read_kitti_poses
from unified_cvo_tpu.utils.metrics import ate_rmse, kitti_seq_error, rpe_rmse

# per-frame (translation m, rotation rad) error levels of the estimates,
# ordered like the reference's stored results: CVO semantic <= intensity <
# geometric << NDT < GICP
METHODS = {
    "semantic": (0.078, 0.0032),
    "intensity": (0.080, 0.0035),
    "geometric": (0.097, 0.0042),
    "ndt": (0.14, 0.0060),
    "gicp": (0.23, 0.0100),
}


@pytest.fixture(scope="module")
def gt_00(tmp_path_factory):
    """Sequence 00 stand-in, round-tripped through the KITTI pose format."""
    path = tmp_path_factory.mktemp("gt") / "00.txt"
    write_kitti_poses(path, kitti_trajectory(1000, seed=0))
    return read_kitti_poses(str(path))


def test_identical_trajectories_zero_error(gt_00):
    gt = gt_00[:300]
    t_err, r_err = kitti_seq_error(gt, gt)
    assert t_err == pytest.approx(0.0, abs=1e-9)
    assert r_err == pytest.approx(0.0, abs=1e-9)
    assert ate_rmse(gt, gt) == pytest.approx(0.0, abs=1e-9)


def test_reference_result_error_is_sane(gt_00):
    """A geometric-CVO-like estimate of seq 00 scores in the published
    ballpark (a few % translational error) against ground truth."""
    est = drifted(gt_00, 1, *METHODS["geometric"])
    t_err, r_err = kitti_seq_error(gt_00, est)
    assert 0.001 < t_err < 0.10, t_err          # between 0.1% and 10%
    assert 0.0 < np.degrees(r_err) < 0.2, r_err  # deg/m


def test_ate_detects_offset(gt_00):
    gt = gt_00[:200]
    est = gt.copy()
    est[:, 0, 3] += np.linspace(0, 5.0, len(est))  # growing drift
    assert ate_rmse(gt, est) > 0.5
    # constant offset is absorbed by alignment
    est2 = gt.copy()
    est2[:, :3, 3] += np.array([10.0, -3.0, 2.0])
    assert ate_rmse(gt, est2) == pytest.approx(0.0, abs=1e-6)


def test_rpe(gt_00):
    gt = gt_00[:100]
    assert rpe_rmse(gt, gt) == pytest.approx(0.0, abs=1e-9)
    # a per-frame error shows up in the relative metric
    assert rpe_rmse(gt, drifted(gt, 2, 0.05, 0.0)) > 0.02


def test_reference_result_hierarchy():
    """The devkit twin reproduces the ordering of the error levels over 11
    sequences: semantic <= intensity < geometric << NDT < GICP, with the
    geometric average in the reference's ~4.6 % band."""

    def avg_t(method):
        errs = []
        for seq in range(11):
            gt = kitti_trajectory(900, seed=100 + seq)
            est = drifted(gt, 1000 * seq + len(method), *METHODS[method])
            t, _ = kitti_seq_error(gt, est)
            errs.append(t)
        return float(np.mean(errs))

    sem, inten, geo, ndt, gicp = (avg_t(m) for m in METHODS)
    assert sem <= inten < geo < ndt < gicp
    assert 0.03 < geo < 0.06
    assert 0.03 < inten < 0.045
