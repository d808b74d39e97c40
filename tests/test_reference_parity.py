"""Trajectory parity vs a literal NumPy simulation of reference align_impl.

The strongest fidelity check available without CUDA: both implementations
run the demo-sized colored pair (tests/fixtures.py) under the outdoor preset
and must produce the same nonzeros sequence, the same ell schedule,
near-identical step sizes, and matching poses. (reference_sim.py includes the ELL scan-order cap this
build drops; on this workload the cap never binds, demonstrating the
designs coincide.)
"""

import numpy as np
import pytest

import jax.numpy as jnp

from fixtures import write_demo_pcds
from reference_sim import align_ref_sim
from unified_cvo_tpu.config import load_preset
from unified_cvo_tpu.datasets.pcd import read_pcd
from unified_cvo_tpu.models.align import align
from unified_cvo_tpu.utils.pointcloud import make_pointcloud

HORIZON = 250


@pytest.mark.slow
def test_demo_trajectory_matches_reference_simulation(tmp_path):
    src_path, tgt_path = write_demo_pcds(tmp_path)
    sx, sc = read_pcd(src_path)
    tx, tc = read_pcd(tgt_path)
    feat = lambda c: np.concatenate([c, np.zeros((len(c), 2), np.float32)], 1)
    p = load_preset("cvo_outdoor_params")
    dist = float(np.linalg.norm(sx.mean(0) - tx.mean(0)))
    p = p.replace(
        ell_init=dist,
        ell_decay_rate=p.ell_decay_rate_first_frame,
        ell_decay_start=p.ell_decay_start_first_frame,
        is_using_geometric_type=0,  # both clouds all-surface: gate is a no-op
    )

    T_ref, ret_ref, h_ref = align_ref_sim(p, sx, tx, feat(sc), feat(tc), max_iter=HORIZON)

    src = make_pointcloud(sx, features=feat(sc), bucket=1)
    tgt = make_pointcloud(tx, features=feat(tc), bucket=1)
    T_j, ret_j, info = align(
        src, tgt, jnp.eye(4), p, record_history=True, max_iter=HORIZON, chunk=1080
    )
    k = int(info.iterations)
    assert k == len(h_ref["step"])
    hj = {n: np.asarray(v)[:k] for n, v in info.history.items()}

    # schedule parity over the first 150 iterations (tolerances cover single
    # threshold-boundary pairs flipping under different f32 summation orders)
    np.testing.assert_allclose(hj["nonzeros"][:150], h_ref["nonzeros"][:150], rtol=3e-3)
    np.testing.assert_allclose(hj["ell"][:150], h_ref["ell"][:150], rtol=1e-2)
    np.testing.assert_allclose(hj["step"][:100], h_ref["step"][:100], rtol=5e-2)

    # poses stay close over the full horizon (f32 vs f64 drift allowed)
    T_j = np.asarray(T_j)
    assert np.abs(T_j[:3, :3] - T_ref[:3, :3]).max() < 5e-3
    assert np.abs(T_j[:3, 3] - T_ref[:3, 3]).max() < 5e-2


def test_dense_scene_neighbor_cap_convergence_parity(rng):
    """SURVEY §7 hard-part 4 / convergence behavior where
    the reference's num_neighbors row cap and its 1.2x shrink
    (CvoGPU.cu:576-589, 1519-1529) actually BIND. The scene is much denser
    than the kernel support (rows want ~380 entries at a 32 cap; the shrink
    drives the cap to single digits near convergence), the regime the
    uncapped streaming design intentionally differs in. Result: the
    scan-order cap is an unbiased row subsample, so the capped reference
    and the uncapped streaming path follow the same ell schedule and converge to
    the same pose (|dT| < 1e-5) — the cap is a memory-format artifact with
    no convergence effect, which is why dropping it is sound."""
    from reference_sim import kernel_rows_capped
    from unified_cvo_tpu.config import CvoParams
    from unified_cvo_tpu.ops import lie

    n = 512
    x = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    xi = np.array([0.002, 0.005, -0.001, 0.02, 0.01, 0.04], np.float32)
    R_m, t_m = (np.asarray(v) for v in lie.se3_exp(jnp.asarray(xi), 1.0))
    y = (x @ R_m.T + t_m).astype(np.float32)
    p = CvoParams(ell_init=0.5, ell_min=0.05, ell_decay_rate=0.9,
                  ell_decay_start=5, indicator_window_size=5,
                  indicator_stable_threshold=0.2, max_step=0.1,
                  sp_thres=0.0006, nearest_neighbors_max=32)

    # the cap must actually bind on this scene
    A_unc = kernel_rows_capped(p, p.ell_init, x, y, None, None, 10**9)
    assert int((A_unc > 0).sum(1).max()) > 5 * p.nearest_neighbors_max

    T_sim, ret_sim, hist = align_ref_sim(p, x, y, max_iter=200)
    assert min(hist["num_neighbors"]) < p.nearest_neighbors_max  # shrink fired

    src = make_pointcloud(x, bucket=n)
    tgt = make_pointcloud(y, bucket=n)
    T_our, ret, info = align(src, tgt, jnp.eye(4), p, backend="jnp",
                             max_iter=200)
    np.testing.assert_allclose(float(info.final_ell), hist["ell"][-1],
                               rtol=1e-5)
    assert np.abs(np.asarray(T_our) - T_sim).max() < 1e-5
    # and both recover the true motion
    T_true = np.eye(4)
    T_true[:3, :3] = R_m
    T_true[:3, 3] = t_m
    inv = np.linalg.inv(T_true)
    assert np.abs(T_sim - inv).max() < 1e-4
    assert np.abs(np.asarray(T_our) - inv).max() < 1e-4
