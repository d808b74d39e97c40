"""Worker for the multi-process jax.distributed test.

Launched twice (process_id 0/1) by tests/test_multiprocess.py with 4 local
CPU devices each — an 8-device global mesh spanning a real process boundary
(the DCN analogue the single-process virtual mesh cannot exercise). Runs:

  A. the DP/SP batched align step with the sp (point) axis deliberately
     laid out ACROSS the two processes, so every flow/step psum crosses it;
     checked against the local single-device iteration per pair.
  B. the FULL sharded IRLS solve (edges sharded across processes, clouds
     frame-sharded); checked against the single-device on-device solver.

Usage: python multiprocess_worker.py PORT PROCESS_ID
Prints "MULTIPROC OK <pid>" on success.
"""

import os
import sys

PORT, PID = sys.argv[1], int(sys.argv[2])
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(f"127.0.0.1:{PORT}", num_processes=2,
                           process_id=PID)

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from unified_cvo_tpu.config import CvoParams  # noqa: E402
from unified_cvo_tpu.models import irls  # noqa: E402
from unified_cvo_tpu.ops import lie  # noqa: E402
from unified_cvo_tpu.utils.pointcloud import make_pointcloud  # noqa: E402

assert jax.device_count() == 8 and jax.local_device_count() == 4


def globalize(mesh, spec, x):
    """Host-identical numpy -> global sharded array (both processes build
    the same full value; each contributes its addressable shards)."""
    x = np.asarray(x)
    sh = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(x.shape, sh, lambda idx: x[idx])


def fetch(garr):
    """Assemble the full global value from this process's addressable
    shards (all layouts used here leave every global row addressable from
    both processes — replicated outright, or dp rows replicated over an
    sp column that has one device in each process)."""
    if getattr(garr, "is_fully_replicated", False):
        return np.asarray(garr.addressable_data(0))
    first = np.asarray(garr.addressable_data(0))
    out = np.zeros(garr.shape, first.dtype)
    covered = np.zeros(garr.shape, bool)
    for sh in garr.addressable_shards:
        out[sh.index] = np.asarray(sh.data)
        covered[sh.index] = True
    assert covered.all(), "global array not fully addressable here"
    return out


def cloud_tree(mesh, spec_fn, cloud):
    return jax.tree.map(
        lambda a: None if a is None else globalize(mesh, spec_fn(a.ndim), a),
        cloud)


# ---------------------------------------------------------------- fixtures

rng = np.random.default_rng(0)
params = CvoParams(ell_init=0.5, is_using_intensity=1, max_step=0.05)


def synthetic_pair(n, seed):
    r = np.random.default_rng(seed)
    xyz = np.stack([r.uniform(-8, 8, n), r.uniform(-2, 2, n),
                    r.uniform(1, 25, n)], axis=1).astype(np.float32)
    feats = np.abs(np.sin(xyz * 1.7)).astype(np.float32)
    th = 0.02
    R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                  [-np.sin(th), 0, np.cos(th)]], np.float32)
    t = np.array([0.05, 0.0, 0.3], np.float32)
    src = make_pointcloud(xyz, features=feats, bucket=n)
    tgt = make_pointcloud(xyz @ R.T + t, features=feats, bucket=n)
    return src, tgt


# ---------------------------------------------- A. DP/SP batched align step

from unified_cvo_tpu.parallel.sharded import (  # noqa: E402
    _align_iteration_local, make_batched_align_step)

devices = np.asarray(jax.devices())
# sp axis spans the two processes: column j of the (4, 2) mesh holds
# devices {i, i+4} = (process 0, process 1) — every sp psum crosses DCN
mesh2d = Mesh(devices.reshape(2, 4).T, ("dp", "sp"))

B, n = 4, 256
pairs = [synthetic_pair(n, seed) for seed in range(B)]
src_b = jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                     *[p[0] for p in pairs])
tgt_b = jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                     *[p[1] for p in pairs])


def bspec(point_axis):
    def fn(ndim):
        return P(*(("dp", point_axis) + (None,) * (ndim - 2)))
    return fn


step_fn = make_batched_align_step(params, mesh2d)
args = (
    cloud_tree(mesh2d, bspec(None), src_b),
    cloud_tree(mesh2d, bspec("sp"), tgt_b),
    globalize(mesh2d, P("dp"), np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))),
    globalize(mesh2d, P("dp"), np.zeros((B, 3), np.float32)),
    globalize(mesh2d, P("dp"), np.full((B,), 0.5, np.float32)),
)
R_new, T_new, metrics = step_fn(*args)
jax.block_until_ready(R_new)

for b in range(B):
    R1, T1, m1 = _align_iteration_local(
        params, None, pairs[b][0], pairs[b][1],
        jnp.eye(3, dtype=jnp.float32), jnp.zeros((3,), jnp.float32),
        jnp.float32(0.5))
    np.testing.assert_allclose(fetch(R_new)[b], np.asarray(R1), atol=1e-5)
    np.testing.assert_allclose(fetch(T_new)[b], np.asarray(T1), atol=1e-5)
    assert int(fetch(metrics["nonzeros"])[b]) == int(m1["nonzeros"])
print(f"[{PID}] batched align across processes: OK", flush=True)

# ------------------------------------------------- B. full sharded IRLS BA

from unified_cvo_tpu.parallel.sharded_irls import (  # noqa: E402
    make_sharded_irls_solver, pad_edges, pad_frames)

F, np_ = 5, 256
base = np.stack([rng.uniform(-2, 2, np_), rng.uniform(-2, 2, np_),
                 rng.uniform(-1, 1, np_)], axis=1).astype(np.float32)
clouds, init = [], []
for f in range(F):
    xi = 0.06 * np.random.default_rng(100 + f).normal(size=6).astype(np.float32)
    if f == 0:
        xi *= 0.0
    R, t = (np.asarray(v) for v in lie.se3_exp(jnp.asarray(xi), 1.0))
    clouds.append(make_pointcloud(((base - t) @ R).astype(np.float32),
                                  bucket=np_))
    init.append(np.eye(3, 4, dtype=np.float32))
stacked = irls.stack_clouds(clouds)
init = np.stack(init)
edges = [(i, j) for i in range(F) for j in range(i + 1, F)]
pivots = np.array([1.0] + [0.0] * (F - 1), np.float32)
ba = CvoParams(ell_init=0.5, multiframe_ell_init=0.5,
               multiframe_ell_min=0.15, multiframe_ell_decay_rate=0.8,
               multiframe_iterations_per_ell=3,
               multiframe_iterations_per_solve=4,
               multiframe_min_nonzeros=10, multiframe_max_iters=40)

# single-controller reference on the local default device
ref_poses, hist = irls.irls_solve(stacked, init, edges,
                                  [True] + [False] * (F - 1), ba,
                                  chunk=256, engine="device", backend="dense")

mesh1d = Mesh(devices, ("dp",))
solver = make_sharded_irls_solver(ba, mesh1d, chunk=256, frame_sharded=True)
ei, ej, valid = pad_edges(
    np.asarray([e[0] for e in edges], np.int32),
    np.asarray([e[1] for e in edges], np.int32), 8)
stacked_p = pad_frames(stacked, 8)
poses_sh, info = solver(
    jax.tree.map(
        lambda a: None if a is None else globalize(
            mesh1d, P(*("dp",) + (None,) * (np.asarray(a).ndim - 1)), a),
        stacked_p),
    globalize(mesh1d, P(), init),
    globalize(mesh1d, P("dp"), ei), globalize(mesh1d, P("dp"), ej),
    globalize(mesh1d, P("dp"), valid), globalize(mesh1d, P(), pivots))
jax.block_until_ready(poses_sh)
assert int(fetch(info["it"])) == hist[0]["iter"], (
    int(fetch(info["it"])), hist[0]["iter"])
np.testing.assert_allclose(fetch(poses_sh), np.asarray(ref_poses), atol=5e-4)
print(f"[{PID}] full sharded IRLS across processes: OK "
      f"(outer_iters={int(fetch(info['it']))} "
      f"final_ell={float(fetch(info['ell'])):.3f})", flush=True)

print(f"MULTIPROC OK {PID}", flush=True)
