"""unified_cvo_tpu — continuous visual odometry & registration in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
UMich-CURLY/unified_cvo (RKHS correspondence-free registration): point clouds
are lifted to functions f(X) = sum_i l_i k(., x_i) in a reproducing-kernel
Hilbert space and registration maximizes <f(X), f(TY)> over SE(3) by gradient
flow (reference: README.md:1-17).

Sub-packages
------------
ops       : Lie-group math, cubic solver, fused pairwise-kernel reductions
models    : pairwise aligner (gradient flow), multiframe IRLS BA, pose graph
frontend  : image/stereo/RGB-D/lidar -> feature point clouds
datasets  : KITTI / TUM / TartanAir / PCD IO
parallel  : mesh sharding, batched f2f alignment, distributed BA
utils     : point-cloud containers, voxel grid, trajectory metrics
"""

import os as _os

import jax as _jax

# Registration math is cancellation-heavy (pose chains, moment contractions,
# kernel distances at scene-coordinate magnitudes). An f32 matmul left at the
# default precision may run in TF32 on a GPU (~3 decimal digits: ~0.05%
# rounding of a rotation entry per composition). The hot kernels pin their
# precision explicitly; this covers every small pose/moment matmul elsewhere
# at negligible cost.
_jax.config.update("jax_default_matmul_precision", "highest")

# Persistent compilation cache, so drivers, benches, and tests pay a cold
# compile once per program shape. JAX_COMPILATION_CACHE_DIR, when set, is
# used as it is; otherwise the cache lives at one fixed directory inside the
# checkout (listed in .gitignore). Opt out with UNIFIED_CVO_NO_COMPILE_CACHE=1.
CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache")

if not _os.environ.get("UNIFIED_CVO_NO_COMPILE_CACHE"):
    if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        _jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from unified_cvo_tpu.config import CvoParams, read_cvo_params_yaml

__version__ = "0.1.0"
