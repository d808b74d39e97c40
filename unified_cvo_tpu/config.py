"""Runtime hyper-parameters for CVO registration.

Mirrors the reference's flat YAML -> POD parameter system
(reference: include/UnifiedCvo/cvo/CvoParams.hpp:12-128, reader :193-303).
Defaults replicate the C++ constructor defaults (CvoParams.hpp:73-128).

The reference's compile-time template parameters (FEATURE_DIMENSIONS,
NUM_CLASSES, CVO_POINT_NEIGHBORS; reference CMakeLists.txt:498,513) become
static array shapes captured at jit-trace time here, so one binary serves all
modalities.
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass(frozen=True)
class CvoParams:
    """Frozen (hashable) so a params object can be a jit static argument."""
    # lengthscale schedule (reference CvoParams.hpp:14-19)
    ell_init_first_frame: float = 0.5
    ell_init: float = 0.5
    ell_min: float = 0.05
    min_ell_iter_limit: int = 1
    ell_max: float = 1.2
    dl: float = 0.0            # adaptive-ell only
    dl_step: float = 0.3
    # kernel shape (reference CvoParams.hpp:20-27)
    sigma: float = 0.1         # geometric kernel signal std
    sp_thres: float = 0.0006   # sparsification threshold on the kernel value
    c: float = 7.0             # so(3) flow scale
    d: float = 7.0             # R^3 flow scale
    c_ell: float = 0.15        # color kernel lengthscale
    c_sigma: float = 0.6       # color kernel signal std
    s_ell: float = 0.1         # semantic kernel lengthscale
    s_sigma: float = 0.8       # semantic kernel signal std
    # iteration control (reference CvoParams.hpp:28-33)
    MAX_ITER: int = 10000
    eps: float = 0.00005       # flow-norm convergence threshold
    eps_2: float = 0.000012    # se(3) step-distance convergence threshold
    min_step: float = 2e-5
    max_step: float = 0.8      # reference reads this from yaml; clamp ceiling
    step: float = 0.0
    # neighbor cap / ell decay (reference CvoParams.hpp:35-43)
    nearest_neighbors_max: int = 512
    ell_decay_rate: float = 0.9
    ell_decay_rate_first_frame: float = 0.99
    ell_decay_start: int = 30
    ell_decay_start_first_frame: int = 300
    indicator_window_size: int = 15
    indicator_stable_threshold: float = 0.2
    # feature switches (reference CvoParams.hpp:46-59)
    is_pcl_visualization_on: int = 0
    is_using_least_square: int = 0
    is_ell_adaptive: int = 0
    is_full_ip_matrix: int = 0
    is_using_geometry: int = 1
    is_using_intensity: int = 0
    is_using_semantics: int = 0
    is_using_range_ell: int = 0
    is_using_kdtree: int = 0
    is_exporting_association: int = 0
    is_using_geometric_type: int = 0
    # multiframe IRLS BA (reference CvoParams.hpp:62-75)
    multiframe_using_cpu: int = 1
    multiframe_max_iters: int = 200
    multiframe_ell_init: float = 0.15
    multiframe_ell_min: float = 0.05
    multiframe_iter_per_ell: int = 10
    multiframe_ell_decay_rate: float = 0.7
    multiframe_iterations_per_ell: int = 50
    multiframe_iterations_per_solve: int = 8
    multiframe_expected_points: int = 1000
    multiframe_downsample_voxel_size: float = 0.5
    multiframe_num_neighbors: int = 128
    multiframe_least_squares_num_threads: int = 24
    multiframe_min_nonzeros: int = 300

    def replace(self, **kw) -> "CvoParams":
        return dataclasses.replace(self, **kw)

    def first_frame(self) -> "CvoParams":
        """Parameter swap used for the sequence-start frame.

        Reference: main_cvo_gpu_align_raw_image.cpp:40-46 swaps
        ell_init/ell_decay_rate/ell_decay_start for their *_first_frame twins.
        """
        return self.replace(
            ell_init=self.ell_init_first_frame,
            ell_decay_rate=self.ell_decay_rate_first_frame,
            ell_decay_start=self.ell_decay_start_first_frame,
        )


_FIELD_TYPES = {f.name: f.type for f in dataclasses.fields(CvoParams)}


PRESET_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "presets")


def parse_flat_params(text: str) -> dict:
    """Parse the flat `key: value` preset format of the reference's
    cvo_params/*.yaml files (read by CvoParams.hpp:193-303 through
    cv::FileStorage): an optional `%YAML:1.0` directive and `---` marker,
    `#` comments, one scalar per line. Values come back as int, float, or
    the bare string (OpenCV writes booleans as True/False words)."""
    out = {}
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.split("#", 1)[0].strip()
        if not line or line.startswith("%") or line == "---":
            continue
        key, sep, value = line.partition(":")
        key, value = key.strip(), value.strip().strip("'\"")
        if not sep or not key:
            raise ValueError(f"line {lineno}: expected 'key: value', got {raw!r}")
        for cast in (int, float):
            try:
                out[key] = cast(value)
                break
            except ValueError:
                continue
        else:
            out[key] = value
    return out


def _coerce(want, value):
    if want in ("int", int):
        if isinstance(value, str):
            return int(value.lower() in ("true", "1", "yes"))
        return int(value)
    if want in ("float", float):
        return float(value)
    return value


def read_cvo_params_yaml(path: str) -> CvoParams:
    """Load a reference-format preset file (reference CvoParams.hpp:193-303).

    Unknown keys are ignored; missing keys keep their defaults, matching the
    reference reader's every-field-optional behavior.
    """
    with open(path) as f:
        data = parse_flat_params(f.read())
    return CvoParams().replace(**{
        k: _coerce(_FIELD_TYPES[k], v) for k, v in data.items()
        if k in _FIELD_TYPES})


def preset_path(name: str) -> str:
    """Path of an in-repo preset, by its reference file name (with or
    without the .yaml suffix), e.g. 'cvo_geometric_params_img_gpu0'."""
    base = name if name.endswith(".yaml") else name + ".yaml"
    path = os.path.join(PRESET_DIR, base)
    if not os.path.exists(path):
        known = sorted(f[:-5] for f in os.listdir(PRESET_DIR)
                       if f.endswith(".yaml"))
        raise FileNotFoundError(f"no preset {name!r}; known: {known}")
    return path


def load_preset(name: str) -> CvoParams:
    """CvoParams from an in-repo preset (see preset_path)."""
    return read_cvo_params_yaml(preset_path(name))
