"""ctypes bindings for the native C++ runtime components (native/).

Gracefully degrades: `available()` is False when libcvo_native.so hasn't
been built (`make -C native`), and callers fall back to the OpenCV/NumPy
paths.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_LIB_PATH = os.path.join(_REPO_ROOT, "native", "libcvo_native.so")
_lib: Optional[ctypes.CDLL] = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    lib.cvo_sgm_disparity.restype = ctypes.c_int
    lib.cvo_sgm_disparity.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.POINTER(ctypes.c_float),
    ]
    lib.cvo_voxel_downsample.restype = ctypes.c_int
    lib.cvo_voxel_downsample.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_float,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.cvo_loader_create.restype = ctypes.c_void_p
    lib.cvo_loader_create.argtypes = [ctypes.c_int]
    lib.cvo_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.cvo_loader_submit.restype = ctypes.c_int64
    lib.cvo_loader_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.cvo_loader_wait.restype = ctypes.c_int64
    lib.cvo_loader_wait.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p,
    ]
    lib.cvo_loader_fetch.restype = ctypes.c_int
    lib.cvo_loader_fetch.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
    ]
    lib.cvo_read_npy_header.restype = ctypes.c_int64
    lib.cvo_read_npy_header.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p,
    ]
    lib.cvo_read_npy.restype = ctypes.c_int
    lib.cvo_read_npy.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64]
    _lib = lib
    return lib


def build(verbose: bool = False) -> bool:
    """Compile the native library in place. Returns success."""
    try:
        out = subprocess.run(
            ["make", "-C", os.path.join(_REPO_ROOT, "native")],
            capture_output=not verbose, check=True,
        )
        return os.path.exists(_LIB_PATH)
    except Exception:
        return False


def available() -> bool:
    return _load() is not None


def sgm_disparity(left: np.ndarray, right: np.ndarray, max_disp: int = 128,
                  p1: int = 10, p2: int = 120, uniqueness: float = 0.1):
    """Census/SGM left disparity [H,W] float32 (<=0 invalid), native C++."""
    lib = _load()
    if lib is None:
        raise RuntimeError("libcvo_native.so not built (run `make -C native`)")
    left = np.ascontiguousarray(left, np.uint8)
    right = np.ascontiguousarray(right, np.uint8)
    assert left.shape == right.shape and left.ndim == 2
    h, w = left.shape
    out = np.empty((h, w), np.float32)
    rc = lib.cvo_sgm_disparity(
        left.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        right.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h, w, max_disp, p1, p2, ctypes.c_float(uniqueness),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if rc != 0:
        raise RuntimeError(f"cvo_sgm_disparity failed: {rc}")
    return out


def voxel_downsample_indices(xyz: np.ndarray, voxel: float) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError("libcvo_native.so not built (run `make -C native`)")
    xyz = np.ascontiguousarray(xyz, np.float32).reshape(-1, 3)
    out = np.empty(len(xyz), np.int32)
    n = lib.cvo_voxel_downsample(
        xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(xyz),
        ctypes.c_float(voxel), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out[:n]


_DTYPES = {b"f": np.float32, b"d": np.float64, b"u": np.uint8,
           b"q": np.int64, b"h": np.int16}


def read_npy(path: str) -> np.ndarray:
    """Native npy reader (the cnpy twin, reference thirdparty/cnpy/cnpy.cpp)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("libcvo_native.so not built (run `make -C native`)")
    ndim = ctypes.c_int()
    shape = (ctypes.c_int64 * 8)()
    dt = ctypes.create_string_buffer(1)
    nbytes = lib.cvo_read_npy_header(path.encode(), ctypes.byref(ndim), shape, dt)
    if nbytes == 0:
        raise IOError(f"cvo_read_npy_header failed for {path}")
    out = np.empty(nbytes, np.uint8)
    rc = lib.cvo_read_npy(path.encode(), out.ctypes.data_as(ctypes.c_char_p), nbytes)
    if rc != 0:
        raise IOError(f"cvo_read_npy failed ({rc}) for {path}")
    arr = out.view(_DTYPES[dt.raw[:1]])
    return arr.reshape(tuple(shape[i] for i in range(ndim.value)))


class PrefetchLoader:
    """Threaded native file prefetcher: overlaps disk IO (npy / raw-f32 .bin)
    with device compute. The reference's data path is synchronous C++
    inside the drivers; here odometry apps submit frame k+1 while the
    accelerator registers frame k."""

    RAW_F32 = 0
    NPY = 1

    def __init__(self, n_workers: int = 2):
        lib = _load()
        if lib is None:
            raise RuntimeError("libcvo_native.so not built (run `make -C native`)")
        self._lib = lib
        self._h = lib.cvo_loader_create(n_workers)

    def submit(self, path: str, kind: int) -> int:
        return self._lib.cvo_loader_submit(self._h, path.encode(), kind)

    def get(self, ticket: int) -> np.ndarray:
        ndim = ctypes.c_int()
        shape = (ctypes.c_int64 * 8)()
        dt = ctypes.create_string_buffer(1)
        nbytes = self._lib.cvo_loader_wait(
            self._h, ticket, ctypes.byref(ndim), shape, dt
        )
        if nbytes == 0:
            raise IOError(f"prefetch read failed (ticket {ticket})")
        out = np.empty(nbytes, np.uint8)
        rc = self._lib.cvo_loader_fetch(
            self._h, ticket, out.ctypes.data_as(ctypes.c_char_p), nbytes
        )
        if rc != 0:
            raise IOError(f"prefetch fetch failed ({rc})")
        arr = out.view(_DTYPES[dt.raw[:1]])
        return arr.reshape(tuple(shape[i] for i in range(ndim.value)))

    def close(self):
        if self._h:
            self._lib.cvo_loader_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
