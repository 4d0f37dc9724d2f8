"""ctypes binding + on-demand build of the native host library (counterpart
of ``tpu_joints/native/loader.py``).

The C++ source (``src/tpujoints_native.cpp``, the reference's, byte for
byte) exposes a plain C ABI. It is compiled with g++ on first use into
``tpu_joints_torch/_build/``, keyed by a hash of the source and the flags,
as the CUDA kernels are; nothing prebuilt ships. Every entry point returns
None when the library cannot be built or loaded, and its callers then take
their Python path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "src" / "tpujoints_native.cpp"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# no -march=native: the library must not fault if the checkout moves to
# another CPU; nothing here is SIMD-bound
_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
_ABI = 1

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _library_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return _BUILD_DIR / f"libtpujoints_{h.hexdigest()[:16]}.so"


def _build(path: Path) -> bool:
    """Compile into a temporary file, then move it into place, so that
    a concurrent process never loads a half-written library."""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", tmp], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, path)
        return True
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.unlink(tmp)
        return False


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.tj_abi_version.restype = ctypes.c_int
    lib.tj_free.argtypes = [ctypes.c_void_p]
    lib.tj_load_pcd.restype = ctypes.c_int
    lib.tj_load_pcd.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_long),
    ]
    lib.tj_ingest.restype = ctypes.c_long
    lib.tj_ingest.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_long,
        ctypes.c_float,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.tj_depth_to_cloud.restype = None
    lib.tj_depth_to_cloud.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_long,
        ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.POINTER(ctypes.c_float),
    ]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library, building it if needed; None when unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _library_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = _bind(ctypes.CDLL(str(path)))
        except OSError:
            return None
        if lib.tj_abi_version() == _ABI:
            _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def load_pcd_native(path: str
                    ) -> Optional[Tuple[np.ndarray, Optional[np.ndarray]]]:
    """(xyz[N,3], rgb[N,3] or None), or None if the library can't parse it."""
    lib = get_lib()
    if lib is None:
        return None
    xyz_p = ctypes.POINTER(ctypes.c_float)()
    rgb_p = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_long()
    rc = lib.tj_load_pcd(path.encode(), ctypes.byref(xyz_p),
                         ctypes.byref(rgb_p), ctypes.byref(n))
    if rc != 0:
        return None
    try:
        npts = n.value
        xyz = np.ctypeslib.as_array(xyz_p, shape=(npts, 3)).copy()
        rgb = (np.ctypeslib.as_array(rgb_p, shape=(npts, 3)).copy()
               if rgb_p else None)
    finally:
        lib.tj_free(xyz_p)
        if rgb_p:
            lib.tj_free(rgb_p)
    return xyz, rgb


def ingest_native(xyz: np.ndarray, capacity: int, sentinel: float = 1.0e6
                  ) -> Optional[Tuple[np.ndarray, np.ndarray, int]]:
    """NaN filter + even-stride subsample + sentinel pad, in C++.

    Returns (padded [capacity,3], mask [capacity] bool, n_valid) or None.
    """
    lib = get_lib()
    if lib is None:
        return None
    xyz = np.ascontiguousarray(xyz, np.float32).reshape(-1, 3)
    out = np.empty((capacity, 3), np.float32)
    mask = np.empty(capacity, np.uint8)
    n = lib.tj_ingest(_fptr(xyz), xyz.shape[0], capacity,
                      ctypes.c_float(sentinel), _fptr(out),
                      mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out, mask.astype(bool), int(n)


def depth_to_cloud_native(depth: np.ndarray, fov_deg: float = 57.0,
                          near: float = 0.0, far: float = 0.0
                          ) -> Optional[np.ndarray]:
    """``serve.depth.depth_to_cloud`` in C++, or None."""
    lib = get_lib()
    if lib is None:
        return None
    depth = np.ascontiguousarray(depth, np.float32)
    h, w = depth.shape
    out = np.empty((h, w, 3), np.float32)
    lib.tj_depth_to_cloud(_fptr(depth), h, w, ctypes.c_float(fov_deg),
                          ctypes.c_float(near), ctypes.c_float(far),
                          _fptr(out))
    return out
