"""Kernel K1: exact 3-D nearest valid source (k = 1), hand-written in CUDA.

Counterpart of ``tpu_joints/neighbors/pallas_knn.py::knn_pallas`` in its
k=1 mode. The CUDA source is ``csrc/nn1.cu``; it is compiled with nvcc for
``sm_90a`` on first use into ``tpu_joints_torch/_build/`` (keyed by a hash of
the source and flags) and bound with ctypes -- no ninja, no PyTorch headers.

Contract (both versions): distance in difference form
``((dx²+dy²)+dz²)+pen`` with ``pen`` = 0 on valid sources and 3e38 on masked
ones; ties go to the lowest source index; a row with no valid source gets
``(3e38, 0)``. Returns ``(dist_sq f32[M, 1], idx i32[M, 1])``.

``nn1`` picks by the query tensor's device only: CPU tensors take the plain
version :func:`nn1_reference`, CUDA tensors launch the kernel (a failed build
or launch raises). ``nn1.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import torch

INF = 3.0e38

_SRC = Path(__file__).resolve().parent / "csrc" / "nn1.cu"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# query rows per block of the plain version: bounds its [rows, N] temporaries
_ROWS = 4096
_NVCC_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a", "--fmad=false",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC")
_build_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc"]:
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def _library_path() -> Path:
    """Where the shared library for the current source and flags lives."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_NVCC_FLAGS).encode())
    return _BUILD_DIR / f"nn1_{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and bind the kernel's C launcher.

    Raises ``RuntimeError`` with the compiler's output if nvcc fails.
    """
    with _build_lock:
        lib_path = _library_path()
        if not lib_path.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
            os.close(fd)
            cmd = [_nvcc(), *_NVCC_FLAGS, "-o", tmp, str(_SRC)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                    f"{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, lib_path)
        lib = ctypes.CDLL(str(lib_path))
    lib.tj_nn1.restype = ctypes.c_int
    lib.tj_nn1.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                                   ctypes.c_void_p]
    return lib


def _check(query: torch.Tensor, source: torch.Tensor,
           source_mask: Optional[torch.Tensor]) -> torch.Tensor:
    if query.ndim != 2 or query.shape[1] != 3 or source.ndim != 2 \
            or source.shape[1] != 3:
        raise ValueError(f"nn1 takes [M, 3] and [N, 3] points, got "
                         f"{tuple(query.shape)} and {tuple(source.shape)}")
    if query.dtype != torch.float32 or source.dtype != torch.float32:
        raise TypeError("nn1 takes float32 points")
    if source.shape[0] == 0:
        raise ValueError("nn1 needs at least one source point")
    if source_mask is None:
        source_mask = torch.ones(source.shape[0], dtype=torch.bool,
                                 device=source.device)
    if source_mask.shape != (source.shape[0],) or source_mask.dtype != torch.bool:
        raise ValueError("source_mask must be bool[N]")
    if not (query.device == source.device == source_mask.device):
        raise ValueError("nn1 inputs must share one device")
    return source_mask


def nn1_reference(query: torch.Tensor, source: torch.Tensor,
                  source_mask: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, op by op the same arithmetic."""
    source_mask = _check(query, source, source_mask)
    pen = torch.where(source_mask, 0.0, INF).to(torch.float32)
    sx, sy, sz = source[:, 0], source[:, 1], source[:, 2]
    ds, js = [], []
    for r in range(0, query.shape[0], _ROWS):
        q = query[r:r + _ROWS]
        dx = q[:, 0:1] - sx
        dy = q[:, 1:2] - sy
        dz = q[:, 2:3] - sz
        d = dx * dx + dy * dy + dz * dz + pen
        v, a = d.min(dim=1)          # first index of the minimum
        ds.append(v)
        js.append(a)
    if not ds:
        z = query.new_zeros((0, 1))
        return z, z.to(torch.int32)
    v, a = torch.cat(ds), torch.cat(js)
    take = v < INF                   # the kernel's strict '<' against (3e38, 0)
    dist = torch.where(take, v, torch.full_like(v, INF))
    idx = torch.where(take, a, torch.zeros_like(a)).to(torch.int32)
    return dist[:, None], idx[:, None]


def nn1(query: torch.Tensor, source: torch.Tensor,
        source_mask: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest valid source per query row: K1 on CUDA, plain on the CPU."""
    source_mask = _check(query, source, source_mask)
    if query.device.type == "cpu":
        return nn1_reference(query, source, source_mask)
    if query.device.type != "cuda":
        raise ValueError(f"nn1 runs on cpu or cuda, not {query.device}")
    lib = load_library()
    q = query.contiguous()
    s = source.contiguous()
    m = source_mask.contiguous().view(torch.uint8)
    M, N = q.shape[0], s.shape[0]
    out_d = torch.empty((M, 1), dtype=torch.float32, device=q.device)
    out_i = torch.empty((M, 1), dtype=torch.int32, device=q.device)
    if M == 0:
        return out_d, out_i
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = lib.tj_nn1(q.data_ptr(), s.data_ptr(), m.data_ptr(),
                        out_d.data_ptr(), out_i.data_ptr(), M, N, stream)
    if rc != 0:
        raise RuntimeError(f"nn1 kernel launch failed: cudaError_t {rc}")
    nn1.launches += 1
    return out_d, out_i


nn1.launches = 0
