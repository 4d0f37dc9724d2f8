"""Kernels K1 and K2: exact 3-D nearest valid sources, hand-written in CUDA.

Counterpart of ``tpu_joints/neighbors/pallas_knn.py::knn_pallas``: K1 is
its k=1 mode (``csrc/nn1.cu``), K2 its 2 <= k <= 32 mode (``csrc/knnk.cu``);
both instantiate the split-row kernel of ``csrc/knn_split.cuh``. K1 also
has the batch mode the TPU kernel gains under ``jax.vmap`` (the batch as an
outer grid axis): ``nn1_batched`` searches entry b of ``query [B, M, 3]`` in
entry b of ``source [B, N, 3]`` under ``source_mask [B, N]``, in one launch
(``tj_nn1_batched`` in ``csrc/nn1.cu``), equal bit for bit to B ``nn1``
calls. The same route builds ``csrc/unproject.cu``, the served depth
frame's kernel (``serve/depth.py::unproject``), and ``csrc/hv_greedy.cu``,
GO-HV's greedy search (``recognize/hv.py::hv_greedy``); neither replaces a
TPU kernel.
Each source is compiled with nvcc for ``sm_90a`` on first use into
``tpu_joints_torch/_build/`` (keyed by a hash of the source, the shared
headers and the flags) and
bound with ctypes -- no ninja, no PyTorch headers. :func:`build_all` starts
one nvcc per source at once.

Contract (kernels and plain versions): distance in difference form
``((dx²+dy²)+dz²)+pen`` with ``pen`` = 0 on valid sources and 3e38 on
masked ones; the k smallest per row in ascending order, ties to the lowest
source index; a slot without a valid source is ``(3e38, 0)``. Returns
``(dist_sq f32[M, k], idx i32[M, k])``.

:func:`knn_pallas` is the TPU kernel's own entry under its name and
signature: it sends k = 1 to ``nn1`` and 2 <= k <= 32 to ``knnk``.

``nn1``, ``nn1_batched`` and ``knnk`` pick by the query tensor's device
only: CPU tensors take the plain versions :func:`nn1_reference` /
:func:`nn1_batched_reference` / :func:`knnk_reference`, CUDA tensors launch
the kernel (a failed build or launch raises). ``nn1.launches``,
``nn1_batched.launches`` and ``knnk.launches`` count kernel launches, and
``<wrapper>.by_device`` (a Counter by card index) the same launches per
card; both under a lock, since a device mesh launches from one thread per
device.
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
from collections import Counter
from pathlib import Path
from typing import Optional, Tuple

import torch

INF = 3.0e38
MAX_K = 32                      # K2's largest k (the TPU kernel's range)

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# elements per [rows, N] block of the plain K1 (two such buffers live)
_NN1_ELEMS = 1 << 25
# elements per [rows, N] block of the plain K2 (its sort keeps several)
_BLOCK_ELEMS = 1 << 24
_NVCC_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a", "--fmad=false",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC")
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# source file -> {C entry point: its argument types}; the wrapper ``name``
# launches entry ``tj_<name>``
_ENTRY = {"nn1": {"tj_nn1": [_P] * 5 + [_I, _I, _P],
                  "tj_nn1_batched": [_P] * 5 + [_I, _I, _I, _P]},
          "knnk": {"tj_knnk": [_P] * 5 + [_I, _I, _I, _P]},
          "unproject": {"tj_unproject": [_P] * 6 + [_I] * 3 + [_F] * 3
                        + [_P]},
          "hv_greedy": {"tj_hv_greedy": [_P] * 7 + [_I] * 3 + [_F] * 2
                        + [_P]}}
_SOURCE_OF = {entry[3:]: src for src, entries in _ENTRY.items()
              for entry in entries}
_build_lock = threading.Lock()
_count_lock = threading.Lock()


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


def _library_path(name: str) -> Path:
    """Where the shared library for kernel ``name``'s source, the shared
    headers it may include (every ``csrc/*.cuh``) and the flags lives."""
    h = hashlib.sha256((_CSRC / f"{name}.cu").read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(_NVCC_FLAGS).encode())
    return _BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def _compile(names) -> None:
    """Build every named kernel whose library is missing, one nvcc process
    each, all started together. Raises with the compiler's output."""
    todo = [n for n in names if not _library_path(n).exists()]
    if not todo:
        return
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *_NVCC_FLAGS, "-o", tmp, str(_CSRC / f"{name}.cu")]
        jobs.append((name, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, tmp, cmd, proc in jobs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                          f"{out}\n{err}")
        else:
            os.replace(tmp, _library_path(name))
    if failed:
        raise RuntimeError("\n".join(failed))


@functools.lru_cache(maxsize=None)
def load_library(name: str = "nn1") -> ctypes.CDLL:
    """Build (once per source hash) source ``name`` and bind its C launchers.

    Raises ``RuntimeError`` with the compiler's output if nvcc fails.
    """
    with _build_lock:
        _compile([name])
        lib = ctypes.CDLL(str(_library_path(name)))
    for entry, argtypes in _ENTRY[name].items():
        fn = getattr(lib, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return lib


def build_all() -> None:
    """Build every kernel library of this module in parallel (K1, K2,
    ``unproject`` and ``hv_greedy``) and bind them."""
    with _build_lock:
        _compile(_ENTRY)
    for name in _ENTRY:
        load_library(name)


def _check(name: str, query: torch.Tensor, source: torch.Tensor,
           source_mask: Optional[torch.Tensor], batch: bool = False
           ) -> torch.Tensor:
    """Validate a ([B,] M, 3) query against a ([B,] N, 3) source; returns
    the mask ([B,] N), all true when none was given."""
    nd = 3 if batch else 2
    lead = "[B, " if batch else "["
    if query.ndim != nd or query.shape[-1] != 3 or source.ndim != nd \
            or source.shape[-1] != 3 or query.shape[:-2] != source.shape[:-2]:
        raise ValueError(f"{name} takes {lead}M, 3] and {lead}N, 3] points, "
                         f"got {tuple(query.shape)} and {tuple(source.shape)}")
    if query.dtype != torch.float32 or source.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 points")
    if source.shape[-2] == 0:
        raise ValueError(f"{name} needs at least one source point")
    if source_mask is None:
        source_mask = torch.ones(source.shape[:-1], dtype=torch.bool,
                                 device=source.device)
    if source_mask.shape != source.shape[:-1] or source_mask.dtype != torch.bool:
        raise ValueError(f"source_mask must be bool{lead}N]")
    if not (query.device == source.device == source_mask.device):
        raise ValueError(f"{name} inputs must share one device")
    return source_mask


def _launch(wrapper, query: torch.Tensor, source: torch.Tensor,
            source_mask: torch.Tensor, k: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel of ``wrapper`` (``nn1``, ``nn1_batched`` or
    ``knnk``) on the current stream, raise if it is refused, and count the
    launch on the wrapper. Inputs carry a leading batch axis for
    ``nn1_batched`` only."""
    name = wrapper.__name__
    if query.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {query.device}")
    lib = load_library(_SOURCE_OF[name])
    q = query.contiguous()
    s = source.contiguous()
    m = source_mask.contiguous().view(torch.uint8)
    lead = tuple(q.shape[:-2])              # () or (B,)
    M, N = q.shape[-2], s.shape[-2]
    out_d = torch.empty(lead + (M, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty(lead + (M, k), dtype=torch.int32, device=q.device)
    if out_d.numel() == 0:
        return out_d, out_i
    args = [q.data_ptr(), s.data_ptr(), m.data_ptr(), out_d.data_ptr(),
            out_i.data_ptr(), *lead, M, N] + ([k] if name == "knnk" else [])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = getattr(lib, f"tj_{name}")(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {rc}")
    with _count_lock:
        wrapper.launches += 1
        wrapper.by_device[q.device.index] += 1
    return out_d, out_i


def _penalty(source_mask: torch.Tensor) -> torch.Tensor:
    return torch.where(source_mask, 0.0, INF).to(torch.float32)


def _columns(source: torch.Tensor):
    """The x, y, z columns of ``source`` [N, 3], each contiguous."""
    return tuple(source[:, c].contiguous() for c in range(3))


def _difference_form(q: torch.Tensor, cols, pen: torch.Tensor) -> torch.Tensor:
    """[rows, N] ((dx²+dy²)+dz²)+pen, rounded op by op like the kernels,
    over the source columns ``cols`` (``_columns``); in place, in one
    [rows, N] buffer and one scratch."""
    d = q[:, 0:1] - cols[0]
    d.mul_(d)
    t = q[:, 1:2] - cols[1]
    t.mul_(t)
    d.add_(t)
    torch.sub(q[:, 2:3], cols[2], out=t)
    t.mul_(t)
    d.add_(t)
    return d.add_(pen)


def nn1_reference(query: torch.Tensor, source: torch.Tensor,
                  source_mask: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1, op by op the same arithmetic."""
    source_mask = _check("nn1", query, source, source_mask)
    pen = _penalty(source_mask)
    cols = _columns(source)
    rows = max(1, _NN1_ELEMS // max(source.shape[0], 1))
    ds, js = [], []
    for r in range(0, query.shape[0], rows):
        v, a = _difference_form(query[r:r + rows], cols, pen).min(dim=1)
        ds.append(v)                 # first index of the minimum
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
    source_mask = _check("nn1", query, source, source_mask)
    if query.device.type == "cpu":
        return nn1_reference(query, source, source_mask)
    return _launch(nn1, query, source, source_mask, 1)


nn1.launches = 0
nn1.by_device = Counter()


def nn1_batched_reference(query: torch.Tensor, source: torch.Tensor,
                          source_mask: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1's batch mode: :func:`nn1_reference` per
    batch entry, stacked."""
    source_mask = _check("nn1_batched", query, source, source_mask, batch=True)
    if query.shape[0] == 0:
        z = query.new_zeros((0, query.shape[1], 1))
        return z, z.to(torch.int32)
    per = [nn1_reference(q, s, m)
           for q, s, m in zip(query, source, source_mask)]
    return torch.stack([d for d, _ in per]), torch.stack([i for _, i in per])


def nn1_batched(query: torch.Tensor, source: torch.Tensor,
                source_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest valid source of the SAME batch entry per query row:
    ``query [B, M, 3]``, ``source [B, N, 3]``, ``source_mask bool[B, N]`` →
    ``(dist_sq f32[B, M, 1], idx i32[B, M, 1])``, indices within the entry.
    One K1 launch on CUDA (the batch on the grid's second axis), plain on
    the CPU; equal bit for bit to B :func:`nn1` calls."""
    source_mask = _check("nn1_batched", query, source, source_mask, batch=True)
    if query.device.type == "cpu":
        return nn1_batched_reference(query, source, source_mask)
    return _launch(nn1_batched, query, source, source_mask, 1)


nn1_batched.launches = 0
nn1_batched.by_device = Counter()


def _check_k(k: int) -> None:
    if not 2 <= k <= MAX_K:
        raise ValueError(f"knnk takes 2 <= k <= {MAX_K}, got k={k}")


def knnk_reference(query: torch.Tensor, source: torch.Tensor, k: int,
                   source_mask: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2: the same distances, op by op, then the
    first k of a stable sort of each row (ties to the lowest index)."""
    _check_k(k)
    source_mask = _check("knnk", query, source, source_mask)
    pen = _penalty(source_mask)
    M, N = query.shape[0], source.shape[0]
    kk = min(k, N)
    rows = max(1, _BLOCK_ELEMS // N)
    cols = _columns(source)
    ds, js = [], []
    for r in range(0, M, rows):
        d = _difference_form(query[r:r + rows], cols, pen)
        v, a = torch.sort(d, dim=1, stable=True)
        ds.append(v[:, :kk])
        js.append(a[:, :kk])
    v = torch.cat(ds) if ds else query.new_zeros((0, kk))
    a = torch.cat(js) if js else query.new_zeros((0, kk), dtype=torch.int64)
    if kk < k:                       # fewer sources than slots
        v = torch.cat([v, v.new_full((M, k - kk), INF)], 1)
        a = torch.cat([a, a.new_zeros((M, k - kk))], 1)
    take = v < INF                   # the kernel's strict '<' against (3e38, 0)
    dist = torch.where(take, v, torch.full_like(v, INF))
    idx = torch.where(take, a, torch.zeros_like(a)).to(torch.int32)
    return dist, idx


def knnk(query: torch.Tensor, source: torch.Tensor, k: int,
         source_mask: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest valid sources per query row, ascending, 2 <= k <= 32: K2 on
    CUDA, plain on the CPU."""
    _check_k(k)
    source_mask = _check("knnk", query, source, source_mask)
    if query.device.type == "cpu":
        return knnk_reference(query, source, k, source_mask)
    return _launch(knnk, query, source, source_mask, k)


knnk.launches = 0
knnk.by_device = Counter()


def knn_pallas(query: torch.Tensor, source: torch.Tensor, k: int,
               source_mask: Optional[torch.Tensor] = None, tm: int = 256,
               tn: int = 2048, interpret: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN over 3-D points under the TPU kernel's name and contract:
    ``(dist_sq f32[M, k], idx i32[M, k])``, a slot without a valid source
    ``(3e38, 0)``. k = 1 runs K1 (:func:`nn1`), 2 <= k <= 32 K2
    (:func:`knnk`), each choosing its kernel or plain version by the
    tensor's device. ``tm``, ``tn`` (the TPU's tiles) and ``interpret``
    (Pallas's interpret mode) are accepted and ignored."""
    del tm, tn, interpret
    if not 1 <= k <= MAX_K:
        raise ValueError(f"knn_pallas takes 1 <= k <= {MAX_K}, got k={k}")
    if k == 1:
        return nn1(query, source, source_mask)
    return knnk(query, source, k, source_mask)


def pallas_available() -> bool:
    """True when a CUDA card is visible and every kernel library of this
    module builds and binds."""
    if not torch.cuda.is_available():
        return False
    try:
        build_all()
    except (RuntimeError, OSError):
        return False
    return True
