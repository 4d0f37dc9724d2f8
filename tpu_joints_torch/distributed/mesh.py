"""Device meshes, placements and collectives, driven from one process
(counterpart of ``tpu_joints/distributed/mesh.py``).

As under JAX's single-controller model, one Python process drives every
device of a 2-D ``(data, model)`` mesh:

  * ``data``  — scene-batch data parallelism: each data row runs the whole
    pipeline on its share of the scenes;
  * ``model`` — descriptor-bank sharding: each model column holds a block
    of the bank's views, so matching runs per view block.

A mesh is a grid of ``torch.device``; an explicit ``devices`` list may name
one device more than once (the CPU tests stand eight entries of the CPU in
for eight devices). There is no compiler to insert collectives, so they are
written out as plain tensor movement in a fixed order:

  * ``ppermute``   — ``.to(next_device, non_blocking=True)`` around a ring;
  * ``psum``       — a sum in shard order on the axis' first device
    (:func:`psum`), copied on to the others where they need it;
  * ``all_gather`` — concatenation on the axis' first device
    (:func:`all_gather`, :meth:`Placed.gather`).

None of them reads a value to the host. :func:`run_on` issues the work of
each device from its own thread under that device (and its current
stream), so that one shard's host reads do not stall another device's.
"""
from __future__ import annotations

import contextlib
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """A ``(data, model)`` grid of torch devices: ``devices[r, c]``."""

    def __init__(self, devices: np.ndarray):
        self.devices = devices

    @property
    def shape(self) -> dict:
        d, m = self.devices.shape
        return {DATA_AXIS: d, MODEL_AXIS: m}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis``: the first row's for ``model``, the
        first column's for ``data``."""
        if axis == MODEL_AXIS:
            return list(self.devices[0, :])
        if axis == DATA_AXIS:
            return list(self.devices[:, 0])
        raise ValueError(f"unknown mesh axis {axis!r}")


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A 2-D ``(data, model)`` mesh: ``model_parallel`` must divide the
    device count, the remaining factor is the data axis.

    ``devices`` defaults to every visible card (``cuda:0..n-1``) and raises
    without one; an explicit list may name the CPU or a device more than
    once. A device that names a card the process cannot see raises, and so
    does asking for more devices than the list holds: nothing falls back to
    fewer devices or to the CPU.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass devices= "
                               "(for example [torch.device('cpu')] * 8)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    for d in devices:
        if d.type != "cuda":
            continue
        if d.index is None:
            raise ValueError(f"name a card by its index ({d}:0, ...)")
        if not torch.cuda.is_available() or d.index >= torch.cuda.device_count():
            raise RuntimeError(f"mesh names {d}, which this process cannot "
                               f"see")
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"asked for {n_devices} devices, "
                             f"{len(devices)} available")
        devices = devices[:n_devices]
    n = len(devices)
    if n == 0 or n % model_parallel != 0:
        raise ValueError(f"model_parallel={model_parallel} must divide {n} "
                         f"devices")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(n // model_parallel, model_parallel))


class Sharding(NamedTuple):
    """Where the pieces of an array live: its leading axis split over the
    mesh axis ``axis`` (each device of the other axis holding a copy), or
    the whole array on every device (``axis`` None)."""

    mesh: Mesh
    axis: Optional[str]


def scene_sharding(mesh: Mesh) -> Sharding:
    """Scene batches: leading batch axis over ``data``, replicated over
    ``model``."""
    return Sharding(mesh, DATA_AXIS)


def bank_sharding(mesh: Mesh) -> Sharding:
    """Bank arrays: leading view axis over ``model``, replicated over
    ``data``."""
    return Sharding(mesh, MODEL_AXIS)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


class Placed:
    """An array placed on a mesh: ``local(r, c)`` is the piece on
    ``mesh.devices[r, c]``; ``shape`` is the whole array's."""

    def __init__(self, sharding: Sharding, pieces: np.ndarray, shape):
        self.sharding = sharding
        self.pieces = pieces
        self.shape = torch.Size(shape)

    def local(self, r: int, c: int) -> torch.Tensor:
        return self.pieces[r, c]

    def shards(self) -> List[torch.Tensor]:
        """The pieces along the sharded axis, on that axis' devices
        (``Mesh.axis_devices``)."""
        axis = self.sharding.axis
        if axis is None:
            return [self.pieces[0, 0]]
        return list(self.pieces[0, :] if axis == MODEL_AXIS
                    else self.pieces[:, 0])

    def gather(self) -> torch.Tensor:
        """The whole array on the mesh's first device (an all-gather)."""
        return all_gather(self.shards())


def device_put(x: torch.Tensor, sharding: Sharding) -> Placed:
    """``x`` placed as ``sharding`` says; the leading axis must divide
    evenly over the sharded mesh axis. A device named twice holds one copy
    of each piece."""
    mesh, axis = sharding
    d, m = mesh.devices.shape
    n = mesh.shape[axis] if axis is not None else 1
    if x.shape[0] % n:
        raise ValueError(f"leading axis {x.shape[0]} does not split evenly "
                         f"over the {axis!r} axis of {n} devices")
    size = x.shape[0] // n
    copies = {}
    pieces = np.empty((d, m), dtype=object)
    for r in range(d):
        for c in range(m):
            block = {DATA_AXIS: r, MODEL_AXIS: c, None: 0}[axis]
            dev = mesh.devices[r, c]
            key = (dev, block)
            if key not in copies:
                copies[key] = x[block * size:(block + 1) * size].to(
                    dev, non_blocking=True)
            pieces[r, c] = copies[key]
    return Placed(sharding, pieces, x.shape)


def all_gather(parts: Sequence[torch.Tensor], dim: int = 0) -> torch.Tensor:
    """Per-shard pieces concatenated along ``dim`` in shard order, on the
    first shard's device."""
    dev = parts[0].device
    return torch.cat([p.to(dev, non_blocking=True) for p in parts], dim)


def psum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum of per-shard values in shard order, on the first shard's device."""
    dev = parts[0].device
    out = parts[0]
    for p in parts[1:]:
        out = out + p.to(dev, non_blocking=True)
    return out


def on_device(device: torch.device):
    """The context that makes ``device`` current (for a card: its current
    stream takes the kernels issued inside)."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def _on_device(device: torch.device, fn: Callable, entries: List[int]):
    """``fn(i, device)`` for each mesh entry i of ``device``, in order,
    under that device; an entry's error is kept and the next runs."""
    out = {}
    with on_device(device):
        for i in entries:
            try:
                out[i] = (fn(i, device), None)
            except Exception as e:  # noqa: BLE001 — re-raised by run_on
                out[i] = (None, e)
    return out


def _issuer(i: int, device: torch.device):
    """The thread that issues mesh entry ``i``: one per distinct device.
    (The tests key it by entry, to run the threaded form on a mesh that
    names the CPU several times.)"""
    return device


def run_on(devices: Sequence[torch.device], fn: Callable) -> list:
    """``[fn(i, devices[i]) for i ...]`` with one thread per distinct
    device, each running its entries in order under that device (its
    current stream): work on different devices is issued concurrently, and
    a device named twice runs its entries one after the other, as its one
    stream would anyway. Every entry runs to its end; the first error, in
    entry order, is then raised: a failing shard fails the whole call."""
    groups = {}
    for i, d in enumerate(devices):
        groups.setdefault(_issuer(i, d), []).append(i)
    if len(groups) == 1:
        done = [_on_device(devices[idx[0]], fn, idx)
                for idx in groups.values()]
    else:
        with ThreadPoolExecutor(max_workers=len(groups)) as ex:
            futures = [ex.submit(_on_device, devices[idx[0]], fn, idx)
                       for idx in groups.values()]
            done = [f.result() for f in futures]
    results = {i: r for part in done for i, r in part.items()}
    for i in range(len(devices)):
        if results[i][1] is not None:
            raise results[i][1]
    return [results[i][0] for i in range(len(devices))]
