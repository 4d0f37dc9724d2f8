"""Captured CUDA graphs of the detection chains (counterpart of the JAX
package's ``jax.jit`` executables of ``detect_fused``, the fused organized
program, the batch and the two-part program).

An entry that the JAX package runs as one XLA executable runs here, on a
card, as a ``torch.cuda.CUDAGraph``: captured once for each (entry,
configuration, block, half-window, input shapes and dtypes, device, which
optional inputs are given, bank) and replayed for every call after that, so
a frame costs one graph launch where the eager chain costs thousands of
kernel launches. On CPU tensors an entry runs its eager chain. On a card it
replays, or it raises: a capture that fails is discarded and never falls
back to the eager chain.

* A cache entry holds the entry's static inputs (each call ``copy_``-s its
  tensors into them), its graphs and their outputs, and a strong reference
  to the bank, so a freed bank can never be read through a stale graph.
* Before a capture the chain runs once eagerly on the capture stream: that
  fills what a capture may not fill (the host-to-device uploads of cached
  constants, ``core/prng.py``; library handles and workspaces; the kernels'
  one-time occupancy query).
* A capture runs under one process-wide lock, with
  ``capture_error_mode="thread_local"`` and ``torch.cuda.set_sync_debug_mode
  ("error")``: a host read inside the chain raises instead of being frozen
  into the graph.
* All graphs of a device share one memory pool and one capture stream (the
  allocator reuses a freed block only on the stream it was used on); replays
  take the same lock, so they run one at a time and each graph's outputs
  keep their own storage.
* A replay returns clones of the outputs: a result outlives the next call,
  as a JAX array does.

Region growings read the host once per chunk of sweeps in the eager chain.
In a captured chain the lattice and the graph one
(``segment/organized.py``, ``segment/region_growing.py``: the crop of an
organized frame, the clustered box) read nothing: the first
graph runs one chunk (the module's ``SWEEPS_PER_CHECK``) and keeps the last
sweep's change flag among its outputs. The replay reads the flags once;
where a growing had not settled, it replays a second graph, captured at
that first need, in which every growing runs to its cap. A sweep past the
fixpoint changes nothing, so either way the labels equal the eager
schedule's.

A constant that the chain uploads once and caches (``core/prng.py``'s
draws) is read by the graph at its address, so the capture passes it
through ``hold`` and the graph's cache entry (``Captured.held``) keeps it
for as long as the graph: an eviction from the module's cache can never
hand its block to another tensor under a live graph.

With spans on (``core/spans.py``) a call on a card is the span
``graphs.replay`` (``graphs.capture`` when it captured), and a capture
keeps the chain's stage marks as timed event nodes of its graph: such a
graph is keyed apart from the one captured with spans off, which has none.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Dict, List, Optional

import torch

from tpu_joints_torch.core import spans
from tpu_joints_torch.core.ops import tree_map

_LOCK = threading.Lock()
_CACHE: Dict[tuple, "Captured"] = {}
_POOLS: Dict[torch.device, tuple] = {}   # device → (pool, capture stream)
_capture = threading.local()


@contextlib.contextmanager
def captured_schedule(mode: str, flags: list, held: Optional[list] = None):
    """Region growings called inside run the schedule of a captured chain:
    ``mode`` "first" (one chunk of sweeps, each growing's change flag
    appended to ``flags``) or "cap" (every growing to its cap). The cached
    constants the chain reads are appended to ``held``."""
    _capture.mode, _capture.flags, _capture.held = mode, flags, held
    try:
        yield
    finally:
        _capture.mode = _capture.flags = _capture.held = None


def hold(t: torch.Tensor) -> torch.Tensor:
    """``t``, a cached device constant the chain reads; inside a capture the
    graph's entry keeps a reference to it (module docstring)."""
    held = getattr(_capture, "held", None)
    if held is not None:
        held.append(t)
    return t


def fixed_sweeps(check_every: int, max_sweeps: int) -> Optional[int]:
    """The sweeps a region growing runs with no host read while its chain is
    captured (or warmed up for a capture): one chunk of ``check_every`` in
    the first graph, ``max_sweeps`` in the second. None outside a capture:
    the growing keeps its read-checked schedule."""
    mode = getattr(_capture, "mode", None)
    if mode is None:
        return None
    if mode == "first" and 0 < check_every < max_sweeps:
        return check_every
    return max_sweeps


def note_unsettled(changed: torch.Tensor) -> None:
    """Record a region growing's last-sweep change flag (a bool tensor) in
    the first graph: a replay whose flags are all False is exact."""
    _capture.flags.append(changed)


class Captured:
    """One cache entry: static inputs, graphs and their outputs."""

    def __init__(self, entry: str, fn: Callable, args: tuple, keep,
                 device: torch.device):
        self.entry, self.fn, self.keep, self.device = entry, fn, keep, device
        self.inputs = [None if a is None else
                       torch.empty(a.shape, dtype=a.dtype, device=a.device)
                       for a in args]
        self.graphs: List[tuple] = []   # (graph, outputs, flag or None)
        self.marks: List[list] = []     # each graph's stage events
        self.held: List[torch.Tensor] = []   # cached constants the graphs read
        self.capture_s = 0.0
        self.pool_bytes = 0             # the shared pool's growth
        self.need_bytes = 0             # the most a graph allocated in it
        self.reads = 0                  # flag reads over all replays

    def _mode_run(self, mode: str, flags: list, held=None):
        with captured_schedule(mode, flags, held):
            return self.fn(*self.inputs)

    def capture(self, mode: str) -> None:
        """Warm the chain up eagerly on the capture stream, then capture it
        (``mode`` "first" or "cap"); a failure discards the graph and
        raises."""
        t0 = time.perf_counter()
        spans.rename("graphs.capture")
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        graph = out = None
        try:
            if self.device not in _POOLS:
                _POOLS[self.device] = (torch.cuda.graph_pool_handle(),
                                       torch.cuda.Stream(self.device))
            pool, stream = _POOLS[self.device]
            stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(stream):
                self._mode_run(mode, [])
            torch.cuda.current_stream(self.device).wait_stream(stream)
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            before = torch.cuda.memory_reserved(self.device)
            allocated = torch.cuda.memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
            graph, flags, held, marks = torch.cuda.CUDAGraph(), [], [], []
            with torch.cuda.graph(graph, pool=pool, stream=stream,
                                  capture_error_mode="thread_local"):
                torch.cuda.set_sync_debug_mode("error")
                try:
                    with spans.collecting(marks):
                        out = self._mode_run(mode, flags, held)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                flag = torch.stack(flags).any() if flags else None
            torch.cuda.synchronize(self.device)
            self.pool_bytes += torch.cuda.memory_reserved(self.device) - before
            self.need_bytes = max(self.need_bytes, torch.cuda.max_memory_allocated(
                self.device) - allocated)
        except torch.cuda.OutOfMemoryError:
            del graph, out              # discarded before any retry
            raise
        except Exception as e:
            del graph, out
            raise RuntimeError(
                f"capturing {self.entry} ({mode} graph) failed; the chain is "
                f"not run eagerly in its place: {e}") from e
        finally:
            torch.cuda.set_sync_debug_mode(prev)
        self.graphs.append((graph, out, flag))
        self.marks.append(marks)
        self.held.extend(held)
        self.capture_s += time.perf_counter() - t0

    def replay(self, args: tuple):
        spans.settle()          # stage times a call left unread
        for dst, src in zip(self.inputs, args):
            if dst is not None:
                dst.copy_(src)
        graph, out, flag = self.graphs[0]
        graph.replay()
        spans.replayed(self.marks[0])
        if flag is not None:
            self.reads += 1
            if bool(flag):
                if len(self.graphs) == 1:
                    self.capture("cap")
                graph, out, _ = self.graphs[1]
                graph.replay()
                spans.replayed(self.marks[1])
        return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor)
                        else t, out)


def cache_key(entry: str, args: tuple, static, keep) -> tuple:
    """A graph's key: the entry, ``static`` (configuration, block, ...),
    the bank's identity, and the device, shape and dtype of each tensor of
    ``args`` (None where an optional one is not given); with spans on, the
    mark ``"spans"`` after them (a graph that times its stages)."""
    key = (entry, static, id(keep),
           tuple(None if a is None else (a.device, tuple(a.shape), a.dtype)
                 for a in args))
    return key + ("spans",) if spans.enabled() else key


def run(entry: str, fn: Callable, args: tuple, static, keep):
    """``fn(*args)`` — eagerly when no tensor of ``args`` (tensors or None)
    is on a card, else through the captured graph of (entry, ``static``,
    the tensors' shapes, dtypes and device, which are None, ``keep``),
    capturing it on the first call. ``fn`` must read nothing but ``args``,
    what ``static`` and ``keep`` (the bank, or banks) pin down, and
    constants it passes through ``hold``."""
    devices = {a.device for a in args if a is not None}
    if all(d.type != "cuda" for d in devices):
        return fn(*args)
    if len(devices) != 1:
        raise ValueError(f"{entry}: inputs on several devices {devices}")
    device = devices.pop()
    with spans.span("graphs.replay"):
        key = cache_key(entry, args, static, keep)
        with _LOCK:
            hit = _CACHE.get(key)
            if hit is None:
                hit = Captured(entry, fn, args, keep, device)
                for dst, src in zip(hit.inputs, args):
                    if dst is not None:
                        dst.copy_(src)
                hit.capture("first")
                _CACHE[key] = hit
            return hit.replay(args)


def entries() -> List[Captured]:
    """The cache's entries, in capture order."""
    with _LOCK:
        return list(_CACHE.values())


def clear() -> None:
    """Drop every captured graph (their memory returns to the allocator's
    cache; ``torch.cuda.empty_cache()`` hands it back to the card)."""
    with _LOCK:
        _CACHE.clear()
        _POOLS.clear()
