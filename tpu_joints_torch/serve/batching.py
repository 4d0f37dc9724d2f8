"""Frame micro-batching for the detection server (counterpart of
``tpu_joints/serve/batching.py``).

The reference handles one frame per ROS callback (``SHOT.cpp:592-602``). A
saturated server drains its queue into ONE batched pass
(``detect_organized_batch``), which shares the host's launches over the
frames of the batch.

Leader–follower batching: every request thread enqueues its frame and
waits; the first thread to arrive becomes the leader, waits up to
``window_ms`` for concurrent requests to pile in (less when ``max_batch``
frames are queued before that: a full batch has nothing to wait for), then
runs the queue as one batch and hands each waiter its result. A batch holds
exactly the queued frames, never padding: each frame more is device work,
and nothing here compiles per batch size.

``to_host`` moves a result (tensors in NamedTuples, tuples, lists and
dicts) to the host in one copy, so a request or a batch costs one host
read.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from tpu_joints_torch.core import spans
from tpu_joints_torch.core.ops import tree_map


def tree_zip(fn, trees: list):
    """One tree shaped like ``trees[0]`` whose tensor leaves are ``fn`` of
    the list of corresponding leaves of all ``trees`` (equally shaped);
    other leaves come from the first tree."""
    flat = [[] for _ in trees]
    for i, tree in enumerate(trees):
        tree_map(lambda t, i=i: flat[i].append(t), tree)
    leaves = iter([fn([f[j] for f in flat]) for j in range(len(flat[0]))])
    return tree_map(lambda _: next(leaves), trees[0])


def to_host(tree):
    """Every tensor leaf of ``tree`` on the CPU through ONE device-to-host
    copy (one synchronisation): the leaves are packed as bytes into one
    buffer on their device, copied, and unpacked as views of the host
    buffer. CPU leaves pass through. The span ``serve.to_host``; the stage
    times of the graphs that made ``tree`` are read after it
    (``core/spans.py``)."""
    with spans.span("serve.to_host"):
        tree = _to_host(tree)
    spans.settle()
    return tree


def _to_host(tree):
    leaves = []
    tree_map(lambda t: leaves.append(t) if isinstance(t, torch.Tensor)
             and t.device.type != "cpu" else None, tree)
    if not leaves:
        return tree
    parts, offsets, at = [], {}, 0
    for t in leaves:
        raw = t.contiguous().reshape(-1).view(torch.uint8)
        pad = -raw.numel() % 8           # every leaf starts 8-byte aligned
        parts += [raw, raw.new_zeros(pad)] if pad else [raw]
        offsets[id(t)] = at
        at += raw.numel() + pad
    host = torch.cat(parts).cpu()

    def unpack(t):
        if not isinstance(t, torch.Tensor) or id(t) not in offsets:
            return t
        n = t.numel() * t.element_size()
        start = offsets[id(t)]
        return host[start:start + n].view(t.dtype).reshape(t.shape)

    return tree_map(unpack, tree)


def _stack(frames: list):
    """One batch of frames: ``torch.stack`` for tensors (a card's, already
    on it), ``np.stack`` for host arrays (a mesh's)."""
    if isinstance(frames[0], torch.Tensor):
        return torch.stack(frames)
    return np.stack(frames)


class _Entry:
    __slots__ = ("img", "vmask", "done", "result", "error", "started_ns")

    def __init__(self, img, vmask):
        self.img = img
        self.vmask = vmask
        self.done = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.started_ns = 0         # when its batch started (spans on)


class FrameBatcher:
    """Collect concurrent same-shape frames into one batched pass.

    ``run_batch(imgs [B,H,W,3], vmasks [B,H,W]) -> result with leading
    batch axis`` is the only device-facing hook (the frames stacked as they
    were submitted: tensors, or host arrays); index ``i`` of every leaf
    of its return must be frame ``i``'s result. The batcher moves the
    result to the host once (``to_host``) and hands each waiter its slice.
    ``max_batch`` bounds one pass; ``window_ms`` is how long the leader
    waits at most for followers (0 = batch only what is already queued —
    still coalesces a backed-up queue); ``max_batch`` queued frames end the
    wait.
    """

    def __init__(self, run_batch: Callable, max_batch: int = 8,
                 window_ms: float = 4.0):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.run_batch = run_batch
        self.max_batch = int(max_batch)
        self.window_ms = float(window_ms)
        self._lock = threading.Lock()
        self._queue: List[_Entry] = []
        self._full = threading.Event()     # max_batch frames are queued
        self._leader_busy = False
        self.n_batches = 0
        self.n_batched_frames = 0

    def submit(self, img: np.ndarray, vmask: np.ndarray):
        """Enqueue one frame; blocks until its result is ready. With spans
        on, the wait until its batch started is the span ``serve.queue``."""
        queued_ns = time.time_ns() if spans.enabled() else 0
        e = _Entry(img, vmask)
        lead = False
        with self._lock:
            self._queue.append(e)
            if len(self._queue) >= self.max_batch:
                self._full.set()
            if not self._leader_busy:
                self._leader_busy = True
                lead = True
        if lead:
            self._lead()
        e.done.wait()
        if queued_ns and e.started_ns:
            spans.add("serve.queue", queued_ns, e.started_ns)
        if e.error is not None:
            raise e.error
        return e.result

    def _lead(self):
        if self.window_ms > 0:
            self._full.wait(self.window_ms / 1000.0)
        while True:
            with self._lock:
                batch = self._queue[: self.max_batch]
                del self._queue[: len(batch)]
                if len(self._queue) < self.max_batch:
                    self._full.clear()
                if not batch:
                    self._leader_busy = False
                    return
            self._run(batch)

    def _run(self, batch: List[_Entry]):
        if spans.enabled():
            started = time.time_ns()
            for e in batch:
                e.started_ns = started
        try:
            out = to_host(self.run_batch(_stack([e.img for e in batch]),
                                         _stack([e.vmask for e in batch])))
            self.n_batches += 1
            self.n_batched_frames += len(batch)
            for i, e in enumerate(batch):
                e.result = tree_map(lambda a, i=i: a[i], out)
        except BaseException as err:  # noqa: BLE001 — every waiter re-raises it
            for e in batch:
                e.error = err
        finally:
            for e in batch:
                e.done.set()
