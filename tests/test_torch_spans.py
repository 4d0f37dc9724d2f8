"""The port's span recorder (``tpu_joints_torch/core/spans.py``) and the
spans of the served frame, on the CPU.

Off, a span is one shared object that records nothing, and the service's
replies are bit-equal with spans on and off. On, spans nest per thread, a
root span opens a request id its children share, and self time is the
duration less what the children cover. A served depth frame is one
``serve.frame`` over the host spans of its layers and the chain's four
stages (on the CPU the stages are host spans; on a card they are timed on
the device inside the captured graph: ``tests/test_torch_cuda.py``). The
span stamps share the clock of the profiler's events. ``/healthz`` reports
each span's count and mean with spans on. The graph cache keys a graph
captured with spans on apart and leaves the key of one captured with them
off as it was.

Scale: the bench chain (crop off) at 1,024 lanes on a 160×120 raycast of
the bench joint, and a level-0 bank at 64 px built by the port on the CPU.
"""
import dataclasses
import importlib
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from tpu_joints_torch import synthetic as syn
from tpu_joints_torch.core import graphs, spans
from tpu_joints_torch.modelbank.bank import build_bank
from tpu_joints_torch.serve import DetectionService, make_server
from tpu_joints_torch.serve.batching import FrameBatcher

tdet = importlib.import_module("tpu_joints_torch.pipelines.detect")

FRAME = ["serve.upload", "serve.unproject", "serve.queue", "chain.ingest",
         "chain.features", "chain.match", "chain.refine", "serve.to_host",
         "serve.payload"]


@pytest.fixture
def spans_on():
    spans.enable(True)
    spans.drain()
    yield
    spans.enable(False)
    spans.drain()


@pytest.fixture(scope="module")
def served():
    """(service, depth frame) of the bench chain at test size."""
    cfg = dataclasses.replace(
        syn.bench_config(), segment_scene=False, remove_plane=False,
        scene_capacity=1024, scene_key_capacity=64, max_candidates=4,
        refine_top=2)
    bank = build_bank(syn.joint_model(3000, 1800), device="cpu",
                      **dict(syn.bench_bank_kwargs(cfg), level=0,
                             resolution=64, key_capacity=64,
                             icp_capacity=1024))
    xyz, _ = syn.frame(syn.bench_pose(), 42, with_table=False, width=160,
                       height=120)
    return DetectionService(bank, cfg), xyz[..., 2]


def _reply(r):
    return {k: v for k, v in r.items() if k != "latency_ms"}


def test_spans_off_record_nothing(served):
    """Off (the default): every span is one shared object, nothing is
    recorded, and a served frame's reply equals the one with spans on."""
    service, depth = served
    assert not spans.enabled()
    assert spans.span("a") is spans.span("b") is spans.stage(
        "chain.ingest", torch.zeros(1))
    with spans.span("a") as rec:
        assert rec is None and spans.current() is None
    off = service.detect_depth(depth)
    assert spans.drain() == [] and spans.summary() == {}
    spans.enable(True)
    try:
        on = service.detect_depth(depth)
    finally:
        spans.enable(False)
    assert spans.drain()
    assert off["metrics"]["scene_points"] > 64       # the organized chain ran
    assert _reply(on) == _reply(off)


def test_nesting_parent_request_and_self_time(spans_on):
    with spans.span("a") as a:
        with spans.span("b") as b:
            with spans.span("c") as c:
                spans.rename("c2")
        with spans.span("d") as d:
            pass
    with spans.span("e") as e:
        pass
    other = []
    t = threading.Thread(target=lambda: other.append(
        spans.span("f").__enter__()))
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    recs = spans.drain()
    assert [r.name for r in recs] == ["c2", "b", "d", "a", "e"]
    assert (b.parent, c.parent, d.parent, a.parent, e.parent) == (
        a, b, a, None, None)
    assert a.request == b.request == c.request == d.request != e.request
    assert other[0].request not in (a.request, e.request)   # its own root
    assert other[0].thread != a.thread == e.thread
    assert all(r.clock == "host" and r.end_ns >= r.start_ns for r in recs)
    assert a.start_ns <= b.start_ns <= c.start_ns <= c.end_ns <= b.end_ns \
        <= d.start_ns <= d.end_ns <= a.end_ns
    assert spans.self_ns(a, recs) == a.ns - b.ns - d.ns
    assert spans.self_ns(b, recs) == b.ns - c.ns
    assert spans.self_ns(e, recs) == e.ns
    assert spans.summary()["b"]["count"] == 1
    assert spans.drain() == []


def test_a_served_frame_is_one_tree_of_its_layers(served, spans_on):
    """A depth frame on the CPU: one ``serve.frame`` (a root) whose children
    are, in order, the host spans of the serving layers and the chain's
    four stages (no ``graphs.replay``: the chain runs eagerly here), all of
    one request; the totals count them."""
    service, depth = served
    service.detect_depth(depth)
    recs = spans.drain()
    frame, = [r for r in recs if r.name == "serve.frame"]
    assert frame.parent is None
    kids = sorted((r for r in recs if r is not frame), key=lambda r: r.start_ns)
    assert [r.name for r in kids] == FRAME
    assert all(r.parent is frame and r.request == frame.request
               and frame.start_ns <= r.start_ns <= r.end_ns <= frame.end_ns
               for r in kids)
    total = spans.summary()
    assert total["serve.upload"]["count"] == 1
    assert total["serve.frame"]["mean_ms"] == pytest.approx(frame.ns / 1e6)


def test_a_span_contains_the_profilers_event_on_its_clock(spans_on):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("outer") as rec:
            with record_function("tj_probe"):
                torch.ones(256, 256).sum()
    ev, = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "tj_probe"]
    assert rec.start_ns <= ev.start_ns()
    assert ev.start_ns() + ev.duration_ns() <= rec.end_ns


def test_healthz_reports_the_span_summary(served):
    service, depth = served
    server = make_server(service, host="127.0.0.1", port=0)
    url = f"http://127.0.0.1:{server.server_address[1]}/healthz"
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            assert "spans" not in json.loads(r.read())
        spans.enable(True)
        service.detect_depth(depth)
        with urllib.request.urlopen(url, timeout=30) as r:
            summary = json.loads(r.read())["spans"]
    finally:
        spans.enable(False)
        spans.drain()
        server.shutdown()
        server.server_close()
        t.join(timeout=30)
    assert set(summary) == set(FRAME) | {"serve.frame"}
    assert summary["serve.upload"]["count"] == 1
    assert summary["serve.frame"]["count"] == 1
    assert summary["serve.frame"]["mean_ms"] > summary["chain.refine"][
        "mean_ms"] > 0


def test_a_micro_batched_frame_spans_its_wait(spans_on):
    """In a micro-batch, ``serve.queue`` runs from ``submit`` to the start
    of the frame's batch (which another thread may lead)."""
    started = []

    def run_batch(imgs, vms):
        started.append(spans.current())
        return torch.from_numpy(imgs.sum((1, 2)))

    batcher = FrameBatcher(run_batch, max_batch=2, window_ms=200.0)
    out = {}

    def camera(i):
        with spans.span("serve.frame"):
            out[i] = batcher.submit(np.full((4, 4), i, np.float32),
                                    np.ones((4, 4), bool))

    threads = [threading.Thread(target=camera, args=(i,)) for i in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert out == {1: 16.0, 2: 32.0}
    recs = spans.drain()
    frames = [r for r in recs if r.name == "serve.frame"]
    queues = [r for r in recs if r.name == "serve.queue"]
    assert len(frames) == len(queues) == 2 and len(started) == 1
    assert {q.parent for q in queues} == set(frames)
    assert len({q.end_ns for q in queues}) == 1       # one batch start
    assert all(q.parent.start_ns <= q.start_ns <= q.end_ns <= q.parent.end_ns
               for q in queues)


def test_graph_key_marks_a_traced_capture(served):
    """Spans off: the graph's key is the one it always was. On: another
    key, so a graph that times its stages is never replayed in place of
    one that does not, nor the other way round."""
    service, depth = served
    x = torch.zeros(120, 160, 3)
    v = torch.ones(120, 160, dtype=torch.bool)
    _, args, static = tdet._organized(x, v, service.bank, service.cfg, 4, 5,
                                      None, None, None)
    plain = ("detect_organized", static, id(service.bank),
             tuple(None if a is None else (a.device, tuple(a.shape), a.dtype)
                   for a in args))
    assert graphs.cache_key("detect_organized", args, static,
                            service.bank) == plain
    spans.enable(True)
    try:
        traced = graphs.cache_key("detect_organized", args, static,
                                  service.bank)
    finally:
        spans.enable(False)
    assert traced == plain + ("spans",)
