#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs its paths on a GPU.

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py
    python3 chip_smoke.py --against DIR
    python3 chip_smoke.py --yardsticks

``--against DIR`` also holds another version of the kernels against this
one: DIR (a scratch directory, for example a revision's
``tpu_joints_torch/neighbors/csrc`` written out with ``git archive``) holds
its ``nn1.cu`` and ``knnk.cu`` and any headers they include. They are
built into DIR with this tree's flags in phase 2, beside this tree's
(ptxas's register and spill report of both is printed), checked bit for bit
against the plain version at every timed shape and timed there in turns
with this tree's kernels (other, this, this, other). ``--yardsticks``
re-times the plain version and cdist+topk at every timed shape; by default
they are timed only at the kernels' main shapes (phase 3's K1 ICP shape and
batch shape, phase 6's K2 region-growing shape); the other shapes'
yardsticks stand in PERF.md.

Phases (any failure raises and the exit code is non-zero):
  1. device  — card name and power limit (nvidia-smi);
  2. build   — compiles kernels K1 (nn1.cu: tj_nn1 and its batch mode
               tj_nn1_batched) and K2 (knnk.cu, both with the shared
               knn_split.cuh) and the served frame's unproject.cu from the
               checkout, one nvcc each, started together (with --against,
               the other version's too);
  3. kernels — K1, K1's batch mode and K2 against their plain PyTorch
               versions on the card (the batch mode also against B unbatched
               K1 launches; fixed shapes, the stacked edge cases of
               knn_cases.batches(); timed at the batch ICP's 8 x 8192 x 2560
               beside 8 single launches, its plain version and batched
               cdist+topk),
               bit for bit, at the paths' shapes, at edge cases, at the
               orders and ties that stress the split sweep and the lane merge
               and at shapes that straddle the split (the inputs of
               tpu_joints_torch/neighbors/knn_cases.py); K1 timed at its
               three path shapes (ICP, both coverage tiers); 3.1 the served
               frame's unproject kernel bit for bit against its plain
               version on the cases of serve/depth_cases.py, and timed at
               640x480, block 4, beside the plain version and its bound;
  4. bank    — the 42-view SHOT bank of bench.py built on the card: K2
               launches counted (the k=16 normals, one per view), every
               launch's inputs rechecked against the plain version, and K2
               timed on the first launch's inputs at 1024 and 2048 lanes;
  5. organized path — detect_organized on a 640×480 frame of the bench
               joint with bench.py's scene_latency config: K1 launches (by
               shape) and host syncs over one run (none allowed), latency
               over 3 runs, gate < 1° / < 5 mm, and the same chain at small
               size against the CPU path;
  6. generic path — detect on the same frame's points as an unorganized
               2560-point cloud (the CLI's recipe) with the SHOT_demo-shaped
               config: K1 and K2 launches and host syncs over one run (syncs
               must equal the region-growing schedule's reads), every K2
               launch rechecked, K2 timed at the region-growing and
               clustered-OBB shapes against its plain version and
               cdist+topk, latency over 3 runs, the gate, and the same path
               at small size against the CPU path;
  7. segmented organized path — detect_organized on the same pose's frame
               with the workshop table behind the joint and bench.py's
               scene_latency_segmented config (RANSAC plane removal, lattice
               region growing and the curvature filter on the 120×160 tile
               lattice): K1 and K2 launches and host syncs over one run
               (syncs must equal the lattice region growing's reads),
               latency over 3 runs, the gate, and the same chain at small
               size against the CPU path;
  8. two-part path — the {chord, stub} part banks of bench.py built on the
               card (84 K2 launches, every launch's inputs rechecked), their
               concatenation and shared-CAD check made once, then
               detect_parts_organized on the table frame with bench.py's
               scene_latency_two_part config: launches, host syncs (again
               the lattice region growing's reads), latency over 3 runs,
               the gate, the winning part, and the candidate field at small
               size against the CPU path;
  9. multi-instance — detect_organized on bench.py's two-instance frame
               (two posed joints, seed 77, the wide crop box) with its
               multi_instance config (local coverage gate, 4 instances per
               view, the peak-grouped cut of 48 candidates, 12 tier-2
               survivors, 8192 scene lanes, 1024 keys), then good_instances:
               exactly two instances, joints a and b, each < 1 deg / < 5 mm;
               0 host syncs; K1 launches by shape, each new shape rechecked
               and timed, latency, device busy time and operations;
 10. GO-HV  — the same frame with hv_enabled (the global hypothesis
               verification over the 48 registered candidates): the same
               gate, the verified count, the launches HV adds (one of K1's
               batch mode, one folded K1; both rechecked on their recorded
               inputs and timed), HV on against HV off in turns, and
               verify_hypotheses at small size on the card against the CPU;
 11. batch of 8 — detect_organized_batch on bench.py's 8 jittered frames
               with the scene_latency config: 0 host syncs, launches by
               shape (every frame refined on its own: 8 x phase 5's
               launches, shapes phase 5 rechecked and timed), every
               accepted frame < 5 deg / < 20 mm and >= 70% accepted, each
               frame equal to its own detect_organized run (accept flag,
               n_selected, accepted poses within 3e-4, and the winning view,
               unless this frame of the batch holds that run's view as a
               tier-2 survivor at the winner's pose within 3e-4: two views
               of one pose, tied in rank), ms per frame amortised beside the
               single-frame median of the same call (in turns), device
               operations per batch beside 8 x the single frame's, device
               busy time, peak memory;
 12. server — the detection server (tpu_joints_torch/serve) on the card,
               started with make_server(port=0) on a daemon thread and sent
               depth frames at full size (640x480, base64 float32) over
               HTTP, every count taken from 0 per served path: 12.1
               streaming (bench_config, crop off, 3 bench frames, seeds 0-2,
               one at a time): each reply within the gate, equal to a direct
               detect_organized on the unprojected frame at the server's
               block, one host read per request, request 0 capturing the
               one graph, /healthz naming the card and counting 3; host
               decode + unproject, device call and round trip; then the
               warm-up with a depth shape (it replays that graph); 12.2
               micro-batched (batch_max 8): phase 11's 8 jittered frames at
               once, fewer batches than frames, one read per batch, every
               reply equal to the streaming service's under phase 11's
               gate; 12.3 segmented + clustered box (4 table frames,
               batch_max 4, 8192 lanes so that the server's block rule
               picks the bench's block 4): each reply equal to its own
               single run, the box within 1e-4, phase 11's share accepted and
               every accepted pose within the gate, one read per batch of
               its region growings' change flags besides the reply's, the
               two K2 launches of the clustered box per frame of every
               capture's warm-up rechecked; the same at 2560 lanes (block
               8) on one frame,
               reported (an accepted pose must pass the gate);
               12.4 GO-HV (the two-instance frame and a jittered copy,
               batch_max 2): the GOOD list and the verified count equal to
               the single run's, every GOOD instance on a joint within
               1 deg / 5 mm; 12.5 a points request (phase 6's cloud through
               the native ingest, which must have built): equal to phase 6's
               detect, the gate. Every shape a served path launches that no
               earlier path did is rechecked bit for bit on its inputs, and
               the shapes only a served path launches are timed (5 calls);
 13. FPFH and the generic options — 13.1 bench.py's FPFH bank
               (synthetic.fpfh_bank_recipe) built on the card (K2 launches
               rechecked) and its scene_latency_fpfh frame
               (synthetic.fpfh_config, the table frame, the crop box):
               launches by shape, every K1 launch rechecked on its recorded
               inputs, syncs equal to the lattice region growing's reads,
               median of 3 frames, device busy, bank seconds, and the result
               held to the JAX package's on the CPU (FPFH_CPU_JAX): the same
               accept flag and winning view, rotation and translation errors
               within 0.1 deg / 1 mm of its; 13.2 on phase 6's cloud:
               anchored normals (anchors >= capacity bit-equal to
               estimate_normals; 1024 anchors: their K2 and K1 launches
               rechecked and timed, and tests/test_anchor_normals.py's
               agreement gate), then detect with normal_anchors,
               algorithm="gc", keypoints="iss" and rg_backend="voxel" (every
               launch rechecked, syncs equal to the region growings' reads;
               all but ISS within 1 deg / 5 mm, ISS reported), and SHOT's
               "pcl" scheme on phase 6's keys, card against CPU (reported);
               13.3 the fpfh_demo preset on its own 42-view bank (radius
               normals) served at 8192 lanes: warmup, one table frame over
               HTTP, the reply equal to a direct detect_organized, the
               shapes no other path launches timed (5 calls).
 14. the CLI and the last features — 14.1 the command-line flow at full
               width through tpu_joints_torch.cli: the bench joint written
               as model.pcd, render (host; 42 views at 100 px), bank
               --preset shot_demo on the card (42 views, 256 keys), phase
               6's frame (all valid points) as scene.pcd, detect --preset
               shot_demo --json once in a subprocess (beside 14.1-14.4's
               untimed work, collected before any timed run) and once
               in-process (16384 lanes: graph region growing and clustered
               box, K2 at 16384), each pose equal to a direct detect() on
               the card,
               launches by shape with every launch rechecked, syncs equal to
               the region growings' reads, median of 3 and device busy, the
               result held to the JAX package's on the CPU (CLI_CPU_JAX:
               flag, view, errors within 0.1 deg / 1 mm; an accepted pose
               within 1 deg / 5 mm of the truth); 14.2 detect --tree 3 on
               the same files, equal to a direct detect_tree, views matched
               and time beside 14.1's, held to TREE_CPU_JAX; 14.3 detect
               with two name=path part banks (phase 8's recipe at the
               preset's descriptor) on the table frame as a PCD, equal to a
               direct detect_parts, and scenes --hv --preset
               shot_hypothesis on both scene files (K1's batch mode
               rechecked, the GOOD lines printed); 14.4 crop, segment,
               edges -k 100 / 20 (K2 rechecked) and var-desc on scene.pcd
               strided to 16384 points, each output equal to a direct call;
               14.5 detect_organized with lattice keys (key_group 3) on
               phase 5's and phase 7's frames (key-count band, held to
               LATTICE_CPU_JAX), phase 11's 8 frames as a batch with lattice
               keys (each equal to its single run), ingest_organized at
               640x480 (capacity 32768, leaf 4 mm). Every shape no earlier
               path launched is timed (5 calls).
 15. the multi-device surface — on a mesh over every visible card and,
               where fewer than 4 are visible, on each 4-entry layout over
               cuda:0 named four times (printed: no link between cards is
               exercised there); the layouts are printed first. 15.1 the
               served mesh: DetectionService(batch_max=8, mesh=data x 1)
               over HTTP with phase 11's 8 frames as depth, each reply equal
               to the single-device batched service's in flag and view and
               within 0.5 deg / 3 mm, phase 11's gate, K1 launches per
               device, host reads per batch (one per device with frames),
               every new per-device shape rechecked and timed, the batch on
               the mesh beside the single-device batch in turns, and issued
               from one thread per data device (as on distinct cards), equal
               bit for bit to the one-thread issue; 15.2
               distributed.detect_batch (generic_config, phase 6's cloud and
               3 jittered copies, a 2 x 2 mesh: 21 views a shard), both call
               forms, each scene held to its single-device detect (accept
               flag and view equal, pose within rtol 1e-4 / atol 1e-5,
               fitness within rtol 1e-4), every K2 launch rechecked, the
               issue from one thread per data row (as on distinct cards)
               equal bit for bit to the one-thread issue, wall time against
               the serial loop; 15.3
               the collectives on a ring of 4: ring_knn (k = 16) and
               halo_radius_neighbors (r = 0.06, k_max 96, the halo sized
               from the data) on the table frame's 307,200 lanes unprojected
               whole (slab-sorted along x, the masked invalid pixels last), 1024
               sampled rows held to a dense single-device search; ring_icp
               (12 iterations, the bench joint at 65,536 points against a
               copy moved by 8 deg and 2 cm) held to the single-device icp
               (5e-4, fitness 1e-6); sharded_match_votes (phase 5's 512 keys
               x 42 views x 256 keys) equal to a float64 oracle.
 16. the README's Python API — after the paths at small size: the
               README's block run line for line through the package's
               exports (tpu_joints_torch.config.PRESETS, core.cloud.
               make_cloud, modelbank.build_bank, pipelines.detect), each
               on the card by default: build_bank(model_xyz) of the bench
               joint at its defaults (42 SHOT views), make_cloud(scene_xyz,
               capacity=32768) of phase 5's frame's valid points strided to
               32,768, detect(scene, bank, PRESETS["shot"]); its full_pose,
               fitness and accepted printed; launches by shape and host
               syncs (equal to the region growings' reads), every launch of
               a shape no earlier path launched rechecked bit for bit and
               timed (5 calls; its plain version and cdist+topk with
               --yardsticks);
               the result held to the JAX package's on the
               CPU (API_CPU_JAX: flag, view, errors within 0.1 deg / 1 mm;
               the reference accepts that pose about 9 deg off the truth,
               so no truth gate); then neighbors.pallas_knn.knn_pallas, the
               TPU kernel's own entry, at k = 1 and k = 16 on the scene
               (32,768 x 32,768), each one launch of K1 / K2, bit-equal to
               nn1 / knnk and to the plain versions. Phase 17 times the
               detect (10 runs in turns with its graph) and its device
               busy time.
 17. captured paths — the one-dispatch entries (core/graphs.py: one CUDA
               graph per entry, configuration, shapes and bank) against the
               eager chains on the same inputs, at the full width of their
               phases: detect_organized(fused=True) on phase 5's, 9's, 10's
               and 7's frames, detect_parts_organized (phase 8),
               detect_organized_batch (phase 11's 8 frames) and detect_fused
               (phase 16's README call). For each: capture seconds, the
               pool memory the graph allocated and the pool's growth; every
               leaf of a replay torch.equal to the eager run's; K1/K2
               kernels per replay from the profiler's kernel names (a
               replay calls no wrapper) equal to the eager run's; host
               syncs per replay (0, or the one read of the region growings'
               change flags); eager against replay wall medians and
               quartiles of 10 each in turns (eager, replay, replay, eager)
               and each form's device busy time. After the segmented
               capture the cache of the RANSAC plane's draw is emptied and
               every free block of its size refilled with 0.5: none may
               overlap the draw, and the replay must still equal the
               eager chain (the graph holds the draw it reads). Then the
               served paths from an empty graph cache with
               warmup(depth_shape=(480, 640)) (serve --warm-depth):
               streaming (3 requests), each reply's pose equal to the eager
               chain's on its frame, and micro-batched (batch_max 8, every
               batch size captured at start-up; 8 requests), every replayed
               batch equal leaf for leaf to the eager batch of the frames it
               held and each reply's pose to its frame's entry there; one
               host read per device call.
Phases 8 and 11 (and 14.5's batch) run the eager chains
(``multi._detect_parts_organized_eager``,
``detect._detect_organized_batch_eager``), whose launches the recorder can
recheck; phase 17 runs their captured forms. The served paths of phases 12,
13.3 and 15.1 (its single-card service) replay captured graphs: a request
that needs a graph first captures it, and the recorder keeps the inputs of
the eager warm-up before each capture (a call made while capturing holds no
values). The paths' timed frames are 3 each. Every timing gives the kernel (CUDA
events and profiler device time; its plain version and cdist+topk where
re-timed, see ``--yardsticks``) beside the bound and the shape's launches
per bank build, organized frame and generic frame. The kernels JSON line
(per kernel: its main shape's numbers, and "timings" for every timed shape)
and then the card's nvidia-smi name and power limit come before the last
line, which is the JSON result.
"""
import argparse
import base64
import collections
import contextlib
import ctypes
import dataclasses
import importlib
import json
import math
import statistics
import subprocess
import threading
import time
import urllib.error
import urllib.request
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

# a batch's accuracy gate (phases 11 and 12.2): at least this share of the
# frames accepted, each accepted one within 5 deg / 20 mm
BATCH_ACCEPTED = 0.7

# H100 SXM published peaks at 700 W (NVIDIA data sheet): fp32 outside the
# tensor cores, and HBM3 bandwidth
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def _err(T, G):
    import numpy as np

    Rd = T[:3, :3] @ G[:3, :3].T
    rot = math.degrees(math.acos(float(np.clip((np.trace(Rd) - 1) / 2, -1, 1))))
    return rot, float(np.linalg.norm(T[:3, 3] - G[:3, 3]))


def _event_ms(fn, reps=20):
    """Median of ``reps`` CUDA-event timings of ``fn`` (after one warm-up)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _device_ms(fn, reps=20):
    """Device time per call of ``fn``: the profiler's sum of kernel time
    over ``reps`` calls (host launch gaps excluded), after one warm-up. A
    profile that caught no device time at all is taken again, up to three
    times; then the CUDA-event time per call stands in, and says so."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages())
        if us > 0:
            return us / reps / 1000.0
    ms = _event_ms(fn, reps)
    print(f"# the profiler caught no device time in three tries; CUDA-event "
          f"time per call instead: {ms:.4f} ms", flush=True)
    return ms


def _bound(M, N, n_valid, k, B=1):
    """(ms, what bounds it): the least time the card could take for an
    exact kNN of M queries over N sources of which n_valid are valid (with
    B batch entries: M queries and N sources per entry, n_valid the valid
    sources of all entries together, each searched by its entry's M
    queries) — each
    input read once (query xyz, the N mask bytes and the valid sources'
    xyz, float32), each output written once (float32 + int32 per slot), 9
    fp32 flops per (query, valid source) pair for the difference-form
    distance (a masked source can never enter a list) — at the published
    peaks."""
    t_bytes = (B * (12 * M + N + 8 * M * k) + 12 * n_valid) / HBM_BYTES_PER_S
    t_ops = 9 * M * n_valid / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def _start_other_build(other):
    """Start one nvcc per source, all together, with this tree's flags and
    ptxas's report: the other version's nn1.cu and knnk.cu into ``other``,
    and this tree's again for the report alone. Returns the jobs."""
    from tpu_joints_torch.neighbors import pallas_knn as pk

    jobs = []
    for tag, csrc in (("other", other), ("this", pk._CSRC)):
        for name in pk._ENTRY:
            out = other / f"{tag}_{name}.so"
            cmd = [pk._nvcc(), *pk._NVCC_FLAGS, "-Xptxas", "-v", "-o",
                   str(out), str(csrc / f"{name}.cu")]
            jobs.append((tag, name, out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
    return jobs


def _finish_other_build(jobs, card):
    """Wait for the builds of ``_start_other_build``, print ptxas's
    register and spill lines, and bind the other version's C entry points:
    {"nn1": fn, "knnk": fn}. Raises with the compiler's output."""
    from tpu_joints_torch.neighbors import pallas_knn as pk

    other = {}
    for tag, name, out, proc in jobs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {tag} {name}.cu:\n"
                               f"{stdout}\n{stderr}")
        for line in (stdout + stderr).splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"# ptxas {tag} {name}.cu: {line.strip()} {card}",
                      flush=True)
        if tag == "other":
            entry = f"tj_{name}"      # the unbatched entry every version has
            fn = getattr(ctypes.CDLL(str(out)), entry)
            fn.restype, fn.argtypes = ctypes.c_int, pk._ENTRY[name][entry]
            other[name] = fn
    return other


def _other_call(fn, q, s, m, k):
    """Launch the other version's kernel through its C entry point, on
    contiguous inputs: the paths hand the kernels strided views (the
    coverage's stride-sampled model), which only the wrapper copies."""
    import torch

    q, s, m = q.contiguous(), s.contiguous(), m.contiguous()
    M = q.shape[0]
    d = torch.empty((M, k), dtype=torch.float32, device=q.device)
    i = torch.empty((M, k), dtype=torch.int32, device=q.device)
    args = [q.data_ptr(), s.data_ptr(), m.view(torch.uint8).data_ptr(),
            d.data_ptr(), i.data_ptr(), M, s.shape[0]] + ([k] if k > 1 else [])
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"the other version's launch failed: cudaError_t {rc}")
    return d, i


# re-time the plain version and cdist+topk at every timed shape
# (``--yardsticks``); by default only where ``yardsticks=True`` is passed:
# the kernels' main shapes. PERF.md's table carries the others' yardsticks
# from earlier runs.
_EVERY_YARDSTICK = [False]
_T_START = time.perf_counter()


def _time_knn(pk, q, s, m, k, card, label, other=None, reps=20,
              yardsticks=False):
    """CUDA-event and profiler times of K1 (k = 1) or K2 and, with
    ``yardsticks`` (or ``--yardsticks``), its plain version and cdist+topk
    (two PyTorch calls, unmasked) on the same inputs, as one row of the
    kernels line (``reps`` runs each: 5 at the large folded shapes, where
    the plain version takes 10-190 ms a call; a yardstick not timed is
    None). With ``other`` (the other version's entry points), that version
    is first held against the plain version bit for bit, then timed in
    turns with this one: other, this, this, other; the row gives each one's
    median."""
    import torch

    yardsticks = yardsticks or _EVERY_YARDSTICK[0]

    if m is None:
        m = torch.ones(s.shape[0], dtype=torch.bool, device=s.device)
    if k == 1:
        kernel, plain = pk.nn1, pk.nn1_reference
    else:
        def kernel(a, b, c):
            return pk.knnk(a, b, k, c)

        def plain(a, b, c):
            return pk.knnk_reference(a, b, k, c)
    fns = {"kernel": lambda: kernel(q, s, m),
           "plain": lambda: plain(q, s, m),
           "cdist+topk": lambda: torch.cdist(q, s).topk(k, largest=False)}
    order = list(fns) if yardsticks else ["kernel"]
    if other is not None:
        fn = other["nn1" if k == 1 else "knnk"]
        fns["other"] = lambda: _other_call(fn, q, s, m, k)
        (d, i), (dr, ir) = fns["other"](), fns["plain"]()
        if not (torch.equal(d, dr) and torch.equal(i, ir)):
            raise RuntimeError(f"the other version disagrees with the plain "
                               f"version ({label})")
        order = ["other", "kernel", "kernel", "other"] + order[1:]
    ev, dv = collections.defaultdict(list), collections.defaultdict(list)
    for n in order:
        ev[n].append(_event_ms(fns[n], reps))
        dv[n].append(_device_ms(fns[n], reps))
    n_valid = int(m.sum())
    bound_ms, bound_by = _bound(q.shape[0], s.shape[0], n_valid, k)
    print(f"# timing {label} {q.shape[0]}x{s.shape[0]} k={k} ({n_valid} of "
          f"{s.shape[0]} sources valid): median of {reps} CUDA-event runs, ms: "
          + ", ".join(f"{n} " + " ".join(f"{v:.4f}" for v in vs)
                      for n, vs in ev.items())
          + f"; device time per call (profiler, {reps} calls), ms: "
          + ", ".join(f"{n} " + " ".join(f"{v:.4f}" for v in vs)
                      for n, vs in dv.items())
          + f"; bound {bound_ms:.5f} ms ({bound_by}) {card}", flush=True)
    row = {"shape": [q.shape[0], s.shape[0], k], "label": label,
           "n_valid": n_valid, "ms": statistics.median(ev["kernel"]),
           "dev_ms": statistics.median(dv["kernel"]),
           **_yardstick_fields(ev, dv), "bound_ms": bound_ms,
           "bound_by": bound_by}
    if other is not None:
        row.update(other_ms=statistics.median(ev["other"]),
                   other_dev_ms=statistics.median(dv["other"]))
    return row


def _unproject_phase(dev, card):
    """Phase 3.1: the served frame's unprojection kernel (``unproject.cu``)
    against its plain version bit for bit on every ``depth_cases`` case
    (img as float32 bits, vmask, both counts; one launch each), then timed
    at 640x480, block 4 (the bench frame): CUDA events and profiler device
    time of the kernel and of the plain version run on the card's tensors,
    beside the bound (bytes once over 3.35 TB/s). Returns the kernels
    line's row."""
    import torch

    from tpu_joints_torch.serve import depth as D
    from tpu_joints_torch.serve.depth_cases import CASES
    from tpu_joints_torch.serve.server import depth_block

    def inputs(depth, fov):
        xs, ys = D.pixel_scales(depth.shape[1], depth.shape[0], fov)
        return [torch.from_numpy(a).to(dev) for a in (depth, xs, ys)]

    for name, case in sorted(CASES.items()):
        depth, kw, cap = case()
        block = depth_block(*depth.shape, cap)
        near, far = kw.get("near", 0.0), kw.get("far", 0.0)
        args = inputs(depth, kw["fov_deg"])
        before = D.unproject.launches
        got = D.unproject(*args, near, far, block)
        torch.cuda.synchronize()
        want = D.unproject_reference(*(a.cpu() for a in args), near, far,
                                     block)
        img, vmask, counts = (t.cpu() for t in got)
        if not (D.unproject.launches == before + 1
                and torch.equal(img.view(torch.int32),
                                want[0].view(torch.int32))
                and torch.equal(vmask, want[1])
                and torch.equal(counts, want[2])):
            raise RuntimeError(f"unproject disagrees with its plain version "
                               f"({name}, {depth.shape[1]}x{depth.shape[0]}, "
                               f"block {block})")
        print(f"# phase 3.1 unproject {name} {depth.shape[1]}x"
              f"{depth.shape[0]} block {block}: bit-equal, counts "
              f"{counts.tolist()} {card}", flush=True)
    depth, kw, cap = CASES["metric_noisy"]()
    H, W = depth.shape
    block = depth_block(H, W, cap)
    args = inputs(depth, kw["fov_deg"])
    fns = {"kernel": lambda: D.unproject(*args, 0.0, 0.0, block),
           "plain": lambda: D.unproject_reference(*args, 0.0, 0.0, block)}
    ev = {n: _event_ms(f) for n, f in fns.items()}
    dv = {n: _device_ms(f) for n, f in fns.items()}
    Hc, Wc = H - H % block, W - W % block
    nbytes = 4 * (H * W + H + W) + 13 * Hc * Wc + 8
    bound_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    print(f"# timing phase 3.1 unproject {W}x{H} block {block} ({nbytes} "
          f"bytes): median of 20 CUDA-event runs, ms: kernel "
          f"{ev['kernel']:.4f}, plain {ev['plain']:.4f}; device time per "
          f"call (profiler, 20 calls), ms: kernel {dv['kernel']:.4f}, plain "
          f"{dv['plain']:.4f}; bound {bound_ms:.5f} ms (bytes), dev against "
          f"the bound {100 * bound_ms / dv['kernel']:.1f}% {card}",
          flush=True)
    return {"name": "unproject", "route": "cuda",
            "source": "tpu_joints_torch/neighbors/csrc/unproject.cu",
            "replaces": None, "shape": [H, W, block], "label": "bench frame",
            "cases": len(CASES), "ms": ev["kernel"], "dev_ms": dv["kernel"],
            "plain_ms": ev["plain"], "plain_dev_ms": dv["plain"],
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None}


class _Recorder:
    """Wraps ``bruteforce.nn1``, ``bruteforce.nn1_batched`` and
    ``bruteforce.knnk`` (the kernels' entries from ``knn`` and
    ``knn_batched``) and keeps every call's inputs as (query, source, k,
    mask), so each launch of a path can be rechecked and timed afterwards.
    It launches nothing itself: the wrapped functions count the launches.
    A call made while a CUDA graph is captured is not kept (its inputs hold
    no values yet): a captured path is recorded by the eager warm-up that
    runs before each capture."""

    def __init__(self, bruteforce):
        self.bf, self.calls = bruteforce, []
        self.real = (bruteforce.nn1, bruteforce.knnk, bruteforce.nn1_batched)

    def _keep(self, call):
        import torch

        if not torch.cuda.is_current_stream_capturing():
            self.calls.append(call)

    def nn1(self, query, source, source_mask=None):
        self._keep((query, source, 1, source_mask))
        return self.real[0](query, source, source_mask)

    def nn1_batched(self, query, source, source_mask=None):
        self._keep((query, source, 1, source_mask))
        return self.real[2](query, source, source_mask)

    def knnk(self, query, source, k, source_mask=None):
        self._keep((query, source, k, source_mask))
        return self.real[1](query, source, k, source_mask)

    def counts(self):
        """(K1, K1 batched, K2) calls kept."""
        return (sum(q.ndim == 2 and k == 1 for q, _, k, _ in self.calls),
                sum(q.ndim == 3 for q, _, _, _ in self.calls),
                sum(k > 1 for _, _, k, _ in self.calls))

    def k2_calls(self):
        return [c for c in self.calls if c[2] > 1]

    def shapes(self):
        """Launches by shape: {(M, N, k): count}, (B, M, N, 1) for K1's
        batch mode."""
        return collections.Counter((*q.shape[:-1], s.shape[-2], k)
                                   for q, s, k, _ in self.calls)

    def first(self, shape):
        """The inputs of the first recorded call of that shape."""
        return next(c for c in self.calls
                    if (*c[0].shape[:-1], c[1].shape[-2], c[2]) == tuple(shape))

    def __enter__(self):
        self.bf.nn1, self.bf.knnk = self.nn1, self.knnk
        self.bf.nn1_batched = self.nn1_batched
        return self

    def __exit__(self, *exc):
        self.bf.nn1, self.bf.knnk, self.bf.nn1_batched = self.real


def _check_knn(pk, q, s, k, m, label, card):
    """K1 (k = 1) or K2 against its plain version on the same card inputs:
    equal bit for bit (``torch.equal`` on distances and indices, so 0 index
    mismatches and 0.0 distance difference), ascending rows."""
    import torch

    if k == 1:
        (d, i), (dr, ir) = pk.nn1(q, s, m), pk.nn1_reference(q, s, m)
    else:
        (d, i), (dr, ir) = pk.knnk(q, s, k, m), pk.knnk_reference(q, s, k, m)
    torch.cuda.synchronize()
    mism = int((i != ir).sum())
    err = float((d - dr).abs().max()) if d.numel() else 0.0
    print(f"# K{min(k, 2)} {q.shape[0]}x{s.shape[0]} k={k} ({label}): index "
          f"mismatches {mism}, max |dist diff| {err:.3e} {card}", flush=True)
    if not (torch.equal(d, dr) and torch.equal(i, ir)) \
            or not bool((d[:, 1:] >= d[:, :-1]).all()):
        raise RuntimeError(f"{'nn1' if k == 1 else 'knnk'} disagrees with its "
                           f"plain version ({label})")
    return err


def _check_nn1_batched(pk, q, s, m, label, card):
    """K1's batch mode against its plain version and against B unbatched K1
    launches on the same card inputs: equal bit for bit, in one launch."""
    import torch

    before = pk.nn1_batched.launches
    d, i = pk.nn1_batched(q, s, m)
    if pk.nn1_batched.launches != before + 1:
        raise RuntimeError(f"nn1_batched did not launch exactly once ({label})")
    dr, ir = pk.nn1_batched_reference(q, s, m)
    torch.cuda.synchronize()
    singles = [pk.nn1(q[b], s[b], None if m is None else m[b])
               for b in range(q.shape[0])]
    same = all(torch.equal(d[b], db) and torch.equal(i[b], ib)
               for b, (db, ib) in enumerate(singles))
    mism = int((i != ir).sum())
    err = float((d - dr).abs().max()) if d.numel() else 0.0
    print(f"# K1 batched {tuple(q.shape[:2])}x{s.shape[1]} ({label}): index "
          f"mismatches {mism}, max |dist diff| {err:.3e}, equal to "
          f"{q.shape[0]} unbatched launches: {same} {card}", flush=True)
    if not (torch.equal(d, dr) and torch.equal(i, ir) and same):
        raise RuntimeError(f"nn1_batched disagrees with its plain version or "
                           f"with unbatched launches ({label})")
    return err


def _yardstick_fields(ev, dv):
    """The plain version's and cdist+topk's times of a row (None where not
    timed)."""
    def first(d, n):
        return d[n][0] if d.get(n) else None

    return {"plain_ms": first(ev, "plain"), "plain_dev_ms": first(dv, "plain"),
            "cdist_topk_ms": first(ev, "cdist+topk"),
            "cdist_topk_dev_ms": first(dv, "cdist+topk")}


def _time_nn1_batched(pk, q, s, m, card, label, reps=20, yardsticks=False):
    """CUDA-event and profiler times of K1's batch mode and of B unbatched
    K1 launches in turns (singles, kernel, kernel, singles) and, with
    ``yardsticks`` (or ``--yardsticks``), of its plain version and of
    batched cdist+topk (unmasked) on the same inputs, as one row of the
    kernels line."""
    import torch

    yardsticks = yardsticks or _EVERY_YARDSTICK[0]

    B, M, _ = q.shape
    N = s.shape[1]
    if m is None:
        m = torch.ones((B, N), dtype=torch.bool, device=s.device)

    def singles():
        for b in range(B):
            pk.nn1(q[b], s[b], m[b])

    fns = {"kernel": lambda: pk.nn1_batched(q, s, m), "singles": singles,
           "plain": lambda: pk.nn1_batched_reference(q, s, m),
           "cdist+topk": lambda: torch.cdist(q, s).topk(1, largest=False)}
    ev, dv = collections.defaultdict(list), collections.defaultdict(list)
    for n in ("singles", "kernel", "kernel", "singles") + (
            ("plain", "cdist+topk") if yardsticks else ()):
        ev[n].append(_event_ms(fns[n], reps))
        dv[n].append(_device_ms(fns[n], reps))
        torch.cuda.empty_cache()
    n_valid = int(m.sum())
    bound_ms, bound_by = _bound(M, N, n_valid, 1, B)
    print(f"# timing {label} {B}x{M}x{N} k=1 ({n_valid} of {B * N} sources "
          f"valid): median of {reps} CUDA-event runs, ms: "
          + ", ".join(f"{n} " + " ".join(f"{v:.4f}" for v in vs)
                      for n, vs in ev.items())
          + f"; device time per call (profiler, {reps} calls), ms: "
          + ", ".join(f"{n} " + " ".join(f"{v:.4f}" for v in vs)
                      for n, vs in dv.items())
          + f"; bound {bound_ms:.5f} ms ({bound_by}) {card}", flush=True)
    return {"shape": [B, M, N, 1], "label": label, "n_valid": n_valid,
            "ms": statistics.median(ev["kernel"]),
            "dev_ms": statistics.median(dv["kernel"]),
            "singles_ms": statistics.median(ev["singles"]),
            "singles_dev_ms": statistics.median(dv["singles"]),
            **_yardstick_fields(ev, dv), "bound_ms": bound_ms,
            "bound_by": bound_by}


def _device_busy(fn):
    """(device ms, device operations, peak MiB) of one call of ``fn``: the
    profiler's kernel, copy and fill time and count, and the allocator's
    peak over the call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ka = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    return (sum(e.self_device_time_total for e in ka) / 1e3,
            sum(e.count for e in ka), torch.cuda.max_memory_allocated() / 2**20)


def _instances_gate(label, res, cfg, T_a, T_b, card, good_instances):
    """bench.py's multi-instance gate: exactly two GOOD instances, covering
    joints a and b, each < 1 deg and < 5 mm."""
    inst = good_instances(res, cfg, min_separation=0.2)
    errs, covered = [], set()
    for k in inst:
        e = {n: _err(k["pose"], T) for n, T in (("a", T_a), ("b", T_b))}
        name, (ang, dt) = min(e.items(), key=lambda kv: kv[1][1])
        errs.append((name, ang, dt))
        covered.add(name)
    print(f"# {label}: {len(inst)} GOOD instances: "
          + ", ".join(f"{n}: {a:.3f} deg {t * 1000:.3f} mm (candidate "
                      f"{k['candidate']}, view {k['view_idx']})"
                      for (n, a, t), k in zip(errs, inst))
          + f"; valid {int(res.cand_valid.sum())}, verified "
          f"{int(res.cand_verified.sum())} of {res.cand_valid.shape[0]} "
          f"candidates, tier 2 {int(res.metrics['cand_tier2'].sum())}; winner "
          f"accepted {bool(res.accepted)} {card}", flush=True)
    if not (len(inst) == 2 and covered == {"a", "b"}
            and all(a < 1.0 and t < 0.005 for _, a, t in errs)):
        raise RuntimeError(f"{label} missed the gate: {errs}")


def _small_hv(dev, card):
    """verify_hypotheses at small size on the card against the CPU: the
    exhaustive sweep (H = 9, two chunks, one invalid hypothesis) and the
    greedy search (H = 24), with the occlusion exemption; masks equal."""
    import numpy as np
    import torch

    from tpu_joints_torch import synthetic as syn
    from tpu_joints_torch.core.cloud import make_cloud
    from tpu_joints_torch.recognize.hv import verify_hypotheses

    rng = np.random.default_rng(0)
    model = syn.joint_model(500, 300)
    n = len(model)
    seen = (model @ syn.bench_pose()[:3, :3].T + syn.bench_pose()[:3, 3]
            ).astype(np.float32)
    pad = np.full((1024 - n, 3), 1e6, np.float32)
    good = np.concatenate([seen, pad])
    mask = np.zeros(1024, bool)
    mask[:n] = True
    for H in (9, 24):
        insts = np.stack([good + np.float32(0.002 * h) for h in range(3)] + [
            good + rng.normal(scale=0.3, size=3).astype(np.float32)
            for _ in range(H - 3)])
        valid = np.ones(H, bool)
        valid[4] = False
        out = {}
        for d in (dev, torch.device("cpu")):
            out[d.type] = verify_hypotheses(
                torch.as_tensor(insts, device=d),
                torch.as_tensor(np.tile(mask, (H, 1)), device=d),
                torch.as_tensor(valid, device=d),
                make_cloud(seen, capacity=1024, device=d),
                inlier_threshold=0.005, occlusion_threshold=0.001).cpu()
        print(f"# phase 10 verify_hypotheses small, H = {H} "
              f"({'greedy' if H > 16 else 'exhaustive'}), card vs CPU: "
              f"{out['cuda'].int().tolist()} vs {out['cpu'].int().tolist()} "
              f"{card}", flush=True)
        if not torch.equal(out["cuda"], out["cpu"]) or not out["cuda"].any() \
                or bool(out["cuda"][4]):
            raise RuntimeError(f"card and CPU disagree on verify_hypotheses "
                               f"(H = {H})")


def _small_on(d):
    """The organized, generic, segmented and two-part paths at small size
    (320×240 frame, level-0 bank) on device ``d``, with the configurations
    of phases 5-8: ({path: result}, the two-part result). The CPU's run
    needs no card, so ``main`` runs it in a thread during the build."""
    import torch

    from tpu_joints_torch import synthetic as syn
    from tpu_joints_torch.config import DetectionConfig
    from tpu_joints_torch.core.cloud import make_cloud
    from tpu_joints_torch.modelbank.bank import build_bank
    from tpu_joints_torch.pipelines.detect import detect, detect_organized
    from tpu_joints_torch.pipelines.multi import detect_parts_organized

    def small(cfg, capacity):
        return DetectionConfig(**{**dataclasses.asdict(cfg), "scene_ss": 0.03,
                                  "final_icp_iterations": 8,
                                  "scene_capacity": capacity,
                                  "scene_key_capacity": 256})

    det_cfg = dataclasses.replace(syn.bench_config(), segment_scene=False,
                                  remove_plane=False)
    s_org, s_gen = small(det_cfg, 3072), small(syn.generic_config(), 3072)
    s_seg = small(syn.segmented_config(), 3072)
    s_two = small(syn.two_part_config(), 3072)
    T_gt = syn.bench_pose()
    kw = dict(syn.bench_bank_kwargs(s_org), level=0, resolution=64,
              key_capacity=64, icp_capacity=1024)
    xs, vs = syn.frame(T_gt, 42, with_table=False, width=320, height=240)
    xt, vt = syn.frame(T_gt, 42, with_table=True, width=320, height=240)
    pts = syn.scene_points(xs[vs], 3072)
    b = build_bank(syn.joint_model(3000, 1800), **kw, device=d)
    geo = dict(block=2, half_window=3,
               crop_lo=torch.as_tensor(syn.CROP_LO, device=d),
               crop_hi=torch.as_tensor(syn.CROP_HI, device=d))
    out = {}
    out["organized"], _ = detect_organized(torch.as_tensor(xs, device=d),
                                           torch.as_tensor(vs, device=d), b,
                                           s_org, **geo)
    out["generic"] = detect(make_cloud(pts, capacity=3072, device=d), b, s_gen)
    table = (torch.as_tensor(xt, device=d), torch.as_tensor(vt, device=d))
    out["segmented"], _ = detect_organized(*table, b, s_seg, **geo)
    parts = syn.build_part_banks(s_two, device=d, level=0, resolution=64,
                                 key_capacity=64, icp_capacity=1024)
    _, two, _ = detect_parts_organized(*table, parts, s_two, **geo)
    return out, two


def _small_runs(dev, T_gt, card, cpu):
    """The paths at small size (``_small_on``) on the card against ``cpu``,
    the CPU's run (plain versions): poses within 2e-3, both accepted, both
    within the gate. The two-part path at that size finds no acceptable
    pose on either device (most Hough peaks rest on 3-5 matches), so there
    the candidate field is held equal: the views and their validity, each
    half its own part's."""
    import numpy as np
    import torch

    runs = {"cuda": _small_on(dev), "cpu": cpu}
    out = {path: {k: r[0][path] for k, r in runs.items()}
           for path in ("organized", "generic", "segmented")}
    two = {k: r[1] for k, r in runs.items()}
    for path, res in out.items():
        poses = {k: r.full_pose.cpu().numpy() for k, r in res.items()}
        diff = float(np.abs(poses["cuda"] - poses["cpu"]).max())
        errs = {k: _err(p, T_gt) for k, p in poses.items()}
        acc = {k: bool(r.accepted) for k, r in res.items()}
        views = {k: int(r.view_idx) for k, r in res.items()}
        print(f"# {path} path small 320x240, card vs CPU (plain versions): max "
              f"|full_pose diff| {diff:.3e}, view {views['cuda']} vs "
              f"{views['cpu']}, accepted {acc['cuda']} vs {acc['cpu']}, "
              f"rot/trans err card {errs['cuda'][0]:.3f} deg "
              f"{errs['cuda'][1] * 1000:.3f} mm, CPU {errs['cpu'][0]:.3f} deg "
              f"{errs['cpu'][1] * 1000:.3f} mm {card}", flush=True)
        # two views can carry the same true pose, so the winning view may
        # differ where their ranks tie to the last bits; the poses may not
        if diff > 2e-3 or not all(acc.values()) or any(
                r >= 1.0 or t >= 0.005 for r, t in errs.values()):
            raise RuntimeError(f"card and CPU disagree on the small {path} path")
    views = {k: r.cand_views.cpu() for k, r in two.items()}
    ok = {k: r.cand_valid.cpu() for k, r in two.items()}
    half = views["cuda"].shape[0] // 2
    print(f"# two-part path small 320x240, card vs CPU (plain versions): "
          f"candidate views {views['cuda'].tolist()} vs "
          f"{views['cpu'].tolist()}, {int(ok['cuda'].sum())} vs "
          f"{int(ok['cpu'].sum())} valid, accepted "
          f"{bool(two['cuda'].accepted)} vs {bool(two['cpu'].accepted)} {card}",
          flush=True)
    if not (torch.equal(views["cuda"], views["cpu"])
            and torch.equal(ok["cuda"], ok["cpu"])
            and bool((views["cuda"][:half] < 12).all())
            and bool((views["cuda"][half:] >= 12).all())):
        raise RuntimeError("card and CPU disagree on the small two-part "
                           "candidate field")


def _timed_runs(run, n=3):
    import torch

    run()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1000.0)
    return res, times


def _gate(label, res, T_gt, times, card, extra=""):
    import numpy as np

    pose = res.full_pose.cpu().numpy()
    rot, trans = _err(pose, T_gt)
    accepted = bool(res.accepted)
    print(f"# {label}: median {statistics.median(times):.3f} ms "
          f"(min {min(times):.3f}, max {max(times):.3f}) over {len(times)} runs, "
          f"{extra}fitness {float(res.fitness):.3e}, full_fitness "
          f"{float(res.full_fitness):.3e}, accepted {accepted}, view "
          f"{int(res.view_idx)}, rot_err {rot:.3f} deg, trans_err "
          f"{trans * 1000:.3f} mm {card}", flush=True)
    if pose.shape != (4, 4) or not np.isfinite(pose).all():
        raise RuntimeError(f"bad pose {pose}")
    if not (accepted and rot < 1.0 and trans < 0.005):
        raise RuntimeError(f"{label} missed the gate: accepted={accepted} "
                           f"rot={rot:.2f} deg trans={trans * 1000:.1f} mm")


def _count_syncs(fn):
    """Run ``fn`` once with synchronisation warnings on; return its result
    and the flagged host synchronisations, each with the Python line that
    made it."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out, [f"{str(w.message).splitlines()[0]} [{w.filename}:{w.lineno}]"
                 for w in caught if "synchroniz" in str(w.message)]


def _tie(r, view, pose_tol):
    """Whether one frame's batch result ``r`` shows a differing winning
    view as a tie: ``view`` is a valid, verified tier-2 survivor of that
    frame whose polished pose lies within ``pose_tol`` of the winner's.
    Returns (shown, candidate, its gap to the winner, its rank, the
    winner's rank)."""
    import torch

    mt = r.metrics
    rank = mt["cand_coverage"] + 0.1 * mt["cand_full_fitness"]
    twin = (r.cand_views == view) & mt["cand_tier2"] & r.cand_valid \
        & r.cand_verified
    gap = (mt["cand_full_poses"] - r.full_pose).abs().amax((1, 2))
    gap = torch.where(twin, gap, torch.full_like(gap, float("inf")))
    j = int(gap.argmin())
    won = mt["best_coverage"] + 0.1 * r.full_fitness
    return (float(gap[j]) <= pose_tol, j, float(gap[j]), float(rank[j]),
            float(won))


@contextlib.contextmanager
def _serving(service):
    """The service's HTTP server on a free port, served by a daemon thread;
    yields its URL, then shuts the server down."""
    from tpu_joints_torch.serve import make_server

    server = make_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def _post(url, body):
    """POST ``body`` to ``url``/detect: (status, reply, round-trip ms)."""
    req = urllib.request.Request(
        url + "/detect", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            status, reply = r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        status, reply = e.code, json.loads(e.read())
    return status, reply, (time.perf_counter() - t0) * 1e3


def _health(url):
    with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
        return json.loads(r.read())


def _depth(xyz_img, valid):
    """A raycast frame as a depth sensor gives it: its z plane, 0 where the
    ray missed (metric, the raycaster's 57° field of view)."""
    import numpy as np

    return np.where(valid, xyz_img[..., 2], 0.0).astype(np.float32)


def _depth_body(depth):
    """A /detect body carrying a depth frame as base64 float32."""
    return {"depth_b64": base64.b64encode(depth.tobytes()).decode(),
            "depth_shape": list(depth.shape)}


class _Replies:
    """Wraps a service's ``_payload`` and keeps every request's host
    result beside its reply, so a reply's candidate tables can be read."""

    def __init__(self, service):
        self.kept, real = [], service._payload

        def payload(res, latency_ms, cfg):
            out = real(res, latency_ms, cfg)
            self.kept.append((res, out))
            return out

        service._payload = payload

    def result_of(self, reply):
        return next(r for r, out in self.kept if out["pose"] == reply["pose"]
                    and out["latency_ms"] == reply["latency_ms"])


def _reply_gate(label, reply, T, card):
    """The accuracy gate on one reply: accepted, < 1 deg and < 5 mm."""
    import numpy as np

    rot, trans = _err(np.asarray(reply["pose"]), T)
    print(f"#   {label}: accepted {reply['accepted']}, view "
          f"{reply['view_idx']}, rot_err {rot:.3f} deg, trans_err "
          f"{trans * 1000:.3f} mm, scene points "
          f"{reply['metrics']['scene_points']}, device call "
          f"{reply['latency_ms']:.3f} ms {card}", flush=True)
    if not (reply["accepted"] and rot < 1.0 and trans < 0.005):
        raise RuntimeError(f"{label} missed the gate: accepted "
                           f"{reply['accepted']}, {rot:.2f} deg, "
                           f"{trans * 1000:.1f} mm")


def _serve_phase(dev, kind, card, bank, launches, check, check_batched, cfgs,
                 frames, timings, n_batch=8):
    """Phase 12: the detection server on the card, driven over HTTP with
    depth frames at the frames' full size (see the module docstring).
    ``cfgs`` holds the organized (det), segmented (seg), GO-HV (hv) and
    generic (gen) configurations, ``frames`` the bench frame (xyz, valid,
    its pose T and phase 6's cloud, scene) and the two-instance frame (two,
    two_valid, T_a, T_b). Adds each served path's launches by shape to
    ``launches`` and returns its (K1, K1 batched, K2) launch counts by
    path."""
    import numpy as np
    import torch

    from tpu_joints_torch import native
    from tpu_joints_torch import synthetic as syn
    from tpu_joints_torch.core import graphs
    from tpu_joints_torch.neighbors import bruteforce
    from tpu_joints_torch.neighbors import pallas_knn as pk
    from tpu_joints_torch.pipelines.detect import (detect, detect_organized,
                                                   good_instances)
    from tpu_joints_torch.segment import organized as lattice
    rg = importlib.import_module("tpu_joints_torch.segment.region_growing")
    from tpu_joints_torch.serve import DetectionService
    from tpu_joints_torch.serve.depth import depth_to_cloud
    from tpu_joints_torch.serve.server import _decode_array, depth_block

    det_cfg, seg_cfg, hv_cfg, gen_cfg = (cfgs[k] for k in ("det", "seg", "hv",
                                                           "gen"))
    xyz_h, valid_h, two_h, two_valid_h, T_gt, T_a, T_b, scene = (
        frames[k] for k in ("xyz", "valid", "two", "two_valid", "T", "T_a",
                            "T_b", "scene"))
    H, W = valid_h.shape
    POSE_TOL = 3e-4

    def reply_gate(label, reply, T):
        _reply_gate(label, reply, T, card)

    def direct(cfg, depth):
        """``detect_organized`` on the depth frame as the server unprojects
        it, at the server's block and half-window, no crop box."""
        xyz = depth_to_cloud(depth)
        ok = np.isfinite(xyz).all(-1)
        H, W = ok.shape
        blk = depth_block(H, W, cfg.scene_capacity)
        Hc, Wc = H - H % blk, W - W % blk
        return detect_organized(
            torch.as_tensor(np.nan_to_num(xyz[:Hc, :Wc]), device=dev),
            torch.as_tensor(ok[:Hc, :Wc], device=dev), bank, cfg, block=blk,
            half_window=5)

    def served(label, service, bodies):
        """Send ``bodies`` concurrently (one thread each) with every count
        taken from 0: (replies, round-trip ms, syncs flagged, recorder,
        (K1, K1 batched, K2) launches of the eager warm-ups before this
        call's captures, (lattice, graph) region-growing reads plus the
        captured graphs' flag reads, the graphs captured). A request
        replays the captured chain of its configuration, shapes and bank
        (phase 17), captured by the first request that needs it: a replay
        calls no wrapper, so the wrappers' counts (the warm-up's and the
        capture's launches) are printed, the recorder's kept. Every reply
        must be a 200."""
        pk.nn1.launches = pk.nn1_batched.launches = pk.knnk.launches = 0
        lattice.region_growing_lattice.host_checks = 0
        rg.region_growing.host_checks = 0
        n_entries = len(graphs.entries())
        flag_reads = sum(e.reads for e in graphs.entries())
        with _serving(service) as url, _Recorder(bruteforce) as rec:
            with ThreadPoolExecutor(len(bodies)) as ex:
                out, syncs = _count_syncs(
                    lambda: list(ex.map(lambda b: _post(url, b), bodies)))
            health = _health(url)
        wrapped = (pk.nn1.launches, pk.nn1_batched.launches, pk.knnk.launches)
        n = rec.counts()
        new = graphs.entries()[n_entries:]
        reads = (lattice.region_growing_lattice.host_checks,
                 rg.region_growing.host_checks,
                 sum(e.reads for e in graphs.entries()) - flag_reads)
        bad = [(st, r) for st, r, _ in out if st != 200]
        if bad:
            raise RuntimeError(f"{label}: the server answered {bad[0]}")
        print(f"# {label}: {len(bodies)} requests, {len(new)} graphs "
              f"captured; the warm-ups launched nn1 {n[0]} times, "
              f"nn1_batched {n[1]}, knnk {n[2]} (with the captures "
              f"{wrapped}); launches by shape: "
              f"{dict(sorted(rec.shapes().items()))}; host synchronisations "
              f"flagged: {len(syncs)}, region-growing host reads (lattice, "
              f"graph, captured flags): {reads}; batches {service.n_batches}; "
              f"/healthz {health} {card}", flush=True)
        for msg in sorted(set(syncs))[:5]:
            print(f"#   sync: {msg}", flush=True)
        return ([r for _, r, _ in out], [t for _, _, t in out], syncs, rec, n,
                reads, health, new)

    def recheck_new_shapes(label, rec, k2_all=False):
        """Recheck bit for bit, on its recorded inputs, the first launch of
        every shape no earlier path launched (every K2 launch with
        ``k2_all``)."""
        seen = set().union(*(set(c) for c in launches.values()))
        done = set()
        for q, s_, k, m in rec.calls:
            shape = (*q.shape[:-1], s_.shape[-2], k)
            if k > 1 and k2_all:
                check(q, s_, k, m, f"{label} K2, recorded inputs")
            elif shape not in seen and shape not in done:
                if q.ndim == 3:
                    check_batched(q.contiguous(), s_, m,
                                  f"{label} {shape}, recorded inputs")
                else:
                    check(q, s_, k, m, f"{label} {shape}, recorded inputs")
            done.add(shape)

    def time_served_shapes(label, rec):
        """Time the K1 shapes no earlier path launched on their recorded
        inputs (K1, or K1's batch mode for a 4-tuple), 5 calls each."""
        from tpu_joints_torch.neighbors import pallas_knn as pk

        seen = set().union(*(set(c) for c in launches.values()))
        for shape in sorted(set(rec.shapes()) - seen):
            if shape[-1] != 1:
                continue
            q, s_, k, m = rec.first(shape)
            if len(shape) == 4:
                timings["batched"].append(_time_nn1_batched(
                    pk, q.contiguous(), s_, m, card,
                    f"{label} K1 batched {shape}", reps=5))
            else:
                timings[1].append(_time_knn(pk, q, s_, m, k, card,
                                            f"{label} K1 {shape}", reps=5))
        torch.cuda.empty_cache()

    def same_reply(label, reply, ref, res):
        """Phase 11's gate on a batched reply against the reply of the
        frame's own single run: accept flag, counts, pose within 3e-4, and
        the view unless ``res`` (the batched reply's host result) shows the
        tie. Returns the pose gap."""
        diff = float(np.abs(np.asarray(reply["pose"], np.float32)
                            - np.asarray(ref["pose"], np.float32)).max())
        counts = [(reply["metrics"][k], ref["metrics"][k]) for k in (
            "scene_points", "scene_keypoints", "correspondences", "instances")]
        if reply["accepted"] != ref["accepted"] or any(
                a != b for a, b in counts) or (reply["accepted"]
                                               and diff > POSE_TOL):
            raise RuntimeError(f"{label} differs from its own run: accepted "
                               f"{reply['accepted']} vs {ref['accepted']}, "
                               f"counts {counts}, max |pose diff| {diff:.3e}")
        if reply["accepted"] and reply["view_idx"] != ref["view_idx"]:
            shown, j, gap, rank, won = _tie(res, ref["view_idx"], POSE_TOL)
            print(f"#     {label} won view {reply['view_idx']} at rank "
                  f"{won:.9g}; view {ref['view_idx']}, its own run's, is "
                  f"candidate {j}: tie shown {shown}, rank {rank:.9g}, max "
                  f"|full_pose diff| to the winner {gap:.3e} {card}",
                  flush=True)
            if not shown:
                raise RuntimeError(f"{label} won view {reply['view_idx']}, "
                                   f"its own run view {ref['view_idx']}, "
                                   f"with no tie shown")
        return diff if reply["accepted"] else 0.0

    # 12.1 streaming: bench frames (seeds 0-2) one at a time
    stream_frames = [_depth(*syn.frame(T_gt, seed, with_table=False, width=W,
                                       height=H)) for seed in range(3)]
    bodies = [_depth_body(f) for f in stream_frames]
    host_ms = []
    for body in bodies:
        t0 = time.perf_counter()
        xyz = depth_to_cloud(_decode_array(body, "depth"))
        np.isfinite(xyz).all(-1)
        host_ms.append((time.perf_counter() - t0) * 1e3)
    svc = DetectionService(bank, det_cfg)
    stream = []
    for i, body in enumerate(bodies):     # request 0 captures the graph
        out = served(f"phase 12.1 streaming request {i}", svc, [body])
        stream.append(out)
        if len(out[2]) != 1 or out[5] != (0, 0, 0) or len(out[7]) != (i == 0):
            raise RuntimeError(f"streaming request {i} read the host "
                               f"{len(out[2])} times, expected once, and "
                               f"captured {len(out[7])} graphs")
    t0 = time.perf_counter()
    DetectionService(bank, det_cfg).warmup(depth_shape=(H, W))
    print(f"# phase 12 warmup (a 16-point cloud and the first view rendered "
          f"to {W}x{H} depth, which replays request 0's graph; phase 17 "
          f"times a warm-up that captures) in "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms {card}", flush=True)
    recheck_new_shapes("phase 12.1", stream[0][3])
    launches["served streaming"] = stream[0][3].shapes()
    health = stream[-1][6]
    if health["requests"] != 3 or health["device"] != kind:
        raise RuntimeError(f"/healthz after 3 requests: {health}")
    blk = depth_block(H, W, det_cfg.scene_capacity)
    for i, (frame_i, out) in enumerate(zip(stream_frames, stream)):
        reply = out[0][0]
        ref, _ = direct(det_cfg, frame_i)
        diff = float(np.abs(np.asarray(reply["pose"], np.float32)
                            - ref.full_pose.cpu().numpy()).max())
        print(f"#   streaming request {i} (seed {i}): max |pose diff| to a "
              f"direct detect_organized at block {blk} {diff:.3e} {card}",
              flush=True)
        if diff > 1e-5:
            raise RuntimeError(f"streaming request {i} differs from its "
                               f"direct run by {diff:.3e}")
        reply_gate(f"phase 12.1 streaming request {i}", reply, T_gt)
    dev_ms = [out[0][0]["latency_ms"] for out in stream]
    rt_ms = [out[1][0] for out in stream]
    print(f"# phase 12.1 streaming {W}x{H} over HTTP (block {blk}, "
          f"{det_cfg.scene_capacity} lanes): medians of 3, host decode + "
          f"unproject {statistics.median(host_ms):.3f} ms, device call "
          f"{statistics.median(dev_ms):.3f} ms, round trip "
          f"{statistics.median(rt_ms):.3f} ms; 1 host read per request "
          f"{card}", flush=True)

    # 12.2 micro-batched: phase 11's 8 jittered frames, concurrently. Each
    # request spends ~25-40 ms on the host (JSON, base64, unprojection)
    # under one interpreter lock before it reaches the batcher, so the
    # leader waits up to 1 s for the last of them
    bodies = [_depth_body(_depth(f, valid_h))
              for f in syn.batch_frames(xyz_h, n_batch)]
    svc_b = DetectionService(bank, det_cfg, batch_max=8,
                             batch_window_ms=1000.0)
    replies = _Replies(svc_b)
    outs, rt_b, syncs, rec, nb, reads, _, _ = served(
        "phase 12.2 micro-batched 8 frames", svc_b, bodies)
    batches = svc_b.n_batches
    if batches >= n_batch or len(syncs) != batches or reads != (0, 0, 0):
        raise RuntimeError(f"8 requests ran as {batches} batches with "
                           f"{len(syncs)} host reads")
    recheck_new_shapes("phase 12.2", rec)
    launches["served batch"] = rec.shapes()
    worst, n_acc = 0.0, 0
    for b, (reply, body) in enumerate(zip(outs, bodies)):
        ref = svc.detect_depth(_decode_array(body, "depth"))
        worst = max(worst, same_reply(f"phase 12.2 batched frame {b}", reply,
                                      ref, replies.result_of(reply)))
        rot, trans = _err(np.asarray(reply["pose"]), T_gt)
        print(f"#   phase 12.2 batched frame {b}: accepted "
              f"{reply['accepted']}, view {reply['view_idx']} (streaming "
              f"{ref['view_idx']}), rot_err {rot:.3f} deg, trans_err "
              f"{trans * 1000:.3f} mm {card}", flush=True)
        if reply["accepted"]:      # phase 11's gate on a batch
            n_acc += 1
            if not (rot < 5.0 and trans < 0.020):
                raise RuntimeError(f"the served batch accepted a wrong pose: "
                                   f"frame {b}, {rot:.1f} deg")
    if n_acc < int(BATCH_ACCEPTED * n_batch):
        raise RuntimeError(f"only {n_acc} of {n_batch} served frames accepted")
    print(f"# phase 12.2 micro-batched {W}x{H} over HTTP: {n_batch} requests "
          f"in {batches} batches, every reply within {worst:.3e} of the "
          f"streaming service's; round trip median "
          f"{statistics.median(rt_b):.3f} ms, max {max(rt_b):.3f} ms "
          f"(the slowest reply bounds the batch: {max(rt_b) / n_batch:.3f} ms "
          f"per request) against {statistics.median(rt_ms):.3f} ms streaming "
          f"{card}", flush=True)
    # 12.3 segmented + the clustered box, micro-batched: 4 table frames.
    # The block rule sizes the block from the capacity as if the whole frame
    # were the working set; the crop chain keeps the object only, and needs
    # the bench's block 4, which a capacity of 8192 lanes gives at 640x480
    # (at 2560 lanes, block 8, it misses, as the reference does: below)
    seg_box_cfg = dataclasses.replace(seg_cfg, obb_largest_cluster=True,
                                      scene_capacity=8192)
    table_depths = [_depth(*syn.frame(T_gt, seed, with_table=True, width=W,
                                      height=H)) for seed in range(4)]
    bodies = [_depth_body(d) for d in table_depths]
    svc_s = DetectionService(bank, seg_box_cfg, batch_max=4,
                             batch_window_ms=1000.0)
    replies = _Replies(svc_s)
    outs, rt_s, syncs, rec, ns, reads, _, new = served(
        "phase 12.3 segmented + clustered box, 4 frames", svc_s, bodies)
    # each batch reads its graph's growings' flags once; each capture's
    # warm-up runs the clustered box (2 K2 launches) frame by frame
    warm_frames = sum(e.inputs[0].shape[0] * len(e.graphs) for e in new)
    if (len(syncs) != reads[2] + svc_s.n_batches or reads != (0, 0,
                                                               svc_s.n_batches)
            or svc_s.n_batches >= 4 or not new
            or len(rec.k2_calls()) != 2 * warm_frames):
        raise RuntimeError(f"the segmented batch read the host {len(syncs)} "
                           f"times (region growings {reads}, "
                           f"{svc_s.n_batches} batches) and its warm-ups "
                           f"launched K2 {len(rec.k2_calls())} times for "
                           f"{warm_frames} frames")
    recheck_new_shapes("phase 12.3", rec, k2_all=True)
    time_served_shapes("phase 12.3", rec)
    launches["served segmented"] = rec.shapes()
    single = DetectionService(bank, seg_box_cfg)
    worst_box, n_acc = 0.0, 0
    for b, (reply, body) in enumerate(zip(outs, bodies)):
        ref = single.detect_depth(_decode_array(body, "depth"))
        diff = same_reply(f"phase 12.3 frame {b}", reply, ref,
                          replies.result_of(reply))
        if reply["accepted"] and reply["view_idx"] == ref["view_idx"]:
            # the box's leaves, its angles in radians
            box = max(float(np.abs(np.radians(np.subtract(
                reply["obb"][k], ref["obb"][k])) if k == "euler_deg"
                else np.subtract(reply["obb"][k], ref["obb"][k])).max())
                for k in ("position", "rotation", "extents", "euler_deg"))
            worst_box = max(worst_box, box)
            print(f"#   phase 12.3 frame {b}: pose {diff:.3e} and clustered "
                  f"box {box:.3e} from its own run's {card}", flush=True)
            if box > 1e-4:
                raise RuntimeError(f"phase 12.3 frame {b}: the clustered box "
                                   f"is {box:.3e} from its own run's")
        if reply["accepted"]:      # phase 11's share; an accepted pose
            n_acc += 1             # must pass the gate
            reply_gate(f"phase 12.3 segmented frame {b}", reply, T_gt)
        else:
            rot, trans = _err(np.asarray(reply["pose"]), T_gt)
            print(f"#   phase 12.3 segmented frame {b}: rejected, as in its "
                  f"own run (winner {rot:.3f} deg, {trans * 1000:.3f} mm "
                  f"from the truth) {card}", flush=True)
    if n_acc < int(BATCH_ACCEPTED * len(bodies)):
        raise RuntimeError(f"only {n_acc} of {len(bodies)} segmented frames "
                           f"accepted")
    print(f"# phase 12.3 segmented + clustered box {W}x{H} over HTTP "
          f"(block {depth_block(H, W, seg_box_cfg.scene_capacity)}, "
          f"{seg_box_cfg.scene_capacity} lanes): 4 requests in "
          f"{svc_s.n_batches} batches, {n_acc} accepted, boxes within "
          f"{worst_box:.3e} of their own runs; round trip median "
          f"{statistics.median(rt_s):.3f} ms {card}", flush=True)
    narrow = dataclasses.replace(seg_box_cfg,
                                 scene_capacity=seg_cfg.scene_capacity)
    reply = DetectionService(bank, narrow).detect_depth(table_depths[0])
    rot, trans = _err(np.asarray(reply["pose"]), T_gt)
    print(f"# phase 12.3 the same config at {narrow.scene_capacity} lanes "
          f"(block {depth_block(H, W, narrow.scene_capacity)}), table frame "
          f"0, reported, not gated: accepted {reply['accepted']}, scene "
          f"points {reply['metrics']['scene_points']}, rot_err {rot:.3f} "
          f"deg, trans_err {trans * 1000:.3f} mm {card}", flush=True)
    if reply["accepted"]:          # an accepted pose must be right
        reply_gate("phase 12.3 at block 8", reply, T_gt)

    # 12.4 GO-HV, micro-batched: the two-instance frame and a jittered copy
    bodies = [_depth_body(_depth(f, two_valid_h))
              for f in (two_h, syn.batch_frames(two_h, 1)[0])]
    svc_h = DetectionService(bank, hv_cfg, batch_max=2,
                             batch_window_ms=1000.0)
    replies = _Replies(svc_h)
    outs, rt_h, syncs, rec, nh, reads, _, _ = served(
        "phase 12.4 GO-HV, 2 frames", svc_h, bodies)
    if (len(syncs) != svc_h.n_batches or reads != (0, 0, 0)
            or not any(c[0].ndim == 3 for c in rec.calls)):
        raise RuntimeError(f"the HV batch read the host {len(syncs)} times "
                           f"in {svc_h.n_batches} batches")
    recheck_new_shapes("phase 12.4", rec)
    time_served_shapes("phase 12.4", rec)
    launches["served hv"] = rec.shapes()
    def joints(r):
        """The GOOD instances of a result (phase 9's separation), each with
        the joint it lies nearest to: (joint, deg, m, pose, view)."""
        out = []
        for k in good_instances(r, hv_cfg, min_separation=0.2):
            errs = {n: _err(k["pose"], T) for n, T in (("a", T_a), ("b", T_b))}
            name, (ang, dt) = min(errs.items(), key=lambda kv: kv[1][1])
            out.append((name, ang, dt, k["pose"], k["view_idx"]))
        return out

    def listed(js):
        return ", ".join(f"{n} {a:.3f} deg {t * 1000:.3f} mm (view {v})"
                         for n, a, t, _, v in js) or "none"

    single = DetectionService(bank, hv_cfg)
    singles = _Replies(single)
    found = set()
    for b, (reply, body) in enumerate(zip(outs, bodies)):
        ref = single.detect_depth(_decode_array(body, "depth"))
        r_b, r_1 = replies.result_of(reply), singles.result_of(ref)
        same_reply(f"phase 12.4 frame {b}", reply, ref, r_b)
        j_b, j_1 = joints(r_b), joints(r_1)
        ver = (int(r_b.cand_verified.sum()), int(r_1.cand_verified.sum()))
        print(f"#   phase 12.4 frame {b}: GOOD in the batch: {listed(j_b)}; "
              f"alone: {listed(j_1)}; verified {ver[0]} and {ver[1]} of "
              f"{r_b.cand_verified.shape[0]}; {len(reply['instances'])} and "
              f"{len(ref['instances'])} instances in the replies {card}",
              flush=True)
        if (ver[0] != ver[1] or [j[0] for j in j_b] != [j[0] for j in j_1]
                or any(float(np.abs(x[3] - y[3]).max()) > POSE_TOL
                       for x, y in zip(j_b, j_1))
                or len(reply["instances"]) != len(ref["instances"])):
            raise RuntimeError(f"phase 12.4 frame {b}: the batch's verified "
                               f"count or GOOD list differs from its own "
                               f"run's")
        if (not j_b or len({j[0] for j in j_b}) != len(j_b)
                or any(a >= 1.0 or t >= 0.005 for _, a, t, _, _ in j_b)):
            raise RuntimeError(f"phase 12.4 frame {b}: a wrong, twice "
                               f"listed or missing GOOD instance: "
                               f"{listed(j_b)}")
        found |= {j[0] for j in j_b}
    # the same frame as phase 10 gives it (the raycast cloud, not the
    # unprojected depth), without the crop box: reported, not gated
    r_x, _ = detect_organized(torch.as_tensor(two_h, device=dev),
                              torch.as_tensor(two_valid_h, device=dev), bank,
                              hv_cfg, block=depth_block(H, W,
                                                        hv_cfg.scene_capacity),
                              half_window=5)
    print(f"# phase 12.4 joints GOOD over both frames: {sorted(found)}; the "
          f"raycast frame of phase 10 without its crop box: "
          f"{listed(joints(r_x))} {card}", flush=True)
    print(f"# phase 12.4 GO-HV {W}x{H} over HTTP: 2 requests in "
          f"{svc_h.n_batches} batch(es); round trip median "
          f"{statistics.median(rt_h):.3f} ms {card}", flush=True)

    # 12.5 a points request: the generic cloud through the native ingest
    if not native.available():
        raise RuntimeError("the native host library did not build")
    gen_pts = syn.scene_points(xyz_h[valid_h], gen_cfg.scene_capacity)
    body = {"points_b64": base64.b64encode(gen_pts.tobytes()).decode(),
            "points_shape": list(gen_pts.shape)}
    svc_p = DetectionService(bank, gen_cfg)
    outs, rt_p, syncs, rec, npnt, reads, _, _ = served(
        "phase 12.5 points request", svc_p, [body])
    if (len(syncs) != reads[1] + 1 or reads[0] != 0 or reads[2] != 0
            or len(rec.k2_calls()) != 4):
        raise RuntimeError(f"the points request read the host {len(syncs)} "
                           f"times ({reads[1]} region-growing reads) and "
                           f"launched K2 {len(rec.k2_calls())} times")
    recheck_new_shapes("phase 12.5", rec, k2_all=True)
    launches["served points"] = rec.shapes()
    ref = detect(scene, bank, gen_cfg)
    diff = float(np.abs(np.asarray(outs[0]["pose"], np.float32)
                        - ref.full_pose.cpu().numpy()).max())
    print(f"#   phase 12.5: {len(gen_pts)} points through the native ingest "
          f"(built: {native.available()}), max |pose diff| to phase 6's "
          f"direct detect {diff:.3e}; round trip {rt_p[0]:.3f} ms {card}",
          flush=True)
    if diff > 1e-5:
        raise RuntimeError(f"the points request differs from a direct detect "
                           f"by {diff:.3e}")
    reply_gate("phase 12.5 points request", outs[0], T_gt)
    # the served paths: one streaming request, the batch of 8 requests, the
    # 4 segmented requests, the 2 HV requests, the points request
    return {"served streaming": stream[0][4], "served batch": nb,
            "served segmented": ns, "served hv": nh, "served points": npnt}


# the JAX package's detect_organized on the FPFH frame on the CPU
# (scripts/full_size_reference.py fpfh [--port-bank]): on the same bank as
# the port builds it, the result phase 13.1 reproduces; on the JAX
# package's own bank, printed beside it
FPFH_CPU_JAX = dict(accepted=False, view=38, rot_deg=11.985, trans_mm=76.272)
FPFH_CPU_JAX_OWN_BANK = dict(accepted=False, view=38, rot_deg=11.888,
                             trans_mm=77.454)


def _fpfh_phase(dev, card, bank, launches, check, timings, frames, gen_cfg):
    """Phase 13: the FPFH chain at bench width (13.1), the generic path's
    options on phase 6's cloud (13.2) and the ``fpfh_demo`` preset served
    (13.3); see the module docstring. ``frames`` holds the table frame
    (tab, tab_valid), its pose T, the crop box (lo, hi) and phase 6's cloud
    (scene). Adds each path's launches by shape to ``launches`` and returns
    its (K1, K1 batched, K2) launch counts by path."""
    counts = {}
    for part in (_fpfh_frame, _fpfh_options, _fpfh_served):
        counts.update(part(dev, card, bank, launches, check, timings, frames,
                           gen_cfg))
    return counts


def _run_counted(label, run, check, card):
    """One run with every launch count, the syncs and the region growings'
    reads taken from 0; every K1 and K2 launch rechecked bit for bit on its
    recorded inputs. Returns (result, recorder, (K1, K1 batched, K2)
    launches, syncs, (lattice, graph, voxel) reads)."""
    from tpu_joints_torch.neighbors import bruteforce
    from tpu_joints_torch.neighbors import pallas_knn as pk
    from tpu_joints_torch.segment import organized as lattice
    rg = importlib.import_module("tpu_joints_torch.segment.region_growing")
    from tpu_joints_torch.segment import voxel

    pk.nn1.launches = pk.nn1_batched.launches = pk.knnk.launches = 0
    lattice.region_growing_lattice.host_checks = 0
    rg.region_growing.host_checks = 0
    voxel.region_growing_voxel.host_checks = 0
    with _Recorder(bruteforce) as rec:
        out, syncs = _count_syncs(run)
    n = (pk.nn1.launches, pk.nn1_batched.launches, pk.knnk.launches)
    reads = (lattice.region_growing_lattice.host_checks,
             rg.region_growing.host_checks,
             voxel.region_growing_voxel.host_checks)
    print(f"# {label}: nn1 launched {n[0]} times, nn1_batched {n[1]}, knnk "
          f"{n[2]}; launches by shape: {dict(sorted(rec.shapes().items()))}; "
          f"host synchronisations flagged: {len(syncs)}, region-growing host "
          f"reads (lattice, graph, voxel): {reads} {card}", flush=True)
    for msg in sorted(set(syncs))[:5]:
        print(f"#   sync: {msg}", flush=True)
    for j, (q, s_, k, m) in enumerate(rec.calls):
        check(q, s_, k, m, f"{label}, launch {j}, recorded inputs")
    return out, rec, n, syncs, reads


def _fpfh_frame(dev, card, bank, launches, check, timings, frames, gen_cfg):
    """13.1: the FPFH bank and frame at bench width (``_fpfh_phase``)."""
    import numpy as np
    import torch

    from tpu_joints_torch import synthetic as syn
    from tpu_joints_torch.modelbank.bank import build_bank
    from tpu_joints_torch.neighbors import bruteforce
    from tpu_joints_torch.neighbors import pallas_knn as pk
    from tpu_joints_torch.pipelines.detect import detect_organized

    tab, tab_valid, T_gt, lo, hi = (
        frames[k] for k in ("tab", "tab_valid", "T", "lo", "hi"))
    counts = {}
    fp_cfg = syn.fpfh_config()
    torch.cuda.synchronize()
    pk.knnk.launches = 0
    t0 = time.perf_counter()
    with _Recorder(bruteforce) as rec:
        fbank = build_bank(syn.joint_model(), **syn.fpfh_bank_recipe(fp_cfg),
                           device=dev)
    torch.cuda.synchronize()
    fbank_s = time.perf_counter() - t0
    launches["fpfh bank"] = rec.shapes()
    counts["fpfh bank"] = (0, 0, pk.knnk.launches)
    print(f"# phase 13.1 FPFH bank: {fbank.n_views} views, desc "
          f"{tuple(fbank.desc.shape)}, {int(fbank.key_valid.sum())} valid "
          f"keys, built in {fbank_s:.2f} s; K2 launched {pk.knnk.launches} "
          f"times; launches by shape: "
          f"{dict(sorted(launches['fpfh bank'].items()))} {card}", flush=True)
    if pk.knnk.launches != fbank.n_views or fbank.desc.shape[-1] != 33:
        raise RuntimeError("the FPFH bank launched K2 "
                           f"{pk.knnk.launches} times for {fbank.n_views} "
                           f"views, or its descriptors are not 33-D")
    for n, (q, s_, k, m) in enumerate(rec.k2_calls()):
        check(q, s_, k, m, f"FPFH bank view {n} normals")

    def run_fpfh():
        return detect_organized(tab, tab_valid, fbank, fp_cfg, block=4,
                                half_window=5, crop_lo=lo, crop_hi=hi)

    (res, n_sel), rec, n, syncs, reads = _run_counted(
        "phase 13.1 FPFH frame", run_fpfh, check, card)
    launches["fpfh"] = rec.shapes()
    counts["fpfh"] = n
    if n[0] == 0 or n[1:] != (0, 0) or len(syncs) != reads[0] or reads[0] < 1:
        raise RuntimeError(f"the FPFH frame launched {n}, read the host "
                           f"{len(syncs)} times for {reads} region-growing "
                           f"reads")
    (res, n_sel), times = _timed_runs(run_fpfh)
    busy, ops, peak = _device_busy(run_fpfh)
    pose = res.full_pose.cpu().numpy()
    rot, trans = _err(pose, T_gt)
    print(f"# phase 13.1 FPFH 640x480 with table (synthetic.fpfh_config): "
          f"median {statistics.median(times):.3f} ms (min {min(times):.3f}, "
          f"max {max(times):.3f}) over {len(times)} runs, n_selected "
          f"{int(n_sel)}, {int(res.metrics['valid_descriptors'])} valid "
          f"descriptors, {int(res.metrics['correspondences'])} matches, "
          f"accepted {bool(res.accepted)}, view {int(res.view_idx)}, rot_err "
          f"{rot:.3f} deg, trans_err {trans * 1000:.3f} mm; device busy "
          f"{busy:.3f} ms, {ops} device operations, peak {peak:.1f} MiB, bank "
          f"{fbank_s:.2f} s {card}", flush=True)
    ref = FPFH_CPU_JAX
    print(f"# phase 13.1 the JAX package on the CPU, same frame and bank: "
          f"accepted {ref['accepted']}, view {ref['view']}, rot_err "
          f"{ref['rot_deg']:.3f} deg, trans_err {ref['trans_mm']:.3f} mm "
          f"(on its own bank: {FPFH_CPU_JAX_OWN_BANK}); "
          f"FPFH's own gate (accepted, < 2 deg, < 5 mm) met on the card: "
          f"{bool(res.accepted) and rot < 2.0 and trans < 0.005} {card}",
          flush=True)
    # the card reproduces the reference's result, and an accepted pose must
    # pass FPFH's gate
    if not (np.isfinite(pose).all()
            and bool(res.accepted) == ref["accepted"]
            and int(res.view_idx) == ref["view"]
            and abs(rot - ref["rot_deg"]) < 0.1
            and abs(trans * 1000 - ref["trans_mm"]) < 1.0):
        raise RuntimeError(f"phase 13.1 differs from the JAX package's result "
                           f"on the CPU: accepted {bool(res.accepted)}, view "
                           f"{int(res.view_idx)}, {rot:.3f} deg, "
                           f"{trans * 1000:.3f} mm")
    if bool(res.accepted) and not (rot < 2.0 and trans < 0.005):
        raise RuntimeError(f"phase 13.1 accepted a pose {rot:.2f} deg, "
                           f"{trans * 1000:.1f} mm off")

    return counts


def _fpfh_options(dev, card, bank, launches, check, timings, frames,
                  gen_cfg):
    """13.2: the generic path's options on phase 6's cloud
    (``_fpfh_phase``)."""
    import numpy as np
    import torch

    from tpu_joints_torch.features import normals as fnormals
    from tpu_joints_torch.features.shot import compute_shot
    from tpu_joints_torch.neighbors import pallas_knn as pk
    from tpu_joints_torch.pipelines.detect import detect, prepare_scene

    T_gt, scene = frames["T"], frames["scene"]
    counts = {}
    N = scene.capacity
    anchors = 1024
    full = fnormals.estimate_normals_anchored(scene, k=16, anchors=N)
    exact = fnormals.estimate_normals(scene, k=16)
    if not all(torch.equal(a, b) for a, b in zip(full, exact)):
        raise RuntimeError("anchored normals with anchors >= capacity differ "
                           "from estimate_normals")
    part, rec, n, _, _ = _run_counted(
        "phase 13.2 anchored normals",
        lambda: fnormals.estimate_normals_anchored(scene, k=16,
                                                   anchors=anchors),
        check, card)
    new = {(anchors, N, 16): 1, (N, anchors, 1): 1}
    if dict(rec.shapes()) != new:
        raise RuntimeError(f"the anchored normals launched "
                           f"{dict(rec.shapes())}, expected {new}")
    for shape, label in (((anchors, N, 16), "anchor k-NN"),
                         ((N, anchors, 1), "nearest anchor")):
        q, s_, k, m = rec.first(shape)
        timings[min(k, 2)].append(_time_knn(
            pk, q, s_, m, k, card, f"phase 13.2 K{min(k, 2)} ({label})"))
    mask = scene.mask
    dots = (part[0] * exact[0]).sum(1).abs()[mask].cpu().numpy()
    print(f"# phase 13.2 anchored normals ({anchors} of {N} lanes) against "
          f"the exact k = 16 normals: median |cos| {np.median(dots):.6f}, 5% "
          f"quantile {np.quantile(dots, 0.05):.6f}; anchors >= capacity "
          f"bit-equal to estimate_normals {card}", flush=True)
    # tests/test_anchor_normals.py's gate
    if not (np.median(dots) > 0.999 and np.quantile(dots, 0.05) > 0.98):
        raise RuntimeError("anchored normals stray from the exact ones")
    gated = {"normal_anchors": True, "algorithm": True, "rg_backend": True,
             "keypoints": False}
    for opt in ({"normal_anchors": anchors}, {"algorithm": "gc"},
                {"keypoints": "iss"}, {"rg_backend": "voxel"}):
        cfg = dataclasses.replace(gen_cfg, **opt)
        name = next(iter(opt))
        r, rec, n, syncs, reads = _run_counted(
            f"phase 13.2 detect with {opt}",
            lambda c=cfg: detect(scene, bank, c), check, card)
        launches[f"option {name}"] = rec.shapes()
        counts[f"option {name}"] = n
        if len(syncs) != sum(reads):
            raise RuntimeError(f"{opt}: {len(syncs)} host syncs for region-"
                               f"growing reads {reads}")
        rot, trans = _err(r.full_pose.cpu().numpy(), T_gt)
        print(f"# phase 13.2 {opt}: accepted {bool(r.accepted)}, view "
              f"{int(r.view_idx)}, rot_err {rot:.3f} deg, trans_err "
              f"{trans * 1000:.3f} mm, keys {int(r.metrics['scene_keypoints'])}"
              f", scene points after the crop "
              f"{int(r.metrics['scene_points'])} "
              f"({'gated' if gated[name] else 'reported'}) {card}", flush=True)
        if gated[name] and not (bool(r.accepted) and rot < 1.0
                                and trans < 0.005):
            raise RuntimeError(f"phase 13.2 {opt} missed the gate")
    feats = prepare_scene(scene, gen_cfg)
    out = {}
    for d in (dev, torch.device("cpu")):
        keys = type(feats.keys)(*(t.to(d) for t in feats.keys))
        cloud = type(feats.cloud)(*(t.to(d) for t in feats.cloud))
        out[d.type] = compute_shot(keys, cloud, feats.normals.to(d),
                                   radius=gen_cfg.descr_rad,
                                   k_max=gen_cfg.k_max, scheme="pcl")
    dc, dp = out["cuda"][0].cpu(), out["cpu"][0]
    diff = (dc - dp).abs().amax(1)
    print(f"# phase 13.2 SHOT scheme='pcl' on phase 6's {int(feats.keys.mask.sum())} "
          f"keys: {int(out['cuda'][2].sum())} valid on the card, "
          f"{int(out['cpu'][2].sum())} on the CPU; max |desc diff| card vs "
          f"CPU {float(diff.max()):.3e}, rows past 1e-4: "
          f"{int((diff > 1e-4).sum())} (reported) {card}", flush=True)
    if not torch.equal(out["cuda"][2].cpu(), out["cpu"][2]):
        raise RuntimeError("SHOT pcl validity differs between card and CPU")

    return counts


def _fpfh_served(dev, card, bank, launches, check, timings, frames,
                 gen_cfg):
    """13.3: the ``fpfh_demo`` preset served at 8192 lanes on its own bank
    (``_fpfh_phase``)."""
    import numpy as np
    import torch

    from tpu_joints_torch import synthetic as syn
    from tpu_joints_torch.config import PRESETS
    from tpu_joints_torch.modelbank.bank import build_bank
    from tpu_joints_torch.neighbors import pallas_knn as pk
    from tpu_joints_torch.pipelines.detect import detect_organized
    from tpu_joints_torch.serve import DetectionService
    from tpu_joints_torch.serve.depth import depth_to_cloud
    from tpu_joints_torch.serve.server import depth_block

    tab, tab_valid, T_gt = frames["tab"], frames["tab_valid"], frames["T"]
    counts = {}
    demo = dataclasses.replace(PRESETS["fpfh_demo"], scene_capacity=8192)
    t0 = time.perf_counter()
    dbank = build_bank(
        syn.joint_model(), descriptor="fpfh", descr_radius=demo.descr_rad,
        rf_radius=demo.rf_rad, rf_k_max=demo.rf_k_max, frames=demo.rf_frames,
        sampling_radius=demo.model_ss, normal_k=demo.normal_k,
        normal_radius=demo.normal_radius, k_max=demo.k_max,
        fpfh_surface=demo.fpfh_surface, fpfh_k_max=demo.fpfh_k_max,
        level=1, resolution=128, surface_leaf=0.01, key_capacity=256,
        icp_capacity=2048, device=dev)
    torch.cuda.synchronize()
    print(f"# phase 13.3 fpfh_demo bank (radius normals at "
          f"{demo.normal_radius}): {dbank.n_views} views, built in "
          f"{time.perf_counter() - t0:.2f} s {card}", flush=True)
    svc = DetectionService(dbank, demo)
    H, W = tab_valid.shape
    svc.warmup()
    depth = _depth(tab.cpu().numpy(), tab_valid.cpu().numpy())
    (status, reply, rt_ms), rec, n, syncs, reads = _run_counted(
        "phase 13.3 fpfh_demo served", lambda: _serve_one(svc, depth), check,
        card)
    launches["served fpfh"] = rec.shapes()
    counts["served fpfh"] = n
    seen = set().union(*(set(c) for k, c in launches.items()
                         if k != "served fpfh"))
    for shape in sorted(set(rec.shapes()) - seen):     # its own shapes
        q, s_, k, m = rec.first(shape)
        timings[min(k, 2)].append(_time_knn(
            pk, q, s_, m, k, card, f"phase 13.3 K{min(k, 2)} {shape}",
            reps=5))
    if status != 200:
        raise RuntimeError(f"phase 13.3: the server answered {status}: {reply}")
    xyz = depth_to_cloud(depth)
    ok = np.isfinite(xyz).all(-1)
    blk = depth_block(H, W, demo.scene_capacity)
    ref, _ = detect_organized(torch.as_tensor(np.nan_to_num(xyz), device=dev),
                              torch.as_tensor(ok, device=dev), dbank, demo,
                              block=blk, half_window=5)
    diff = float(np.abs(np.asarray(reply["pose"], np.float32)
                        - ref.full_pose.cpu().numpy()).max())
    rot, trans = _err(np.asarray(reply["pose"]), T_gt)
    print(f"# phase 13.3 fpfh_demo {W}x{H} over HTTP (block {blk}, "
          f"{demo.scene_capacity} lanes): accepted {reply['accepted']}, view "
          f"{reply['view_idx']}, rot_err {rot:.3f} deg, trans_err "
          f"{trans * 1000:.3f} mm (reported), scene points "
          f"{reply['metrics']['scene_points']}, device call "
          f"{reply['latency_ms']:.3f} ms, round trip {rt_ms:.3f} ms; max "
          f"|pose diff| to a direct detect_organized {diff:.3e} {card}",
          flush=True)
    if diff > 1e-5:
        raise RuntimeError(f"the served fpfh_demo reply differs from a direct "
                           f"run by {diff:.3e}")
    return counts


# the JAX package on the CPU on phase 14's inputs, loading the port-built
# bank (scripts/full_size_reference.py cli / lattice): 14.1's detect, 14.2's
# tree, and 14.5's lattice-key frames
CLI_CPU_JAX = dict(accepted=False, view=21, rot_deg=179.062, trans_mm=155.514)
TREE_CPU_JAX = dict(accepted=False, view=21, rot_deg=179.062, trans_mm=155.514)
LATTICE_CPU_JAX = {
    "organized": dict(accepted=True, view=28, rot_deg=0.217, trans_mm=0.371),
    "segmented": dict(accepted=True, view=31, rot_deg=0.134, trans_mm=0.480)}


def _held_to(label, res_pose, accepted, view, T_gt, ref, card,
             truth_gate=True):
    """The reference's rule for a result the JAX package computed on the
    CPU: the same accept flag and view, rotation and translation errors
    within 0.1 deg / 1 mm of its; with ``truth_gate``, an accepted pose
    within 1 deg / 5 mm of the truth."""
    import numpy as np

    pose = np.asarray(res_pose, np.float64)
    rot, trans = _err(pose, T_gt)
    print(f"# {label}: accepted {accepted}, view {view}, rot_err {rot:.3f} "
          f"deg, trans_err {trans * 1000:.3f} mm; the JAX package on the "
          f"CPU: {ref} {card}", flush=True)
    if not (np.isfinite(pose).all() and pose.shape == (4, 4)
            and accepted == ref["accepted"] and view == ref["view"]
            and abs(rot - ref["rot_deg"]) < 0.1
            and abs(trans * 1000 - ref["trans_mm"]) < 1.0):
        raise RuntimeError(f"{label} differs from the JAX package's result "
                           f"on the CPU")
    if truth_gate and accepted and not (rot < 1.0 and trans < 0.005):
        raise RuntimeError(f"{label} accepted a pose {rot:.2f} deg, "
                           f"{trans * 1000:.1f} mm off")


def _cli_phase(dev, card, bank, launches, check, check_batched, timings,
               frames, cfgs):
    """Phase 14: the CLI's offline → online flow at full width (14.1-14.4)
    and the lattice keys and the pixel ingest (14.5); see the module
    docstring. ``frames`` holds phase 5's and 7's frames, phase 11's batch
    and the truth; ``cfgs`` phase 5's and 7's configurations. Adds each
    path's launches by shape to ``launches``, times every shape no earlier
    path launched, and returns each path's (K1, K1 batched, K2) launches."""
    import io
    import os
    import sys
    import tempfile

    import numpy as np
    import torch

    from tpu_joints_torch import synthetic as syn
    from tpu_joints_torch.cli.main import main as cli
    from tpu_joints_torch.config import PRESETS
    from tpu_joints_torch.core.cloud import make_cloud, to_numpy
    from tpu_joints_torch.core.io import PointData, load_pcd, save_pcd
    from tpu_joints_torch.features.edges import detect_edges
    from tpu_joints_torch.features.normals import estimate_normals
    from tpu_joints_torch.features.variance import compute_variance_descriptor
    from tpu_joints_torch.filters.filters import (compact_cloud, passthrough,
                                                  uniform_sample_mask,
                                                  voxel_downsample)
    from tpu_joints_torch.modelbank.bank import load_bank, save_bank
    from tpu_joints_torch.neighbors import pallas_knn as pk
    from tpu_joints_torch.pipelines import multi
    from tpu_joints_torch.pipelines.cluster_tree import (detect_tree,
                                                         make_view_clusters)
    from tpu_joints_torch.pipelines.detect import detect, detect_organized
    from tpu_joints_torch.pipelines.ingest import ingest_organized
    D = importlib.import_module("tpu_joints_torch.pipelines.detect")
    rg = importlib.import_module("tpu_joints_torch.segment.region_growing")
    from tpu_joints_torch.segment.sac import sac_cylinder, sac_plane
    from tpu_joints_torch.serve.batching import tree_map

    T_gt = frames["T"]
    t_phase = time.perf_counter()
    counts = {}
    seen = set().union(*(set(n) for n in launches.values()))

    def run_cli(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli(argv)
        return buf.getvalue()

    pending = []         # shapes no earlier path launched, timed later

    def counted(path, label, run):
        out, rec, n, syncs, reads = _run_counted(label, run, check, card)
        launches[path] = rec.shapes()
        counts[path] = n
        for shape in sorted(set(rec.shapes()) - seen, key=str):
            pending.append((label, shape, rec.first(shape)))
            seen.add(shape)
        return out, rec, n, syncs, reads

    def time_pending():
        for label, shape, (q, s_, k, m) in pending:
            if len(shape) == 4:
                timings["batched"].append(_time_nn1_batched(
                    pk, q.contiguous(), s_, m, card,
                    f"{label} K1 batched {shape}", reps=5))
            else:
                timings[min(k, 2)].append(_time_knn(
                    pk, q, s_, m, k, card, f"{label} K{min(k, 2)} {shape}",
                    reps=5))
        pending.clear()

    def same(label, a, b, tol=0.0):
        diff = float(np.abs(np.asarray(a, np.float64)
                            - np.asarray(b, np.float64)).max())
        print(f"#   {label}: max |diff| {diff:.3e} {card}", flush=True)
        if not diff <= tol:
            raise RuntimeError(f"{label} differs by {diff:.3e}")

    work = tempfile.TemporaryDirectory(prefix="chip_smoke_cli_")
    d = work.name
    proc = None
    try:
        # --- 14.1 render, bank, detect --------------------------------------
        save_pcd(f"{d}/model.pcd", PointData(xyz=syn.joint_model()))
        t0 = time.perf_counter()
        out = run_cli(["render", f"{d}/model.pcd", "--out", f"{d}/views"])
        print(f"# phase 14.1 render (host): {out.strip()} in "
              f"{time.perf_counter() - t0:.2f} s {card}", flush=True)
        t0 = time.perf_counter()
        out, _, n, _, _ = counted("cli bank", "phase 14.1 CLI bank", lambda: run_cli(
            ["bank", f"{d}/model.pcd", "--out", f"{d}/bank.npz",
             "--preset", "shot_demo"]))
        cbank = load_bank(f"{d}/bank.npz", device=dev)
        print(f"# phase 14.1 bank --preset shot_demo: {out.strip()}; "
              f"{int(cbank.key_valid.sum())} valid keys, "
              f"{time.perf_counter() - t0:.2f} s with the rechecks {card}",
              flush=True)
        if tuple(cbank.desc.shape) != (42, 256, 352) or n[0] or n[1]:
            raise RuntimeError(f"the CLI bank is {tuple(cbank.desc.shape)}, "
                               f"launched {n}")
        pts = frames["xyz"][frames["valid"]]
        save_pcd(f"{d}/scene.pcd", PointData(xyz=pts))
        demo = PRESETS["shot_demo"]
        argv = ["detect", f"{d}/scene.pcd", "--bank", f"{d}/bank.npz",
                "--preset", "shot_demo", "--json"]
        # the subprocess (mostly start-up) runs beside 14.1-14.4's untimed
        # work and is collected before any timed run
        t_sub = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-m", "tpu_joints_torch.cli",
                                 *argv], cwd=Path(__file__).resolve().parent,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)
        out, rec, n, syncs, _ = counted(
            "cli detect", "phase 14.1 CLI detect (in-process)",
            lambda: run_cli(argv))
        inproc = json.loads(out.strip().splitlines()[-1])
        scene = make_cloud(syn.scene_points(pts, demo.scene_capacity),
                           capacity=demo.scene_capacity, device=dev)

        def run_detect():
            return detect(scene, cbank, demo)

        rg.region_growing.host_checks = 0
        res, syncs = _count_syncs(run_detect)
        reads = rg.region_growing.host_checks
        print(f"# phase 14.1 CLI: {len(pts)} scene points strided to "
              f"{int(scene.mask.sum())}; a direct detect: host "
              f"synchronisations {len(syncs)}, graph region-growing reads "
              f"{reads} {card}", flush=True)
        if len(syncs) != reads or reads < 2:
            raise RuntimeError(f"{len(syncs)} syncs for {reads} reads")

        def same_detect(label, got):
            same(f"phase 14.1 CLI detect ({label}) against a direct detect",
                 got["pose"], res.full_pose.cpu().numpy())
            if got["accepted"] != bool(res.accepted):
                raise RuntimeError(f"phase 14.1 {label} accept flag differs")

        same_detect("in-process", inproc)
        _held_to("phase 14.1 CLI detect", res.full_pose.cpu().numpy(),
                 bool(res.accepted), int(res.view_idx), T_gt, CLI_CPU_JAX,
                 card)

        # --- 14.2 the cluster tree ------------------------------------------
        out, *_ = counted("cli tree", "phase 14.2 CLI detect --tree 3",
                          lambda: run_cli(argv + ["--tree", "3"]))
        tree = json.loads(out.strip().splitlines()[-1])
        clusters = make_view_clusters(cbank, n_clusters=3)

        def run_tree():
            return detect_tree(scene, cbank, clusters, demo)

        res_t = run_tree()
        same("phase 14.2 CLI detect --tree 3 against a direct detect_tree",
             tree["pose"], res_t.full_pose.cpu().numpy())
        _held_to("phase 14.2 CLI detect --tree 3", res_t.full_pose.cpu().numpy(),
                 bool(res_t.accepted), int(res_t.view_idx), T_gt,
                 TREE_CPU_JAX, card)

        # --- 14.3 two part banks; the scene loop with GO-HV ----------------
        # phase 8's recipe (each part's own views, one view capacity, the
        # full joint as CAD) at the preset's descriptor: phase 8's banks
        # carry BOARD frames that no CLI preset reads
        t0 = time.perf_counter()
        parts = syn.build_part_banks(demo, device=dev, resolution=100)
        for name, b in parts.items():
            save_bank(f"{d}/{name}.npz", b)
        tab = frames["tab"][frames["tab_valid"]]
        save_pcd(f"{d}/table.pcd", PointData(xyz=tab))
        print(f"# phase 14.3 part banks {list(parts)} built and saved in "
              f"{time.perf_counter() - t0:.2f} s {card}", flush=True)
        argv2 = ["detect", f"{d}/table.pcd", "--bank", f"chord={d}/chord.npz",
                 "--bank", f"stub={d}/stub.npz", "--preset", "shot_demo",
                 "--json"]
        out, *_ = counted("cli two-part", "phase 14.3 CLI detect, two part "
                          "banks", lambda: run_cli(argv2))
        two = json.loads(out.strip().splitlines()[-1])
        tscene = make_cloud(syn.scene_points(tab, demo.scene_capacity),
                            capacity=demo.scene_capacity, device=dev)
        loaded = {n: load_bank(f"{d}/{n}.npz", device=dev) for n in parts}
        mres = multi.detect_parts(tscene, loaded, demo)
        same("phase 14.3 CLI two-part detect against a direct detect_parts",
             two["pose"], mres.result.full_pose.cpu().numpy())
        rot, trans = _err(np.asarray(two["pose"]), T_gt)
        print(f"# phase 14.3 two-part detect on the table frame: part "
              f"{two['part']} (direct: {mres.part}), accepted "
              f"{two['accepted']}, rot_err {rot:.3f} deg, trans_err "
              f"{trans * 1000:.3f} mm (reported) {card}", flush=True)
        if two["part"] != mres.part:
            raise RuntimeError("phase 14.3 picked another part")
        argv3 = ["scenes", f"{d}/scene.pcd", f"{d}/table.pcd", "--bank",
                 f"{d}/bank.npz", "--hv", "--preset", "shot_hypothesis"]
        out, rec, n, _, _ = counted("cli scenes hv", "phase 14.3 CLI scenes "
                                    "--hv", lambda: run_cli(argv3))
        for line in out.splitlines():
            if "GOOD" in line or "verdict" in line or "accepted" in line:
                print(f"#   {line.strip()} {card}", flush=True)
        if not any(len(shape) == 4 for shape in rec.shapes()):
            raise RuntimeError("phase 14.3 scenes --hv launched no K1 batch")

        # --- 14.4 the utilities ---------------------------------------------
        util = pts[np.linspace(0, len(pts) - 1, 16384).astype(np.int64)]
        save_pcd(f"{d}/util.pcd", PointData(xyz=util))
        u = f"{d}/util.pcd"
        ucloud = make_cloud(util, device=dev)
        run_cli(["crop", u, "--out", f"{d}/crop.pcd", "--xmin", "-0.1",
                 "--xmax", "0.1", "--zmin", "0.5", "--zmax", "1.5"])
        c = passthrough(passthrough(ucloud, "x", -0.1, 0.1), "z", 0.5, 1.5)
        same("phase 14.4 crop", load_pcd(f"{d}/crop.pcd").xyz, to_numpy(c))
        run_cli(["segment", u, "--plane_out", f"{d}/plane.pcd",
                 "--cylinder_out", f"{d}/cyl.pcd"])
        c = passthrough(ucloud, "z", 0.0, 1.5)
        nrm, _ = estimate_normals(c, k=50)
        plane = sac_plane(c, nrm, 0, distance_threshold=0.03)
        rest = c.with_mask(c.mask & ~plane.inliers)
        cyl = sac_cylinder(rest, nrm, 0, distance_threshold=0.05,
                           radius_max=0.1)
        xyz = c.xyz.cpu().numpy()
        same("phase 14.4 segment, plane", load_pcd(f"{d}/plane.pcd").xyz,
             xyz[(plane.inliers & c.mask).cpu().numpy()])
        same("phase 14.4 segment, cylinder", load_pcd(f"{d}/cyl.pcd").xyz,
             xyz[(cyl.inliers & rest.mask).cpu().numpy()])
        for k in (100, 20):
            path = f"cli edges k{k}"
            counted(path, f"phase 14.4 CLI edges -k {k}", lambda k=k: run_cli(
                ["edges", u, "--out", f"{d}/edges{k}.pcd", "-k", str(k)]))
            k2 = sum(c for shape, c in launches[path].items()
                     if len(shape) == 3 and shape[2] > 1)
            if (k2 > 0) != (k <= 32):
                raise RuntimeError(f"edges -k {k} launched K2 {k2} times")
            v = voxel_downsample(ucloud, 0.002)
            e = detect_edges(v, k=k)
            same(f"phase 14.4 edges -k {k}", load_pcd(f"{d}/edges{k}.pcd").xyz,
                 v.xyz.cpu().numpy()[(e & v.mask).cpu().numpy()])
        run_cli(["var-desc", u, "--out", f"{d}/var.txt"])
        nrm, _ = estimate_normals(ucloud, k=40)
        keys, kidx = compact_cloud(ucloud, uniform_sample_mask(ucloud, 0.01),
                                   512)
        desc, valid = compute_variance_descriptor(keys, nrm[kidx], ucloud, nrm,
                                                  radius=0.05)
        # the file holds each value to 6 decimals
        same("phase 14.4 var-desc", np.loadtxt(f"{d}/var.txt"),
             desc.cpu().numpy()[valid.cpu().numpy()].reshape(-1), tol=6e-7)
        print(f"# phase 14.4 crop, segment, edges -k 100 / 20, var-desc on "
              f"16384 points: each output equal to its direct call "
              f"({int(valid.sum())} variance keys) {card}", flush=True)

        stdout, stderr = proc.communicate(timeout=300)
        print(f"# phase 14.1 the CLI subprocess: exit {proc.returncode} after "
              f"{time.perf_counter() - t_sub:.2f} s {card}", flush=True)
        if proc.returncode != 0:
            raise RuntimeError(f"the CLI subprocess failed:\n{stderr}")
        same_detect("subprocess", json.loads(stdout.strip().splitlines()[-1]))
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        work.cleanup()

    time_pending()
    _, times = _timed_runs(run_detect)
    busy, ops, peak = _device_busy(run_detect)
    print(f"# phase 14.1 detect --preset shot_demo at {demo.scene_capacity} "
          f"lanes: median {statistics.median(times):.3f} ms (min "
          f"{min(times):.3f}, max {max(times):.3f}) over {len(times)} runs, "
          f"device busy {busy:.3f} ms, {ops} device operations, peak "
          f"{peak:.1f} MiB, {int(res.metrics['scene_points'])} points after "
          f"the crop, {int(res.metrics['scene_keypoints'])} keys {card}",
          flush=True)
    _, t_times = _timed_runs(run_tree)
    K, M = clusters.members.shape
    print(f"# phase 14.2 detect --tree 3: {K} + 2 x {M} = {K + 2 * M} views "
          f"matched of {cbank.n_views}, cluster "
          f"{int(res_t.metrics['cluster_id'])}; median "
          f"{statistics.median(t_times):.3f} ms against 14.1's "
          f"{statistics.median(times):.3f} ms {card}", flush=True)

    # --- 14.5 lattice keys and the pixel ingest -----------------------------
    lat = dict(keypoints="lattice", key_group=3)
    lo, hi = frames["lo"], frames["hi"]
    for path, img, vmask, cfg in (
            ("lattice organized", frames["xyz_img"], frames["valid_t"],
             dataclasses.replace(cfgs["det"], **lat)),
            ("lattice segmented", frames["tab_img"], frames["tab_valid_t"],
             dataclasses.replace(cfgs["seg"], **lat))):
        def run(img=img, vmask=vmask, cfg=cfg):
            return detect_organized(img, vmask, bank, cfg, block=4,
                                    half_window=5, crop_lo=lo, crop_hi=hi)

        (res, n_sel), *_ = counted(path, f"phase 14.5 {path}", run)
        (res, n_sel), t_l = _timed_runs(run)
        n_keys = int(res.metrics["scene_keypoints"])
        n_scene = int(res.metrics["scene_points"])
        print(f"# phase 14.5 {path} keys: median "
              f"{statistics.median(t_l):.3f} ms over {len(t_l)} runs, "
              f"{n_keys} keys of {n_scene} scene points, n_selected "
              f"{int(n_sel)} {card}", flush=True)
        if not n_scene // 14 < n_keys <= -(-n_scene // 4):
            raise RuntimeError(f"{path}: {n_keys} keys for {n_scene} points")
        _held_to(f"phase 14.5 {path}", res.full_pose.cpu().numpy(),
                 bool(res.accepted), int(res.view_idx), T_gt,
                 LATTICE_CPU_JAX[path.split()[1]], card)
    bcfg = dataclasses.replace(cfgs["det"], **lat)
    imgs, valids = frames["imgs"], frames["valids"]

    def run_batch():
        return D._detect_organized_batch_eager(
            imgs, valids, bank, bcfg, block=4, half_window=5, crop_lo=lo,
            crop_hi=hi)

    (res_b, n_b), *_ = counted("lattice batch", "phase 14.5 lattice batch of "
                               f"{imgs.shape[0]}", run_batch)
    POSE_TOL = 3e-4
    for b in range(imgs.shape[0]):
        r1, n1 = detect_organized(imgs[b], valids[b], bank, bcfg, block=4,
                                  half_window=5, crop_lo=lo, crop_hi=hi)
        acc = bool(res_b.accepted[b])
        diff = float((res_b.full_pose[b] - r1.full_pose).abs().max())
        tie = ""
        if acc and int(res_b.view_idx[b]) != int(r1.view_idx):
            shown, j, gap, _, _ = _tie(tree_map(lambda a, b=b: a[b], res_b),
                                       r1.view_idx, POSE_TOL)
            tie = f", its view a tier-2 twin: {shown} (gap {gap:.3e})"
            if not shown:
                raise RuntimeError(f"lattice batch frame {b}: another view")
        print(f"#   lattice batch frame {b}: accepted {acc} (single run "
              f"{bool(r1.accepted)}), view {int(res_b.view_idx[b])} "
              f"({int(r1.view_idx)}), max |full_pose diff| {diff:.3e}{tie} "
              f"{card}", flush=True)
        if acc != bool(r1.accepted) or int(n_b[b]) != int(n1) or (
                acc and diff > POSE_TOL):
            raise RuntimeError(f"lattice batch frame {b} differs from its "
                               f"own run")

    def run_ingest():
        return ingest_organized(frames["xyz_img"], frames["valid_t"],
                                capacity=32768, leaf=0.004, half_window=5)

    (_, _, _, n_sel), t_i = _timed_runs(run_ingest)
    print(f"# phase 14.5 ingest_organized 640x480 (capacity 32768, leaf 4 "
          f"mm): n_selected {int(n_sel)}, median "
          f"{statistics.median(t_i):.3f} ms over {len(t_i)} runs {card}",
          flush=True)
    if not 0 < int(n_sel) <= int(frames["valid_t"].sum()):
        raise RuntimeError(f"ingest_organized kept {int(n_sel)} points")
    time_pending()
    print(f"# phase 14 took {time.perf_counter() - t_phase:.1f} s {card}",
          flush=True)
    return counts


# the JAX package on the CPU on phase 16's inputs, loading the port-built
# bank (scripts/full_size_reference.py api): PRESETS["shot"] accepts this
# pose on that frame, about 9 deg off the truth, so the truth gate of the
# other phases does not apply
API_CPU_JAX = dict(accepted=True, view=6, rot_deg=8.898, trans_mm=19.270)
API_CAPACITY = 32768


def _api_phase(dev, card, launches, check, timings, frames):
    """Phase 16: the README's Python API on the card, through the
    package's exports only (module docstring). ``frames`` holds phase 5's
    frame (xyz, valid) and its pose T. Adds each run's launches by shape to
    ``launches``, rechecks and times every shape no earlier path launched,
    and returns each run's (K1, K1 batched, K2) launches."""
    import torch

    from tpu_joints_torch import synthetic as syn
    from tpu_joints_torch.config import PRESETS
    from tpu_joints_torch.core.cloud import make_cloud
    from tpu_joints_torch.modelbank import build_bank
    from tpu_joints_torch.neighbors import pallas_knn as pk
    from tpu_joints_torch.pipelines import detect

    T_gt = frames["T"]
    t_phase = time.perf_counter()
    print(f"# phase 16 starts {t_phase - _T_START:.1f} s into the script "
          f"{card}", flush=True)
    seen = set().union(*(set(n) for n in launches.values()))
    counts, new = {}, {}      # new: {shape: (label, inputs of its first launch)}

    def check_new(q, s_, k, m, label):
        """Recheck a launch whose shape no earlier path launched."""
        shape = (*q.shape[:-1], s_.shape[-2], k)
        if shape not in seen:
            check(q, s_, k, m, label)
            new.setdefault(shape, (label, (q, s_, k, m)))

    def counted(path, label, run):
        out, rec, n, syncs, reads = _run_counted(label, run, check_new, card)
        launches[path] = rec.shapes()
        counts[path] = n
        return out, n, len(syncs), sum(reads)

    # the README's block, line for line
    model_xyz = syn.joint_model()
    scene_xyz = syn.scene_points(frames["xyz"][frames["valid"]], API_CAPACITY)
    t0 = time.perf_counter()
    # the bank build uploads host arrays (syncs reported, not held)
    bank, *_ = counted("api bank", "phase 16 build_bank(model_xyz)",
                       lambda: build_bank(model_xyz))
    torch.cuda.synchronize()
    print(f"# phase 16 bank: {bank.n_views} views, desc "
          f"{tuple(bank.desc.shape)}, on {bank.device}, "
          f"{time.perf_counter() - t0:.2f} s with the rechecks {card}",
          flush=True)
    if bank.n_views != 42 or bank.device.type != dev.type:
        raise RuntimeError(f"build_bank(model_xyz) gave {bank.n_views} views "
                           f"on {bank.device}")
    scene = make_cloud(scene_xyz, capacity=API_CAPACITY)
    cfg = PRESETS["shot"]

    def run():
        return detect(scene, bank, cfg)

    res, n, syncs, reads = counted("api detect", "phase 16 detect(scene, "
                                   "bank, PRESETS['shot'])", run)
    if syncs != reads:
        raise RuntimeError(f"phase 16 detect: {syncs} host syncs for the "
                           f"region growings' {reads} reads")
    print(f"# phase 16 {len(scene_xyz)} of {int(frames['valid'].sum())} "
          f"points at {API_CAPACITY} lanes on {scene.xyz.device}: "
          f"K1 {n[0]}, K1 batched {n[1]}, K2 {n[2]} launches {card}",
          flush=True)
    if n[0] == 0 or n[1]:
        raise RuntimeError(f"phase 16 detect launched K1 {n[0]} and K1 "
                           f"batched {n[1]} times")
    print(f"# phase 16 print(res.full_pose, float(res.fitness), "
          f"bool(res.accepted)): {res.full_pose.cpu().numpy().tolist()} "
          f"{float(res.fitness)} {bool(res.accepted)}", flush=True)
    _held_to("phase 16 README detect", res.full_pose.cpu().numpy(),
             bool(res.accepted), int(res.view_idx), T_gt, API_CPU_JAX, card,
             truth_gate=False)

    # the TPU kernel's own entry, k = 1 and k = 16, on the scene itself
    rec_kp = collections.Counter()
    for k, wrapper in ((1, pk.nn1), (16, pk.knnk)):
        q, m = scene.xyz, scene.mask
        pk.nn1.launches = pk.nn1_batched.launches = pk.knnk.launches = 0
        d, i = pk.knn_pallas(q, q, k, m)
        if (wrapper.launches, pk.nn1.launches + pk.knnk.launches) != (1, 1):
            raise RuntimeError(f"knn_pallas k={k} launched nn1 "
                               f"{pk.nn1.launches}, knnk {pk.knnk.launches}")
        rec_kp[(q.shape[0], q.shape[0], k)] += 1
        d2, i2 = pk.nn1(q, q, m) if k == 1 else pk.knnk(q, q, k, m)
        dr, ir = (pk.nn1_reference(q, q, m) if k == 1
                  else pk.knnk_reference(q, q, k, m))
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in ((d, d2), (i, i2), (d, dr),
                                                   (i, ir)))
        print(f"# phase 16 knn_pallas k={k} on the scene "
              f"({q.shape[0]}x{q.shape[0]}): equal to "
              f"{wrapper.__name__} and to its plain version bit for bit: "
              f"{same} {card}", flush=True)
        if not same:
            raise RuntimeError(f"knn_pallas k={k} differs")
        if (q.shape[0], q.shape[0], k) not in seen:
            new.setdefault((q.shape[0], q.shape[0], k),
                           (f"phase 16 knn_pallas k={k}", (q, q, k, m)))
    launches["api knn_pallas"] = rec_kp
    counts["api knn_pallas"] = (1, 0, 1)

    for shape, (label, (q, s_, k, m)) in new.items():
        timings[min(k, 2)].append(_time_knn(
            pk, q, s_, m, k, card, f"{label} K{min(k, 2)} {shape}", reps=5))
        torch.cuda.empty_cache()
    rot, trans = _err(res.full_pose.cpu().numpy(), T_gt)
    print(f"# phase 16 README detect at {API_CAPACITY} lanes (timed, with "
          f"its device busy time and peak, in phase 17 in turns with its "
          f"graph): {int(res.metrics['scene_keypoints'])} keys, accepted "
          f"{bool(res.accepted)} at {rot:.3f} deg / {trans * 1000:.3f} mm "
          f"from the truth (reported) {card}", flush=True)
    print(f"# phase 16 took {time.perf_counter() - t_phase:.1f} s {card}",
          flush=True)
    return counts, (bank, scene, cfg)


def _leaves(tree, name=""):
    """(name, leaf) for every leaf of a result: tensors, and the part names
    of a two-part result."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{name}.{k}")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from _leaves(v, f"{name}.{k}")
    elif isinstance(tree, (tuple, list)) and not all(
            isinstance(v, str) for v in tree):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{name}[{i}]")
    else:
        yield name, tree


def _unequal_leaves(a, b):
    """The leaves of two equally shaped results that are not equal bit for
    bit (``torch.equal``; other leaves by ``==``)."""
    import torch

    out = []
    for (n, x), (_, y) in zip(_leaves(a), _leaves(b), strict=True):
        same = (torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y)
        if not same:
            out.append(n)
    return out


def _profile_call(fn):
    """(device ms, device operations, peak MiB, K1 kernels, K2 kernels) of
    one call of ``fn``: the profiler's kernel, copy and fill time and count,
    the allocator's peak, and the kernels by name (``knn_split_kernel<1>``
    is K1 and its batch mode, any other K is K2; a replay launches no
    wrapper, so the wrappers' counts cannot see it). A profile with no
    device event is taken again, up to three times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ka = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        if ka:
            break
    else:
        raise RuntimeError("the profiler caught no device event in three tries")
    k1 = sum(e.count for e in ka if "knn_split_kernel<1>" in e.key)
    k2 = sum(e.count for e in ka if "knn_split_kernel<" in e.key) - k1
    return (sum(e.self_device_time_total for e in ka) / 1e3,
            sum(e.count for e in ka), torch.cuda.max_memory_allocated() / 2**20,
            k1, k2)


def _quartiles(times):
    q1, q2, q3 = statistics.quantiles(times, n=4)
    return f"{q2:.3f} ms [{q1:.3f}, {q3:.3f}]"


def _abba(runs: dict, n: int) -> dict:
    """Wall ms of each of two thunks ({"a": fn, "b": fn}), synced, in turns
    a, b, b, a: ``n`` // 2 timed calls a turn after one untimed one."""
    import torch

    times = {k: [] for k in runs}
    a, b = runs
    for which in (a, b, b, a):
        runs[which]()
        for _ in range(n // 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[which]()
            torch.cuda.synchronize()
            times[which].append((time.perf_counter() - t0) * 1e3)
    return times


def _hold_captured(label, eager, fused, card, runs=10):
    """Phase 17 for one path: ``eager`` (the eager chain) and ``fused`` (the
    captured graph's entry) on the same inputs. The first ``fused`` call
    captures (its seconds and the pool's growth printed); every leaf of a
    replay must equal the eager run's bit for bit, the K1/K2 kernels per
    replay (profiler) must equal the eager run's, and the host syncs per
    replay are counted (the flag reads of a growing's first chunk, none
    elsewhere); then eager against replay wall time in turns (eager,
    replay, replay, eager: ``runs`` each) and each form's device busy time.
    Returns a dict of the numbers."""
    import torch

    from tpu_joints_torch.core import graphs

    t_path = time.perf_counter()
    ref = eager()
    torch.cuda.synchronize()
    n_before = len(graphs.entries())
    t0 = time.perf_counter()
    fused()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    new = graphs.entries()[n_before:]
    capture_s = sum(e.capture_s for e in new)
    pool_mib = sum(e.pool_bytes for e in new) / 2**20
    need_mib = max(e.need_bytes for e in new) / 2**20
    got = fused()
    torch.cuda.synchronize()
    bad = _unequal_leaves(ref, got)
    reads0 = sum(e.reads for e in graphs.entries())
    _, syncs = _count_syncs(fused)
    reads = sum(e.reads for e in graphs.entries()) - reads0
    prof = {"eager": _profile_call(eager), "replay": _profile_call(fused)}
    turns = _abba({"eager": eager, "replay": fused}, runs)
    k = {w: p[3:] for w, p in prof.items()}
    print(f"# {label}: capture {capture_s:.3f} s (first call {first_s:.3f} "
          f"s), {len(new)} graph entr{'y' if len(new) == 1 else 'ies'}, "
          f"{need_mib:.1f} MiB allocated in the pool, its growth "
          f"+{pool_mib:.1f} MiB; leaves equal to the eager run bit for bit: "
          f"{'all' if not bad else 'NOT ' + ', '.join(bad)}; K1/K2 kernels "
          f"eager {k['eager']}, replay {k['replay']} (profiler); host syncs "
          f"per replay {len(syncs)} (flag reads {reads}); wall median "
          f"[quartiles] over {len(turns['eager'])} each, in turns eager, "
          f"replay, replay, eager: eager {_quartiles(turns['eager'])}, replay "
          f"{_quartiles(turns['replay'])}; device busy eager "
          f"{prof['eager'][0]:.3f} ms ({prof['eager'][1]} operations), replay "
          f"{prof['replay'][0]:.3f} ms ({prof['replay'][1]}); peak "
          f"{prof['eager'][2]:.1f} / {prof['replay'][2]:.1f} MiB; "
          f"{time.perf_counter() - t_path:.1f} s {card}", flush=True)
    for msg in sorted(set(syncs))[:5]:
        print(f"#   sync: {msg}", flush=True)
    if bad:
        raise RuntimeError(f"{label}: the replay differs from the eager chain "
                           f"in {bad}")
    if k["eager"] != k["replay"] or k["eager"][0] == 0:
        raise RuntimeError(f"{label}: K1/K2 kernels eager {k['eager']}, "
                           f"replay {k['replay']}")
    if len(syncs) != reads:
        raise RuntimeError(f"{label}: {len(syncs)} host syncs in a replay "
                           f"that reads {reads} flags")
    return dict(capture_s=capture_s, pool_mib=pool_mib, need_mib=need_mib,
                k=k["replay"],
                syncs=len(syncs),
                eager_ms=statistics.median(turns["eager"]),
                replay_ms=statistics.median(turns["replay"]),
                busy_eager=prof["eager"][0], busy_replay=prof["replay"][0])


def _evicted_draw(dev, card, bank, cfg, f, geo):
    """Phase 17 segmented, after its capture: the RANSAC plane's draw (seed
    0, 256 hypotheses × 3 uniforms) is a cached upload (``core/prng.py``)
    that the graph reads at its address, so the graph's entry must hold it.
    The draw cache is emptied, then every free block of the draw's size on
    the current and the capture stream is taken and filled with 0.5 (a
    draw of one point three times) until the allocator maps new memory:
    none may overlap the draw's bytes, and a replay must still equal the
    eager chain bit for bit."""
    import torch

    from tpu_joints_torch.core import graphs, prng
    D = importlib.import_module("tpu_joints_torch.pipelines.detect")

    entry = graphs.entries()[-1]
    hits = prng._uploaded.cache_info().hits
    ptr = prng._uploaded(0, (256, 3), dev).data_ptr()
    if (entry.entry != "detect_organized" or not entry.held
            or prng._uploaded.cache_info().hits != hits + 1):
        raise RuntimeError(f"phase 17 segmented: the last graph ({entry.entry})"
                           f" holds {len(entry.held)} draws, expected the "
                           f"plane's, which the draw cache holds")
    prng._uploaded.cache_clear()
    junk, hit, nbytes = [], False, 256 * 3 * 4
    for stream in [torch.cuda.current_stream()] + [
            st for _, st in graphs._POOLS.values()]:
        with torch.cuda.stream(stream):
            reserved = torch.cuda.memory_reserved()
            while torch.cuda.memory_reserved() == reserved:
                junk.append(torch.full((nbytes // 4,), 0.5, device=dev))
                at = junk[-1].data_ptr()
                hit |= at < ptr + nbytes and ptr < at + nbytes
    got = D.detect_organized(f["tab_img"], f["tab_valid"], bank, cfg,
                             fused=True, **geo)
    ref = D.detect_organized(f["tab_img"], f["tab_valid"], bank, cfg, **geo)
    torch.cuda.synchronize()
    bad = _unequal_leaves(ref, got)
    print(f"# phase 17 segmented, the draw cache emptied and {len(junk)} free "
          f"blocks of the draw's size taken and filled with 0.5: one over "
          f"the draw's bytes: {hit}; replay equal to the eager chain bit for "
          f"bit: {'all' if not bad else 'NOT ' + ', '.join(bad)} {card}",
          flush=True)
    if hit or bad:
        raise RuntimeError(f"phase 17 segmented: after the draw cache was "
                           f"emptied its bytes were handed on ({hit}) and "
                           f"the replay differs in {bad}")


def _captured_phase(dev, card, bank, cfgs, frames, part_banks, api):
    """Phase 17: the captured one-dispatch paths (module docstring).
    ``cfgs`` holds the organized (det), segmented (seg), two-part (two),
    multi-instance (multi) and HV (hv) configurations; ``frames`` phase 5's
    frame (xyz_img, valid, lo, hi, and as host arrays xyz, valid_h, T),
    phase 7's (tab_img, tab_valid), phase 9's (two_img, two_valid, wlo,
    whi) and phase 11's batch (imgs, valids); ``api`` phase 16's bank,
    scene and preset."""
    import numpy as np
    import torch

    from tpu_joints_torch import synthetic as syn
    from tpu_joints_torch.core import graphs
    from tpu_joints_torch.core.ops import tree_map
    from tpu_joints_torch.pipelines import multi
    from tpu_joints_torch.serve import DetectionService
    from tpu_joints_torch.serve.depth import depth_to_cloud
    from tpu_joints_torch.serve.server import depth_block
    D = importlib.import_module("tpu_joints_torch.pipelines.detect")

    t_phase = time.perf_counter()
    print(f"# phase 17 starts {t_phase - _T_START:.1f} s into the script "
          f"{card}", flush=True)
    f = frames
    org = dict(block=4, half_window=5, crop_lo=f["lo"], crop_hi=f["hi"])
    wide = dict(block=4, half_window=5, crop_lo=f["wlo"], crop_hi=f["whi"])
    out = {}

    def organized(label, img, valid, cfg, geo):
        out[label] = _hold_captured(
            f"phase 17 {label}",
            lambda: D.detect_organized(img, valid, bank, cfg, **geo),
            lambda: D.detect_organized(img, valid, bank, cfg, fused=True,
                                       **geo), card)

    organized("organized", f["xyz_img"], f["valid"], cfgs["det"], org)
    organized("multi-instance", f["two_img"], f["two_valid"], cfgs["multi"],
              wide)
    organized("multi-instance + HV", f["two_img"], f["two_valid"], cfgs["hv"],
              wide)
    organized("segmented", f["tab_img"], f["tab_valid"], cfgs["seg"], org)
    _evicted_draw(dev, card, bank, cfgs["seg"], f, org)
    out["two-part"] = _hold_captured(
        "phase 17 two-part",
        lambda: multi._detect_parts_organized_eager(
            f["tab_img"], f["tab_valid"], part_banks, cfgs["two"], **org),
        lambda: multi.detect_parts_organized(
            f["tab_img"], f["tab_valid"], part_banks, cfgs["two"], **org),
        card)
    out["batch of 8"] = _hold_captured(
        "phase 17 batch of 8",
        lambda: D._detect_organized_batch_eager(
            f["imgs"], f["valids"], bank, cfgs["det"], **org),
        lambda: D.detect_organized_batch(
            f["imgs"], f["valids"], bank, cfgs["det"], **org), card)
    api_bank, api_scene, api_cfg = api
    out["README detect_fused"] = _hold_captured(
        "phase 17 README detect_fused",
        lambda: D.detect(api_scene, api_bank, api_cfg),
        lambda: D.detect_fused(api_scene, api_bank, api_cfg), card)

    # served, with --warm-depth: the streaming service and the
    # micro-batched one (every batch size up to 8 captured at start-up),
    # from an empty cache (phase 12 captured the served graphs before)
    graphs.clear()
    torch.cuda.empty_cache()
    H, W = f["valid_h"].shape
    cfg = cfgs["det"]
    blk = depth_block(H, W, cfg.scene_capacity)
    depths = [_depth(*syn.frame(f["T"], seed, with_table=False, width=W,
                                height=H)) for seed in range(8)]

    def direct(depth):
        xyz = depth_to_cloud(depth)
        ok = np.isfinite(xyz).all(-1)
        Hc, Wc = H - H % blk, W - W % blk
        return np.nan_to_num(xyz[:Hc, :Wc]), ok[:Hc, :Wc]

    for name, batch_max in (("streaming", 1), ("batched", 8)):
        n0 = len(graphs.entries())
        svc = DetectionService(bank, cfg, batch_max=batch_max,
                               batch_window_ms=1000.0)
        t0 = time.perf_counter()
        svc.warmup(depth_shape=(H, W))
        warm_s = time.perf_counter() - t0
        new = graphs.entries()[n0:]
        frames_h = [direct(d) for d in depths[:3 if batch_max == 1 else 8]]
        bodies = [_depth_body(d) for d in depths[:len(frames_h)]]
        # every micro-batch the service runs, as it ran: its frames and
        # the replayed result it read to the host
        batches = []
        run_batch = svc._run_batch

        def recording(imgs, vms, block, run_batch=run_batch, batches=batches):
            res = run_batch(imgs, vms, block)
            batches.append((imgs, vms, block, res))
            return res

        svc._run_batch = recording
        calls0 = svc.n_batches
        with _serving(svc) as url:
            replies, syncs = [], []
            if batch_max == 1:
                for body in bodies:
                    (r,), s_ = _count_syncs(lambda: [_post(url, body)])
                    replies.append(r)
                    syncs.append(len(s_))
            else:
                with ThreadPoolExecutor(len(bodies)) as ex:
                    replies, s_ = _count_syncs(
                        lambda: list(ex.map(lambda b: _post(url, b), bodies)))
                syncs.append(len(s_))
        if any(st != 200 for st, _, _ in replies):
            raise RuntimeError(f"phase 17 served {name}: {replies[0]}")
        # each reply against the eager chain on its frame alone (streaming)
        # or, batched, on the frames it was batched with: every leaf of each
        # replayed batch equal to the eager batch of the same frames, and
        # each reply's pose equal to its frame's entry there
        if batch_max == 1:
            refs = [D.detect_organized(torch.as_tensor(img, device=dev),
                                       torch.as_tensor(vm, device=dev), bank,
                                       cfg, block=blk, half_window=5)[0]
                    for img, vm in frames_h]
        else:
            refs = [None] * len(frames_h)
            for imgs, vms, block, res in batches:
                # the card's service batches its own unprojected frames
                imgs, vms = imgs.cpu().numpy(), vms.cpu().numpy()
                res_e, _ = D._detect_organized_batch_eager(
                    torch.as_tensor(imgs, device=dev),
                    torch.as_tensor(vms, device=dev), bank, cfg, block=block,
                    half_window=5)
                bad = _unequal_leaves(tree_map(lambda t: t.cpu(), res_e), res)
                if bad:
                    raise RuntimeError(
                        f"phase 17 served {name}: the replayed batch of "
                        f"{imgs.shape[0]} differs from the eager batch of its "
                        f"frames in {bad}")
                for j, img in enumerate(imgs):
                    i = next((i for i, (im, _) in enumerate(frames_h)
                              if np.array_equal(im, img)), None)
                    if i is None:
                        raise RuntimeError(f"phase 17 served {name}: a "
                                           f"batched frame is none of the "
                                           f"frames sent")
                    refs[i] = tree_map(lambda a, j=j: a[j], res_e)
            if any(r is None for r in refs):
                raise RuntimeError(f"phase 17 served {name}: a frame was in "
                                   f"no recorded batch")
        gaps = [float(np.abs(np.asarray(r["pose"], np.float32)
                             - ref.full_pose.cpu().numpy()).max())
                for (_, r, _), ref in zip(replies, refs)]
        rt = [t for _, _, t in replies]
        dev_ms = [r["latency_ms"] for _, r, _ in replies]
        held = (f" (batches of {[b[0].shape[0] for b in batches]}, each "
                f"equal leaf for leaf to the eager batch of its frames)"
                if batch_max > 1 else "")
        print(f"# phase 17 served {name} (--warm-depth {W}x{H}, batch_max "
              f"{batch_max}): warm-up {warm_s:.3f} s, {len(new)} graphs "
              f"captured in {sum(e.capture_s for e in new):.3f} s, at most "
              f"{max(e.need_bytes for e in new) / 2**20:.1f} MiB allocated "
              f"in the pool, its growth "
              f"{sum(e.pool_bytes for e in new) / 2**20:.1f} MiB; "
              f"{len(bodies)} requests in "
              f"{svc.n_batches - calls0 if batch_max > 1 else len(bodies)} "
              f"device calls{held}, host syncs {syncs}; replies' max |pose diff| to the eager "
              f"chain {max(gaps)}; device call median "
              f"{statistics.median(dev_ms):.3f} ms, round trip median "
              f"{statistics.median(rt):.3f} ms {card}", flush=True)
        if any(g != 0.0 for g in gaps):
            raise RuntimeError(f"phase 17 served {name}: a reply differs from "
                               f"the eager chain by {max(gaps):.3e}")
        calls = svc.n_batches - calls0 if batch_max > 1 else 1
        if any(n != calls for n in syncs):
            raise RuntimeError(f"phase 17 served {name}: host syncs {syncs}, "
                               f"one per device call expected")
        out[f"served {name}"] = dict(warm_s=warm_s, device_ms=dev_ms, rt=rt)
        print(f"#   phase 17 served {name} took "
              f"{time.perf_counter() - t0:.1f} s {card}", flush=True)
    pool = sum(e.pool_bytes for e in graphs.entries()) / 2**20
    print(f"# phase 17 took {time.perf_counter() - t_phase:.1f} s; "
          f"{len(graphs.entries())} captured entries, their pool growth "
          f"{pool:.1f} MiB in all {card}", flush=True)
    return out


def _layouts(n_cards):
    """Phase 15's meshes: (label, data-mesh devices, 2-D mesh devices and
    its model axis, ring devices). Over every visible card; where fewer
    than 4 are visible, each 4-entry layout again on ``cuda:0`` named four
    times (no link between cards is exercised there)."""
    import torch

    cards = [torch.device("cuda", i) for i in range(n_cards)]
    grid = max(n for n in (1, 2, 4, 8) if n <= n_cards)   # divides 4 scenes x 2
    out = [("every visible card", cards, cards[:grid], 2 if grid > 1 else 1,
            cards)]
    if n_cards < 4:
        out.append(("cuda:0 named four times", [cards[0]] * 4,
                    [cards[0]] * 4, 2, [cards[0]] * 4))
    return out


def _turns(runs: dict, order) -> dict:
    """One synchronised wall-clock run of ``runs[name]`` for each name of
    ``order`` (in turns, after their warm-up elsewhere): {name: [ms, ...]}."""
    import torch

    out = collections.defaultdict(list)
    for name in order:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[name]()
        torch.cuda.synchronize()
        out[name].append((time.perf_counter() - t0) * 1e3)
    return out


def _mesh_phase(dev, card, bank, launches, check, check_batched, timings,
                cfgs, frames, n_batch=8, icp_points=65536):
    """Phase 15: the multi-device surface (``tpu_joints_torch.distributed``
    and the mesh server) on a mesh over every visible card and, where fewer
    than 4 are visible, on the 4-entry layouts over ``cuda:0`` named four
    times (module docstring). ``frames`` holds phase 5's frame (xyz, valid,
    its crop box lo, hi and pose T) and the table frame (tab, tab_valid).
    Adds the new paths' launches by shape to ``launches`` and returns each
    path's (K1, K1 batched, K2) launch counts."""
    import numpy as np
    import torch

    from tpu_joints_torch import synthetic as syn
    from tpu_joints_torch.core.cloud import make_cloud
    from tpu_joints_torch.core.ops import fused_sumsq, top_k
    from tpu_joints_torch.distributed import (detect_batch, halo_radius_neighbors,
                                              make_mesh, ring_icp, ring_knn,
                                              shard_inputs, sharded_match_votes,
                                              stack_clouds)
    from tpu_joints_torch.distributed import mesh as mesh_mod
    from tpu_joints_torch.distributed.mesh import on_device
    from tpu_joints_torch.neighbors import bruteforce
    from tpu_joints_torch.neighbors import pallas_knn as pk
    from tpu_joints_torch.pipelines.detect import (detect,
                                                   detect_organized_batch,
                                                   organized_features)
    from tpu_joints_torch.recognize.icp import icp
    from tpu_joints_torch.serve import DetectionService
    from tpu_joints_torch.serve.batching import to_host, tree_map
    from tpu_joints_torch.serve.depth import depth_to_cloud
    from tpu_joints_torch.serve.server import depth_block

    det_cfg, gen_cfg = cfgs["det"], cfgs["gen"]
    xyz_h, valid_h, tab_h, tab_valid_h, T_gt, lo, hi = (
        frames[k] for k in ("xyz", "valid", "tab", "tab_valid", "T", "lo",
                            "hi"))
    n_cards = torch.cuda.device_count()
    t_phase = time.perf_counter()
    print(f"# phase 15 starts {t_phase - _T_START:.1f} s into the script "
          f"{card}", flush=True)
    layouts = _layouts(n_cards)
    for label, data, grid, model, ring in layouts:
        print(f"# phase 15 layout '{label}': data mesh {[str(d) for d in data]}"
              f" ({len(data)} x 1); batch mesh {[str(d) for d in grid]} "
              f"({len(grid) // model} x {model}); ring {[str(d) for d in ring]}"
              f" ({len(ring)} entries); {n_cards} card(s) visible"
              + ("; no link between cards is exercised on this layout"
                 if len(set(data + grid + ring)) == 1 and len(data + ring) > 2
                 else "") + f" {card}", flush=True)
    by_path = {}
    real_issuer = mesh_mod._issuer

    def threaded(run, reps):
        """``run()`` ``reps`` times with ``run_on`` issuing each mesh entry
        from its own thread, as on a mesh of distinct cards: (results, ms)."""
        mesh_mod._issuer = lambda i, d: i
        try:
            outs, ms = [], []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs.append(run())
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1000.0)
        finally:
            mesh_mod._issuer = real_issuer
        return outs, ms

    def bit_equal(a, b):
        la, lb = [], []
        tree_map(la.append, a)
        tree_map(lb.append, b)
        return len(la) == len(lb) and all(torch.equal(x, y)
                                          for x, y in zip(la, lb))

    def reset():
        for w in (pk.nn1, pk.nn1_batched, pk.knnk):
            w.launches = 0
            w.by_device.clear()

    def counts():
        return (pk.nn1.launches, pk.nn1_batched.launches, pk.knnk.launches)

    # --- 15.1 the served mesh: phase 11's frames over the data axis ---------
    depths = [_depth(f, valid_h) for f in syn.batch_frames(xyz_h, n_batch)]
    bodies = [_depth_body(d) for d in depths]
    H, W = valid_h.shape
    blk = depth_block(H, W, det_cfg.scene_capacity)
    Hc, Wc = H - H % blk, W - W % blk
    img_stack = [depth_to_cloud(d) for d in depths]
    imgs_h = np.stack([np.nan_to_num(x[:Hc, :Wc]) for x in img_stack])
    vms_h = np.stack([np.isfinite(x).all(-1)[:Hc, :Wc] for x in img_stack])
    svc_1 = DetectionService(bank, det_cfg, batch_max=n_batch,
                             batch_window_ms=1000.0)
    with _serving(svc_1) as url:
        with ThreadPoolExecutor(n_batch) as ex:
            ref = [r for _, r, _ in ex.map(lambda b: _post(url, b), bodies)]

    def single_batch():
        res, _ = detect_organized_batch(
            torch.as_tensor(imgs_h, device=dev),
            torch.as_tensor(vms_h, device=dev), bank, det_cfg, block=blk,
            half_window=5)
        return to_host(res)

    for label, data, _, _, _ in layouts:
        mesh = make_mesh(devices=data)
        svc = DetectionService(bank, det_cfg, batch_max=n_batch,
                               batch_window_ms=1000.0, mesh=mesh)
        if any(d != dev for d in data):
            svc._mesh_batch(imgs_h, vms_h, blk)          # warm the other cards
        reset()
        with _serving(svc) as url, _Recorder(bruteforce) as rec:
            with ThreadPoolExecutor(n_batch) as ex:
                out, syncs = _count_syncs(lambda: list(ex.map(
                    lambda b: _post(url, b), bodies)))
            health = _health(url)
        n = counts()
        per_dev = {f"cuda:{i}": c for i, c in sorted(pk.nn1.by_device.items())}
        per_dev_b = {f"cuda:{i}": c
                     for i, c in sorted(pk.nn1_batched.by_device.items())}
        bad = [(st, r) for st, r, _ in out if st != 200]
        if bad:
            raise RuntimeError(f"phase 15.1 ({label}): the server answered "
                               f"{bad[0]}")
        busy = len([idx for idx in np.array_split(np.arange(n_batch),
                                                  len(data)) if idx.size])
        print(f"# phase 15.1 served mesh ({label}): {n_batch} requests in "
              f"{svc.n_batches} batch(es), nn1 launched {n[0]} times "
              f"{per_dev}, nn1_batched {n[1]} {per_dev_b}, knnk {n[2]}; "
              f"launches by shape {dict(sorted(rec.shapes().items()))}; host "
              f"reads {len(syncs)} ({len(syncs) / max(svc.n_batches, 1):.1f} "
              f"per batch, {busy} devices with frames); /healthz devices "
              f"{health['devices']} {card}", flush=True)
        if len(syncs) != busy * svc.n_batches or health["devices"] != len(data):
            raise RuntimeError(f"phase 15.1 ({label}): {len(syncs)} host reads "
                               f"in {svc.n_batches} batches over {busy} "
                               f"devices; /healthz {health}")
        by_path[f"mesh served ({label})"] = n
        launches[f"mesh served ({label})"] = rec.shapes()
        seen = set().union(*(set(c) for k, c in launches.items()
                             if not k.startswith("mesh")))
        for shape in sorted(set(rec.shapes()) - seen):
            q, s_, k, m = rec.first(shape)
            with on_device(q.device):
                if len(shape) == 4:
                    check_batched(q.contiguous(), s_, m,
                                  f"phase 15.1 {shape}, recorded inputs")
                    timings["batched"].append(_time_nn1_batched(
                        pk, q.contiguous(), s_, m, card,
                        f"phase 15.1 K1 batched {shape}", reps=5))
                else:
                    check(q, s_, k, m, f"phase 15.1 {shape}, recorded inputs")
                    timings[1].append(_time_knn(
                        pk, q, s_, m, k, card, f"phase 15.1 K1 {shape}",
                        reps=5))
        n_acc = 0
        for b, (reply, r1) in enumerate(zip([r for _, r, _ in out], ref)):
            rot, trans = _err(np.asarray(reply["pose"]), np.asarray(r1["pose"]))
            err_gt = _err(np.asarray(reply["pose"]), T_gt)
            print(f"#   phase 15.1 ({label}) frame {b}: accepted "
                  f"{reply['accepted']}, view {reply['view_idx']}; the "
                  f"single-device service: accepted {r1['accepted']}, view "
                  f"{r1['view_idx']}, {rot:.4f} deg / {trans * 1000:.4f} mm "
                  f"apart; to the truth {err_gt[0]:.3f} deg / "
                  f"{err_gt[1] * 1000:.3f} mm {card}", flush=True)
            if (reply["accepted"] != r1["accepted"]
                    or reply["view_idx"] != r1["view_idx"]
                    or not (rot < 0.5 and trans < 0.003)):
                raise RuntimeError(f"phase 15.1 ({label}) frame {b} differs "
                                   f"from the single-device service")
            if reply["accepted"]:
                n_acc += 1
                if not (err_gt[0] < 5.0 and err_gt[1] < 0.020):
                    raise RuntimeError(f"phase 15.1 ({label}) accepted a "
                                       f"wrong pose: frame {b}")
        if n_acc < int(BATCH_ACCEPTED * n_batch):
            raise RuntimeError(f"phase 15.1 ({label}): only {n_acc} of "
                               f"{n_batch} accepted")
        single_batch()
        turns = _turns({"single": single_batch,
                        "mesh": lambda: svc._mesh_batch(imgs_h, vms_h, blk)},
                       ("single", "mesh", "mesh", "single"))
        print(f"# phase 15.1 ({label}): the batch of {n_batch} frames from "
              f"host arrays to host results, ms on the mesh of {len(data)} "
              f"{[round(t, 3) for t in turns['mesh']]} against "
              f"{[round(t, 3) for t in turns['single']]} on {dev} alone (in "
              f"turns single, mesh, mesh, single) {card}", flush=True)
        if len(data) > 1:
            serial = svc._mesh_batch(imgs_h, vms_h, blk)
            outs_t, ms_t = threaded(
                lambda: svc._mesh_batch(imgs_h, vms_h, blk), 1)
            if not all(bit_equal(o, serial) for o in outs_t):
                raise RuntimeError(f"phase 15.1 ({label}): the threaded issue "
                                   f"differs from the one-thread issue")
            print(f"# phase 15.1 ({label}): the batch issued from one thread "
                  f"per data device ({busy} threads): equal bit for bit to "
                  f"the one-thread issue; ms "
                  f"{[round(t, 3) for t in ms_t]} {card}", flush=True)
    print(f"# phase 15.1 took {time.perf_counter() - t_phase:.1f} s {card}",
          flush=True)

    # --- 15.2 detect_batch: phase 6's cloud and 3 jittered copies ----------
    base = syn.scene_points(xyz_h[valid_h], gen_cfg.scene_capacity)
    pts = [base] + [base + np.random.default_rng(s).normal(
        0, 1e-4, base.shape).astype(np.float32) for s in (1, 2, 3)]
    clouds = [make_cloud(p, capacity=gen_cfg.scene_capacity, device=dev)
              for p in pts]
    singles = [detect(c, bank, gen_cfg) for c in clouds]
    stacked = stack_clouds(clouds)
    for label, _, grid, model, _ in layouts:
        mesh = make_mesh(devices=grid, model_parallel=model)
        placed = shard_inputs(stacked, bank, mesh)
        if any(d != dev for d in grid):
            detect_batch(*placed, gen_cfg)               # warm the other cards
        outs = {}
        for form, run in (("placed", lambda: detect_batch(*placed, gen_cfg)),
                          ("mesh=", lambda: detect_batch(*placed, gen_cfg,
                                                         mesh=mesh))):
            reset()
            with _Recorder(bruteforce) as rec:
                outs[form] = run()
            n = counts()
            per_dev = (dict(sorted(pk.nn1.by_device.items())),
                       dict(sorted(pk.knnk.by_device.items())))
            by_path[f"mesh detect_batch {form} ({label})"] = n
            k2 = rec.k2_calls()
            for q, s_, k, m in k2:
                with on_device(q.device):
                    check(q, s_, k, m, f"phase 15.2 {form} ({label}) K2, "
                                       f"recorded inputs")
            print(f"# phase 15.2 detect_batch {form} ({label}, "
                  f"{len(grid) // model} x {model}, "
                  f"{bank.n_views // model} views a shard): nn1 launched "
                  f"{n[0]} times {per_dev[0]}, knnk {n[2]} {per_dev[1]} (by "
                  f"card index), every K2 launch ({len(k2)}) rechecked "
                  f"{card}", flush=True)
            if len(k2) != n[2] or n[2] != 4 * len(pts):
                raise RuntimeError(f"phase 15.2 {form}: {n[2]} K2 launches, "
                                   f"{len(k2)} recorded")
        # tests/test_distributed.py's rule, on every scene: the accept flag
        # and the view equal to the single detect's, the pose within rtol
        # 1e-4 / atol 1e-5, the fitness within rtol 1e-4
        worst = [0.0, 0.0]
        for b, r1 in enumerate(singles):
            for form, out in outs.items():
                pose = out.full_pose[b].cpu()
                ref_pose = r1.full_pose.cpu()
                if (bool(out.accepted[b]) != bool(r1.accepted)
                        or int(out.view_idx[b]) != int(r1.view_idx)
                        or not torch.allclose(pose, ref_pose, rtol=1e-4,
                                              atol=1e-5)
                        or not math.isclose(float(out.fitness[b]),
                                            float(r1.fitness), rel_tol=1e-4,
                                            abs_tol=1e-8)):
                    raise RuntimeError(
                        f"phase 15.2 {form} ({label}) scene {b}: accepted "
                        f"{bool(out.accepted[b])} vs {bool(r1.accepted)}, view "
                        f"{int(out.view_idx[b])} vs {int(r1.view_idx)}, pose "
                        f"{float((pose - ref_pose).abs().max()):.3e}, fitness "
                        f"{float(out.fitness[b]):.6e} vs {float(r1.fitness):.6e}")
                worst[0] = max(worst[0], float((pose - ref_pose).abs().max()))
                worst[1] = max(worst[1], abs(float(out.fitness[b])
                                             - float(r1.fitness)))
            rot, trans = _err(r1.full_pose.cpu().numpy(), T_gt)
            print(f"#   phase 15.2 ({label}) scene {b}: view "
                  f"{int(r1.view_idx)}, accepted {bool(r1.accepted)}, "
                  f"{rot:.3f} deg / {trans * 1000:.3f} mm from the truth; both "
                  f"forms equal its single detect {card}", flush=True)
        if len(grid) // model > 1:
            outs_t, ms_t = threaded(
                lambda: detect_batch(*placed, gen_cfg, mesh=mesh), 1)
            if not all(bit_equal(o, outs["mesh="]) for o in outs_t):
                raise RuntimeError(f"phase 15.2 ({label}): the threaded issue "
                                   f"differs from the one-thread issue")
            print(f"# phase 15.2 ({label}): issued from one thread per data "
                  f"row ({len(grid) // model} threads): equal bit for bit to "
                  f"the one-thread issue; ms "
                  f"{[round(t, 3) for t in ms_t]} {card}", flush=True)
        turns = _turns({"single": lambda: detect_batch(stacked, bank, gen_cfg),
                        "mesh": lambda: detect_batch(*placed, gen_cfg,
                                                     mesh=mesh)},
                       ("single", "mesh", "mesh", "single"))
        print(f"# phase 15.2 ({label}): 4 scenes, worst |pose diff| to the "
              f"single detects {worst[0]:.3e}, |fitness diff| {worst[1]:.3e}; "
              f"ms on the mesh {[round(t, 3) for t in turns['mesh']]} against "
              f"{[round(t, 3) for t in turns['single']]} for the serial loop "
              f"on {dev} (in turns single, mesh, mesh, single) {card}",
              flush=True)

    print(f"# phase 15.2 done at {time.perf_counter() - t_phase:.1f} s of the "
          f"phase {card}", flush=True)

    # --- 15.3 the collectives ----------------------------------------------
    frame = tab_h.reshape(-1, 3)
    valid_flat = tab_valid_h.reshape(-1)
    xyz0 = torch.as_tensor(frame, device=dev)
    mask0 = torch.as_tensor(valid_flat, device=dev)
    N = xyz0.shape[0]
    rows0 = torch.as_tensor(np.sort(np.random.default_rng(0).choice(
        np.flatnonzero(valid_flat), 1024, replace=False)), device=dev)

    def slab_order(n):
        """Lanes in n slabs of N / n: the valid lanes sorted by x, dealt
        out in equal runs, each slab filled up with invalid lanes (so no
        slab in the middle of the line is empty)."""
        v = np.flatnonzero(valid_flat)
        v = v[np.argsort(frame[v, 0], kind="stable")]
        inv = np.flatnonzero(~valid_flat)
        runs = np.array_split(v, n)
        fill = np.cumsum([0] + [N // n - len(run) for run in runs])
        return np.concatenate([np.concatenate([run, inv[fill[j]:fill[j + 1]]])
                               for j, run in enumerate(runs)])

    ang = math.radians(8.0)
    R8 = np.array([[math.cos(ang), -math.sin(ang), 0],
                   [math.sin(ang), math.cos(ang), 0], [0, 0, 1]], np.float32)
    model = syn.joint_model(icp_points * 5 // 8, icp_points * 3 // 8)
    src = make_cloud(model, capacity=icp_points, device=dev)
    tgt = make_cloud(model @ R8.T + np.array([0.02, 0.0, 0.0], np.float32),
                     capacity=icp_points, device=dev)
    T_ref, fit_ref = icp(src, tgt, torch.eye(4, device=dev), iterations=12,
                         max_corr_dist=0.1)
    q2, s2 = fused_sumsq(xyz0[rows0]), fused_sumsq(xyz0)
    dense = torch.where(mask0[None], torch.clamp_min(
        q2[:, None] + s2[None] - 2.0 * (xyz0[rows0] @ xyz0.T), 0.0), 3.0e38)
    d16, i16 = top_k(dense, 16, largest=False)
    d96, i96 = top_k(dense, 97, largest=False)
    del dense
    r = 0.06
    r2 = float(np.float32(r) * np.float32(r))
    # rows whose 96 nearest hold a distance tie at the cut or one within
    # 1e-6 of r² (a last-bit difference could move them) are held by their
    # distances only
    plain = ~((d96[:, 95] == d96[:, 96])
              | ((d96[:, :97] - r2).abs() < 1e-6).any(1))
    want_v = d96[:, :96] <= r2
    for label, _, grid, model_n, ring in layouts:
        if len(ring) < 2:
            print(f"# phase 15.3 ({label}): a ring of one card exchanges "
                  f"nothing; the collectives run on the 4-entry ring only "
                  f"{card}", flush=True)
            continue
        mesh = make_mesh(devices=ring, model_parallel=len(ring))
        n = len(ring)
        order_h = slab_order(n)
        order = torch.as_tensor(order_h, device=dev)
        xyz, mask = xyz0[order], mask0[order]
        rows = torch.as_tensor(np.argsort(order_h), device=dev)[rows0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d, i = ring_knn(xyz, xyz, mask, 16, mesh)
        torch.cuda.synchronize()
        t_knn = time.perf_counter() - t0
        print(f"# phase 15.3 ring_knn ({label}) ran in {t_knn * 1e3:.1f} ms "
              f"{card}", flush=True)
        gd, gi = d[rows].to(dev), order[i[rows].to(dev).long()]
        gathered = fused_sumsq(xyz0[gi] - xyz0[rows0][:, None])
        if not (torch.allclose(gd, d16, rtol=1e-5, atol=1e-6)
                and torch.allclose(gathered, d16, rtol=1e-5, atol=1e-6)):
            raise RuntimeError(f"phase 15.3 ring_knn ({label}) differs from "
                               f"the dense search")
        same_idx = float((gi == i16).float().mean())
        # the halo the contract asks for: the most valid points within r of
        # any slab edge
        c = xyz[:, 0].reshape(n, -1)
        mk = mask.reshape(n, -1)
        edge_lo = torch.where(mk, c, float("inf")).amin(1, keepdim=True)
        edge_hi = torch.where(mk, c, float("-inf")).amax(1, keepdim=True)
        halo = max(1, int(torch.maximum(((c - edge_lo <= r) & mk).sum(1),
                                        ((edge_hi - c <= r) & mk).sum(1)).max()))
        extent = float((edge_hi - edge_lo).min())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hi_, hv_, hd_ = halo_radius_neighbors(xyz, mask, r, 96, mesh,
                                              halo=halo)
        torch.cuda.synchronize()
        t_halo = time.perf_counter() - t0
        print(f"# phase 15.3 halo_radius_neighbors ({label}) ran in "
              f"{t_halo * 1e3:.1f} ms {card}", flush=True)
        hd, hi2 = hd_[rows].to(dev), order[hi_[rows].to(dev).long()]
        hv = hv_[rows].to(dev)
        if not (torch.equal(hv[plain], want_v[plain])
                and torch.allclose(torch.where(want_v, hd, 0.0),
                                   torch.where(want_v, d96[:, :96], 0.0),
                                   rtol=1e-5, atol=1e-6)):
            raise RuntimeError(f"phase 15.3 halo ({label}) differs from the "
                               f"dense radius search")
        set_ok = [set(hi2[j][want_v[j]].tolist())
                  == set(i96[j, :96][want_v[j]].tolist())
                  for j in torch.nonzero(plain)[:, 0].tolist()]
        if not all(set_ok):
            raise RuntimeError(f"phase 15.3 halo ({label}): "
                               f"{set_ok.count(False)} rows' neighbour sets "
                               f"differ from the dense search")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        T_ring, fit_ring = ring_icp(src.xyz, src.mask, tgt.xyz, tgt.mask,
                                    mesh, iterations=12, max_corr_dist=0.1)
        torch.cuda.synchronize()
        t_icp = time.perf_counter() - t0
        print(f"# phase 15.3 ring_icp ({label}) ran in {t_icp * 1e3:.1f} ms "
              f"{card}", flush=True)
        dT = float((T_ring.to(dev) - T_ref).abs().max())
        dfit = abs(float(fit_ring) - float(fit_ref))
        dR = float(np.abs(T_ring.cpu().numpy()[:3, :3] - R8).max())
        rot, trans = _err(T_ring.cpu().numpy(),
                          np.block([[R8, np.array([[0.02], [0], [0]])],
                                    [np.zeros((1, 3)), np.ones((1, 1))]]))
        # tests/test_distributed.py's tolerances against the single-device
        # ICP: 5e-4 on T, 1e-6 on the fitness; and the motion 8 deg away
        # recovered within 1 deg (12 iterations; reported)
        if dT > 5e-4 or dfit > 1e-6 or rot > 1.0:
            raise RuntimeError(f"phase 15.3 ring_icp ({label}): |T diff| "
                               f"{dT:.3e}, |fitness diff| {dfit:.3e}, "
                               f"|R - R_true| {dR:.3e}")
        print(f"# phase 15.3 collectives ({label}, a ring of {n}): ring_knn "
              f"k=16 on {N} lanes ({int(mask.sum())} valid, the table frame "
              f"unprojected whole, in {n} slabs of equal valid count) "
              f"{t_knn * 1e3:.1f} ms, 1024 sampled rows "
              f"within rtol 1e-5 / atol 1e-6 of the dense search (indices "
              f"equal on {same_idx:.4%} of slots); halo_radius_neighbors r = "
              f"{r}, k_max 96, halo {halo} (the most valid points within r of "
              f"a slab edge; the narrowest slab {extent:.3f} m) "
              f"{t_halo * 1e3:.1f} ms, distances within rtol "
              f"1e-5 / atol 1e-6 on the 1024 sampled rows, valid flags and "
              f"neighbour sets equal on the {len(set_ok)} without a tie at "
              f"the 96th or a distance within 1e-6 of r²; ring_icp 12 "
              f"iterations, {len(model)} points in {icp_points} lanes, 8 deg "
              f"/ 2 cm: "
              f"{t_icp * 1e3:.1f} ms, "
              f"|T diff| to the single-device icp {dT:.3e}, |fitness diff| "
              f"{dfit:.3e}, {rot:.4f} deg / {trans * 1000:.4f} mm from the "
              f"motion (|R - R_true| {dR:.3e}) {card}", flush=True)
    # sharded_match_votes: phase 5's frame's 512 keys x 42 views x 256 keys
    feats, _ = organized_features(
        torch.as_tensor(xyz_h, device=dev), torch.as_tensor(valid_h, device=dev),
        det_cfg, 4, 5, torch.as_tensor(lo, device=dev),
        torch.as_tensor(hi, device=dev), None)
    sd = feats.desc
    d1 = torch.stack([torch.where(
        bank.key_valid[v][None],
        ((sd.double()[:, None, :] - bank.desc[v].double()[None]) ** 2).sum(-1),
        float("inf")).amin(-1) for v in range(bank.n_views)], 1)
    thr = det_cfg.match_threshold
    oracle = (d1 < thr).sum(0).to(torch.int32)
    margin = float((d1 - thr).abs().min())
    for label, _, grid, model_n, _ in layouts:
        mesh = make_mesh(devices=grid, model_parallel=model_n)
        votes = sharded_match_votes(sd, bank.desc, bank.key_valid, thr, mesh)
        if not torch.equal(votes.to(dev), oracle):
            raise RuntimeError(f"phase 15.3 sharded_match_votes ({label}) "
                               f"differs from the float64 oracle")
        print(f"# phase 15.3 sharded_match_votes ({label}, {model_n} view "
              f"shard(s)): {sd.shape[0]} scene keys x {bank.n_views} views x "
              f"{bank.desc.shape[1]} keys equal to the float64 oracle "
              f"(total votes {int(oracle.sum())}; the nearest distance lies "
              f"{margin:.3e} from the gate) {card}", flush=True)
    print(f"# phase 15 took {time.perf_counter() - t_phase:.1f} s (the script "
          f"{time.perf_counter() - _T_START:.1f} s so far) {card}", flush=True)
    return by_path


def _serve_one(service, depth):
    """One depth request to ``service`` over HTTP: (status, reply, ms)."""
    with _serving(service) as url:
        return _post(url, _depth_body(depth))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", type=Path, metavar="DIR",
                    help="directory with another version's nn1.cu and "
                         "knnk.cu, timed in turns with this tree's")
    ap.add_argument("--yardsticks", action="store_true",
                    help="re-time the plain version and cdist+topk at every "
                         "timed shape, not only at the kernels' main shapes")
    args = ap.parse_args()
    _EVERY_YARDSTICK[0] = args.yardsticks
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; none is available")
    from tpu_joints_torch import synthetic as syn
    from tpu_joints_torch.core.cloud import make_cloud
    from tpu_joints_torch.modelbank.bank import build_bank
    from tpu_joints_torch.neighbors import bruteforce
    from tpu_joints_torch.neighbors import knn_cases
    from tpu_joints_torch.neighbors import pallas_knn as pk
    from tpu_joints_torch.pipelines import multi
    from tpu_joints_torch.pipelines.detect import (detect, detect_organized,
                                                   good_instances)
    from tpu_joints_torch.segment import organized as lattice
    rg = importlib.import_module("tpu_joints_torch.segment.region_growing")
    from tpu_joints_torch.serve.batching import tree_map
    D = importlib.import_module("tpu_joints_torch.pipelines.detect")

    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    print(f"# phase 1 device: {kind}; nvidia-smi: {smi}", flush=True)

    # --- phase 2: build ---------------------------------------------------
    t0 = time.perf_counter()
    jobs = _start_other_build(args.against) if args.against else None
    # the small paths' CPU run (their card run comes after phase 16) needs
    # no kernel: it runs in a thread while nvcc compiles
    with ThreadPoolExecutor(1) as ex:
        small = ex.submit(_small_on, torch.device("cpu"))
        pk.build_all()
        print(f"# phase 2 build: nn1.cu (tj_nn1, tj_nn1_batched), knnk.cu "
              f"(tj_knnk) and unproject.cu (tj_unproject) compiled (in "
              f"parallel) and bound in "
              f"{time.perf_counter() - t0:.3f} s {card}", flush=True)
        small_cpu = small.result()
    print(f"# phase 2 the small paths on the CPU done "
          f"{time.perf_counter() - t0:.3f} s after the build started {card}",
          flush=True)
    other = _finish_other_build(jobs, card) if jobs else None
    if other:
        print(f"# phase 2 build: the other version ({args.against}) and "
              f"ptxas's report done in {time.perf_counter() - t0:.3f} s {card}",
              flush=True)

    # --- phase 3: kernels vs plain versions on the card --------------------
    print(f"# phase 3 starts {time.perf_counter() - _T_START:.1f} s "
          f"into the script {card}", flush=True)
    g = torch.Generator().manual_seed(0)

    def pts(n):
        return torch.randn(n, 3, generator=g).to(dev)

    def msk(n, masked):
        return (torch.rand(n, generator=g) >= masked).to(dev)

    max_err = {1: 0.0, 2: 0.0}        # K1, K2

    def check(q, s, k, m, label):
        if q.ndim == 3:          # a launch of K1's batch mode
            return check_batched(q.contiguous(), s, m, label)
        max_err[min(k, 2)] = max(max_err[min(k, 2)],
                                 _check_knn(pk, q, s, k, m, label, card))

    for M, N, masked, label in [(8192, 2560, 0.0, "ICP"),
                                (40960, 2048, 0.0, "tier-1 coverage"),
                                (10240, 4096, 0.0, "tier-2 coverage"),
                                (70, 100, 0.25, "25% of sources masked"),
                                (5000, 3333, 0.1, "N not a multiple of the tile"),
                                (64, 256, 1.0, "all sources masked")]:
        check(pts(M), pts(N), 1, msk(N, masked), label)
    for M, N, k, masked, label in [
            (2560, 2560, 16, 0.0, "region-growing shape, random points"),
            (2560, 2560, 2, 0.0, "k = 2"),
            (2560, 2560, 32, 0.0, "k = 32"),
            (100, 20, 32, 0.0, "N < k"),
            (64, 256, 8, 1.0, "all sources masked"),
            (70, 100, 16, 0.25, "25% of sources masked"),
            (5000, 3333, 16, 0.1, "N not a multiple of the tile"),
            (1001, 2048, 8, 0.0, "M not a multiple of the block")]:
        q, s, m = pts(M), pts(N), msk(N, masked)
        check(q, s, k, m, label)
        if label == "N < k" or masked == 1.0:
            d, i = pk.knnk(q, s, k, m)
            empty = slice(N, None) if masked < 1.0 else slice(None)
            if not (bool((d[:, empty] == np.float32(3e38)).all())
                    and bool((i[:, empty] == 0).all())):
                raise RuntimeError(f"knnk empty slots are not (3e38, 0) ({label})")
    # exact ties: every source twice, queries on sources; the lower index wins
    s = pts(512).repeat(2, 1)
    q = torch.cat([s[:256], pts(256)])
    check(q, s, 16, msk(1024, 0.0), "duplicated sources, exact ties")
    d, i = pk.knnk(q, s, 16, None)
    if not bool((i[:256, 0] == torch.arange(256, device=dev)).all()):
        raise RuntimeError("knnk does not break exact ties to the lowest index")
    # orders and sizes that stress the split sweep and the lane merge, for
    # both kernels (sources approaching every query in scan order, all
    # distances tied, a masked twin before each valid source, N = 1, N < k,
    # N = 33), then M around a warp and N around a 32-lane split, and the
    # clustered OBB's shape with 90% of the sources masked
    def on_card(arrays):
        return [torch.from_numpy(a).to(dev) for a in arrays]

    for name, case in sorted(knn_cases.CASES.items()):
        for k in (1, 2, 16, 32):
            q, s, m = on_card(case(k))
            check(q, s, k, m, f"{name}, k = {k}")
    for M, N, k, masked in knn_cases.STRADDLE:
        q, s, m = on_card(knn_cases.straddle(M, N, k, masked))
        for kk in (1, k):
            check(q, s, kk, m, f"straddling the split, {masked:.0%} masked")
    # K1's batch mode: fixed shapes, then the stacked edge cases (an entry
    # with no valid source, B = 1, masks that differ per entry, many
    # entries, B * M around the row count that changes the lanes per row)
    max_err["batched"] = 0.0

    def check_batched(q, s, m, label):
        max_err["batched"] = max(max_err["batched"], _check_nn1_batched(
            pk, q, s, m, label, card))

    def bpts(b, n):
        return torch.randn(b, n, 3, generator=g).to(dev)

    def bmsk(b, n, masked):
        return (torch.rand(b, n, generator=g) >= masked).to(dev)

    for B, M, N, masked, label in [
            (8, 8192, 2560, 0.0, "8 entries of the ICP shape"),
            (48, 8192, 16384, 0.5, "HV scene -> instance shape"),
            (2, 70, 100, 0.25, "25% of sources masked"),
            (3, 5000, 3333, 0.1, "N not a multiple of the tile"),
            (5, 64, 256, 1.0, "all sources masked")]:
        check_batched(bpts(B, M), bpts(B, N), bmsk(B, N, masked), label)
    for name, arrays in sorted(knn_cases.batches().items()):
        check_batched(*on_card(arrays), name)
    timings = {1: [], 2: [], "batched": []}
    for M, N, label in [(8192, 2560, "ICP"), (40960, 2048, "tier-1 coverage"),
                        (10240, 4096, "tier-2 coverage")]:
        timings[1].append(_time_knn(pk, pts(M), pts(N), msk(N, 0.0), 1, card,
                                    f"phase 3 K1 ({label} shape)", other,
                                    yardsticks=label == "ICP"))
    timings["batched"].append(_time_nn1_batched(
        pk, bpts(8, 8192), bpts(8, 2560), bmsk(8, 2560, 0.0), card,
        "phase 3 K1 batched (batch ICP shape)", yardsticks=True))

    unproject_row = _unproject_phase(dev, card)

    # --- phase 4: the 42-view bank on the card ----------------------------
    print(f"# phase 4 starts {time.perf_counter() - _T_START:.1f} s "
          f"into the script {card}", flush=True)
    cfg = syn.bench_config()
    det_cfg = dataclasses.replace(cfg, segment_scene=False, remove_plane=False)
    torch.cuda.synchronize()
    pk.knnk.launches = 0
    t0 = time.perf_counter()
    with _Recorder(bruteforce) as rec:
        bank = build_bank(syn.joint_model(), **syn.bench_bank_kwargs(cfg),
                          device=dev)
    torch.cuda.synchronize()
    bank_s = time.perf_counter() - t0
    bank_k2 = pk.knnk.launches
    launches = {"bank": rec.shapes()}
    print(f"# phase 4 bank: {bank.n_views} views, desc {tuple(bank.desc.shape)}, "
          f"view capacity Nv {bank.view_xyz.shape[1]}, "
          f"{int(bank.key_valid.sum())} valid keys, built in {bank_s:.2f} s; "
          f"K2 launched {bank_k2} times; launches by shape (M, N, k): "
          f"{dict(sorted(launches['bank'].items()))} {card}", flush=True)
    bank_calls = rec.k2_calls()
    if bank_k2 != bank.n_views or len(bank_calls) != bank_k2:
        raise RuntimeError(f"bank build launched K2 {bank_k2} times, expected "
                           f"one per view ({bank.n_views})")
    for n, (q, s, k, m) in enumerate(bank_calls):
        check(q, s, k, m, f"bank view {n} normals")
    for M in (1024, 2048):
        q, s, k, m = next(c for c in bank_calls if c[0].shape[0] == M)
        timings[2].append(_time_knn(pk, q, s, m, k, card,
                                    f"phase 4 K2 (bank normals, {M} lanes)",
                                    other))

    # --- phase 5: the organized path --------------------------------------
    print(f"# phase 5 starts {time.perf_counter() - _T_START:.1f} s "
          f"into the script {card}", flush=True)
    T_gt = syn.bench_pose()
    xyz_h, valid_h = syn.frame(T_gt, 42, with_table=False)
    xyz_img = torch.as_tensor(xyz_h, device=dev)
    valid = torch.as_tensor(valid_h, device=dev)
    lo = torch.as_tensor(syn.CROP_LO, device=dev)
    hi = torch.as_tensor(syn.CROP_HI, device=dev)

    def run_org():
        return detect_organized(xyz_img, valid, bank, det_cfg, block=4,
                                half_window=5, crop_lo=lo, crop_hi=hi)

    pk.nn1.launches = pk.knnk.launches = 0
    with _Recorder(bruteforce) as rec:
        (res, n_sel), syncs = _count_syncs(run_org)
    org_k1, org_k2 = pk.nn1.launches, pk.knnk.launches
    launches["organized"] = rec.shapes()
    print(f"# phase 5 organized path: nn1 launched {org_k1} times, knnk "
          f"{org_k2} times in one detect_organized; launches by shape (M, N, "
          f"k): {dict(sorted(launches['organized'].items()))}; host "
          f"synchronisations flagged: {len(syncs)} {card}", flush=True)
    for msg in sorted(set(syncs))[:5]:
        print(f"#   sync: {msg}", flush=True)
    if org_k1 == 0 or org_k2 != 0:
        raise RuntimeError(f"the organized path launched K1 {org_k1} and K2 "
                           f"{org_k2} times; expected K1 >= 1 and K2 = 0")
    if syncs:
        raise RuntimeError("detect_organized synchronised with the host")
    (res, n_sel), times = _timed_runs(run_org)
    _gate("phase 5 organized 640x480", res, T_gt, times, card,
          f"n_selected {int(n_sel)}, ")

    # --- phase 6: the generic path ----------------------------------------
    print(f"# phase 6 starts {time.perf_counter() - _T_START:.1f} s "
          f"into the script {card}", flush=True)
    gen_cfg = syn.generic_config()
    scene = make_cloud(syn.scene_points(xyz_h[valid_h], gen_cfg.scene_capacity),
                       capacity=gen_cfg.scene_capacity, device=dev)

    def run_gen():
        return detect(scene, bank, gen_cfg)

    pk.nn1.launches = pk.knnk.launches = 0
    rg.region_growing.host_checks = 0
    with _Recorder(bruteforce) as rec:
        res, syncs = _count_syncs(run_gen)
    gen_k1, gen_k2 = pk.nn1.launches, pk.knnk.launches
    checks = rg.region_growing.host_checks
    launches["generic"] = rec.shapes()
    gen_calls = rec.k2_calls()
    print(f"# phase 6 generic path ({int(scene.mask.sum())} points): nn1 "
          f"launched {gen_k1} times, knnk {gen_k2} times in one detect; "
          f"launches by shape (M, N, k): "
          f"{dict(sorted(launches['generic'].items()))}; host "
          f"synchronisations flagged: {len(syncs)}, region-growing host reads "
          f"(one per 8 sweeps): {checks} {card}", flush=True)
    for msg in sorted(set(syncs))[:5]:
        print(f"#   sync: {msg}", flush=True)
    if gen_k1 == 0 or gen_k2 != 4 or len(gen_calls) != 4:
        raise RuntimeError(f"the generic path launched K1 {gen_k1} and K2 "
                           f"{gen_k2} times; expected K1 >= 1 and K2 = 4")
    if len(syncs) != checks:
        raise RuntimeError(f"{len(syncs)} host syncs flagged, but the region "
                           f"growing schedule reads {checks} times")
    labels = ["scene normals", "region-growing graph", "clustered-OBB normals",
              "clustered-OBB graph"]
    for (q, s, k, m), label in zip(gen_calls, labels):
        check(q, s, k, m, label)
    q, s, k, m = gen_calls[1]
    timings[2].append(_time_knn(pk, q, s, m, k, card,
                                "phase 6 K2 (region-growing graph)", other,
                                yardsticks=True))
    q, s, k, m = gen_calls[3]
    nv = q.shape[0]
    check(pts(nv), pts(nv), k, msk(nv, 0.3), "OBB shape, random points")
    timings[2].append(_time_knn(pk, q, s, m, k, card,
                                "phase 6 K2 (clustered-OBB graph)", other))
    res, times = _timed_runs(run_gen)
    _gate("phase 6 generic 640x480", res, T_gt, times, card,
          f"scene points after the crop {int(res.metrics['scene_points'])}, ")

    # --- phase 7: the segmented organized path ----------------------------
    print(f"# phase 7 starts {time.perf_counter() - _T_START:.1f} s "
          f"into the script {card}", flush=True)
    seg_cfg = syn.segmented_config()
    tab_h, tab_valid_h = syn.frame(T_gt, 42, with_table=True)
    tab_img = torch.as_tensor(tab_h, device=dev)
    tab_valid = torch.as_tensor(tab_valid_h, device=dev)

    def run_seg():
        return detect_organized(tab_img, tab_valid, bank, seg_cfg, block=4,
                                half_window=5, crop_lo=lo, crop_hi=hi)

    def counted(label, run, want_k2):
        """One run of a lattice-cropped path with launches, syncs and the
        lattice region growing's reads counted and held to each other."""
        pk.nn1.launches = pk.knnk.launches = 0
        lattice.region_growing_lattice.host_checks = 0
        with _Recorder(bruteforce) as rec:
            out, syncs = _count_syncs(run)
        k1, k2 = pk.nn1.launches, pk.knnk.launches
        reads = lattice.region_growing_lattice.host_checks
        print(f"# {label}: nn1 launched {k1} times, knnk {k2} times in one "
              f"run; launches by shape (M, N, k): "
              f"{dict(sorted(rec.shapes().items()))}; host synchronisations "
              f"flagged: {len(syncs)}, lattice region-growing host reads (one "
              f"per {lattice.SWEEPS_PER_CHECK} sweeps): {reads} {card}",
              flush=True)
        for msg in sorted(set(syncs))[:5]:
            print(f"#   sync: {msg}", flush=True)
        if k1 == 0 or k2 != want_k2:
            raise RuntimeError(f"{label} launched K1 {k1} and K2 {k2} times; "
                               f"expected K1 >= 1 and K2 = {want_k2}")
        if len(syncs) != reads:
            raise RuntimeError(f"{len(syncs)} host syncs flagged, but the "
                               f"lattice region growing reads {reads} times")
        return out, rec.shapes(), k1

    _, launches["segmented"], seg_k1 = counted(
        "phase 7 segmented organized path", run_seg, 0)
    (res, n_sel), times = _timed_runs(run_seg)
    _gate("phase 7 segmented 640x480 with table", res, T_gt, times, card,
          f"n_selected {int(n_sel)} of "
          f"{int(res.metrics['scene_points'])} scene points, ")

    # --- phase 8: the two-part path ---------------------------------------
    print(f"# phase 8 starts {time.perf_counter() - _T_START:.1f} s "
          f"into the script {card}", flush=True)
    two_cfg = syn.two_part_config()
    torch.cuda.synchronize()
    pk.knnk.launches = 0
    t0 = time.perf_counter()
    with _Recorder(bruteforce) as rec:
        part_banks = syn.build_part_banks(two_cfg, device=dev)
    torch.cuda.synchronize()
    parts_s = time.perf_counter() - t0
    parts_k2 = pk.knnk.launches
    launches["part banks"] = rec.shapes()
    n_part_views = sum(b.n_views for b in part_banks.values())
    print(f"# phase 8 part banks: {list(part_banks)}, {n_part_views} views, "
          f"view capacity Nv {part_banks['chord'].view_xyz.shape[1]}, built in "
          f"{parts_s:.2f} s; K2 launched {parts_k2} times; launches by shape "
          f"(M, N, k): {dict(sorted(launches['part banks'].items()))} {card}",
          flush=True)
    part_calls = rec.k2_calls()
    if parts_k2 != n_part_views or len(part_calls) != parts_k2:
        raise RuntimeError(f"the part banks launched K2 {parts_k2} times, "
                           f"expected one per view ({n_part_views})")
    for n, (q, s, k, m) in enumerate(part_calls):
        check(q, s, k, m, f"part-bank view {n} normals")
    # the concatenation and the shared-CAD check (a host read) happen here,
    # once per bank set; the frames below find them cached
    t0 = time.perf_counter()
    names, cat = multi._cat_for_parts(part_banks)
    torch.cuda.synchronize()
    print(f"# phase 8 concatenated bank: {cat.n_views} views, desc "
          f"{tuple(cat.desc.shape)}, made and checked in "
          f"{(time.perf_counter() - t0) * 1e3:.3f} ms {card}", flush=True)

    def run_two():              # eager: phase 17 replays the captured form
        _, r, n = multi._detect_parts_organized_eager(
            tab_img, tab_valid, part_banks, two_cfg, block=4, half_window=5,
            crop_lo=lo, crop_hi=hi)
        return r, n

    _, launches["two-part"], two_k1 = counted("phase 8 two-part path",
                                              run_two, 0)
    (res, n_sel), times = _timed_runs(run_two)
    Vp = cat.n_views // len(names)
    cand_parts = (res.cand_views // Vp).tolist()
    _gate("phase 8 two-part 640x480 with table", res, T_gt, times, card,
          f"winning part {names[int(res.view_idx) // Vp]}, candidates' parts "
          f"{cand_parts}, n_selected {int(n_sel)}, ")
    if cand_parts != sorted(cand_parts) or len(set(cand_parts)) != len(names):
        raise RuntimeError(f"the pooled field is not one slice per part: "
                           f"{cand_parts}")

    # --- phase 9: multi-instance detection --------------------------------
    print(f"# phase 9 starts {time.perf_counter() - _T_START:.1f} s "
          f"into the script {card}", flush=True)
    two_h, two_valid_h, T_a, T_b = syn.two_instance_frame()
    two_img = torch.as_tensor(two_h, device=dev)
    two_valid = torch.as_tensor(two_valid_h, device=dev)
    wlo = torch.as_tensor(syn.WIDE_LO, device=dev)
    whi = torch.as_tensor(syn.WIDE_HI, device=dev)
    multi_cfg, hv_cfg = syn.multi_instance_config(), syn.hv_config()

    def run_multi(c=multi_cfg):
        return detect_organized(two_img, two_valid, bank, c, block=4,
                                half_window=5, crop_lo=wlo, crop_hi=whi)

    def counted_frame(label, run):
        """One run with all three launch counts and the syncs taken from 0;
        no sync is allowed."""
        pk.nn1.launches = pk.nn1_batched.launches = pk.knnk.launches = 0
        with _Recorder(bruteforce) as rec:
            out, syncs = _count_syncs(run)
        n = (pk.nn1.launches, pk.nn1_batched.launches, pk.knnk.launches)
        print(f"# {label}: nn1 launched {n[0]} times, nn1_batched {n[1]} "
              f"times, knnk {n[2]} times in one run; launches by shape (M, N, "
              f"k) or (B, M, N, k): {dict(sorted(rec.shapes().items()))}; host "
              f"synchronisations flagged: {len(syncs)} {card}", flush=True)
        for msg in sorted(set(syncs))[:5]:
            print(f"#   sync: {msg}", flush=True)
        if syncs:
            raise RuntimeError(f"{label} synchronised with the host")
        return out, rec, n

    (res, n_sel), rec, (multi_k1, multi_kb, multi_k2) = counted_frame(
        "phase 9 multi-instance path", run_multi)
    launches["multi-instance"] = rec.shapes()
    want = {(24576, 8192, 1): 17, (393216, 2048, 1): 1, (98304, 4096, 1): 1}
    if dict(rec.shapes()) != want or (multi_kb, multi_k2) != (0, 0):
        raise RuntimeError(f"the multi-instance frame launched "
                           f"{dict(rec.shapes())}, expected {want}")
    for shape, label in [((24576, 8192, 1), "multi-instance ICP"),
                         ((393216, 2048, 1), "multi-instance tier-1 coverage"),
                         ((98304, 4096, 1), "multi-instance tier-2 coverage")]:
        q, s_, k, m = rec.first(shape)
        check(q, s_, k, m, label + ", recorded inputs")
        timings[1].append(_time_knn(pk, q, s_, m, k, card,
                                    f"phase 9 K1 ({label})", other, reps=5))
    (res, n_sel), times = _timed_runs(run_multi)
    busy, ops, peak = _device_busy(run_multi)
    print(f"# phase 9 multi-instance 640x480: median "
          f"{statistics.median(times):.3f} ms (min {min(times):.3f}, max "
          f"{max(times):.3f}) over {len(times)} runs, n_selected {int(n_sel)}, "
          f"device busy {busy:.3f} ms, {ops} device operations, peak "
          f"{peak:.1f} MiB {card}", flush=True)
    _instances_gate("phase 9 multi-instance", res, multi_cfg, T_a, T_b, card,
                    good_instances)

    # --- phase 10: global hypothesis verification --------------------------
    print(f"# phase 10 starts {time.perf_counter() - _T_START:.1f} s "
          f"into the script {card}", flush=True)
    (res_hv, _), rec, (hv_k1, hv_kb, hv_k2) = counted_frame(
        "phase 10 GO-HV path", lambda: run_multi(hv_cfg))
    launches["hv"] = rec.shapes()
    Nv = bank.view_xyz.shape[1]
    hv_shapes = {(48, 8192, Nv, 1): 1, (48 * Nv, 8192, 1): 1}
    if (dict(rec.shapes()) != {**want, **hv_shapes}
            or (hv_k1, hv_kb, hv_k2) != (multi_k1 + 1, 1, 0)):
        raise RuntimeError(f"the HV frame launched {dict(rec.shapes())}, "
                           f"expected {({**want, **hv_shapes})}")
    print(f"# phase 10 GO-HV adds {hv_kb} nn1_batched launch and "
          f"{hv_k1 - multi_k1} nn1 launch to the multi-instance frame {card}",
          flush=True)
    q, s_, _, m = rec.first((48, 8192, Nv, 1))
    check_batched(q.contiguous(), s_, m, "HV scene -> instance, recorded inputs")
    timings["batched"].append(_time_nn1_batched(
        pk, q.contiguous(), s_, m, card,
        "phase 10 K1 batched (HV scene -> instance)", reps=5))
    q, s_, k, m = rec.first((48 * Nv, 8192, 1))
    check(q, s_, k, m, "HV instance -> scene, recorded inputs")
    timings[1].append(_time_knn(pk, q, s_, m, k, card,
                                "phase 10 K1 (HV instance -> scene)", other,
                                reps=5))
    del q, s_, m
    torch.cuda.empty_cache()
    turns = {"off": [], "on": []}
    for which in ("off", "on", "on", "off"):
        c = hv_cfg if which == "on" else multi_cfg
        (r, _), t = _timed_runs(lambda: run_multi(c), n=3)
        turns[which] += t
    busy, ops, peak = _device_busy(lambda: run_multi(hv_cfg))
    print(f"# phase 10 GO-HV 640x480: HV on median "
          f"{statistics.median(turns['on']):.3f} ms, HV off "
          f"{statistics.median(turns['off']):.3f} ms (in turns off, on, on, "
          f"off; 3 runs each); HV on: device busy {busy:.3f} ms, {ops} device "
          f"operations, peak {peak:.1f} MiB {card}", flush=True)
    _instances_gate("phase 10 GO-HV", res_hv, hv_cfg, T_a, T_b, card,
                    good_instances)
    _small_hv(dev, card)

    # --- phase 11: a batch of 8 frames --------------------------------------
    print(f"# phase 11 starts {time.perf_counter() - _T_START:.1f} s "
          f"into the script {card}", flush=True)
    n_batch = 8
    imgs = torch.as_tensor(syn.batch_frames(xyz_h, n_batch), device=dev)
    valids = valid[None].expand(n_batch, -1, -1).contiguous()

    def run_batch():            # eager: phase 17 replays the captured form
        return D._detect_organized_batch_eager(
            imgs, valids, bank, det_cfg, block=4, half_window=5, crop_lo=lo,
            crop_hi=hi)

    (res_b, n_sel_b), rec, (bat_k1, bat_kb, bat_k2) = counted_frame(
        "phase 11 batch of 8", run_batch)
    launches["batch"] = rec.shapes()
    # each frame is refined on its own: phase 5's launches, n_batch times
    want = {shape: n_batch * c for shape, c in launches["organized"].items()}
    if dict(rec.shapes()) != want or bat_k2 != 0:
        raise RuntimeError(f"the batch launched {dict(rec.shapes())}, "
                           f"expected {want}")
    singles = [detect_organized(imgs[b], valids[b], bank, det_cfg, block=4,
                                half_window=5, crop_lo=lo, crop_hi=hi)
               for b in range(n_batch)]
    # an accepted frame's pose entries, batch against its own run: K1 is
    # bit-equal per entry, the batched products round differently
    POSE_TOL = 3e-4
    n_acc, worst = 0, 0.0
    for b, (r1, n1) in enumerate(singles):
        pose = res_b.full_pose[b].cpu().numpy()
        rot, trans = _err(pose, T_gt)
        acc = bool(res_b.accepted[b])
        diff = float((res_b.full_pose[b] - r1.full_pose).abs().max())
        print(f"#   frame {b}: accepted {acc}, view {int(res_b.view_idx[b])}, "
              f"rot_err {rot:.3f} deg, trans_err {trans * 1000:.3f} mm; its own "
              f"detect_organized run: accepted {bool(r1.accepted)}, view "
              f"{int(r1.view_idx)}, max |full_pose diff| {diff:.3e} {card}",
              flush=True)
        if acc != bool(r1.accepted) or int(n_sel_b[b]) != int(n1) or (
                acc and diff > POSE_TOL):
            raise RuntimeError(f"frame {b} of the batch differs from its own "
                               f"detect_organized run")
        if acc and int(res_b.view_idx[b]) != int(r1.view_idx):
            # the winning view may differ only where two views carry the
            # same pose and their ranks tie to the last bits: the single
            # run's view must be a tier-2 survivor of this frame of the
            # batch, polished to the batch winner's pose
            shown, j, gap, rank, won = _tie(
                tree_map(lambda a, b=b: a[b], res_b), r1.view_idx, POSE_TOL)
            print(f"#     frame {b} won view {int(res_b.view_idx[b])} at rank "
                  f"{won:.9g}; view {int(r1.view_idx)}, the single run's, is "
                  f"candidate {j} of this frame: tier-2 survivor {shown}, "
                  f"rank {rank:.9g}, max |full_pose diff| to the winner "
                  f"{gap:.3e} {card}", flush=True)
            if not shown:
                raise RuntimeError(
                    f"frame {b} of the batch won view {int(res_b.view_idx[b])}"
                    f", its own run view {int(r1.view_idx)}, and the batch "
                    f"holds no tier-2 candidate of that view at the same pose")
        if acc:
            n_acc += 1
            worst = max(worst, diff)
            if not (rot < 5.0 and trans < 0.020):
                raise RuntimeError(f"the batch accepted a wrong pose: frame "
                                   f"{b}, {rot:.1f} deg {trans * 1000:.1f} mm")
    if n_acc < int(BATCH_ACCEPTED * n_batch):
        raise RuntimeError(f"only {n_acc} of {n_batch} frames accepted")
    turns = {"single": [], "batch": []}
    for which in ("single", "batch", "batch", "single"):
        _, t = _timed_runs(run_org if which == "single" else run_batch)
        turns[which] += t
    busy_1, ops_1, peak_1 = _device_busy(run_org)
    busy_b, ops_b, peak_b = _device_busy(run_batch)
    med_b = statistics.median(turns["batch"])
    print(f"# phase 11 batch of {n_batch} 640x480: {n_acc} of {n_batch} "
          f"accepted, accepted poses within {worst:.3e} of their own runs; "
          f"batch median {med_b:.3f} ms = {med_b / n_batch:.3f} ms per frame "
          f"amortised, single frame median "
          f"{statistics.median(turns['single']):.3f} ms (in turns single, "
          f"batch, batch, single; 3 runs each); device operations per batch "
          f"{ops_b} against {n_batch} x {ops_1} = {n_batch * ops_1}; device "
          f"busy {busy_b:.3f} ms per batch against {busy_1:.3f} ms per single "
          f"frame; peak {peak_b:.1f} MiB against {peak_1:.1f} MiB {card}",
          flush=True)

    # --- phase 12: the detection server on the card ----------------------
    print(f"# phase 12 starts {time.perf_counter() - _T_START:.1f} s "
          f"into the script {card}", flush=True)
    served_n = _serve_phase(
        dev, kind, card, bank, launches, check, check_batched,
        cfgs=dict(det=det_cfg, seg=seg_cfg, hv=hv_cfg, gen=gen_cfg),
        frames=dict(xyz=xyz_h, valid=valid_h, two=two_h, two_valid=two_valid_h,
                    T=T_gt, T_a=T_a, T_b=T_b, scene=scene), timings=timings)

    # --- phase 13: FPFH, the generic options, fpfh_demo served -------------
    print(f"# phase 13 starts {time.perf_counter() - _T_START:.1f} s "
          f"into the script {card}", flush=True)
    fpfh_n = _fpfh_phase(
        dev, card, bank, launches, check, timings,
        frames=dict(tab=tab_img, tab_valid=tab_valid, T=T_gt, lo=lo, hi=hi,
                    scene=scene), gen_cfg=gen_cfg)

    # --- phase 14: the CLI's flow, lattice keys, the pixel ingest -----------
    cli_n = _cli_phase(
        dev, card, bank, launches, check, check_batched, timings,
        frames=dict(xyz=xyz_h, valid=valid_h, tab=tab_h, tab_valid=tab_valid_h,
                    T=T_gt, xyz_img=xyz_img, valid_t=valid, tab_img=tab_img,
                    tab_valid_t=tab_valid, lo=lo, hi=hi, imgs=imgs,
                    valids=valids),
        cfgs=dict(det=det_cfg, seg=seg_cfg))

    # --- phase 15: the multi-device surface ---------------------------------
    mesh_n = _mesh_phase(
        dev, card, bank, launches, check, check_batched, timings,
        cfgs=dict(det=det_cfg, gen=gen_cfg),
        frames=dict(xyz=xyz_h, valid=valid_h, tab=tab_h, tab_valid=tab_valid_h,
                    T=T_gt, lo=syn.CROP_LO, hi=syn.CROP_HI))

    # --- the paths at small size, card vs CPU ------------------------------
    print(f"# the paths at small size start {time.perf_counter() - _T_START:.1f} "
          f"s into the script {card}", flush=True)
    _small_runs(dev, T_gt, card, small_cpu)

    # --- phase 16: the README's Python API ----------------------------------
    api_n, api = _api_phase(dev, card, launches, check, timings,
                            frames=dict(xyz=xyz_h, valid=valid_h, T=T_gt))

    # --- phase 17: the captured one-dispatch paths ---------------------------
    _captured_phase(
        dev, card, bank,
        cfgs=dict(det=det_cfg, seg=seg_cfg, two=two_cfg, multi=multi_cfg,
                  hv=hv_cfg),
        frames=dict(xyz_img=xyz_img, valid=valid, lo=lo, hi=hi, xyz=xyz_h,
                    valid_h=valid_h, T=T_gt, tab_img=tab_img,
                    tab_valid=tab_valid, two_img=two_img, two_valid=two_valid,
                    wlo=wlo, whi=whi, imgs=imgs, valids=valids),
        part_banks=part_banks, api=api)

    # the top-level numbers of each kernel are those of its main shape
    # (K1: ICP; K2: the region-growing graph) and its launches in phase 8
    # (K1: one two-part frame; K2: the part banks' build);
    # "launches_by_path" gives each path's own count, taken from 0 over one
    # run of it, and "timings" lists every shape with its launches per bank
    # build and per frame of each path
    for row in timings[1] + timings[2] + timings["batched"]:
        row["launches"] = {path: n[tuple(row["shape"])]
                           for path, n in launches.items()}
    main_row = {1: timings[1][0], 2: timings[2][2],
                "batched": timings["batched"][0]}
    kernels = []
    by_path = {
        1: {"organized": org_k1, "generic": gen_k1, "segmented": seg_k1,
            "two-part": two_k1, "multi-instance": multi_k1, "hv": hv_k1,
            "batch": bat_k1},
        "batched": {"organized": 0, "generic": 0, "segmented": 0,
                    "two-part": 0, "multi-instance": multi_kb, "hv": hv_kb,
                    "batch": bat_kb},
        2: {"bank": bank_k2, "organized": org_k2, "generic": gen_k2,
            "segmented": 0, "part banks": parts_k2, "two-part": 0,
            "multi-instance": multi_k2, "hv": hv_k2, "batch": bat_k2}}
    for path, n in {**served_n, **fpfh_n, **cli_n, **mesh_n,
                    **api_n}.items():
        for kk, i in ((1, 0), ("batched", 1), (2, 2)):
            by_path[kk][path] = n[i]
    # "launches": K1 over one batch of 8, its batch mode over the GO-HV
    # frame (a batch refines its frames one by one), K2 over the part
    # banks' build
    for kk, name, src, line, n_launches in (
            (1, "nn1", "nn1", "59", bat_k1),
            ("batched", "nn1_batched", "nn1",
             "92 (under jax.vmap: tpu_joints/pipelines/detect.py:1067, "
             "tpu_joints/recognize/hv.py:140)", hv_kb),
            (2, "knnk", "knnk", "65", parts_k2)):
        row = main_row[kk]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"tpu_joints_torch/neighbors/csrc/{src}.cu",
            "replaces": f"tpu_joints/neighbors/pallas_knn.py:{line}",
            "launches": n_launches, "launches_by_path": by_path[kk],
            "max_abs_err": max_err[kk],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "cdist_topk_ms": row["cdist_topk_ms"],
            "timings": timings[kk]})
    kernels.append(unproject_row)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
