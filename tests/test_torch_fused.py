"""Port parity, the one-dispatch entries (``tpu_joints_torch/core/graphs.py``):
``detect_organized(fused=True)``, ``detect_fused`` and
``detect_parts_organized`` against the JAX package's on the CPU, where the
port runs its eager chain; the captured chain's sweep schedule of the
lattice region growing (no host read, labels equal); the graph cache's key;
``detect_fused``'s refusal of the region-growing crop. The replays
themselves run only on a card (``tests/test_torch_cuda.py``).

Scale: the bench joint's 320×240 raycast frames with and without the table,
block 2 / half-window 3, and the level-0 bank at 64 px that
``tests/level0_bank.py`` shares (built by the JAX package once per session
and carried across), with ``tests/test_torch_segmented.py``'s
configuration; the two-part case splits that bank's
views into two part banks that share its CAD.
"""
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.level0_bank import level0_jax_bank
from tests.test_torch_segmented import _seg_cfgs
from tpu_joints.core.cloud import make_cloud as jmake_cloud
from tpu_joints_torch import synthetic as syn
from tpu_joints_torch.core import graphs
from tpu_joints_torch.core.cloud import make_cloud
from tpu_joints_torch.modelbank import bank as tbank
from tpu_joints_torch.pipelines import multi as tmulti
from tpu_joints_torch.pipelines.ingest import ingest_organized_blocks
from tpu_joints_torch.segment import organized as torg
tdet = importlib.import_module("tpu_joints_torch.pipelines.detect")
trg = importlib.import_module("tpu_joints_torch.segment.region_growing")

jdet = importlib.import_module("tpu_joints.pipelines.detect")
jmulti = importlib.import_module("tpu_joints.pipelines.multi")
ARRAYS = ("view_xyz", "view_mask", "key_xyz", "key_valid", "desc", "rf",
          "poses", "model_xyz", "model_mask", "icp_xyz", "icp_mask")
PER_VIEW = tuple(k for k in ARRAYS if not k.startswith("model_"))
GEO = dict(block=2, half_window=3)
LO, HI = syn.CROP_LO, syn.CROP_HI


def _t(a):
    return torch.from_numpy(np.array(a))


def _carry(jb):
    return tbank.bank_from_numpy(
        {k: np.asarray(getattr(jb, k)) for k in ARRAYS}
        | {"params_hash": jb.params_hash}, device="cpu")


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """The bench joint's shared level-0 bank (JAX, port) and its 320×240
    frames, with the table (True) and without."""
    jb = level0_jax_bank(tmp_path_factory)
    T_gt = syn.bench_pose()
    frames = {table: syn.frame(T_gt, 42, with_table=table, width=320,
                               height=240) for table in (True, False)}
    return jb, _carry(jb), frames, T_gt


@pytest.mark.parametrize("route", ["lattice crop", "plain"])
def test_detect_organized_fused_matches_jax(bench, route):
    """``detect_organized(fused=True)`` on both routes of the JAX package's
    fused-against-split test (the crop chain on, and off), the table frame,
    against the JAX package's fused program: n_selected, winning view,
    candidate views and accept flag equal, poses within 5e-4 (that test's
    tolerance). On the CPU the port's fused call is its eager chain and
    captures nothing."""
    jb, tb, frames, _ = bench
    crop = route == "lattice crop"
    jcfg, tcfg = _seg_cfgs(segment_scene=crop, remove_plane=crop)
    img, valid = frames[True]
    rj, nj = jdet.detect_organized(
        jnp.asarray(img), jnp.asarray(valid), jb, jcfg, fused=True,
        crop_lo=jnp.asarray(LO), crop_hi=jnp.asarray(HI), **GEO)
    n_entries = len(graphs.entries())
    rt, nt = tdet.detect_organized(_t(img), _t(valid), tb, tcfg, fused=True,
                                   crop_lo=_t(LO), crop_hi=_t(HI), **GEO)
    assert len(graphs.entries()) == n_entries
    assert int(nt) == int(nj)
    assert int(rt.view_idx) == int(rj.view_idx)
    np.testing.assert_array_equal(rt.cand_views.numpy(),
                                  np.asarray(rj.cand_views))
    assert bool(rt.accepted) == bool(rj.accepted)
    np.testing.assert_allclose(rt.full_pose.numpy(), np.asarray(rj.full_pose),
                               rtol=0, atol=5e-4)


def test_detect_fused_matches_jax(bench):
    """``detect_fused`` on the table-free frame's points as an unorganized
    cloud (kNN normals, no crop) against the JAX package's: winning view,
    candidate views and accept flag equal, poses within 5e-4."""
    jb, tb, frames, _ = bench
    jcfg, tcfg = _seg_cfgs(segment_scene=False, remove_plane=False)
    img, valid = frames[False]
    pts = syn.scene_points(img[valid], jcfg.scene_capacity)
    rj = jdet.detect_fused(jmake_cloud(pts, capacity=jcfg.scene_capacity), jb,
                           jcfg)
    rt = tdet.detect_fused(make_cloud(pts, capacity=tcfg.scene_capacity,
                                      device="cpu"), tb, tcfg)
    assert int(rt.view_idx) == int(rj.view_idx)
    np.testing.assert_array_equal(rt.cand_views.numpy(),
                                  np.asarray(rj.cand_views))
    assert bool(rt.accepted) == bool(rj.accepted)
    np.testing.assert_allclose(rt.full_pose.numpy(), np.asarray(rj.full_pose),
                               rtol=0, atol=5e-4)


@pytest.mark.parametrize("backend", ["graph", "voxel"])
def test_detect_fused_refuses_the_region_growing_crop(bench, backend):
    """The crop's graph and voxel growings read the host inside
    ``prepare_scene``: ``detect_fused`` raises, naming the read, before
    any work, on every device."""
    _, tb, frames, _ = bench
    _, tcfg = _seg_cfgs(remove_plane=False, rg_backend=backend)
    img, valid = frames[False]
    scene = make_cloud(img[valid][:64], capacity=256, device="cpu")
    with pytest.raises(ValueError, match="reads the host once per 8 sweeps"):
        tdet.detect_fused(scene, tb, tcfg)


def test_detect_parts_organized_matches_jax(bench):
    """The two-part search through its captured entry (eager on the CPU)
    against the JAX package's one program, on the table frame through the
    lattice crop, with the bank's first and second half of views as two
    part banks sharing its CAD: names, n_selected, the candidate field
    (views and validity), winning view, accept flag and counts equal,
    poses within 5e-4."""
    jb, _, frames, _ = bench
    half = jb.view_xyz.shape[0] // 2
    jbanks = {name: dataclasses.replace(
        jb, **{k: getattr(jb, k)[sl] for k in PER_VIEW})
        for name, sl in (("chord", slice(0, half)),
                         ("stub", slice(half, 2 * half)))}
    tbanks = {n: _carry(b) for n, b in jbanks.items()}
    jcfg, tcfg = _seg_cfgs()
    img, valid = frames[True]
    nj, rj, sj = jmulti.detect_parts_organized(
        jnp.asarray(img), jnp.asarray(valid), jbanks, jcfg,
        crop_lo=jnp.asarray(LO), crop_hi=jnp.asarray(HI), **GEO)
    nt, rt, st = tmulti.detect_parts_organized(
        _t(img), _t(valid), tbanks, tcfg, crop_lo=_t(LO), crop_hi=_t(HI),
        **GEO)
    assert nt == nj == ["chord", "stub"]
    assert int(st) == int(sj)
    np.testing.assert_array_equal(rt.cand_views.numpy(),
                                  np.asarray(rj.cand_views))
    np.testing.assert_array_equal(rt.cand_valid.numpy(),
                                  np.asarray(rj.cand_valid))
    assert int(rt.view_idx) == int(rj.view_idx)
    assert bool(rt.accepted) == bool(rj.accepted)
    np.testing.assert_allclose(rt.full_pose.numpy(), np.asarray(rj.full_pose),
                               rtol=0, atol=5e-4)
    for k in ("scene_points", "scene_keypoints", "correspondences",
              "instances"):
        assert int(rt.metrics[k]) == int(rj.metrics[k]), k


@pytest.fixture(scope="module")
def lattice(bench):
    """The table frame's 120×160 tile lattice from the port's ingest: xyz,
    normals, curvature, valid."""
    img, valid = bench[2][True]
    scene, normals, curvature, _ = ingest_organized_blocks(
        _t(img), _t(valid), capacity=None, crop_lo=_t(LO), crop_hi=_t(HI),
        **GEO)
    return (scene.xyz.reshape(120, 160, 3), normals.reshape(120, 160, 3),
            curvature.reshape(120, 160), scene.mask.reshape(120, 160))


@pytest.mark.parametrize("mode", ["first", "cap"])
def test_captured_sweep_schedule_reads_nothing(lattice, mode):
    """The lattice growing as a captured chain runs it: one chunk of 8
    sweeps with its change flag kept ("first"), or all 64 sweeps
    ("cap"), no host read either way (``host_checks`` unchanged); the
    labels and sizes a replay keeps (the chunk's where its flag says the
    growing had settled, else the cap's) equal the read-checked
    schedule's. The graph growing of the clustered box likewise, on the
    lattice's valid nodes as a cloud."""
    kw = dict(smoothness_deg=12.0, curvature_threshold=7.0,
              min_cluster_size=50, max_edge=0.05)
    want = torg.region_growing_lattice(*lattice, **kw)
    before = torg.region_growing_lattice.host_checks
    flags = []
    with graphs.captured_schedule(mode, flags):
        got = torg.region_growing_lattice(*lattice, **kw)
    assert torg.region_growing_lattice.host_checks == before
    assert len(flags) == (mode == "first")
    if any(bool(f) for f in flags):     # unsettled: the replay takes the cap
        with graphs.captured_schedule("cap", []):
            got = torg.region_growing_lattice(*lattice, **kw)
    assert torch.equal(got.labels, want.labels)
    assert torch.equal(got.sizes, want.sizes)
    assert len(set(got.labels.tolist()) - {-1}) >= 3

    xyz, normals, curvature, valid = (t.reshape(-1, *t.shape[2:])
                                      for t in lattice)
    cloud = make_cloud(xyz[valid].numpy()[::8], capacity=2048, device="cpu")
    n = int(cloud.mask.sum())
    nrm = torch.zeros(2048, 3)
    nrm[:n] = normals[valid][::8]
    cur = torch.zeros(2048)
    cur[:n] = curvature[valid][::8]
    want = trg.region_growing(cloud, nrm, cur, k=16, max_edge=0.05)
    before = trg.region_growing.host_checks
    flags = []
    with graphs.captured_schedule(mode, flags):
        got = trg.region_growing(cloud, nrm, cur, k=16, max_edge=0.05)
    assert trg.region_growing.host_checks == before
    assert len(flags) == (mode == "first")
    if any(bool(f) for f in flags):
        with graphs.captured_schedule("cap", []):
            got = trg.region_growing(cloud, nrm, cur, k=16, max_edge=0.05)
    assert torch.equal(got.labels, want.labels)
    assert torch.equal(got.sizes, want.sizes)


@pytest.mark.parametrize("mode", ["first", "cap"])
def test_capture_holds_the_cached_draws(lattice, mode):
    """The RANSAC plane's uniforms are a cached upload that a graph reads at
    its address: run under a capture's schedule, the plane removal hands
    the very tensor the draw cache holds to the graph's entry
    (``graphs.hold``), so an eviction cannot free it under the graph;
    outside a capture nothing is held, and the plane is the same either
    way."""
    from tpu_joints_torch.core import prng
    from tpu_joints_torch.segment import sac

    xyz, normals, _, valid = (t.reshape(-1, *t.shape[2:]) for t in lattice)
    cloud = make_cloud(xyz[valid].numpy(), capacity=int(valid.sum()),
                       device="cpu")
    nrm = normals[valid]
    want = sac.sac_plane(cloud, nrm, seed=7, n_hypotheses=32)
    held = []
    with graphs.captured_schedule(mode, [], held):
        got = sac.sac_plane(cloud, nrm, seed=7, n_hypotheses=32)
    assert len(held) == 1
    assert held[0] is prng._uploaded(7, (32, 3), torch.device("cpu"))
    t = torch.zeros(1)
    assert graphs.hold(t) is t and len(held) == 1      # outside a capture
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_graph_cache_key(bench):
    """One key for equal calls; another for another configuration, frame
    shape, bank or crop box given; a fresh copy of the bank is another bank
    (the cache holds the bank it captured with)."""
    jb, tb, frames, _ = bench
    _, cfg = _seg_cfgs()
    img, valid = frames[True]

    def key(bank=tb, c=cfg, im=img, lo=LO):
        _, args, static = tdet._organized(
            _t(im), _t(valid[:im.shape[0], :im.shape[1]]), bank, c, 2, 3,
            None if lo is None else _t(lo), _t(HI), None)
        return graphs.cache_key("detect_organized", args, static, bank)

    assert key() == key()
    others = [key(c=dataclasses.replace(cfg, max_candidates=6)),
              key(im=img[:-2]), key(bank=_carry(jb)), key(lo=None)]
    assert len({key(), *others}) == 1 + len(others)


def test_warm_depth_runs_every_batch_size(bench, monkeypatch):
    """``serve --warm-depth`` with ``--batch-max 2``: the warm-up runs the
    depth frame (a batch of 1, through the batcher) and the batch of 2 —
    on a card that captures both graphs, here it runs them eagerly — and
    counts no request for the batch it runs itself."""
    from tpu_joints_torch.serve import DetectionService

    _, tb, _, _ = bench
    _, tcfg = _seg_cfgs(segment_scene=False, remove_plane=False,
                        scene_capacity=1024, scene_key_capacity=64)
    sizes = []
    real = tdet.detect_organized_batch

    def recording(imgs, *a, **kw):
        sizes.append(imgs.shape[0])
        return real(imgs, *a, **kw)

    monkeypatch.setattr(tdet, "detect_organized_batch", recording)
    svc = DetectionService(tb, tcfg, batch_max=2)
    svc.warmup(depth_shape=(120, 160))
    assert sizes == [1, 2]
    assert svc.n_requests == 2          # the 16-point cloud and the frame
