"""Port parity, the FPFH-33 chain (``bench.py``'s ``scene_latency_fpfh``,
the ``fpfh_demo`` preset): pair features, binning, SPFH and FPFH, the
self-excluding radius search and the radius normals, the FPFH bank, and
``detect_organized`` (single, batched, served) — JAX package vs port on the
CPU, same inputs.

Scale: seeded 1500-point samples of the bench joint for the feature
functions; a level-0 FPFH bank (12 views at 64 px, 64 keys) and the 320×240
table frame (block 2, half-window 3, 3072 lanes, 256 keys) for the chain.

Tolerances. The radius gathers take the expansion form on both sides, so
their distances are equal bit for bit and their indices equal except
within runs of exactly tied distances, which XLA's CPU ``approx_min_k``
orders arbitrarily (sets equal there; counted). Bins are equal except for
features within 1e-6 of a bin edge (0 measured on random normals) and pairs
whose source/target choice is a tie: on a rendered cylinder two points'
normals often meet their baseline at equal angles (|a1| = |a2| in exact
arithmetic), and the last bit of the two dot products, which XLA's fused
code and the port round differently, decides the swap and so the sign of
φ (6 of 12,794 pairs of the level-0 bank's keys, measured). Descriptors
within 2e-3, the tolerance ``tests/test_golden_descriptors.py`` gives the
JAX package against PCL's algorithm (the mixing product's sum order
differs; 1.5e-5 measured), except rows that mix an SPFH holding such a tie
(34 of 671 valid bank rows, measured, all in the 4 views with a tie).
Normals within 1e-4.
"""
import ast
import concurrent.futures
import dataclasses
import importlib
import inspect
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_batch import assert_batch_equals_singles
from tpu_joints.config import PRESETS as JPRESETS
from tpu_joints.config import DetectionConfig
from tpu_joints.core.cloud import make_cloud as jmake_cloud
from tpu_joints.features import fpfh as jfpfh
from tpu_joints.features import normals as jnormals
from tpu_joints.modelbank.bank import build_bank as jbuild_bank
from tpu_joints.modelbank.bank import save_bank as jsave_bank
from tpu_joints.neighbors import radius_neighbors as jradius
from tpu_joints.serve import DetectionService as JDetectionService
from tpu_joints_torch import config as tconfig
from tpu_joints_torch import synthetic as syn
from tpu_joints_torch.core.cloud import make_cloud
from tpu_joints_torch.features import fpfh as tfpfh
from tpu_joints_torch.features import normals as tnormals
from tpu_joints_torch.modelbank import bank as tbank
from tpu_joints_torch.neighbors.bruteforce import radius_neighbors
tdet = importlib.import_module("tpu_joints_torch.pipelines.detect")
from tpu_joints_torch.serve import DetectionService

jdet = importlib.import_module("tpu_joints.pipelines.detect")
ARRAYS = ("view_xyz", "view_mask", "key_xyz", "key_valid", "desc", "rf",
          "poses", "model_xyz", "model_mask", "icp_xyz", "icp_mask")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "descriptors.npz")
LO, HI = syn.CROP_LO, syn.CROP_HI
GEO = dict(block=2, half_window=3)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfg():
    """``synthetic.fpfh_config`` at test size."""
    return dataclasses.replace(syn.fpfh_config(), scene_ss=0.03,
                               scene_capacity=3072, scene_key_capacity=256)


def _bank_kw(cfg):
    return dict(syn.fpfh_bank_recipe(cfg), level=0, resolution=64,
                key_capacity=64, icp_capacity=1024)


@pytest.fixture(scope="module")
def cloud():
    """1500 points of the posed bench joint (some exact distance ties: the
    model is sampled on cylinders) with seeded unit normals, at 2048 lanes."""
    rng = np.random.default_rng(0)
    T = syn.bench_pose()
    pts = syn.joint_model(3000, 1800) @ T[:3, :3].T + T[:3, 3]
    xyz = pts[rng.choice(len(pts), 1500, replace=False)].astype(np.float32)
    nrm = rng.normal(size=xyz.shape).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    nrm = np.pad(nrm, ((0, 548), (0, 0)))
    return (jmake_cloud(xyz, capacity=2048), jnp.asarray(nrm),
            make_cloud(xyz, capacity=2048, device="cpu"), _t(nrm))


def _assert_gather_matches(jout, tout):
    """Same within-radius slots and distances bit for bit; indices equal
    except inside runs of exactly equal distances, whose members agree
    (but for a run cut by ``k_max``). Returns the number of slots whose
    index differs."""
    ij, wj, dj = (np.asarray(a) for a in jout)
    it, wt, dt = (a.numpy() for a in tout)
    np.testing.assert_array_equal(wt, wj)
    np.testing.assert_array_equal(dt[wj], dj[wj])
    moved = 0
    for r in np.flatnonzero(((it != ij) & wj).any(1)):
        n = int(wj[r].sum())
        for d in np.unique(dj[r, :n]):
            run = dj[r, :n] == d
            if run.sum() == 1:
                assert (it[r, :n][run] == ij[r, :n][run]).all(), (r, d)
            elif not (run[-1] and n == wj.shape[1]):
                assert set(it[r, :n][run]) == set(ij[r, :n][run]), (r, d)
        moved += int((it[r, :n] != ij[r, :n]).sum())
    return moved


@pytest.mark.parametrize("k_max,exclude_self",
                         [(1, True), (16, True), (192, True), (192, False)])
def test_radius_neighbors_exclude_self_matches(cloud, k_max, exclude_self):
    """``radius_neighbors(exclude_self=True)`` takes the sort path at every
    k (the kernels have no self-exclusion; k <= 32 without it is kernel K1
    or K2, held to ``knn_pallas`` in ``tests/test_torch_knn*.py``): equal
    to the JAX package's XLA path, and no row ever lists its own lane; the
    same at k = 192 without it, where every row lists its own."""
    jc, _, tc, _ = cloud
    jout = jradius(jc.xyz, jc.xyz, 0.06, k_max, source_mask=jc.mask,
                   exclude_self=exclude_self)
    tout = radius_neighbors(tc.xyz, tc.xyz, 0.06, k_max, source_mask=tc.mask,
                            exclude_self=exclude_self)
    moved = _assert_gather_matches(jout, tout)
    assert moved <= 0.01 * int(tout[1].sum())
    own = tout[0].numpy() == np.arange(2048)[:, None]
    assert (own & tout[1].numpy()).any() != exclude_self


def test_pair_features_and_bins_match(cloud):
    """Darboux features within 1e-5 and the degenerate flags equal on every
    (point, neighbour) pair of the 0.06 m supports; bins equal except where
    the feature lies within 1e-6 of a bin edge (counted: none)."""
    jc, jn, tc, tn = cloud
    idx, _, _ = radius_neighbors(tc.xyz, tc.xyz, 0.06, 64,
                                 source_mask=tc.mask, exclude_self=True)
    idx = idx.long()
    args = (tc.xyz[:1500, None, :], tn[:1500, None, :], tc.xyz[idx[:1500]],
            tn[idx[:1500]])
    ft = tfpfh.pair_features(*args)
    fj = jfpfh.pair_features(*(jnp.asarray(a.numpy()) for a in args))
    np.testing.assert_array_equal(ft[3].numpy(), np.asarray(fj[3]))
    for a, b in zip(ft[:3], fj[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)
    bt = tfpfh._hard_bins(*(_t(np.asarray(f)) for f in fj[:3]))
    bj = jfpfh._hard_bins(*fj[:3])
    scaled = (11 * (np.asarray(fj[0]) + 1) * 0.5, 11 * (np.asarray(fj[1]) + 1) * 0.5,
              11 * (np.asarray(fj[2]) + np.pi) / (2 * np.pi))
    near_edge = 0
    for a, b, x in zip(bt, bj, scaled):
        edge = np.abs(x - np.round(x)) < 1e-6
        near_edge += int((a.numpy() != np.asarray(b)).sum())
        np.testing.assert_array_equal(a.numpy()[~edge], np.asarray(b)[~edge])
    assert near_edge == 0


def test_spfh_matches(cloud):
    """SPFH over the cloud itself (the self-excluding pass): every block's
    counts equal, values within 1e-4 (100 / count in float32)."""
    jc, jn, tc, tn = cloud
    sj = jfpfh.spfh(jc.xyz, jn, jc.mask, jc.xyz, jn, jc.mask, 0.06, 192)
    st = tfpfh.spfh(tc.xyz, tn, tc.mask, tc.xyz, tn, tc.mask, 0.06, 192,
                    exclude_self=True)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=1e-4)
    assert np.asarray(sj)[:1500].sum(1).min() > 0


@pytest.fixture(scope="module")
def key_views():
    """The level-0 FPFH bank's keypoint clouds as the port builds them (1 cm
    surface, radius normals at 0.15, 64 keys at 2 cm), view by view: (keys,
    key normals)."""
    from tpu_joints_torch.core.cloud import bucket_size
    from tpu_joints_torch.filters.filters import (compact_cloud,
                                                  uniform_sample_mask)
    from tpu_joints_torch.modelbank.scanner import render_views

    views, _, _ = render_views(syn.joint_model(3000, 1800), level=0,
                               resolution=64)
    out = []
    for v in views:
        c = make_cloud(v, capacity=bucket_size(len(v)), device="cpu")
        c, _ = compact_cloud(c, uniform_sample_mask(c, 0.01), c.capacity)
        nrm, _ = tnormals.estimate_normals_radius(c, 0.15, 96)
        keys, kidx = compact_cloud(c, uniform_sample_mask(c, 0.02), 64)
        out.append((keys, nrm[kidx]))
    return out


def _swap_tie_views(key_views):
    """Per view, the (key, slot) pairs of the r = 0.15 SPFH pass whose bins
    differ between the JAX package's jitted code and the port, each checked
    to be a swap tie (||a1| − |a2|| < 1e-6 in float64)."""
    import jax

    @jax.jit
    def jax_bins(kx, km, kn):
        idx, within, d2 = jradius(kx, kx, 0.15, 192, source_mask=km,
                                  exclude_self=True)
        a, p, t, ok = jfpfh.pair_features(kx[:, None, :], kn[:, None, :],
                                          kx[idx], kn[idx])
        return (jnp.stack(jfpfh._hard_bins(a, p, t)),
                within & (d2 > 1e-18) & km[:, None] & ok, idx)

    flips, pairs = [], 0
    for keys, kn in key_views:
        bj, used, idx = jax_bins(*(jnp.asarray(t.numpy())
                                   for t in (keys.xyz, keys.mask, kn)))
        idx = _t(np.asarray(idx)).long()
        bt = torch.stack(tfpfh._hard_bins(*tfpfh.pair_features(
            keys.xyz[:, None, :], kn[:, None, :], keys.xyz[idx], kn[idx])[:3]))
        used = np.asarray(used)
        flip = (bt.numpy() != np.asarray(bj)).any(0) & used
        q, n = keys.xyz.numpy().astype(np.float64), kn.numpy().astype(np.float64)
        for r, k in np.argwhere(flip):
            s = int(idx[r, k])
            du = (q[s] - q[r]) / np.linalg.norm(q[s] - q[r])
            assert abs(abs(n[r] @ du) - abs(n[s] @ du)) < 1e-6, (r, s)
        flips.append(int(flip.sum()))
        pairs += int(used.sum())
    return flips, pairs


def test_spfh_bins_differ_only_at_swap_ties(key_views):
    """On the bank's keypoint clouds (normals on a rendered cylinder) the
    SPFH bins of the JAX package's jitted pass and the port's differ only
    at swap ties, on a handful of pairs."""
    flips, pairs = _swap_tie_views(key_views)
    assert pairs > 10000
    assert 0 < sum(flips) <= 0.001 * pairs, (flips, pairs)


@pytest.mark.parametrize("surface", ["keys", "cloud"])
def test_compute_fpfh_matches(cloud, surface):
    """FPFH of 300 keypoints over the keypoints themselves (r = 0.15, 192
    neighbours: truncated, as the chain's) or over the cloud (r = 0.06):
    validity equal, the keypoint gather as ``_assert_gather_matches`` holds
    it, descriptors within 2e-3 (no row differs by more; measured 1.5e-5)."""
    jc, jn, tc, tn = cloud
    sel = np.random.default_rng(1).choice(1500, 300, replace=False)
    xyz = tc.xyz.numpy()[sel]
    jk, tk = jmake_cloud(xyz, capacity=512), make_cloud(xyz, capacity=512,
                                                        device="cpu")
    kn = np.pad(tn.numpy()[sel], ((0, 212), (0, 0)))
    if surface == "keys":
        js, jsn, ts, tsn, r = jk, jnp.asarray(kn), tk, _t(kn), 0.15
    else:
        js, jsn, ts, tsn, r = jc, jn, tc, tn, 0.06
    dj, vj = jfpfh.compute_fpfh(jk, jnp.asarray(kn), js, jsn, radius=r,
                                k_max=192)
    dt, vt = tfpfh.compute_fpfh(tk, _t(kn), ts, tsn, radius=r, k_max=192)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert int(vt.sum()) == 300
    if surface == "keys":
        assert int(radius_neighbors(tk.xyz, tk.xyz, r, 192)[1].sum(1).max()) \
            == 192                             # the gather is truncated
    _assert_gather_matches(jradius(jk.xyz, js.xyz, r, 192, source_mask=js.mask),
                           radius_neighbors(tk.xyz, ts.xyz, r, 192,
                                            source_mask=ts.mask))
    diff = np.abs(dt.numpy() - np.asarray(dj)).max(1)
    assert (diff > 2e-3).sum() == 0, diff.max()
    blocks = dt.numpy()[vt.numpy()].reshape(-1, 3, 11).sum(-1)
    np.testing.assert_allclose(blocks, 100.0, rtol=1e-5)


def test_compute_fpfh_matches_golden():
    """The port against ``tests/golden/descriptors.npz`` (PCL's algorithm,
    an independent scalar implementation) at the JAX test's 2e-3."""
    g = np.load(GOLDEN)
    n = g["key_idx"].shape[0]
    keys = make_cloud(g["xyz"][g["key_idx"]], capacity=16, device="cpu")
    surface = make_cloud(g["xyz"], capacity=512, device="cpu")
    normals = _t(np.pad(g["normals"], ((0, 512 - g["xyz"].shape[0]), (0, 0))))
    desc, valid = tfpfh.compute_fpfh(keys, None, surface, normals,
                                     radius=float(g["radius_fpfh"]), k_max=256)
    assert bool(valid[:n].all())
    np.testing.assert_allclose(desc.numpy()[:n], g["fpfh"], atol=2e-3)


def test_estimate_normals_radius_matches(cloud):
    """Radius normals (r = 0.03, k_max 96) within 1e-4, curvature within
    1e-5."""
    jc, _, tc, _ = cloud
    nj, cj = jnormals.estimate_normals_radius(jc, radius=0.03, k_max=96)
    nt, ct = tnormals.estimate_normals_radius(tc, radius=0.03, k_max=96)
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), rtol=0, atol=1e-4)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0, atol=1e-5)
    assert (np.linalg.norm(nt.numpy()[:1500], axis=1) > 0.99).mean() > 0.9


@pytest.fixture(scope="module")
def banks(tmp_path_factory):
    """The level-0 FPFH bank built by each package (radius normals at
    0.15, as the ``fpfh_demo`` preset's), the JAX one also saved as ``.npz``
    and loaded by the port."""
    cfg = _cfg()
    kw = dict(_bank_kw(cfg), normal_radius=0.15)
    model = syn.joint_model(3000, 1800)
    jb = jbuild_bank(model, **kw)
    tb = tbank.build_bank(model, device="cpu", **kw)
    path = str(tmp_path_factory.mktemp("bank") / "fpfh.npz")
    jsave_bank(path, jb)
    return jb, tb, tbank.load_bank(path, device="cpu")


def test_build_bank_fpfh_matches(banks, key_views):
    """``build_bank(descriptor="fpfh", normal_radius=0.15)``: views, keys,
    validity and poses equal; descriptors within 2e-3; BOARD frames within
    1e-4 where valid; 33-D descriptors through every field."""
    jb, tb, _ = banks
    for f in ("view_xyz", "view_mask", "key_xyz", "key_valid", "poses",
              "model_xyz", "icp_xyz", "icp_mask"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)
    v = np.asarray(jb.key_valid)
    assert tb.desc.shape[-1] == 33 and v.sum() > 300
    diff = np.abs(tb.desc.numpy() - np.asarray(jb.desc)).max(-1)
    off = (diff > 2e-3) & v
    # rows past 2e-3 mix an SPFH with a swap tie (module docstring): they
    # lie in the views that hold one, and are few
    tie_views = {i for i, f in enumerate(_swap_tie_views(key_views)[0]) if f}
    assert set(np.flatnonzero(off.any(1))) <= tie_views, tie_views
    assert off.sum() <= 0.06 * v.sum(), off.sum()
    np.testing.assert_allclose(tb.rf.numpy()[v], np.asarray(jb.rf)[v],
                               rtol=0, atol=1e-4)
    assert tb.params_hash == jb.params_hash


def test_jax_built_fpfh_bank_loads(banks):
    """The weight carrier: a JAX-built FPFH ``.npz`` loads in the port with
    every array equal and its 33-D width."""
    jb, _, lb = banks
    for f in ARRAYS:
        np.testing.assert_array_equal(getattr(lb, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)
    assert lb.desc.shape[-1] == 33 and lb.has_model


@pytest.fixture(scope="module")
def table():
    xyz, valid = syn.frame(syn.bench_pose(), 42, with_table=True, width=320,
                           height=240)
    return xyz, valid


def _field_matches(rt, rj):
    """The candidate field and counts of two single-frame results."""
    np.testing.assert_array_equal(rt.cand_views.numpy(),
                                  np.asarray(rj.cand_views))
    np.testing.assert_array_equal(rt.cand_valid.numpy(),
                                  np.asarray(rj.cand_valid))
    assert bool(rt.accepted) == bool(rj.accepted)
    for k in ("scene_points", "scene_keypoints", "valid_descriptors",
              "correspondences", "instances"):
        assert int(rt.metrics[k]) == int(rj.metrics[k]), k
    assert float(rt.metrics["best_votes"]) == pytest.approx(
        float(rj.metrics["best_votes"]), rel=1e-5)


def test_detect_organized_fpfh_matches(banks, table):
    """``synthetic.fpfh_config`` on the table frame through the segmented
    ingest, the port on the JAX-built bank (loaded from its ``.npz``):
    n_selected, the candidate field, the accept flag and the counts equal
    JAX's. At this size neither package accepts a pose (Hough peaks on a
    few ratio-gated matches; measured), so poses are not held (see
    ``tests/test_torch_multi.py::test_detect_parts_organized_matches``)."""
    jb, _, lb = banks
    xyz, valid = table
    tcfg = _cfg()
    jcfg = DetectionConfig(**dataclasses.asdict(tcfg))
    rj, nj = jdet.detect_organized(
        jnp.asarray(xyz), jnp.asarray(valid), jb, jcfg,
        crop_lo=jnp.asarray(LO), crop_hi=jnp.asarray(HI), **GEO)
    rt, nt = tdet.detect_organized(_t(xyz), _t(valid), lb, tcfg,
                                   crop_lo=_t(LO), crop_hi=_t(HI), **GEO)
    assert int(nt) == int(nj)
    _field_matches(rt, rj)
    assert not bool(rt.accepted)
    assert int(rt.metrics["valid_descriptors"]) > 100


@pytest.fixture(scope="module")
def generic_cloud():
    """The bench frame's points (no table) strided to 3072 by the CLI's
    recipe, for ``detect``."""
    from tpu_joints.core.cloud import make_cloud as jmake

    xyz, valid = syn.frame(syn.bench_pose(), 42, with_table=False, width=320,
                           height=240)
    pts = syn.scene_points(xyz[valid], 3072)
    return jmake(pts, capacity=3072), make_cloud(pts, capacity=3072,
                                                 device="cpu")


def test_detect_fpfh_radius_normals_matches(banks, generic_cloud):
    """``detect`` (the unorganized path) with FPFH over the keys and radius
    normals at 0.15 (``fpfh_demo``'s scene side), no crop: the candidate
    field, accept flag and counts equal JAX's on the same bank."""
    jb, _, lb = banks
    js, ts = generic_cloud
    tcfg = dataclasses.replace(_cfg(), segment_scene=False, remove_plane=False,
                               normal_radius=0.15)
    jcfg = DetectionConfig(**dataclasses.asdict(tcfg))
    _field_matches(tdet.detect(ts, lb, tcfg), jdet.detect(js, jb, jcfg))


def _tied_rows(keys_xyz, surface, normals, radius, k_max):
    """bool[M]: keypoints whose gather reaches a surface point whose SPFH
    rests on a tie — a pair with ||a1| − |a2|| < 1e-6 (a swap tie), or a
    ``k_max``-th neighbour exactly as far as the next one (a run of equal
    distances cut by ``k_max``, whose members XLA orders arbitrarily)."""
    idx, within, d2 = radius_neighbors(surface.xyz, surface.xyz, radius,
                                       k_max + 1, source_mask=surface.mask,
                                       exclude_self=True)
    cut = within[:, k_max] & (d2[:, k_max] == d2[:, k_max - 1])
    idx, within, d2 = idx[:, :k_max].long(), within[:, :k_max], d2[:, :k_max]
    du = surface.xyz[idx] - surface.xyz[:, None, :]
    du = du / torch.clamp_min(du.norm(dim=-1, keepdim=True), 1e-12)
    a1 = (normals[:, None, :] * du).sum(-1)
    a2 = (normals[idx] * du).sum(-1)
    swap = ((a1.abs() - a2.abs()).abs() < 1e-6) & within & (d2 > 1e-18)
    tie = swap.any(1) | cut
    kidx, kwithin, _ = radius_neighbors(keys_xyz, surface.xyz, radius, k_max,
                                        source_mask=surface.mask)
    return (tie[kidx.long()] & kwithin).any(1).numpy()


def test_prepare_scene_fpfh_cloud_surface_matches(generic_cloud):
    """``prepare_scene`` with FPFH over the scene (``fpfh_surface="cloud"``,
    r = 0.06, 192 neighbours) from the same normals: keys and validity
    equal, descriptors within 2e-3 but for rows that gather an SPFH resting
    on a tie (``_tied_rows``; 32 of 256 rows measured), BOARD frames within
    1e-4."""
    js, ts = generic_cloud
    n, c = tnormals.estimate_normals(ts, k=16)
    tcfg = dataclasses.replace(_cfg(), segment_scene=False, remove_plane=False,
                               fpfh_surface="cloud", fpfh_k_max=192,
                               descr_rad=0.06)
    jcfg = DetectionConfig(**dataclasses.asdict(tcfg))
    fj = jdet.prepare_scene(js, jcfg, None, jnp.asarray(n.numpy()),
                            jnp.asarray(c.numpy()))
    ft = tdet.prepare_scene(ts, tcfg, None, n, c)
    np.testing.assert_array_equal(ft.keys.xyz.numpy(), np.asarray(fj.keys.xyz))
    v = np.asarray(fj.desc_valid)
    assert v.sum() > 100 and ft.desc.shape[-1] == 33
    np.testing.assert_array_equal(ft.desc_valid.numpy(), v)
    diff = np.abs(ft.desc.numpy() - np.asarray(fj.desc)).max(-1)
    # rows past 2e-3 gather an SPFH resting on a tie: on this sensor-grid
    # cloud neighbouring points often share their k-NN support, hence their
    # normal, and meet the baseline at equal angles, and a dense support's
    # 192nd neighbour can tie with the 193rd
    tied = _tied_rows(ft.keys.xyz, ft.cloud, n, 0.06, 192)
    assert set(np.flatnonzero(diff > 2e-3)) <= set(np.flatnonzero(tied))
    assert (diff > 2e-3).sum() <= 0.15 * v.sum(), (diff > 2e-3).sum()
    ok = np.asarray(fj.rf_ok)
    np.testing.assert_array_equal(ft.rf_ok.numpy(), ok)
    np.testing.assert_allclose(ft.rf.numpy()[ok], np.asarray(fj.rf)[ok],
                               rtol=0, atol=1e-4)


def test_fpfh_batch_equals_single_runs(banks, table):
    """Two FPFH frames (the bench's jittered batch frames of the table
    frame, crop chain off) in one ``detect_organized_batch``: every leaf
    equal to the frame's own ``detect_organized`` run under the batch
    tests' rule (``tests/test_torch_batch.py``)."""
    _, tb, _ = banks
    xyz, valid = table
    cfg = dataclasses.replace(_cfg(), segment_scene=False, remove_plane=False)
    imgs = syn.batch_frames(xyz, 2)
    rt, nt = tdet.detect_organized_batch(
        _t(imgs), _t(np.stack([valid, valid])), tb, cfg, crop_lo=_t(LO),
        crop_hi=_t(HI), **GEO)
    singles = [tdet.detect_organized(_t(img), _t(valid), tb, cfg,
                                     crop_lo=_t(LO), crop_hi=_t(HI), **GEO)
               for img in imgs]
    assert_batch_equals_singles(rt, nt, singles)
    assert int(rt.metrics["valid_descriptors"].min()) > 100


def test_fpfh_demo_served_matches_jax(banks, table):
    """The ``fpfh_demo`` preset served: ``warmup`` runs, and the table frame
    sent as depth gets the reply of JAX's ``DetectionService`` on the same
    bank (accept flag, view, counts; poses of an accepted reply within
    5e-4), equal bit for bit to a direct ``detect_organized`` call at the
    server's block; micro-batched (two requests in one batch) each reply
    equals the streaming one."""
    jb, _, lb = banks
    xyz, valid = table
    depth = np.where(valid, xyz[..., 2], 0.0).astype(np.float32)
    tcfg = dataclasses.replace(tconfig.PRESETS["fpfh_demo"],
                               scene_capacity=3072, scene_key_capacity=256)
    jcfg = dataclasses.replace(JPRESETS["fpfh_demo"], scene_capacity=3072,
                               scene_key_capacity=256)
    svc = DetectionService(lb, tcfg)
    svc.warmup()
    out = svc.detect_depth(depth)
    # micro-batched: the frame twice at once, one batch, each reply the
    # streaming one (flags and counts; poses under the batch tests' 3e-4)
    batched = DetectionService(lb, tcfg, batch_max=2, batch_window_ms=5000.0)
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        replies = list(ex.map(batched.detect_depth, [depth, depth]))
    assert batched.n_batches == 1
    for r in replies:
        assert r["accepted"] == out["accepted"]
        for k in ("scene_points", "scene_keypoints", "correspondences",
                  "instances"):
            assert r["metrics"][k] == out["metrics"][k], k
        if out["accepted"]:
            np.testing.assert_allclose(r["pose"], out["pose"], atol=3e-4)
    ref = JDetectionService(jb, jcfg).detect_depth(depth)
    assert out["accepted"] == ref["accepted"]
    assert out["view_idx"] == ref["view_idx"] or not out["accepted"]
    for k in ("scene_points", "scene_keypoints", "valid_descriptors",
              "correspondences", "instances"):
        assert out["metrics"][k] == ref["metrics"][k], k
    if out["accepted"]:
        np.testing.assert_allclose(out["pose"], ref["pose"], atol=5e-4)
    from tpu_joints_torch.serve import depth_to_cloud
    from tpu_joints_torch.serve.server import depth_block

    img = depth_to_cloud(depth)
    ok = np.isfinite(img).all(-1)
    block = depth_block(*depth.shape, tcfg.scene_capacity)
    direct, _ = tdet.detect_organized(_t(np.nan_to_num(img)), _t(ok), lb,
                                      tcfg, block=block, half_window=5)
    np.testing.assert_array_equal(np.asarray(out["pose"], np.float32),
                                  direct.full_pose.numpy())


def _bench_fpfh_source():
    """The keyword arguments of ``bench.py``'s FPFH configuration and bank
    (its ``scene_latency_fpfh`` block), evaluated at full size."""
    bench = pytest.importorskip("bench")
    tree = ast.parse(inspect.getsource(bench.main))
    calls = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            name = getattr(node.targets[0], "id", None)
            if name in ("fpfh_cfg", "fpfh_bank"):
                calls[name] = node.value
    jcfg = dataclasses.replace(bench._make_config(), **{
        k.arg: ast.literal_eval(k.value) for k in calls["fpfh_cfg"].keywords})
    env = {"fpfh_cfg": jcfg, "SMALL": False}
    bank = {k.arg: eval(compile(ast.Expression(k.value), "bench.py", "eval"),
                        env) for k in calls["fpfh_bank"].keywords}
    return jcfg, bank


def test_fpfh_config_equals_bench():
    """``synthetic.fpfh_config`` and ``fpfh_bank_recipe`` are value for
    value ``bench.py``'s FPFH frame at full size."""
    jcfg, bank = _bench_fpfh_source()
    assert dataclasses.asdict(syn.fpfh_config()) == dataclasses.asdict(jcfg)
    assert syn.fpfh_bank_recipe(syn.fpfh_config()) == bank
