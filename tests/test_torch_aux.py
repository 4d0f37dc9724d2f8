"""Port parity, the auxiliary features: file IO, pose files, mesh sampling,
the edge detector, the variance descriptor, the lattice keypoints of both
tile ingests, the pixel ingest (``ingest_organized`` with its normal fill),
``detect_organized`` and ``detect_organized_batch`` with lattice and ISS
keys, and the cluster tree — JAX package vs port on the CPU, same inputs.

Scale: 320×240 raycast frames of the bench joint (``tests/util.py:109``'s
size) at block 2 / half-window 3 (the pixel ingest, which works on every
pixel, on the table frame at 160×120), the level-0 bank of
``tests/test_torch_detect.py`` (12 views at 64 px), clouds of a few
thousand points, and the model, views and configuration of
``tests/test_cluster_tree.py`` for the tree. Both packages search the same
banks, built by the JAX package and handed to the port as arrays.

Tolerances. The numpy copies (io, posefile, sample_mesh) and the lattice
key flags are held equal. Edge flags are equal (the k = 100 search takes
the sort path in both packages; at k = 20 the port's K2 difference form
and XLA's expansion form swap a k-th neighbour in a few rows, where the
k-th and (k+1)-th distances are a rounding apart, and no flag moves). Variance descriptors within 5e-5: ``arccos`` near
cos = 1 turns a 1-ulp difference of a dot product (6e-8) into ~1e-5 of θ
(measured 1.1e-5 on the same normals). Pixel ingest: mask, xyz and
n_selected equal, normals and curvature within 1e-6 (the organized normals
differ by 1.8e-7 before the fill, which is bit-equal on equal inputs).
"""
import dataclasses
import importlib
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.level0_bank import level0_jax_bank
from tests.util import joint_points, random_rotation
from tpu_joints.config import DetectionConfig
from tpu_joints.core import io as jio
from tpu_joints.core import posefile as jpose
from tpu_joints.core.cloud import make_cloud as jmake_cloud
from tpu_joints.features.edges import detect_edges as jedges
from tpu_joints.features.variance import compute_variance_descriptor as jvar
from tpu_joints.modelbank import build_bank as jbuild_bank
from tpu_joints.modelbank import render_views as jrender_views
from tpu_joints.modelbank import scanner as jscanner
from tpu_joints.neighbors import knn as jknn
from tpu_joints.pipelines import cluster_tree as jtree
from tpu_joints.pipelines import ingest as jingest
from tpu_joints_torch import config as tconfig
from tpu_joints_torch import synthetic as syn
from tpu_joints_torch.core import io as tio
from tpu_joints_torch.core import posefile as tpose
from tpu_joints_torch.core.cloud import make_cloud
from tpu_joints_torch.features.edges import detect_edges
from tpu_joints_torch.features.normals import estimate_normals
from tpu_joints_torch.features.variance import compute_variance_descriptor
from tpu_joints_torch.filters.filters import compact_cloud, uniform_sample_mask
from tpu_joints_torch.modelbank import bank as tbank
from tpu_joints_torch.modelbank import scanner as tscanner
from tpu_joints_torch.neighbors.bruteforce import knn
from tpu_joints_torch.pipelines import cluster_tree as ttree
tdet = importlib.import_module("tpu_joints_torch.pipelines.detect")
from tpu_joints_torch.pipelines import ingest as tingest

jdet = importlib.import_module("tpu_joints.pipelines.detect")
BANK_KW = dict(descriptor="shot", descr_radius=0.06, rf_radius=0.06,
               rf_k_max=96, frames="board", sampling_radius=0.02, normal_k=16,
               k_max=96, level=0, resolution=64, surface_leaf=0.01,
               key_capacity=64, icp_capacity=1024)
ARRAYS = ("view_xyz", "view_mask", "key_xyz", "key_valid", "desc", "rf",
          "poses", "model_xyz", "model_mask", "icp_xyz", "icp_mask")
LO, HI = syn.CROP_LO, syn.CROP_HI
GEO = dict(block=2, half_window=3)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_built(model, **kw):
    """(a bank built by the JAX package, the same arrays as a port bank)."""
    jb = jbuild_bank(model, **kw)
    return jb, tbank.bank_from_numpy(
        {k: np.asarray(getattr(jb, k)) for k in ARRAYS}
        | {"params_hash": jb.params_hash}, device="cpu")


def _pose_diff(A, B):
    Rd = A[:3, :3].astype(np.float64) @ B[:3, :3].astype(np.float64).T
    return (float(np.degrees(np.arccos(np.clip((np.trace(Rd) - 1) / 2, -1,
                                               1)))),
            float(np.linalg.norm(A[:3, 3] - B[:3, 3])))


# --- file IO, pose files, mesh sampling ------------------------------------

def _lzf(data: bytes) -> bytes:
    """A small LZF encoder: literal runs, and back references (offset 0,
    the previous byte) for runs of a repeated byte, so a decoder meets both
    kinds of control byte."""
    out, lit, i = bytearray(), bytearray(), 0

    def flush():
        for j in range(0, len(lit), 32):
            chunk = lit[j:j + 32]
            out.append(len(chunk) - 1)
            out.extend(chunk)
        lit.clear()

    while i < len(data):
        run = 0
        while (i > 0 and i + run < len(data) and run < 264
               and data[i + run] == data[i - 1]):
            run += 1
        if run >= 3:
            flush()
            n = run - 2
            if n >= 7:
                out += bytes([7 << 5, n - 7, 0])
            else:
                out += bytes([n << 5, 0])
            i += run
        else:
            lit.append(data[i])
            i += 1
    flush()
    return bytes(out)


def _write_compressed_pcd(path, xyz, rgb):
    """A binary_compressed PCD (fields stored one after another)."""
    n = xyz.shape[0]
    packed = ((np.clip(rgb * 255.0, 0, 255).astype(np.uint32) << [16, 8, 0])
              .sum(1).astype(np.uint32).view(np.float32))
    raw = b"".join(np.ascontiguousarray(c, np.float32).tobytes()
                   for c in (xyz[:, 0], xyz[:, 1], xyz[:, 2], packed))
    comp = _lzf(raw)
    header = ("VERSION 0.7\nFIELDS x y z rgb\nSIZE 4 4 4 4\nTYPE F F F F\n"
              f"COUNT 1 1 1 1\nWIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
              f"POINTS {n}\nDATA binary_compressed\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(struct.pack("<II", len(comp), len(raw)))
        f.write(comp)


def _assert_points_equal(a, b):
    np.testing.assert_array_equal(a.xyz, b.xyz)
    for f in ("rgb", "normals"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(x, y)
    assert sorted(a.extra) == sorted(b.extra)


@pytest.mark.parametrize("encoding", ["ascii", "binary", "binary_compressed"])
def test_pcd_round_trip_matches_original(tmp_path, encoding):
    """Each PCD encoding read by the copy equals the original's read, and
    the copy's writer writes the original's bytes; rgb and normals ride
    along, and an rgb-free zero run exercises the LZF back references."""
    rng = np.random.default_rng(0)
    xyz = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    xyz[100:180] = 0.0
    rgb = rng.integers(0, 256, (300, 3)).astype(np.float32) / 255.0
    normals = rng.normal(size=(300, 3)).astype(np.float32)
    path = str(tmp_path / f"c_{encoding}.pcd")
    if encoding == "binary_compressed":
        _write_compressed_pcd(path, xyz, rgb)
    else:
        data = tio.PointData(xyz=xyz, rgb=rgb, normals=normals)
        tio.save_pcd(path, data, binary=encoding == "binary")
        ref = str(tmp_path / f"j_{encoding}.pcd")
        jio.save_pcd(ref, jio.PointData(xyz=xyz, rgb=rgb, normals=normals),
                     binary=encoding == "binary")
        assert open(path, "rb").read() == open(ref, "rb").read()
    got, want = tio.load_pcd(path), jio.load_pcd(path)
    _assert_points_equal(got, want)
    _assert_points_equal(tio._load_pcd_py(path), jio._load_pcd_py(path))
    np.testing.assert_allclose(got.xyz, xyz, atol=1e-6)
    if encoding == "binary_compressed":
        np.testing.assert_allclose(got.rgb, rgb, atol=1e-6)


@pytest.mark.parametrize("fmt", ["ascii", "binary_little_endian"])
def test_load_ply_with_faces_matches(tmp_path, fmt):
    rng = np.random.default_rng(1)
    v = rng.uniform(-1, 1, (40, 3)).astype(np.float32)
    col = rng.integers(0, 256, (40, 3)).astype(np.uint8)
    faces = rng.integers(0, 40, (60, 3)).astype(np.int32)
    head = (f"ply\nformat {fmt} 1.0\ncomment test\nelement vertex 40\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "element face 60\nproperty list uchar int vertex_indices\n"
            "end_header\n")
    path = str(tmp_path / f"m_{fmt}.ply")
    with open(path, "wb") as f:
        f.write(head.encode("ascii"))
        if fmt == "ascii":
            for p, c in zip(v, col):
                f.write((" ".join(f"{x:.9g}" for x in p) + " "
                         + " ".join(str(int(x)) for x in c) + "\n").encode())
            for t in faces:
                f.write(("3 " + " ".join(str(int(x)) for x in t) + "\n").encode())
        else:
            rec = np.zeros(40, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                                      ("r", "u1"), ("g", "u1"), ("b", "u1")])
            rec["x"], rec["y"], rec["z"] = v.T
            rec["r"], rec["g"], rec["b"] = col.T
            f.write(rec.tobytes())
            for t in faces:
                f.write(struct.pack("<B3i", 3, *t))
    (dt, ft), (dj, fj) = tio.load_ply(path), jio.load_ply(path)
    _assert_points_equal(dt, dj)
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_array_equal(ft, faces)
    np.testing.assert_allclose(dt.xyz, v, atol=1e-6)


def test_posefile_and_sample_mesh_match(tmp_path):
    rng = np.random.default_rng(2)
    poses = np.stack([np.eye(4, dtype=np.float32)] * 5)
    poses[:, :3, :3] = np.stack([random_rotation(rng) for _ in range(5)])
    poses[:, :3, 3] = rng.normal(size=(5, 3))
    a, b = str(tmp_path / "a.txt"), str(tmp_path / "b.txt")
    tpose.save_pose_file(a, poses)
    jpose.save_pose_file(b, poses)
    assert open(a).read() == open(b).read()
    np.testing.assert_array_equal(tpose.load_pose_file(a),
                                  jpose.load_pose_file(a))
    with open(b, "a") as f:          # the 4x4 form and a blank line
        f.write("\n" + " ".join(["1"] * 16) + "\n")
    np.testing.assert_array_equal(tpose.load_pose_file(b),
                                  jpose.load_pose_file(b))
    xyz = rng.uniform(-1, 1, (50, 3)).astype(np.float32)
    faces = rng.integers(0, 50, (80, 3))
    np.testing.assert_array_equal(tscanner.sample_mesh(xyz, faces, 5000),
                                  jscanner.sample_mesh(xyz, faces, 5000))


# --- edges and the variance descriptor --------------------------------------

@pytest.fixture(scope="module")
def cloud_pts():
    xyz, valid = syn.frame(syn.bench_pose(), 42, with_table=True, width=320,
                           height=240)
    return xyz[valid][::12]


@pytest.mark.parametrize("k", [100, 20])
def test_detect_edges_matches(cloud_pts, k):
    """Edge flags equal at k = 100 (the sort path) and k = 20 (K2's plain
    version; its neighbour sets equal XLA's on this cloud)."""
    jc = jmake_cloud(cloud_pts)
    tc = make_cloud(cloud_pts, device="cpu")
    want = np.asarray(jedges(jc, k=k))
    got = detect_edges(tc, k=k).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < tc.mask.sum()
    if k <= 32:
        # the neighbour sets differ only where the k-th and (k+1)-th
        # distances are a rounding apart (K2's difference form against
        # XLA's expansion form): each such row's relative gap is < 2e-3
        m = tc.mask.numpy()
        d, it = knn(tc.xyz, tc.xyz, k + 1, source_mask=tc.mask)
        _, ij = jknn(jc.xyz, jc.xyz, k, source_mask=jc.mask)
        differ = (np.sort(it.numpy()[:, :k], 1)
                  != np.sort(np.asarray(ij), 1)).any(1) & m
        d = d.numpy()
        gap = (d[:, k] - d[:, k - 1]) / d[:, k - 1]
        assert differ.sum() <= 0.01 * m.sum(), differ.sum()
        assert (gap[differ] < 2e-3).all(), gap[differ]


def test_variance_descriptor_matches(cloud_pts):
    """Three-scale θ-variances within 5e-5 of JAX's on the same normals;
    the -1 sentinel where a scale's neighbourhood is empty."""
    tc = make_cloud(cloud_pts, device="cpu")
    normals, _ = estimate_normals(tc, k=40)
    keys, kidx = compact_cloud(tc, uniform_sample_mask(tc, 0.02), 256)
    far = make_cloud(np.concatenate([keys.xyz.numpy()[:8], [[9.0, 9.0, 9.0]]]),
                     capacity=16, device="cpu")  # a key with no neighbours
    fn = torch.cat([normals[kidx][:8], torch.tensor([[0.0, 0.0, 1.0]])])
    fn = torch.cat([fn, fn.new_zeros((7, 3))])
    for k_cloud, k_normals in ((keys, normals[kidx]), (far, fn)):
        got, valid = compute_variance_descriptor(k_cloud, k_normals, tc,
                                                 normals, radius=0.02)
        jk = jmake_cloud(k_cloud.xyz.numpy()[k_cloud.mask.numpy()],
                         capacity=k_cloud.capacity)
        want, jvalid = jvar(jk, jnp.asarray(k_normals.numpy()),
                            jmake_cloud(cloud_pts), jnp.asarray(normals.numpy()),
                            radius=0.02)
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=5e-5)
    assert float(got[8, 0]) == -1.0 and bool((got[:8] >= 0).all())


# --- lattice keys and the pixel ingest --------------------------------------

@pytest.mark.parametrize("Hb,Wb,g", [(13, 17, 3), (60, 80, 3), (8, 9, 2)])
def test_lattice_key_flags_equal(Hb, Wb, g):
    """One key per occupied cell, chosen by exact ties: flags equal."""
    rng = np.random.default_rng(Hb)
    got = rng.random((Hb, Wb)) > 0.4
    m = [rng.normal(0, 1, (Hb, Wb)).astype(np.float32) for _ in range(3)]
    want = np.asarray(jingest._lattice_key_flags(
        tuple(jnp.asarray(a) for a in m), jnp.asarray(got), g))
    flag = tingest._lattice_key_flags(tuple(_t(a) for a in m), _t(got), g)
    np.testing.assert_array_equal(flag.numpy(), want)


@pytest.fixture(scope="module")
def table_frame():
    T = syn.bench_pose()
    xyz, valid = syn.frame(T, 42, with_table=True, width=320, height=240)
    return xyz, valid, T


def _cfgs(**overrides):
    base = dict(
        descr_rad=0.06, model_ss=0.02, scene_ss=0.03, normal_k=16,
        match_threshold=0.25, rf_frames="board", rf_rad=0.06, rf_k_max=96,
        k_max=96, cg_size=0.05, cg_thresh=3.0, icp_iterations=6,
        icp_point_to_plane=True, icp_max_corr_dist=0.02,
        icp_max_corr_start=0.2, final_icp_iterations=8, max_candidates=16,
        max_instances_per_view=2, view_grouped_candidates=True,
        split_rotation_modes=True, refine_top=4, tier1_rows=512,
        tier1_iterations=4, tier1_view_iterations=3,
        tier1_polish_iterations=4, scene_capacity=3072,
        scene_key_capacity=256, coverage_accept=0.02,
        rg_smoothness_deg=12.0, rg_max_edge=0.05, cluster_max_curvature=0.08,
        rg_min_cluster=50, keypoints="lattice", key_group=3)
    base.update(overrides)
    jcfg = DetectionConfig(**base)
    return jcfg, tconfig.from_dict(dataclasses.asdict(jcfg))


@pytest.mark.parametrize("capacity", [None, 3072, 1024])
def test_blocks_lattice_keys_match(table_frame, capacity):
    """The tile ingest with ``key_group=3``: flags equal before and after a
    capacity cut, and every flagged lane a scene point."""
    xyz, valid, _ = table_frame
    *jout, kj = jingest.ingest_organized_blocks(
        jnp.asarray(xyz), jnp.asarray(valid), capacity=capacity,
        crop_lo=jnp.asarray(LO), crop_hi=jnp.asarray(HI), key_group=3, **GEO)
    *tout, kt = tingest.ingest_organized_blocks(
        _t(xyz), _t(valid), capacity=capacity, crop_lo=_t(LO),
        crop_hi=_t(HI), key_group=3, **GEO)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(tout[0].mask.numpy(),
                                  np.asarray(jout[0].mask))
    assert 0 < int(kt.sum()) and not bool((kt & ~tout[0].mask).any())


def test_segmented_lattice_keys_match(table_frame):
    """The segmented ingest's keys (over its survivors) equal JAX's."""
    xyz, valid, _ = table_frame
    jcfg, tcfg = _cfgs(remove_plane=True, segment_scene=True)
    *_, nj, kj = jingest.ingest_organized_segmented(
        jnp.asarray(xyz), jnp.asarray(valid), jcfg, crop_lo=jnp.asarray(LO),
        crop_hi=jnp.asarray(HI), key_group=3, **GEO)
    st, *_, nt, kt = tingest.ingest_organized_segmented(
        _t(xyz), _t(valid), tcfg, crop_lo=_t(LO), crop_hi=_t(HI), key_group=3,
        **GEO)
    assert int(nt) == int(nj)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    # no key on the table (camera depth beyond the joint)
    assert float((st.xyz.numpy()[kt.numpy()][:, 2] > 1.25).mean()) < 0.05


@pytest.fixture(scope="module")
def pixel_frame():
    """The table frame at 160×120: the pixel ingest works on every pixel."""
    return syn.frame(syn.bench_pose(), 42, with_table=True, width=160,
                     height=120)


def test_normals_with_fill_matches(pixel_frame):
    """The three fill rounds on JAX's own organized normals are bit-equal;
    from the port's normals within 1e-6, the coverage equal."""
    xyz, valid = pixel_frame
    jn, jc, jcov = jingest._normals_with_fill(jnp.asarray(xyz),
                                              jnp.asarray(valid), 3, None)
    tn, tc, tcov = tingest._normals_with_fill(_t(xyz), _t(valid), 3, None)
    np.testing.assert_array_equal(tcov.numpy(), np.asarray(jcov))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-6)
    base = jingest.estimate_normals_organized(jnp.asarray(xyz),
                                              jnp.asarray(valid), half_window=3)
    filled = int(np.asarray(jcov).sum()) - int(
        ((np.asarray(base[0]) ** 2).sum(-1) > 0.25).sum())
    assert filled > 0
    orig = tingest.estimate_normals_organized
    try:
        tingest.estimate_normals_organized = lambda *a, **k: (_t(base[0]),
                                                              _t(base[1]))
        tn2, tc2, _ = tingest._normals_with_fill(_t(xyz), _t(valid), 3, None)
    finally:
        tingest.estimate_normals_organized = orig
    np.testing.assert_array_equal(tn2.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tc2.numpy(), np.asarray(jc))


@pytest.mark.parametrize("crop", [False, True])
def test_ingest_organized_matches(pixel_frame, crop):
    """Scene mask and xyz, n_selected equal; normals and curvature within
    1e-6; below the survivors' count the capacity thins them uniformly."""
    xyz, valid = pixel_frame
    jkw = dict(crop_lo=jnp.asarray(LO), crop_hi=jnp.asarray(HI)) if crop else {}
    tkw = dict(crop_lo=_t(LO), crop_hi=_t(HI)) if crop else {}
    sj, nj, cj, selj = jingest.ingest_organized(
        jnp.asarray(xyz), jnp.asarray(valid), capacity=4096, leaf=0.008,
        half_window=3, **jkw)
    st, nt, ct, selt = tingest.ingest_organized(
        _t(xyz), _t(valid), capacity=4096, leaf=0.008, half_window=3, **tkw)
    assert int(selt) == int(selj) > 0
    np.testing.assert_array_equal(st.mask.numpy(), np.asarray(sj.mask))
    np.testing.assert_array_equal(st.xyz.numpy(), np.asarray(sj.xyz))
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0, atol=1e-6)
    # capacity below the survivors: thinned uniformly, equal again
    sj2, *_ = jingest.ingest_organized(
        jnp.asarray(xyz), jnp.asarray(valid), capacity=512, leaf=0.008,
        half_window=3, **jkw)
    st2, *_ = tingest.ingest_organized(
        _t(xyz), _t(valid), capacity=512, leaf=0.008, half_window=3, **tkw)
    np.testing.assert_array_equal(st2.xyz.numpy(), np.asarray(sj2.xyz))
    assert int(selt) > 512 and int(st2.mask.sum()) == 512


# --- detect_organized and its batch with lattice and ISS keys ---------------

@pytest.fixture(scope="module")
def banks(tmp_path_factory):
    jb = level0_jax_bank(tmp_path_factory)
    return jb, tbank.bank_from_numpy(
        {k: np.asarray(getattr(jb, k)) for k in ARRAYS}
        | {"params_hash": jb.params_hash}, device="cpu")


def _same_detection(rt, nt, rj, nj, T_gt, tol_rad=1e-3, tol_m=1e-4):
    """Equal n_selected, key and point counts, candidate field and accept
    flag; where accepted, the winning view, and the pose within ``tol_rad``
    / ``tol_m`` of JAX's and 1 deg / 5 mm of the truth."""
    assert int(nt) == int(nj)
    for k in ("scene_points", "scene_keypoints", "valid_descriptors",
              "correspondences", "instances"):
        assert int(rt.metrics[k]) == int(rj.metrics[k]), k
    np.testing.assert_array_equal(rt.cand_views.numpy(),
                                  np.asarray(rj.cand_views))
    np.testing.assert_array_equal(rt.cand_valid.numpy(),
                                  np.asarray(rj.cand_valid))
    assert bool(rt.accepted) == bool(rj.accepted)
    if bool(rj.accepted):
        assert int(rt.view_idx) == int(rj.view_idx)
        rot, trans = _pose_diff(rt.full_pose.numpy(), np.asarray(rj.full_pose))
        assert np.radians(rot) < tol_rad and trans < tol_m, (rot, trans)
        rot, trans = _pose_diff(rt.full_pose.numpy(), T_gt)
        assert rot < 1.0 and trans < 0.005, (rot, trans)


def _key_band(res):
    """The key count of ``tests/test_segment_organized.py:463-466``: one key
    per occupied 3×3 cell of tiles, within its slack."""
    n_keys, n_scene = (int(res.metrics[k]) for k in ("scene_keypoints",
                                                     "scene_points"))
    assert n_scene // 14 < n_keys <= -(-n_scene // 4), (n_keys, n_scene)


def test_detect_organized_lattice_keys_crop_route(table_frame, banks):
    """``keypoints="lattice"`` with the crop chain on the table frame
    (``_same_detection``; the other route: ``test_detect_organized_lattice_
    keys_plain_route``). The lattice keys cost accuracy (the reference:
    1.28 deg against 0.17 at full size); at this size both packages reject
    this frame, and a rejected frame's winner is whichever unstable pose
    ranks first, so the winner is held only where accepted."""
    xyz, valid, T_gt = table_frame
    jb, tb = banks
    jcfg, tcfg = _cfgs(remove_plane=True, segment_scene=True)
    rj, nj = jdet.detect_organized(
        jnp.asarray(xyz), jnp.asarray(valid), jb, jcfg,
        crop_lo=jnp.asarray(LO), crop_hi=jnp.asarray(HI), **GEO)
    rt, nt = tdet.detect_organized(_t(xyz), _t(valid), tb, tcfg,
                                   crop_lo=_t(LO), crop_hi=_t(HI), **GEO)
    _same_detection(rt, nt, rj, nj, T_gt)
    _key_band(rt)
    assert not bool(rj.accepted)


@pytest.fixture(scope="module")
def batch_runs(banks):
    """Two frames (the bench frame and a jittered copy) with lattice and
    with ISS keys: JAX's batch, the port's batch and its single runs."""
    jb, tb = banks
    xyz, valid = syn.frame(syn.bench_pose(), 42, with_table=False, width=320,
                           height=240)
    imgs = np.stack([xyz, syn.batch_frames(xyz, 2)[1]])
    valids = np.stack([valid] * 2)
    out = {}
    for kp in ("lattice", "iss"):
        jcfg, tcfg = _cfgs(keypoints=kp)
        rj, nj = jdet.detect_organized_batch(
            jnp.asarray(imgs), jnp.asarray(valids), jb, jcfg,
            crop_lo=jnp.asarray(LO), crop_hi=jnp.asarray(HI), **GEO)
        rt, nt = tdet.detect_organized_batch(
            _t(imgs), _t(valids), tb, tcfg, crop_lo=_t(LO), crop_hi=_t(HI),
            **GEO)
        singles = [tdet.detect_organized(_t(i), _t(v), tb, tcfg,
                                         crop_lo=_t(LO), crop_hi=_t(HI), **GEO)
                   for i, v in zip(imgs, valids)]
        out[kp] = (rj, nj), (rt, nt), singles
    return out


@pytest.mark.parametrize("kp", ["lattice", "iss"])
def test_batch_with_lattice_and_iss_keys(batch_runs, kp):
    """Each frame of the batch equals its own run under the batch gate of
    ``tests/test_torch_batch.py``, and the batch equals JAX's batch (which
    runs both key detectors under its vmap): n_selected, counts, candidate
    views, accept flags, accepted frames' views and poses within 5e-4."""
    from tests.test_torch_batch import assert_batch_equals_singles

    (rj, nj), (rt, nt), singles = batch_runs[kp]
    assert_batch_equals_singles(rt, nt, singles)
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    for k in ("scene_points", "scene_keypoints", "valid_descriptors",
              "correspondences", "instances"):
        np.testing.assert_array_equal(rt.metrics[k].numpy(),
                                      np.asarray(rj.metrics[k]), err_msg=k)
    np.testing.assert_array_equal(rt.cand_views.numpy(),
                                  np.asarray(rj.cand_views))
    acc = np.asarray(rj.accepted)
    np.testing.assert_array_equal(rt.accepted.numpy(), acc)
    np.testing.assert_array_equal(rt.view_idx.numpy()[acc],
                                  np.asarray(rj.view_idx)[acc])
    np.testing.assert_allclose(rt.full_pose.numpy()[acc],
                               np.asarray(rj.full_pose)[acc], atol=5e-4)
    assert acc.any() == (kp == "lattice")   # ISS finds ~15 keys at this size


def test_detect_organized_lattice_keys_plain_route(batch_runs):
    """``keypoints="lattice"`` without the crop chain on the frame without
    the table: the port's single run of the batch's first frame against
    that frame of JAX's batch (a ``jax.vmap`` of its single run), within the
    batch tolerance of 5e-4; accepted."""
    (rj, nj), _, singles = batch_runs["lattice"]
    rt, nt = singles[0]
    r0 = jax_tree_index(rj, 0)
    _same_detection(rt, nt, r0, np.asarray(nj)[0], syn.bench_pose(),
                    tol_rad=5e-4, tol_m=5e-4)
    _key_band(rt)
    assert bool(rt.accepted)


def jax_tree_index(res, b):
    """Frame ``b`` of a JAX batch result, as numpy."""
    import jax

    return jax.tree_util.tree_map(lambda a: np.asarray(a)[b], res)


# --- the cluster tree ---------------------------------------------------------

TREE_CFG = dict(
    descriptor="shot", descr_rad=0.12, model_ss=0.03, scene_ss=0.03,
    normal_k=12, match_mode="nn", match_threshold=0.25, algorithm="hough",
    cg_size=0.05, cg_thresh=3.0, icp_iterations=20, max_candidates=4,
    accept_fitness=0.001, scene_capacity=4096, scene_key_capacity=512,
    k_max=96)


@pytest.fixture(scope="module")
def tree_problem():
    """``tests/test_cluster_tree.py::test_tree_recovers_pose``'s problem."""
    rng = np.random.default_rng(0)
    model_xyz, _ = joint_points(rng, n_chord=1200, n_stub=700, jitter=0.0)
    rngT = np.random.default_rng(0)
    T_world = np.eye(4, dtype=np.float32)
    T_world[:3, :3] = random_rotation(rngT)
    T_world[:3, 3] = rngT.uniform(-0.3, 0.3, 3).astype(np.float32)
    moved = model_xyz @ T_world[:3, :3].T + T_world[:3, 3]
    views, poses, _ = jrender_views(moved, level=0, resolution=96)
    v = int(np.argmax([w.shape[0] for w in views]))
    jcfg = DetectionConfig(**TREE_CFG)
    jb, tb = _jax_built(model_xyz, descriptor=jcfg.descriptor,
                         descr_radius=jcfg.descr_rad,
                         sampling_radius=jcfg.model_ss,
                         normal_k=jcfg.normal_k, k_max=jcfg.k_max, level=0,
                         resolution=96, key_capacity=128)
    return jb, tb, views[v], poses[v] @ T_world, jcfg


@pytest.mark.parametrize("n_clusters,seed", [(3, 0), (4, 1), (12, 0), (20, 0)])
def test_view_clusters_equal(tree_problem, n_clusters, seed):
    jb, tb, *_ = tree_problem
    jc = jtree.make_view_clusters(jb, n_clusters=n_clusters, seed=seed)
    tc = ttree.make_view_clusters(tb, n_clusters=n_clusters, seed=seed)
    for f in ("representatives", "members"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                      np.asarray(getattr(jc, f)))
        assert getattr(tc, f).dtype == torch.int32


def test_detect_tree_matches(tree_problem):
    """View, accept flag, cluster and layer-1 fitness of the best cluster
    equal; the pose within 1e-3 rad / 1e-4 m of JAX's and of the truth
    within 1 deg / 5 mm."""
    jb, tb, scene_xyz, T_gt, jcfg = tree_problem
    tcfg = tconfig.from_dict(dataclasses.asdict(jcfg))
    jc = jtree.make_view_clusters(jb, n_clusters=3)
    tc = ttree.make_view_clusters(tb, n_clusters=3)
    rj = jtree.detect_tree(jmake_cloud(scene_xyz, capacity=4096), jb, jc, jcfg)
    rt = ttree.detect_tree(make_cloud(scene_xyz, capacity=4096, device="cpu"),
                           tb, tc, tcfg)
    assert bool(rt.accepted) and bool(rj.accepted)
    assert int(rt.view_idx) == int(rj.view_idx)
    assert int(rt.metrics["cluster_id"]) == int(rj.metrics["cluster_id"])
    np.testing.assert_array_equal(rt.cand_views.numpy(),
                                  np.asarray(rj.cand_views))
    np.testing.assert_allclose(float(rt.metrics["layer1_fitness"]),
                               float(rj.metrics["layer1_fitness"]), rtol=1e-3)
    rot, trans = _pose_diff(rt.full_pose.numpy(), np.asarray(rj.full_pose))
    assert np.radians(rot) < 1e-3 and trans < 1e-4, (rot, trans)
    rot, trans = _pose_diff(rt.full_pose.numpy(), T_gt)
    assert rot < 1.0 and trans < 0.005, (rot, trans)
