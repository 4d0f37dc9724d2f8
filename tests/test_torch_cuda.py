"""Card-only checks of the port's CUDA kernels and of the paths that run
them, card against CPU (marker ``cuda``).

A CUDA kernel has no CPU mode, so these skip without a card. This file
imports neither JAX nor the JAX package — the GPU host has no JAX — so it
runs there without the suite's conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -o addopts="" -q
"""
import numpy as np
import pytest
import torch

from tpu_joints_torch.neighbors import pallas_knn as k1
from tpu_joints_torch.neighbors.bruteforce import knn
from tpu_joints_torch.neighbors.knn_cases import (CASES, STRADDLE, batches,
                                                  straddle)
from tpu_joints_torch.recognize import hv_cases
from tpu_joints_torch.segment.region_growing import region_growing


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8192, 2560, 0.0), (40960, 2048, 0.0),
                                   (70, 100, 0.25), (5000, 3333, 0.1),
                                   (64, 256, 1.0)])
def test_nn1_kernel_matches_plain_on_card(shape):
    """The CUDA kernel equals its plain version bit for bit, at the main
    path's ICP and coverage shapes and at the edge cases (masked sources,
    a source count off the tile, no valid source)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    M, N, masked = shape
    rng = np.random.default_rng(M + N)
    dev = torch.device("cuda")
    q = torch.from_numpy(rng.normal(size=(M, 3)).astype(np.float32)).to(dev)
    s = torch.from_numpy(rng.normal(size=(N, 3)).astype(np.float32)).to(dev)
    m = torch.from_numpy(rng.uniform(size=N) >= masked).to(dev)
    before = k1.nn1.launches
    d, i = knn(q, s, 1, source_mask=m)      # the main path's entry to K1
    assert k1.nn1.launches == before + 1
    dr, ir = k1.nn1_reference(q, s, m)
    torch.cuda.synchronize()
    assert torch.equal(i, ir)
    assert torch.equal(d, dr)
    if masked == 1.0:
        assert bool((d >= 1e30).all()) and bool((i == 0).all())


@pytest.mark.cuda
def test_nn1_rejects_cpu_mask_with_cuda_points():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q = torch.zeros(4, 3, device="cuda")
    with pytest.raises(ValueError):
        k1.nn1(q, q, torch.ones(4, dtype=torch.bool))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2560, 2560, 16, 0.0), (8192, 8192, 30, 0.3),
                                   (2560, 2560, 2, 0.0), (2560, 2560, 32, 0.0),
                                   (100, 20, 32, 0.0), (64, 256, 8, 1.0),
                                   (70, 100, 16, 0.25), (5000, 3333, 16, 0.1),
                                   (1001, 2048, 8, 0.0)])
def test_knnk_kernel_matches_plain_on_card(shape):
    """Kernel K2 equals its plain version bit for bit, at the generic
    path's region-growing and clustered-OBB shapes and at the edge cases
    (k = 2 and 32, N < k, all or some sources masked, N off the tile, M off
    the block); empty slots are (3e38, 0)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    M, N, k, masked = shape
    rng = np.random.default_rng(M + N + k)
    dev = torch.device("cuda")
    q = torch.from_numpy(rng.normal(size=(M, 3)).astype(np.float32)).to(dev)
    s = torch.from_numpy(rng.normal(size=(N, 3)).astype(np.float32)).to(dev)
    m = torch.from_numpy(rng.uniform(size=N) >= masked).to(dev)
    before = k1.knnk.launches
    d, i = knn(q, s, k, source_mask=m)      # the paths' entry to K2
    assert k1.knnk.launches == before + 1
    dr, ir = k1.knnk_reference(q, s, k, m)
    torch.cuda.synchronize()
    assert torch.equal(i, ir)
    assert torch.equal(d, dr)
    empty = d >= 1e30
    assert int(empty.sum()) == M * max(0, k - int(m.sum()))
    assert bool((i[empty] == 0).all())


@pytest.mark.cuda
def test_knnk_breaks_exact_ties_to_the_lowest_index_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(3)
    base = rng.normal(size=(512, 3)).astype(np.float32)
    s = torch.from_numpy(np.concatenate([base, base])).cuda()
    q = s[:256].clone()
    d, i = k1.knnk(q, s, 16)
    dr, ir = k1.knnk_reference(q, s, 16)
    assert torch.equal(i, ir) and torch.equal(d, dr)
    assert torch.equal(i[:, 0].long(), torch.arange(256, device="cuda"))
    assert torch.equal(i[:, 1].long(), torch.arange(256, device="cuda") + 512)


def _equal_to_plain_on_card(q, s, m, k):
    """K1 (k = 1) or K2 through ``knn`` equals its plain version bit for
    bit: one launch, ``torch.equal`` on distances and indices."""
    dev = torch.device("cuda")
    q, s, m = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
               for a in (q, s, m))
    wrapper = k1.nn1 if k == 1 else k1.knnk
    before = wrapper.launches
    d, i = knn(q, s, k, source_mask=m)
    assert wrapper.launches == before + 1
    dr, ir = (k1.nn1_reference(q, s, m) if k == 1
              else k1.knnk_reference(q, s, k, m))
    torch.cuda.synchronize()
    assert torch.equal(i, ir)
    assert torch.equal(d, dr)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 16, 32])
@pytest.mark.parametrize("case", sorted(CASES))
def test_knn_kernels_on_split_stressing_orders_on_card(case, k):
    """Both kernels on the orders and ties that stress the split sweep and
    the lane merge (sources approaching every query in scan order, all
    distances tied, a masked twin before its valid copy, N = 1, N < k,
    N = 33)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _equal_to_plain_on_card(*CASES[case](k), k)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["nn1", "knnk"])
@pytest.mark.parametrize("shape", STRADDLE)
def test_knn_kernels_straddling_the_split_on_card(shape, kernel):
    """Row counts around a warp, source counts below, at and one above a
    32-lane split, k = 32 with 32 lanes, and the clustered OBB's 16384²
    with 90% of the sources masked."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    k = shape[2]
    _equal_to_plain_on_card(*straddle(*shape), 1 if kernel == "nn1" else k)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 16])
def test_knn_kernels_take_strided_views_on_card(k):
    """Strided source and mask views, as the scene coverage hands K1 (the
    model stride-sampled, ``detect.py::_model_at_capacity``): the wrapper
    launches on contiguous copies, so the kernel equals its plain version
    bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(k)
    dev = torch.device("cuda")
    q = torch.from_numpy(rng.normal(size=(300, 3)).astype(np.float32)).to(dev)
    s = torch.from_numpy(rng.normal(size=(4096, 3)).astype(np.float32)).to(dev)
    m = torch.from_numpy(rng.uniform(size=4096) >= 0.25).to(dev)
    s, m = s[::16][:200], m[::16][:200]
    assert not s.is_contiguous()
    d, i = knn(q, s, k, source_mask=m)
    dr, ir = (k1.nn1_reference(q, s.contiguous(), m.contiguous()) if k == 1
              else k1.knnk_reference(q, s.contiguous(), k, m.contiguous()))
    torch.cuda.synchronize()
    assert torch.equal(i, ir)
    assert torch.equal(d, dr)


@pytest.mark.cuda
def test_region_growing_reads_the_host_once_per_eight_sweeps_on_card():
    """On the card the region growing synchronises exactly once per host
    read of its schedule, and nowhere else."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import warnings

    from tpu_joints_torch.core.cloud import make_cloud
    from tpu_joints_torch.features.normals import estimate_normals

    rng = np.random.default_rng(0)
    t = rng.uniform(0, 2 * np.pi, 2000)
    h = rng.uniform(-0.3, 0.3, 2000)
    pts = np.stack([h, 0.08 * np.cos(t), 0.08 * np.sin(t) + 1.0], 1)
    cloud = make_cloud(pts.astype(np.float32), capacity=2048)
    n, curv = estimate_normals(cloud, k=16)
    torch.cuda.synchronize()
    before = region_growing.host_checks
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            region_growing(cloud, n, curv, k=16, max_edge=0.05)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    assert region_growing.host_checks - before >= 1
    assert len(syncs) == region_growing.host_checks - before


def _small_table_problem(device):
    """The 320×240 table frame, crop box and geometry arguments on
    ``device``."""
    from tpu_joints_torch import synthetic as syn

    xt, vt = syn.frame(syn.bench_pose(), 42, with_table=True, width=320,
                       height=240)
    frame = (torch.as_tensor(xt, device=device),
             torch.as_tensor(vt, device=device))
    geo = dict(block=2, half_window=3,
               crop_lo=torch.as_tensor(syn.CROP_LO, device=device),
               crop_hi=torch.as_tensor(syn.CROP_HI, device=device))
    return frame, geo


def _small(cfg):
    import dataclasses

    return dataclasses.replace(cfg, scene_ss=0.03, final_icp_iterations=8,
                               scene_capacity=3072, scene_key_capacity=256)


@pytest.mark.cuda
def test_segmented_path_small_card_vs_cpu():
    """The segmented organized chain at small size (320×240 table frame,
    level-0 bank) on the card and on the CPU: same n_selected, both
    accepted, full poses within 2e-3; on the card the host syncs equal the
    lattice region growing's reads."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import warnings

    from tpu_joints_torch import synthetic as syn
    from tpu_joints_torch.modelbank.bank import build_bank
    from tpu_joints_torch.pipelines.detect import detect_organized
    from tpu_joints_torch.segment.organized import region_growing_lattice

    cfg = _small(syn.segmented_config())
    kw = dict(syn.bench_bank_kwargs(cfg), level=0, resolution=64,
              key_capacity=64, icp_capacity=1024)
    out = {}
    for d in ("cuda", "cpu"):
        bank = build_bank(syn.joint_model(3000, 1800), **kw, device=d)
        frame, geo = _small_table_problem(d)
        if d == "cuda":
            detect_organized(*frame, bank, cfg, **geo)       # warm
            torch.cuda.synchronize()
            before = region_growing_lattice.host_checks
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    out[d] = detect_organized(*frame, bank, cfg, **geo)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            syncs = [w for w in caught if "synchroniz" in str(w.message)]
            reads = region_growing_lattice.host_checks - before
            assert reads >= 1 and len(syncs) == reads
        else:
            out[d] = detect_organized(*frame, bank, cfg, **geo)
    (rc, nc), (rh, nh) = out["cuda"], out["cpu"]
    assert int(nc) == int(nh)
    assert bool(rc.accepted) and bool(rh.accepted)
    assert float((rc.full_pose.cpu() - rh.full_pose).abs().max()) < 2e-3


@pytest.mark.cuda
def test_two_part_path_small_card_vs_cpu():
    """The two-part chain at small size on the card and on the CPU: the
    pooled candidate field is equal (views and validity, each half its own
    part's); at this size neither finds an acceptable pose."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpu_joints_torch import synthetic as syn
    from tpu_joints_torch.pipelines.multi import detect_parts_organized

    cfg = _small(syn.two_part_config())
    out = {}
    for d in ("cuda", "cpu"):
        banks = syn.build_part_banks(cfg, device=d, level=0, resolution=64,
                                     key_capacity=64, icp_capacity=1024)
        frame, geo = _small_table_problem(d)
        names, out[d], _ = detect_parts_organized(*frame, banks, cfg, **geo)
        assert names == ["chord", "stub"]
    views = out["cuda"].cand_views.cpu()
    assert torch.equal(views, out["cpu"].cand_views)
    assert torch.equal(out["cuda"].cand_valid.cpu(), out["cpu"].cand_valid)
    assert bool((views[:8] < 12).all()) and bool((views[8:] >= 12).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1000, 2560, 19200])
def test_choice_on_card_equals_cpu(n):
    """``xla_cumsum`` and the weighted draw add and search in the same
    order on the card: sums and indices equal the CPU's bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpu_joints_torch.core import prng
    from tpu_joints_torch.core.ops import xla_cumsum

    m = np.random.default_rng(n).uniform(size=n) < 0.4
    p = torch.from_numpy(m.astype(np.float32) / np.float32(m.sum()))
    assert torch.equal(xla_cumsum(p.cuda()).cpu(), xla_cumsum(p))
    u = prng.uniform_on(0, (256, 3), torch.device("cpu"))
    assert torch.equal(prng.choice(u.cuda(), p.cuda()).cpu(),
                       prng.choice(u, p))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(batches()))
def test_nn1_batched_equals_plain_and_single_launches_on_card(name):
    """K1's batch mode equals its plain version and B unbatched K1 launches
    bit for bit, in one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, s, m = (torch.from_numpy(a).cuda() for a in batches()[name])
    before = k1.nn1_batched.launches, k1.nn1.launches
    d, i = k1.nn1_batched(q, s, m)
    assert (k1.nn1_batched.launches, k1.nn1.launches) == (before[0] + 1,
                                                          before[1])
    dr, ir = k1.nn1_batched_reference(q, s, m)
    torch.cuda.synchronize()
    assert torch.equal(d, dr) and torch.equal(i, ir)
    for b in range(q.shape[0]):
        db, ib = k1.nn1(q[b], s[b], m[b])
        assert torch.equal(d[b], db) and torch.equal(i[b], ib), b
    empty = ~m.any(1)
    assert bool((d[empty] >= 1e30).all()) and bool((i[empty] == 0).all())


@pytest.mark.cuda
def test_nn1_batched_rejects_mixed_devices_and_shapes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q = torch.zeros(2, 4, 3, device="cuda")
    with pytest.raises(ValueError):
        k1.nn1_batched(q, q, torch.ones(2, 4, dtype=torch.bool))
    with pytest.raises(ValueError):
        k1.nn1_batched(q, q[:1])


@pytest.mark.cuda
@pytest.mark.parametrize("H", [6, 20])
def test_verify_hypotheses_on_card_equals_cpu(H):
    """The hypothesis verification on the card: one launch of K1's batch
    mode (scene -> instances) and one folded K1 launch (instances -> scene),
    and the same verified mask as on the CPU, exhaustive (H = 6) and greedy
    (H = 20)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpu_joints_torch.core.cloud import make_cloud
    from tpu_joints_torch.recognize.hv import verify_hypotheses

    rng = np.random.default_rng(H)
    seen = (rng.uniform(-0.2, 0.2, size=(700, 3))
            + np.array([0.0, 0.0, 1.0])).astype(np.float32)
    good = np.concatenate([seen, np.full((324, 3), 1e6, np.float32)])
    insts = np.stack([good, good + np.float32(0.003)] + [
        good + rng.normal(scale=0.4, size=3).astype(np.float32)
        for _ in range(H - 2)])
    mask = np.zeros((H, 1024), bool)
    mask[:, :700] = True
    valid = np.ones(H, bool)
    valid[3] = False
    out = {}
    for d in ("cuda", "cpu"):
        before = k1.nn1_batched.launches, k1.nn1.launches
        out[d] = verify_hypotheses(
            torch.as_tensor(insts, device=d), torch.as_tensor(mask, device=d),
            torch.as_tensor(valid, device=d),
            make_cloud(seen, capacity=1024, device=d), inlier_threshold=0.005,
            occlusion_threshold=0.001).cpu()
        added = (k1.nn1_batched.launches - before[0], k1.nn1.launches - before[1])
        assert added == ((1, 1) if d == "cuda" else (0, 0))
    assert torch.equal(out["cuda"], out["cpu"])
    assert bool(out["cuda"][0]) and not bool(out["cuda"][3])


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 16, 192])
def test_exclude_self_never_launches_a_kernel_on_card(k):
    """``knn(exclude_self=True)`` takes the expansion form on the card at
    every k (the kernels have no self-exclusion): no launch, own lane never
    listed, equal to the CPU's indices."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(k)
    pts = torch.from_numpy(rng.normal(size=(3000, 3)).astype(np.float32))
    before = (k1.nn1.launches, k1.knnk.launches)
    d, i = knn(pts.cuda(), pts.cuda(), k, exclude_self=True)
    assert (k1.nn1.launches, k1.knnk.launches) == before
    dc, ic = knn(pts, pts, k, exclude_self=True)
    assert not bool((i.cpu() == torch.arange(3000)[:, None]).any())
    assert (i.cpu() != ic).float().mean() < 1e-3


@pytest.mark.cuda
def test_anchored_normals_shapes_on_card():
    """The anchored normals' two launches (K2 at 1024 anchors × 2560, k =
    16; K1 at 2560 × 1024 anchors) bit-equal to their plain versions, and
    the normals equal to the CPU's within 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpu_joints_torch import synthetic as syn
    from tpu_joints_torch.core.cloud import make_cloud
    from tpu_joints_torch.features.normals import (anchor_lanes,
                                                   estimate_normals_anchored)

    T = syn.bench_pose()
    xyz, valid = syn.frame(T, 42, with_table=False)
    pts = syn.scene_points(xyz[valid], 2560)
    out = {}
    for d in ("cuda", "cpu"):
        cloud = make_cloud(pts, capacity=2560, device=d)
        out[d] = estimate_normals_anchored(cloud, k=16, anchors=1024)
    cloud = make_cloud(pts, capacity=2560, device="cuda")
    a = anchor_lanes(2560, 1024, "cuda")
    for q, s, kk, m in ((cloud.xyz[a], cloud.xyz, 16, cloud.mask),
                        (cloud.xyz, cloud.xyz[a], 1, cloud.mask[a])):
        if kk == 1:
            (dk, ik), (dr, ir) = k1.nn1(q, s, m), k1.nn1_reference(q, s, m)
        else:
            (dk, ik), (dr, ir) = (k1.knnk(q, s, kk, m),
                                  k1.knnk_reference(q, s, kk, m))
        assert torch.equal(dk, dr) and torch.equal(ik, ir)
    for a_, b_ in zip(out["cuda"], out["cpu"]):
        np.testing.assert_allclose(a_.cpu().numpy(), b_.numpy(), atol=1e-5)


@pytest.mark.cuda
def test_fpfh_on_card_equals_cpu():
    """FPFH-33 of 300 keys over themselves (r = 0.15, 192 neighbours, the
    sort path) on the card within 2e-3 of the CPU's, validity equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpu_joints_torch import synthetic as syn
    from tpu_joints_torch.core.cloud import make_cloud
    from tpu_joints_torch.features.fpfh import compute_fpfh

    rng = np.random.default_rng(0)
    T = syn.bench_pose()
    pts = syn.joint_model(3000, 1800) @ T[:3, :3].T + T[:3, 3]
    xyz = pts[rng.choice(len(pts), 300, replace=False)].astype(np.float32)
    nrm = rng.normal(size=(512, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    out = {}
    for d in ("cuda", "cpu"):
        keys = make_cloud(xyz, capacity=512, device=d)
        n = torch.from_numpy(nrm).to(d)
        out[d] = compute_fpfh(keys, n, keys, n, radius=0.15, k_max=192)
    assert torch.equal(out["cuda"][1].cpu(), out["cpu"][1])
    diff = (out["cuda"][0].cpu() - out["cpu"][0]).abs().amax(1)
    assert int((diff > 2e-3).sum()) <= 3, diff.max()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [20, 100])
def test_detect_edges_on_card_equals_cpu(k):
    """``detect_edges`` on the card: k = 20 is one K2 launch at the cloud's
    shape, bit-equal to its plain version; the edge flags equal the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpu_joints_torch.core.cloud import make_cloud
    from tpu_joints_torch.features.edges import detect_edges

    rng = np.random.default_rng(k)
    pts = rng.uniform(-0.2, 0.2, (3000, 3)).astype(np.float32)
    pts[:, 2] = 1.0 + 0.05 * np.sin(8 * pts[:, 0])
    card = make_cloud(pts, device="cuda")
    host = make_cloud(pts, device="cpu")
    before = k1.knnk.launches
    got = detect_edges(card, k=k)
    assert k1.knnk.launches == before + (1 if k <= 32 else 0)
    if k <= 32:
        d, i = k1.knnk(card.xyz, card.xyz, k, card.mask)
        dr, ir = k1.knnk_reference(card.xyz, card.xyz, k, card.mask)
        assert torch.equal(d, dr) and torch.equal(i, ir)
    assert torch.equal(got.cpu(), detect_edges(host, k=k))


@pytest.mark.cuda
def test_cli_runs_on_card(tmp_path):
    """The CLI's default device is the card: ``crop`` and ``edges`` there
    write what ``--device cpu`` writes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpu_joints_torch.cli.main import main as cli
    from tpu_joints_torch.core.io import PointData, load_pcd, save_pcd

    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.3, 0.3, (4000, 3)).astype(np.float32)
    save_pcd(str(tmp_path / "s.pcd"), PointData(xyz=pts))
    for dev in ("cuda", "cpu"):
        cli(["crop", str(tmp_path / "s.pcd"), "--out",
             str(tmp_path / f"crop_{dev}.pcd"), "--xmin", "-0.1", "--xmax",
             "0.2", "--device", dev])
        cli(["edges", str(tmp_path / "s.pcd"), "--out",
             str(tmp_path / f"edges_{dev}.pcd"), "-k", "20", "--leaf", "0",
             "--device", dev])
    for name in ("crop", "edges"):
        assert np.array_equal(load_pcd(str(tmp_path / f"{name}_cuda.pcd")).xyz,
                              load_pcd(str(tmp_path / f"{name}_cpu.pcd")).xyz)


@pytest.mark.cuda
def test_lattice_keys_and_pixel_ingest_on_card_equal_cpu():
    """The lattice key flags of both tile ingests and the pixel ingest on a
    320x240 frame: card equal to CPU (flags and masks exactly; normals
    within 1e-5 at all but 0.1% of the points, where a nearly degenerate
    window covariance lets the card's fused multiply-adds move the
    eigenvector: 0.0143 at most, measured; all within 0.05)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpu_joints_torch import synthetic as syn
    from tpu_joints_torch.pipelines import ingest

    xyz, valid = syn.frame(syn.bench_pose(), 42, with_table=True, width=320,
                           height=240)
    out = {}
    for dev in ("cuda", "cpu"):
        x, v = torch.as_tensor(xyz, device=dev), torch.as_tensor(valid, device=dev)
        blocks = ingest.ingest_organized_blocks(x, v, block=2, half_window=3,
                                                capacity=3072, key_group=3)
        pix = ingest.ingest_organized(x, v, capacity=8192, leaf=0.008,
                                      half_window=3)
        out[dev] = (blocks[4], blocks[0].mask, pix[0].mask, pix[1], pix[3])
    a, b = ([t.cpu() for t in out[d]] for d in ("cuda", "cpu"))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.equal(a[2], b[2]) and int(a[4]) == int(b[4])
    diff = (a[3] - b[3]).abs().amax(1)
    assert int((diff > 1e-5).sum()) <= 0.001 * diff.shape[0], int(
        (diff > 1e-5).sum())
    assert float(diff.max()) < 0.05


@pytest.mark.cuda
def test_grid_on_card_equals_cpu():
    """The voxel-hash grid and its radius search on the card equal the CPU
    run bit for bit (integer hashing, gathers, the same float32 distances,
    a stable sort)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpu_joints_torch.neighbors import grid

    rng = np.random.default_rng(9)
    xyz = rng.uniform(-0.3, 0.3, (4096, 3)).astype(np.float32)
    mask = rng.uniform(size=4096) > 0.2
    out = []
    for dev in ("cpu", "cuda"):
        x, m = torch.from_numpy(xyz).to(dev), torch.from_numpy(mask).to(dev)
        g = grid.build_grid(x, m, cell_size=0.05)
        out.append((g.order, g.hashes, grid.max_cell_occupancy(g),
                    *grid.grid_radius_neighbors(g, x[:700], 0.05, 32,
                                                bucket_cap=64,
                                                query_chunk=256)))
    for a, b in zip(*out):
        assert torch.equal(a, b.cpu())


@pytest.mark.cuda
def test_collectives_on_card_mesh_equal_cpu_mesh():
    """ring_knn, halo_radius_neighbors, ring_icp and sharded_match_votes on
    a ring of four card entries (the visible cards, cuda:0 repeated where
    fewer) against the same ring of CPU entries: distances rtol 1e-5 /
    atol 1e-6, neighbour sets equal, poses within 5e-4, votes exact
    (tests/test_distributed.py's tolerances)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpu_joints_torch import distributed as dist

    n = torch.cuda.device_count()
    cards = [torch.device("cuda", i % n) for i in range(4)]
    meshes = [dist.make_mesh(devices=[torch.device("cpu")] * 4,
                             model_parallel=4),
              dist.make_mesh(devices=cards, model_parallel=4)]
    rng = np.random.default_rng(12)
    pts = rng.normal(size=(1024, 3)).astype(np.float32) * [1.0, 0.1, 0.1]
    pts = pts[np.argsort(pts[:, 0])].astype(np.float32)
    mask = rng.uniform(size=1024) > 0.1
    desc = rng.normal(size=(64, 33)).astype(np.float32)
    bank = rng.normal(size=(8, 32, 33)).astype(np.float32)
    bvalid = rng.uniform(size=(8, 32)) > 0.3
    ang = np.radians(8.0)
    R = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0],
                  [0, 0, 1]], np.float32)
    moved = (pts @ R.T + [0.02, 0.0, 0.0]).astype(np.float32)
    res = []
    for mesh, dev in zip(meshes, ("cpu", "cuda")):
        t = {k: torch.from_numpy(v).to(dev) for k, v in dict(
            pts=pts, mask=mask, moved=moved, desc=desc, bank=bank,
            bvalid=bvalid).items()}
        ones = torch.ones(1024, dtype=torch.bool, device=dev)
        res.append(dict(
            knn=dist.ring_knn(t["pts"], t["pts"], t["mask"], 8, mesh),
            halo=dist.halo_radius_neighbors(t["pts"], t["mask"], 0.1, 16,
                                            mesh, halo=64),
            icp=dist.ring_icp(t["pts"], ones, t["moved"], ones, mesh,
                              iterations=8, max_corr_dist=0.1),
            votes=dist.sharded_match_votes(t["desc"], t["bank"], t["bvalid"],
                                           30.0, mesh)))
    cpu, card = res
    torch.testing.assert_close(card["knn"][0].cpu(), cpu["knn"][0],
                               rtol=1e-5, atol=1e-6)
    (ic, vc, dc), (ig, vg, dg) = cpu["halo"], (t.cpu() for t in card["halo"])
    for q in range(1024):
        assert set(ig[q][vg[q]].tolist()) == set(ic[q][vc[q]].tolist()), q
    torch.testing.assert_close(card["icp"][0].cpu(), cpu["icp"][0], rtol=0,
                               atol=5e-4)
    assert torch.equal(card["votes"].cpu(), cpu["votes"])


def _leaves(tree):
    from tpu_joints_torch.core.ops import tree_map

    out = []
    tree_map(out.append, tree)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("crop", [False, True])
def test_replay_equals_the_eager_chain_on_card(crop):
    """``detect_organized(fused=True)`` at small size (the 320×240 table
    frame, level-0 bank; the lattice crop on or off): the first call
    captures one graph, every leaf of a replay equals the eager chain's bit
    for bit, a replay's result survives the next replay (another frame's),
    and the second frame's replay equals its eager run too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses

    from tpu_joints_torch import synthetic as syn
    from tpu_joints_torch.core import graphs
    from tpu_joints_torch.modelbank.bank import build_bank
    from tpu_joints_torch.pipelines.detect import detect_organized

    cfg = _small(syn.segmented_config())
    if not crop:
        cfg = dataclasses.replace(cfg, segment_scene=False, remove_plane=False)
    bank = build_bank(syn.joint_model(3000, 1800), device="cuda",
                      **dict(syn.bench_bank_kwargs(cfg), level=0,
                             resolution=64, key_capacity=64,
                             icp_capacity=1024))
    (img, valid), geo = _small_table_problem("cuda")
    other = img + 1e-4 * torch.randn(img.shape, generator=torch.Generator()
                                     .manual_seed(1)).to("cuda")
    eager = [detect_organized(x, valid, bank, cfg, **geo) for x in (img, other)]
    n = len(graphs.entries())
    first = detect_organized(img, valid, bank, cfg, fused=True, **geo)
    assert len(graphs.entries()) == n + 1
    kept = _leaves(first)
    snapshot = [t.clone() for t in kept]
    second = detect_organized(other, valid, bank, cfg, fused=True, **geo)
    assert len(graphs.entries()) == n + 1
    for got, want in ((first, eager[0]), (second, eager[1])):
        a, b = _leaves(got), _leaves(want)
        assert len(a) == len(b) > 20
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(torch.equal(x, y) for x, y in zip(kept, snapshot))


def _take_freed_bytes(ptr, nbytes):
    """Allocate blocks of ``nbytes``, filled with 0.5, on the current stream
    and on each capture stream until the allocator has to map new memory
    (every free block that fits is taken, a freed block at ``ptr``
    included). Returns (the blocks, whether one overlaps ``ptr``)."""
    from tpu_joints_torch.core import graphs

    junk, hit = [], False
    for stream in [torch.cuda.current_stream()] + [
            st for _, st in graphs._POOLS.values()]:
        with torch.cuda.stream(stream):
            reserved = torch.cuda.memory_reserved()
            while torch.cuda.memory_reserved() == reserved:
                junk.append(torch.full((nbytes // 4,), 0.5, device="cuda"))
                at = junk[-1].data_ptr()
                hit |= at < ptr + nbytes and ptr < at + nbytes
    return junk, hit


@pytest.mark.cuda
def test_replay_survives_an_evicted_draw():
    """A captured chain that adds a cached draw (``core/prng.py``) to its
    input reads the draw at its address. After the capture the draw cache
    is emptied and every free block of the draw's size is taken and filled
    with 0.5: the graph's entry holds the draw, so no block overlaps its
    bytes and the replay still adds the draw."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpu_joints_torch.core import graphs, prng

    def plus_draw(x):
        return x + prng.uniform_on(12345, (256, 3), x.device)

    x = torch.zeros(256, 3, device="cuda")
    want = torch.from_numpy(prng.uniform(12345, (256, 3))).cuda()
    assert torch.equal(graphs.run("plus_draw", plus_draw, (x,), None,
                                  plus_draw), want)
    assert len(graphs.entries()[-1].held) == 1
    ptr = prng._uploaded(12345, (256, 3), x.device).data_ptr()
    prng._uploaded.cache_clear()
    junk, hit = _take_freed_bytes(ptr, 256 * 3 * 4)
    assert not hit
    assert torch.equal(graphs.run("plus_draw", plus_draw, (x,), None,
                                  plus_draw), want)
    del junk


@pytest.mark.cuda
def test_segmented_replay_survives_an_evicted_draw():
    """The lattice crop's plane removal reads a cached upload (the RANSAC
    draw of ``core/prng.py``: seed 0, 256 hypotheses × 3 uniforms) at its
    address. After the capture the draw cache is emptied and every free
    block of the draw's size is taken and filled with 0.5: the graph's
    entry holds the draw, so no block overlaps its bytes and the replay
    still equals the eager chain bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpu_joints_torch import synthetic as syn
    from tpu_joints_torch.core import graphs, prng
    from tpu_joints_torch.modelbank.bank import build_bank
    from tpu_joints_torch.pipelines.detect import detect_organized

    cfg = _small(syn.segmented_config())
    bank = build_bank(syn.joint_model(3000, 1800), device="cuda",
                      **dict(syn.bench_bank_kwargs(cfg), level=0,
                             resolution=64, key_capacity=64,
                             icp_capacity=1024))
    (img, valid), geo = _small_table_problem("cuda")
    detect_organized(img, valid, bank, cfg, fused=True, **geo)
    entry = graphs.entries()[-1]
    hits = prng._uploaded.cache_info().hits
    ptr = prng._uploaded(0, (256, 3), img.device).data_ptr()
    assert prng._uploaded.cache_info().hits == hits + 1   # the graph's draw
    assert entry.held
    prng._uploaded.cache_clear()
    junk, hit = _take_freed_bytes(ptr, 256 * 3 * 4)
    assert not hit
    got = detect_organized(img, valid, bank, cfg, fused=True, **geo)
    want = detect_organized(img, valid, bank, cfg, **geo)
    a, b = _leaves(got), _leaves(want)
    assert len(a) == len(b) > 20
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    del junk


@pytest.mark.cuda
def test_failed_capture_raises_and_leaves_no_graph():
    """A chain that reads the host cannot be captured: the entry raises
    (no eager run in its place), caches nothing, and the next capture
    works."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpu_joints_torch.core import graphs

    x = torch.arange(8.0, device="cuda")

    def reads_host(t):
        return t * float(t.sum())

    n = len(graphs.entries())
    with pytest.raises(RuntimeError, match="not run eagerly"):
        graphs.run("reads_host", reads_host, (x,), None, reads_host)
    assert len(graphs.entries()) == n

    def doubles(t):
        return t * 2

    assert torch.equal(graphs.run("doubles", doubles, (x,), None, doubles),
                       x * 2)
    assert len(graphs.entries()) == n + 1


def _organized_problem():
    """The organized chain at small size on the card: (bank, cfg, frame,
    valid, geometry), as ``test_replay_equals_the_eager_chain_on_card``
    with the crop off."""
    import dataclasses

    from tpu_joints_torch import synthetic as syn
    from tpu_joints_torch.modelbank.bank import build_bank

    cfg = dataclasses.replace(_small(syn.segmented_config()),
                              segment_scene=False, remove_plane=False)
    bank = build_bank(syn.joint_model(3000, 1800), device="cuda",
                      **dict(syn.bench_bank_kwargs(cfg), level=0,
                             resolution=64, key_capacity=64,
                             icp_capacity=1024))
    (img, valid), geo = _small_table_problem("cuda")
    return bank, cfg, img, valid, geo


@pytest.mark.cuda
def test_traced_replay_times_its_stages_on_card():
    """With spans on, ``detect_organized(fused=True)`` captures a graph of
    its own (another key) whose replay times the chain's four stages on the
    device, in order, under the call's ``graphs.replay`` span; their sum is
    within 5% of a pair of events around the whole replay, and every leaf
    equals the untraced replay's bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpu_joints_torch.core import graphs, spans
    from tpu_joints_torch.pipelines.detect import detect_organized

    bank, cfg, img, valid, geo = _organized_problem()
    plain = detect_organized(img, valid, bank, cfg, fused=True, **geo)
    keys = set(graphs._CACHE)
    spans.enable(True)
    try:
        detect_organized(img, valid, bank, cfg, fused=True, **geo)   # capture
        assert len(set(graphs._CACHE) - keys) == 1
        spans.settle()
        spans.drain()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)       # the host runs ahead of the card
        a.record()
        traced = detect_organized(img, valid, bank, cfg, fused=True, **geo)
        b.record()
        torch.cuda.synchronize()
        spans.settle()
        recs = spans.drain()
    finally:
        spans.enable(False)
    replay, = [r for r in recs if r.clock == "host"]
    assert replay.name == "graphs.replay"
    stages = sorted((r for r in recs if r.clock == "device"),
                    key=lambda r: r.start_ns)
    assert [r.name for r in stages] == ["chain.ingest", "chain.features",
                                        "chain.match", "chain.refine"]
    assert all(r.parent is replay and r.request == replay.request
               for r in stages)
    whole_ms = a.elapsed_time(b)
    stage_ms = sum(r.ns for r in stages) / 1e6
    assert 0.95 * whole_ms <= stage_ms <= whole_ms, (stage_ms, whole_ms)
    x, y = _leaves(traced), _leaves(plain)
    assert len(x) == len(y) > 20
    assert all(torch.equal(p, q) for p, q in zip(x, y))


@pytest.mark.cuda
def test_a_warmed_traced_service_captures_nothing_on_card():
    """``serve --trace``'s order: spans on, then the warm-up. Its frames
    then capture no graph, and each reply's stage times are read after its
    host copy: four device records a frame."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpu_joints_torch.core import graphs, spans
    from tpu_joints_torch.serve import DetectionService

    bank, cfg, img, valid, _ = _organized_problem()
    depth = img[..., 2].cpu().numpy()
    spans.enable(True)
    try:
        service = DetectionService(bank, cfg)
        service.warmup(depth_shape=depth.shape)
        n = len(graphs.entries())
        spans.drain()
        for _ in range(3):
            service.detect_depth(depth)
        recs = spans.drain()
    finally:
        spans.enable(False)
    assert len(graphs.entries()) == n
    names = [r.name for r in recs]
    assert names.count("serve.frame") == names.count("graphs.replay") == 3
    assert "graphs.capture" not in names
    device = [r for r in recs if r.clock == "device"]
    assert len(device) == 12
    assert all(r.parent.name == "graphs.replay" and r.ns > 0 for r in device)


def _unproject_inputs(depth, fov_deg, device):
    from tpu_joints_torch.serve.depth import pixel_scales

    xs, ys = pixel_scales(depth.shape[1], depth.shape[0], fov_deg)
    return [torch.from_numpy(a).to(device) for a in (depth, xs, ys)]


def _unproject_cases():
    """(label, depth, fov, near, far, block) of every ``depth_cases`` case
    and of four of the benchmark's seeded frames (``make_pool``)."""
    from benchmark import cells, frames
    from tpu_joints_torch.serve.depth_cases import CASES
    from tpu_joints_torch.serve.server import depth_block

    out = []
    for name, case in sorted(CASES.items()):
        depth, kw, cap = case()
        out.append((name, depth, kw["fov_deg"], kw.get("near", 0.0),
                    kw.get("far", 0.0), depth_block(*depth.shape, cap)))
    config = cells.resolve("joint_organized.cam1")["config"]
    scene = frames.Scene(config)
    pool = frames.make_pool(scene, 4, 2 ** 31 + 977, "cuda")
    cap = config["detection"]["scene_capacity"]
    for i, depth in enumerate(pool["depth"]):
        out.append((f"make_pool frame {i}", depth, scene.fov_deg, 0.0, 0.0,
                    depth_block(*depth.shape, cap)))
    return out


@pytest.mark.cuda
def test_unproject_kernel_equals_plain_on_card():
    """The unprojection kernel equals its plain version bit for bit (img
    as float32 bits, vmask, both counts) on every ``depth_cases`` case —
    the sensor frame, the far threshold, non-finite, non-positive and
    overflowing depths, the crops, blocks 1, 4, 8 and 16, the scalar and
    the 16-byte paths — and on the benchmark's seeded frames; one launch
    each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpu_joints_torch.serve import depth as D

    for label, depth, fov, near, far, block in _unproject_cases():
        args = _unproject_inputs(depth, fov, "cuda")
        before = D.unproject.launches
        got = D.unproject(*args, near, far, block)
        torch.cuda.synchronize()
        assert D.unproject.launches == before + 1, label
        want = D.unproject_reference(*(a.cpu() for a in args), near, far,
                                     block)
        img, vmask, counts = (t.cpu() for t in got)
        assert torch.equal(img.view(torch.int32),
                           want[0].view(torch.int32)), label
        assert torch.equal(vmask, want[1]), label
        assert torch.equal(counts, want[2]), label


@pytest.mark.cuda
def test_a_served_frame_unprojects_once_on_card(monkeypatch):
    """A served depth frame makes one ``unproject`` launch and one graph
    replay, and never calls the host ``depth_to_cloud``; its reply equals
    the reply to the same frame unprojected on the host and handed to the
    same captured chain."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpu_joints_torch.core import spans
    from tpu_joints_torch.serve import DetectionService
    from tpu_joints_torch.serve import depth as D
    from tpu_joints_torch.serve import server

    bank, cfg, img, valid, _ = _organized_problem()
    depth = torch.where(valid, img[..., 2], 0.0).cpu().numpy()

    def no_host_unprojection(*a, **k):
        raise AssertionError("a served frame called depth_to_cloud")

    spans.enable(True)          # before the warm-up, as serve --trace does
    try:
        service = DetectionService(bank, cfg)
        service.warmup(depth_shape=depth.shape)
        host = service._host_frame(depth, 57.0)
        want = service._payload(*service._guarded(
            lambda: server.detect_mod.detect_organized(
                torch.from_numpy(host[1]).cuda(),
                torch.from_numpy(host[2]).cuda(), bank, cfg, block=host[0],
                half_window=5, fused=True)[0]), cfg)
        monkeypatch.setattr(server, "depth_to_cloud", no_host_unprojection)
        before = D.unproject.launches
        spans.drain()
        got = service.detect_depth(depth)
        torch.cuda.synchronize()
        recs = spans.drain()
    finally:
        spans.enable(False)
    assert D.unproject.launches == before + 1
    names = [r.name for r in recs if r.clock == "host"]
    assert names.count("graphs.replay") == 1
    assert "graphs.capture" not in names
    assert names.count("serve.unproject") == names.count("serve.upload") == 1
    got.pop("latency_ms"), want.pop("latency_ms")
    assert got == want


@pytest.mark.cuda
def test_two_request_threads_batch_as_each_frame_alone_on_card():
    """Two request threads on a ``batch_max`` 2 service, each with its own
    frame (the joint 3 cm apart), each unprojecting it on the service's
    side stream, coalesce into one batch of 2. Each reply equals, bit for
    bit, its entry of that batch run on the same two frames unprojected on
    the host in NumPy, and keeps the working set the frame gets alone: a
    frame read before its kernel finished, or in place of the other, would
    differ."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import threading
    import time

    from tpu_joints_torch import synthetic as syn
    from tpu_joints_torch.core.ops import tree_map
    from tpu_joints_torch.serve import DetectionService

    bank, cfg, _, _, _ = _organized_problem()
    depths = []
    for dx in (0.0, 0.03):
        T = syn.bench_pose().copy()
        T[0, 3] += dx
        xyz, valid = syn.frame(T, 42, with_table=True, width=320, height=240)
        depths.append(np.where(valid, xyz[..., 2], 0.0).astype(np.float32))
    service = DetectionService(bank, cfg, batch_max=2, batch_window_ms=5000.0)
    service.warmup(depth_shape=depths[0].shape)
    alone = [service.detect_depth(d) for d in depths]
    hosts = [service._host_frame(d, 57.0) for d in depths]
    batch = service._run_batch(
        torch.stack([torch.from_numpy(h[1]) for h in hosts]).cuda(),
        torch.stack([torch.from_numpy(h[2]) for h in hosts]).cuda(),
        hosts[0][0])
    want = [service._payload(tree_map(lambda a, i=i: a[i], batch), 0.0, cfg)
            for i in (0, 1)]
    batcher, = service._batchers.values()
    batches, frames = service.n_batches, service.n_batched_frames
    got = [None, None]

    def request(i):
        got[i] = service.detect_depth(depths[i])

    threads = [threading.Thread(target=request, args=(i,)) for i in (0, 1)]
    threads[0].start()
    deadline = time.monotonic() + 60
    while len(batcher._queue) < 1 and time.monotonic() < deadline:
        time.sleep(0.001)             # frame 0 first in the batch
    threads[1].start()
    for t in threads:
        t.join(timeout=120)
    torch.cuda.synchronize()
    assert not any(t.is_alive() for t in threads)
    assert (service.n_batches, service.n_batched_frames) == (batches + 1,
                                                             frames + 2)
    for out, ref, single in zip(got, want, alone):
        assert (out["metrics"]["scene_points"]
                == single["metrics"]["scene_points"])
        out.pop("latency_ms"), ref.pop("latency_ms")
        assert out == ref
    assert (got[0]["metrics"]["scene_points"]
            != got[1]["metrics"]["scene_points"])


def _joint_hv_search():
    """The greedy search's inputs (explained, outliers, valid, prepared as
    ``_select_hypotheses`` prepares them) of one served ``joint_hv`` frame
    at the cell's own configuration: 48 hypotheses over 8,192 lanes,
    recorded on the card from the chain's eager warm-up."""
    import json

    from benchmark import cells, frames
    from benchmark.reference import joint
    from tpu_joints_torch.config import DetectionConfig
    from tpu_joints_torch.modelbank.bank import build_bank
    from tpu_joints_torch.recognize import hv as thv
    from tpu_joints_torch.serve import DetectionService

    cfg = json.loads((cells.HERE / "configs" / "joint_hv.json").read_text())
    scene = frames.Scene(cfg)
    pool = frames.make_pool(scene, 1, 2 ** 31 + 2026, "cuda")
    recipe = dict(cfg["bank"])
    bank = build_bank(joint.joint_model(recipe.pop("model")), device="cuda",
                      **recipe)
    seen, real = [], thv.hv_greedy

    def record(*a):
        if not seen:
            seen.append(tuple(t.clone() for t in a[:3]))
        return real(*a)

    thv.hv_greedy = record
    try:
        DetectionService(bank, DetectionConfig(**cfg["detection"])
                         ).detect_depth(pool["depth"][0],
                                        fov_deg=scene.fov_deg)
    finally:
        thv.hv_greedy = real
    torch.cuda.synchronize()
    return seen[0]


def _hv_greedy_inputs(name):
    """[(explained, outliers, valid)] on the card, prepared: one frame of
    ``hv_cases``, the cell's frame, three frames of one shape for one
    batched launch, or 64 × 65,536 (too large for shared memory: the
    packed rows go to the global workspace)."""
    if name == "joint_hv_frame":
        return [_joint_hv_search()]
    if name == "batch_of_three":
        arrays = [hv_cases.random_case(48, 8192, seed=s) for s in range(3)]
    elif name == "workspace_H64_N65536":
        arrays = [hv_cases.random_case(64, 65536)]
    else:
        arrays = [hv_cases.cases()[name]]
    return [tuple(torch.as_tensor(a, device="cuda")
                  for a in hv_cases.prepare(*x)) for x in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(hv_cases.cases()) + [
    "joint_hv_frame", "batch_of_three", "workspace_H64_N65536"])
def test_hv_greedy_kernel_equals_plain_on_card(name):
    """GO-HV's greedy search kernel equals ``_greedy_verify`` bit for bit
    (active set, steps, improving steps), against the plain version on the
    CPU and on the card, on every ``hv_cases`` case (H 17-64 and 4, Ns
    1,000 / 8,192 / 16,384, invalid hypotheses, ties, outliers deciding,
    margins, an empty matrix), on a served ``joint_hv`` frame, on a batch
    of three frames and past shared memory; one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpu_joints_torch.recognize import hv as thv

    frames = _hv_greedy_inputs(name)
    args = (0.001, 1.0)
    if name == "batch_of_three":
        frames = [tuple(torch.stack(x) for x in zip(*frames))]
    for ex, out, valid in frames:
        before = thv.hv_greedy.launches
        got = thv.hv_greedy(ex, out, valid, *args)
        torch.cuda.synchronize()
        assert thv.hv_greedy.launches == before + 1
        per = ([thv._greedy_verify(e, o, v, *args)
                for e, o, v in zip(ex, out, valid)] if ex.ndim == 3
               else [thv._greedy_verify(ex, out, valid, *args)])
        for i, want in enumerate(per):
            mine = [g[i] if ex.ndim == 3 else g for g in got]
            e, o, v = (t[i] if ex.ndim == 3 else t for t in (ex, out, valid))
            cpu = thv._greedy_verify(e.cpu(), o.cpu(), v.cpu(), *args)
            for g, w, c in zip(mine, want, cpu):
                assert torch.equal(g.cpu(), w.cpu()) and torch.equal(
                    w.cpu(), c), (name, i)
        if name == "joint_hv_frame":
            assert ex.shape == (48, 8192) and bool(got[0].any())
