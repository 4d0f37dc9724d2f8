"""Port parity, ``detect_organized_batch`` with the stages that work on one
frame: the lattice crop chain (``segment_scene`` / ``remove_plane``), the
global hypothesis verification (``hv_enabled``) and the clustered box
(``obb_largest_cluster``). The reference's batch is a ``jax.vmap`` of its
whole fused chain, so it runs every configuration; the port runs these three
stages frame by frame inside the batched pass.

Each case is a batch of two 320×240 frames against the level-0 bank of the
bench joint (``tests/test_torch_segmented.py``), with the bench chain scaled
as ``tests/test_torch_batch.py``'s ``joint_problem`` scales it:

* crop chain — the bench pose on the workshop table, noise seeds 42 and 7,
  ``tests/test_segment_organized.py::_seg_cfg``;
* GO-HV — two jittered frames of ``synthetic.two_instance_frame(320, 240)``
  (seeds 0 and 3 of ``synthetic.batch_frames``; on seeds 1 and the unjittered
  frame a descriptor sits on the match threshold and one package matches it
  where the other does not, in single runs too), with ``hv_config()``'s HV
  and peak-cut fields and its 2 cm keypoint spacing, 4608 lanes and 768
  keys (they hold the frames' 4,408 occupied tiles and ~730 keypoints
  uncut), 16 candidates (the exhaustive search);
* clustered box — the bench pose without the table, seeds 42 and 7.

Held: the batch against the port's own per-frame runs to
``tests/test_torch_batch.py``'s tolerances; against JAX's batch with the
flag on, ``n_selected``, the flags, the stage counts, the candidate field,
``cand_verified`` and the winning view equal, poses within 5e-4 and the box
within 1e-4 (every frame is accepted); and the host reads of a region
growing happen per frame, as many in the batch as in the single runs.
"""
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.level0_bank import level0_jax_bank
from tests.test_segment_organized import _seg_cfg
from tests.test_torch_batch import assert_batch_equals_singles
from tpu_joints.config import DetectionConfig
from tpu_joints_torch import config as tconfig
from tpu_joints_torch import synthetic as syn
from tpu_joints_torch.modelbank import bank as tbank
tdet = importlib.import_module("tpu_joints_torch.pipelines.detect")
from tpu_joints_torch.segment import organized as torg
trg = importlib.import_module("tpu_joints_torch.segment.region_growing")

jdet = importlib.import_module("tpu_joints.pipelines.detect")
BANK_KW = dict(descriptor="shot", descr_radius=0.06, rf_radius=0.06,
               rf_k_max=96, frames="board", sampling_radius=0.02, normal_k=16,
               k_max=96, level=0, resolution=64, surface_leaf=0.01,
               key_capacity=64, icp_capacity=1024)
ARRAYS = ("view_xyz", "view_mask", "key_xyz", "key_valid", "desc", "rf",
          "poses", "model_xyz", "model_mask", "icp_xyz", "icp_mask")
GEO = dict(block=2, half_window=3)
# bench.py's chain at the test size (tests/test_torch_batch.py::joint_problem)
BENCH = dict(
    descr_rad=0.06, model_ss=0.02, scene_ss=0.03, normal_k=16,
    match_threshold=0.25, rf_frames="board", rf_rad=0.06, rf_k_max=96,
    k_max=96, cg_size=0.05, cg_thresh=3.0, icp_iterations=6,
    icp_point_to_plane=True, icp_max_corr_dist=0.02, icp_max_corr_start=0.2,
    final_icp_iterations=8, max_candidates=16, max_instances_per_view=2,
    view_grouped_candidates=True, split_rotation_modes=True, refine_top=4,
    tier1_rows=512, tier1_iterations=4, tier1_view_iterations=4,
    tier1_polish_iterations=4, scene_capacity=3072, scene_key_capacity=256,
    coverage_accept=0.02)


def _t(a):
    return torch.from_numpy(np.array(a))


def _crop_chain():
    frames = [syn.frame(syn.bench_pose(), s, with_table=True, width=320,
                        height=240) for s in (42, 7)]
    return (_seg_cfg(**BENCH), frames, (syn.CROP_LO, syn.CROP_HI))


def _hv():
    hv = syn.hv_config()
    cfg = DetectionConfig(**{
        **BENCH, "scene_ss": 0.02, "scene_capacity": 4608,
        "scene_key_capacity": 768,
        **{f: getattr(hv, f) for f in (
            "coverage_local", "max_instances_per_view",
            "peak_grouped_candidates", "hv_enabled", "hv_inlier_threshold")}})
    xyz, valid, _, _ = syn.two_instance_frame(320, 240)
    jitter = syn.batch_frames(xyz, 4)
    return cfg, [(jitter[0], valid), (jitter[3], valid)], (syn.WIDE_LO,
                                                           syn.WIDE_HI)


def _clustered_box():
    frames = [syn.frame(syn.bench_pose(), s, with_table=False, width=320,
                        height=240) for s in (42, 7)]
    return (DetectionConfig(**BENCH, obb_largest_cluster=True), frames,
            (syn.CROP_LO, syn.CROP_HI))


CASES = {"crop_chain": _crop_chain, "hv": _hv, "clustered_box": _clustered_box}


@pytest.fixture(scope="module")
def banks(tmp_path_factory):
    jb = level0_jax_bank(tmp_path_factory)
    tb = tbank.bank_from_numpy(
        {k: np.asarray(getattr(jb, k)) for k in ARRAYS}
        | {"params_hash": jb.params_hash}, device="cpu")
    return jb, tb


def _reads():
    return (torg.region_growing_lattice.host_checks
            + trg.region_growing.host_checks)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request, banks):
    """JAX's batch, the port's batch and the port's per-frame runs, with the
    region growings' host reads of the port's batch and of its single runs."""
    jb, tb = banks
    jcfg, frames, (lo, hi) = CASES[request.param]()
    tcfg = tconfig.from_dict(dataclasses.asdict(jcfg))
    imgs = np.stack([f[0] for f in frames])
    valids = np.stack([f[1] for f in frames])
    rj, nj = jdet.detect_organized_batch(
        jnp.asarray(imgs), jnp.asarray(valids), jb, jcfg,
        crop_lo=jnp.asarray(lo), crop_hi=jnp.asarray(hi), **GEO)
    before = _reads()
    rt, nt = tdet.detect_organized_batch(_t(imgs), _t(valids), tb, tcfg,
                                         crop_lo=_t(lo), crop_hi=_t(hi), **GEO)
    batch_reads = _reads() - before
    before = _reads()
    singles = [tdet.detect_organized(_t(i), _t(v), tb, tcfg, crop_lo=_t(lo),
                                     crop_hi=_t(hi), **GEO)
               for i, v in zip(imgs, valids)]
    single_reads = _reads() - before
    return dict(name=request.param, jax=(rj, nj), port=(rt, nt),
                singles=singles, reads=(batch_reads, single_reads))


def test_batch_stage_equals_per_frame_runs(case):
    rt, nt = case["port"]
    assert all(bool(r.accepted) for r, _ in case["singles"])
    assert_batch_equals_singles(rt, nt, case["singles"])


def test_batch_stage_matches_jax_batch(case):
    (rj, nj), (rt, nt) = case["jax"], case["port"]
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    for f in ("accepted", "view_idx", "cand_views", "cand_valid",
              "cand_verified"):
        np.testing.assert_array_equal(getattr(rt, f).numpy(),
                                      np.asarray(getattr(rj, f)), err_msg=f)
    assert rt.accepted.all()
    for k in ("scene_points", "scene_keypoints", "valid_descriptors",
              "correspondences", "instances"):
        np.testing.assert_array_equal(rt.metrics[k].numpy(),
                                      np.asarray(rj.metrics[k]), err_msg=k)
    np.testing.assert_allclose(rt.full_pose.numpy(), np.asarray(rj.full_pose),
                               atol=5e-4)
    for f in rt.obb._fields:
        np.testing.assert_allclose(getattr(rt.obb, f).numpy(),
                                   np.asarray(getattr(rj.obb, f)), atol=1e-4,
                                   err_msg=f)
    if case["name"] == "hv":        # the verification selects, per frame
        verified = rt.cand_verified.sum(1)
        assert bool(((verified >= 1) & (verified < rt.cand_valid.sum(1))).all())


def test_batch_stage_reads_host_per_frame(case):
    """The lattice region growing (crop chain) and the graph one (clustered
    box) read the host per frame: the batch reads as often as the single
    runs together; the hypothesis verification never reads."""
    batch_reads, single_reads = case["reads"]
    assert batch_reads == single_reads
    assert (batch_reads > 0) == (case["name"] != "hv")
