"""GO-HV as the detection service serves it, held to the benchmark's plain
float64 reference (``benchmark/reference/hv.py``) on the CPU.

* The port's ``verify_hypotheses_counted`` against the reference's
  ``counts`` and ``search`` on seeded random hypotheses: 8 (every subset),
  20 and 48 (the single-flip search), without and with the occlusion
  exemption. Explained counts, outliers and verdict are equal. The port's
  K1 forms float32 distances and the reference float64 ones, so a point
  within rounding of the inlier threshold may fall on either side: the data
  are drawn with no distance within 1e-5 m of the threshold, which leaves
  the counts determinate.
* A two-joint 320×240 depth frame (the benchmark's frame maker, the
  ``joint_hv`` scene) through ``DetectionService.detect_depth`` with
  ``hv_config()``'s GO-HV at test size and the level-0 bank
  (``tests/level0_bank.py``), with ``batch_max`` 1 and 2 (two requests in
  one batch): the reply carries the ``hv_*`` entries with one entry per
  candidate, and the reference's recount from them stays within the limits
  of ``benchmark/configs/joint_hv.json``.
* With spans on, the stage ``chain.hv`` is recorded once a chain, inside
  ``chain.refine``; with GO-HV off there is no ``chain.hv`` and no ``hv_*``
  entry.
"""
import dataclasses
import json
import threading

import numpy as np
import pytest
import torch

from benchmark import frames as frames_mod
from benchmark.cells import HERE
from benchmark.reference import hv as ref_hv
from tests.level0_bank import BANK_KW, level0_jax_bank
from tpu_joints_torch import synthetic as syn
from tpu_joints_torch.core import spans
from tpu_joints_torch.core.cloud import make_cloud
from tpu_joints_torch.modelbank import bank as tbank
from tpu_joints_torch.recognize import hv as thv
from tpu_joints_torch.serve import DetectionService

INLIER = 0.01
MARGIN = 1e-5


def _nearest(a, b):
    """Distance from each row of ``a`` to its nearest row of ``b``,
    float64."""
    return torch.cdist(torch.as_tensor(a, dtype=torch.float64),
                       torch.as_tensor(b, dtype=torch.float64)).amin(1).numpy()


def _hypotheses(H, seed):
    """(scene float32[n, 3], instances float32[H, m, 3], mask bool[H, m],
    valid bool[H]): a camera-frame scene of jittered sheets, hypotheses
    that copy part of it (some shifted away, some duplicates, one invalid);
    no distance between the two sides lies within MARGIN of INLIER."""
    rng = np.random.default_rng(seed)
    n, m = 400, 120
    scene = np.stack([rng.uniform(-0.3, 0.3, n), rng.uniform(-0.2, 0.2, n),
                      1.0 + 0.05 * rng.standard_normal(n)], 1)
    insts = []
    for h in range(H):
        src = scene[rng.choice(n, m, replace=False)]
        shift = rng.choice([0.0, 0.004, 0.02, 0.06])
        insts.append(src + rng.normal(0.0, 0.004, (m, 3))
                     + np.array([shift, 0.0, -shift]))
    insts = np.stack(insts)
    for _ in range(20):          # thin both sides off the threshold
        bad = np.zeros(n, bool)
        for inst in insts:
            bad |= np.abs(_nearest(scene, inst) - INLIER) < MARGIN
        scene = scene[~bad]
        n = scene.shape[0]
        flat = insts.reshape(-1, 3)
        near = np.abs(_nearest(flat, scene) - INLIER) < MARGIN
        flat[near] += 0.05        # far from everything
        insts = flat.reshape(H, m, 3)
        if not bad.any() and not near.any():
            break
    mask = rng.random((H, m)) > 0.1
    valid = np.ones(H, bool)
    valid[H // 3] = False
    return (scene.astype(np.float32), insts.astype(np.float32), mask, valid)


@pytest.mark.parametrize("occlusion", [0.0, 0.001])
@pytest.mark.parametrize("H", [8, 20, 48])
def test_counts_and_verdict_match_the_reference(H, occlusion):
    scene, insts, mask, valid = _hypotheses(H, seed=H)
    cloud = make_cloud(scene, capacity=512, device="cpu")
    verified, c = thv.verify_hypotheses_counted(
        torch.from_numpy(insts), torch.from_numpy(mask),
        torch.from_numpy(valid), cloud, inlier_threshold=INLIER,
        outlier_regularizer=0.001, occlusion_threshold=occlusion)
    inlier = float(np.float32(INLIER))
    instances = [torch.as_tensor(insts[h][mask[h]], dtype=torch.float64)
                 if valid[h] else None for h in range(H)]
    explained, outliers = ref_hv.counts(
        instances, torch.as_tensor(scene, dtype=torch.float64), inlier,
        occlusion)
    np.testing.assert_array_equal(c["explained"].numpy(),
                                  explained.sum(1).numpy())
    np.testing.assert_array_equal(c["outliers"].numpy()[valid],
                                  outliers.numpy()[valid])
    ref = ref_hv.search(explained, outliers, torch.from_numpy(valid), 0.001)
    np.testing.assert_array_equal(verified.numpy(), ref.numpy())
    assert verified.any() and not verified[~torch.from_numpy(valid)].any()
    assert int(c["steps"]) == (2 * H if H > 16 else 2 ** H // min(256, 2 ** H))
    assert 1 <= int(c["improved"]) <= int(c["steps"])
    if occlusion:       # the exemption is exercised on these data
        assert (outliers < ref_hv.counts(instances, torch.as_tensor(
            scene, dtype=torch.float64), inlier, 0.0)[1])[
                torch.from_numpy(valid)].any()


def _config():
    """The ``joint_hv`` configuration at test size: a 320×240 sensor, the
    level-0 bank's recipe, ``hv_config()`` at 4,608 lanes and 768 keys
    with 24 candidates (still the single-flip search) and 6 survivors."""
    cfg = json.loads((HERE / "configs" / "joint_hv.json").read_text())
    det = dataclasses.replace(
        syn.hv_config(), scene_capacity=4608, scene_key_capacity=768,
        max_candidates=24, refine_top=6)
    cfg["detection"] = dataclasses.asdict(det)
    cfg["sensor"].update(width=320, height=240)
    cfg["bank"].update(model=dict(n_chord=3000, n_stub=1800, seed=7),
                       **{k: BANK_KW[k] for k in (
                           "level", "resolution", "icp_capacity",
                           "key_capacity")})
    return cfg, det


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(config, pool of 2 frames, the bank, the replies of a batch_max 1
    service to each frame, the replies of a batch_max 2 service to both at
    once and its batch counts)."""
    jb = level0_jax_bank(tmp_path_factory)
    bank = tbank.bank_from_numpy(
        {k: np.asarray(getattr(jb, k)) for k in tbank._ARRAYS}
        | {"params_hash": jb.params_hash}, device="cpu")
    cfg, det = _config()
    scene = frames_mod.Scene(cfg)
    pool = frames_mod.make_pool(scene, 2, 2 ** 31 + 77, "cpu")
    fov = scene.fov_deg
    one = DetectionService(bank, det)
    singles = [one.detect_depth(d, fov_deg=fov) for d in pool["depth"]]
    two = DetectionService(bank, det, batch_max=2, batch_window_ms=60_000.0)
    pair = {}

    def send(i):
        pair[i] = two.detect_depth(pool["depth"][i], fov_deg=fov)

    threads = [threading.Thread(target=send, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return dict(config=cfg, det=det, pool=pool, bank=bank, singles=singles,
                pair=[pair[0], pair[1]],
                batches=(two.n_batches, two.n_batched_frames))


@pytest.mark.parametrize("batch_max", [1, 2])
def test_served_reply_carries_hv_and_matches_the_reference(served,
                                                           batch_max):
    cfg, det = served["config"], served["det"]
    replies = served["singles"] if batch_max == 1 else served["pair"]
    if batch_max == 2:
        assert served["batches"] == (1, 2)
    C = det.max_candidates
    ref = ref_hv.Reference(cfg, served["pool"], "cpu")
    for i, reply in enumerate(replies):
        m = reply["metrics"]
        for k in ref_hv.HV_KEYS:
            assert len(m[k]) == C, k
        assert np.asarray(m["hv_view_poses"]).shape == (C, 4, 4)
        assert m["hv_steps"] == 2 * C
        assert 0 < m["hv_steps_improved"] <= m["hv_steps"]
        assert 0 < m["hv_instance_points"]
        assert sum(m["hv_verified"]) >= 1
        numbers = ref.hv_numbers(reply, i)
        for k, v in numbers.items():
            assert v <= cfg["limits"][k], (k, v, i)
        assert m["scene_points"] == ref.working_set(i).shape[0]


def _stages(service, depth):
    spans.enable(True)
    spans.drain()
    try:
        reply = service.detect_depth(depth)
        return reply, spans.drain()
    finally:
        # spans are process-wide: leave them off with no records and no
        # totals (turning them on restarts the totals) for later modules
        spans.enable(False)
        spans.drain()
        spans.enable(True)
        spans.enable(False)


@pytest.mark.parametrize("hv_on", [True, False])
def test_chain_hv_stage_inside_refine(served, hv_on):
    det = dataclasses.replace(served["det"], hv_enabled=hv_on)
    service = DetectionService(served["bank"], det)
    reply, records = _stages(service, served["pool"]["depth"][0])
    hv = [r for r in records if r.name == "chain.hv"]
    assert any(k.startswith("hv_") for k in reply["metrics"]) == hv_on
    if not hv_on:
        assert hv == []
        return
    refine = [r for r in records if r.name == "chain.refine"]
    assert len(hv) == 1 and len(refine) == 1
    assert hv[0].parent is refine[0]
    assert refine[0].start_ns <= hv[0].start_ns <= hv[0].end_ns \
        <= refine[0].end_ns
