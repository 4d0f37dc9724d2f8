"""Judge the replies of a window against the reference: the judge ``hv``,
for a scene of several joints served with the global hypothesis
verification (GO-HV) on.

Every reply is held to the configuration's gate against the true poses
(the frame maker's ``pool["poses"]``, one per joint): each instance the
reply names (its GOOD list) lies within the gate's rotation and translation
errors of a true joint, no two name the same joint, and an accepted winner
lies within the gate of one of them; a request that raised is a failure.
``missed_share`` counts the replies that name fewer than every joint.

A sample of the replies, drawn from the seed, is also held to what the
reference works out again in float64 from the same depth frame, for the
hypotheses the reply says GO-HV judged (``hv_views``, ``hv_view_poses``,
``hv_valid``):

* ``ws_gap`` — |the reply's working-set count − the reference's|;
* ``hv_count_gap`` — the largest |explained − the reference's| and
  |outliers − the reference's| over the valid hypotheses, in points;
* ``hv_cost_gap`` — the reference's cost of the reply's verified set less
  the cost of the set the reference's own search picks from the same
  hypotheses, over the latter's magnitude;
* ``fit_gap``, ``view_gap``, ``obb_gap`` — the accepted winner's, as
  ``check.py`` computes them (a rejected winner's fitness may be a tier-1
  one, over other CAD rows).

The formulation (``tpu_joints/recognize/hv.py``): hypothesis h is the
reference's own render of bank view ``hv_views[h]`` moved by
``hv_view_poses[h]``; a working-set point is explained by h when h has a
point within the inlier threshold (distances in the difference form); an
outlier of h is a point of h with no working-set point within the
threshold that does not lie more than the occlusion threshold behind the
64 × 64 depth buffer of the working set (the nearest depth per ray bin,
the bins spanning the working set's x/z and y/z, twice dilated by a 3 × 3
minimum; stated, as the ingest's rule is, in float32, the sensor's
precision). With cover(s) the number of chosen hypotheses explaining
point s,

    cost = −#{s: cover(s) ≥ 1} + λ_out·Σ_chosen outliers
           + λ_mult·Σ_s max(cover(s) − 1, 0),

λ_out the configuration's ``hv_regularizer``, λ_mult 1. Up to 16
hypotheses every subset is tried (the first minimum in pattern order);
above, a single-flip search from the empty set runs 2H steps, each taking
the first best flip when it lowers the cost by more than 1e-6. Departures
from PCL's GO-HV (``SHOT_hypothesis.cpp:632-651``): no clutter term (the
source runs with clutter detection off, ``:56-64``) and a 1 cm inlier
threshold (the source's 5 mm; the configuration's ``reduced``).

Each number is printed beside its limit; ``correct`` holds when every
number is within its limit. The control (``benchmark/control.py``) puts
the reference in the program's place where its float32 switch cannot
reach: the counts and the verdict from distances formed with TF32
operands, and the winner's fitness at TF32 neighbours (``check.py``).
"""
from __future__ import annotations

import random
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import check, joint
from benchmark.reference.check import rot_trans_err

MULT_PENALTY = 1.0        # λ_mult, the port's and the JAX package's
BINS = 64                 # the occlusion depth buffer's bins per axis
BIG = 3.0e38
ROWS = 2048               # hypothesis points per block of distances
HV_KEYS = ("hv_views", "hv_view_poses", "hv_valid", "hv_verified",
           "hv_explained", "hv_outliers")


def named(reply: dict, poses, gate: dict):
    """(wrong, taken, worst): the reply's named instances and accepted
    winner matched to the true joints ``poses`` [K, 4, 4] within the gate —
    ``wrong`` counts the instances that lie near no joint or take a joint
    an earlier instance took, and an accepted winner near none; ``taken``
    is the set of joints named; ``worst`` the largest (rotation °,
    translation mm) of a match."""
    lims = (gate["rot_deg"], gate["trans_mm"])

    def match(T):
        errs = [rot_trans_err(T, G) for G in poses]
        near = [k for k, e in enumerate(errs)
                if e[0] <= lims[0] and e[1] <= lims[1]]
        if not near:
            return None, (0.0, 0.0)
        k = min(near, key=lambda k: errs[k][1])
        return k, errs[k]

    wrong, taken, worst = 0, set(), [0.0, 0.0]
    for inst in reply["instances"]:
        k, e = match(inst["pose"])
        if k is None or k in taken:
            wrong += 1
            continue
        taken.add(k)
        worst = [max(worst[0], e[0]), max(worst[1], e[1])]
    if reply["accepted"]:
        k, e = match(reply["pose"])
        if k is None:
            wrong += 1
        else:
            worst = [max(worst[0], e[0]), max(worst[1], e[1])]
    return wrong, taken, tuple(worst)


def passes(reply: dict, pool: dict, gate: dict) -> bool:
    """A reply that came and is honest: every instance it names lies within
    the gate of a true joint of ``pool["poses"]``, no two take the same
    joint, and an accepted winner lies within the gate of one. A reply
    without GO-HV's record (``HV_KEYS``) comes from a program that cannot
    run this configuration: that raises, so such a run ends without a
    result."""
    if reply is None:
        return False
    missing = [k for k in HV_KEYS if k not in reply["metrics"]]
    if missing:
        raise RuntimeError(f"the reply carries no {', '.join(missing)}: this "
                           "program does not report what GO-HV judged")
    return named(reply, pool["poses"], gate)[0] == 0


def _d2(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    """Squared distances float64[A, B]: the difference form in float64, or
    with ``tf32`` the expanded form in float32 with the product's operands
    rounded to TF32."""
    if tf32:
        a, b = a.float(), b.float()
        return ((a * a).sum(-1, keepdim=True) + (b * b).sum(-1)
                - 2.0 * (check._tf32(a) @ check._tf32(b).T)).double()
    return ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)


def depth_buffer(scene: torch.Tensor):
    """(depth float32[BINS²], lo [2], scale [2]) of the working set
    ``scene`` [n, 3] seen from the origin (module docstring)."""
    s = scene.float()
    x, y, z = s[:, 0], s[:, 1], s[:, 2]
    ok = z > 1e-6
    zs = torch.clamp_min(z, 1e-6)
    u = torch.where(ok, x / zs, 0.0)
    v = torch.where(ok, y / zs, 0.0)
    lo = torch.stack([torch.where(ok, u, BIG).amin(),
                      torch.where(ok, v, BIG).amin()])
    hi = torch.stack([torch.where(ok, u, -BIG).amax(),
                      torch.where(ok, v, -BIG).amax()])
    scale = (BINS - 1) / torch.clamp_min(hi - lo, 1e-6)
    depth = torch.full((BINS * BINS,), BIG, dtype=torch.float32,
                       device=s.device)
    depth = depth.scatter_reduce(0, _bins(u, v, lo, scale),
                                 torch.where(ok, z, BIG), "amin")
    img = depth.reshape(1, 1, BINS, BINS)
    for _ in range(2):
        img = -F.max_pool2d(F.pad(-img, (1, 1, 1, 1), value=-BIG), 3,
                            stride=1)
    return img.reshape(-1), lo, scale


def _bins(u, v, lo, scale):
    ui = torch.clamp(((u - lo[0]) * scale[0]).to(torch.int32), 0, BINS - 1)
    vi = torch.clamp(((v - lo[1]) * scale[1]).to(torch.int32), 0, BINS - 1)
    return (vi * BINS + ui).long()


def occluded(xyz: torch.Tensor, buffer, threshold: float) -> torch.Tensor:
    """bool[n]: the point lies more than ``threshold`` behind the depth
    buffer, in float32."""
    depth, lo, scale = buffer
    p = xyz.float()
    zs = torch.clamp_min(p[:, 2], 1e-6)
    front = depth[_bins(p[:, 0] / zs, p[:, 1] / zs, lo, scale)]
    return (p[:, 2] > front + float(np.float32(threshold))) & (front < 1e38)


def cost(active: torch.Tensor, explained: torch.Tensor,
         outliers: torch.Tensor, lam_out: float) -> torch.Tensor:
    """The cost of each set of ``active`` bool[P, H] over ``explained``
    bool[H, n] and ``outliers`` [H], float64[P]."""
    a = active.double()
    cover = a @ explained.double()
    return (-(cover >= 1).sum(-1).double() + lam_out * (a @ outliers.double())
            + MULT_PENALTY * torch.clamp_min(cover - 1.0, 0.0).sum(-1))


def search(explained: torch.Tensor, outliers: torch.Tensor,
           valid: torch.Tensor, lam_out: float) -> torch.Tensor:
    """The set the formulation picks, bool[H]: every subset up to 16
    hypotheses, else the single-flip search from the empty set."""
    H = explained.shape[0]
    dev = explained.device
    explained = explained & valid[:, None]
    if H <= 16:
        pats = torch.arange(2 ** H, device=dev)
        bits = ((pats[:, None] >> torch.arange(H, device=dev)) & 1).bool()
        sets = bits & valid[None, :]
        costs = torch.cat([cost(sets[i:i + 4096], explained, outliers,
                                lam_out)
                           for i in range(0, sets.shape[0], 4096)])
        return sets[int(torch.argmin(costs))]
    eye = torch.eye(H, dtype=torch.bool, device=dev)
    active = torch.zeros(H, dtype=torch.bool, device=dev)
    now = cost(active[None], explained, outliers, lam_out)[0]
    for _ in range(2 * H):
        flips = (active[None, :] ^ eye) & valid[None, :]
        costs = cost(flips, explained, outliers, lam_out)
        j = torch.argmin(costs)
        better = costs[j] < now - 1e-6
        active = torch.where(better, flips[j], active)
        now = torch.where(better, costs[j], now)
    return active


def counts(instances: List, scene: torch.Tensor, inlier: float,
           occlusion: float, tf32: bool = False):
    """(explained bool[H, n], outliers float64[H]) of the hypotheses
    ``instances`` (float64[m_h, 3] each, None where invalid: nothing
    explained, no outliers) over the working set ``scene`` [n, 3]; with
    ``occlusion`` > 0 a point hidden behind the depth buffer is no
    outlier. Distances in blocks of ``ROWS`` hypothesis points."""
    thr2 = inlier ** 2
    dev = scene.device
    buffer = depth_buffer(scene) if occlusion > 0 else None
    explained = torch.zeros((len(instances), scene.shape[0]),
                            dtype=torch.bool, device=dev)
    outliers = torch.zeros(len(instances), dtype=torch.float64, device=dev)
    for h, inst in enumerate(instances):
        if inst is None:
            continue
        to_inst = torch.full((scene.shape[0],), float("inf"),
                             dtype=torch.float64, device=dev)
        alone = []
        for a in range(0, inst.shape[0], ROWS):
            d2 = _d2(inst[a:a + ROWS], scene, tf32)
            to_inst = torch.minimum(to_inst, d2.amin(0))
            alone.append(d2.amin(1) > thr2)
        alone = torch.cat(alone)
        if buffer is not None:
            alone &= ~occluded(inst, buffer, occlusion)
        outliers[h] = alone.sum()
        explained[h] = to_inst <= thr2
    return explained, outliers


class Reference(check.Reference):
    """``check.Reference`` (working sets, CAD rows, views, the winner's
    numbers) and the recount of GO-HV for a reply's hypotheses."""

    def __init__(self, config: dict, pool: dict, device):
        super().__init__(config, pool, device)
        det = config["detection"]
        self.inlier = float(np.float32(det["hv_inlier_threshold"]))
        self.occlusion = float(det["hv_occlusion_threshold"])
        self.lam_out = float(det["hv_regularizer"])
        self._counts: Dict[tuple, dict] = {}

    def view_cloud(self, v: int) -> torch.Tensor:
        """The reference's render of bank view ``v``, float64[n, 3]."""
        if v not in self._views:
            cloud = joint.render_view(self.model_xyz, self.view_poses[v],
                                      self.resolution, self.fov)
            self._views[v] = torch.as_tensor(cloud, dtype=torch.float64,
                                             device=self.device)
        return self._views[v]

    def recount(self, reply: dict, i: int, tf32: bool = False) -> dict:
        """GO-HV over the reply's hypotheses on pool entry ``i``:
        dict(explained int64[H], outliers float64[H], valid bool[H],
        verified bool[H] — the reference's own search, cost — the cost of a
        set bool[H]), worked out once per distinct set of hypotheses."""
        m = reply["metrics"]
        views = [int(v) for v in m["hv_views"]]
        poses = np.asarray(m["hv_view_poses"], np.float64)
        valid = np.asarray(m["hv_valid"], bool)
        key = (i, tf32, tuple(views), poses.tobytes(), valid.tobytes())
        if key not in self._counts:
            self._counts[key] = self._recount(views, poses, valid, i, tf32)
        return self._counts[key]

    def _recount(self, views, poses, valid, i, tf32):
        ws = self.working_set(i)
        instances = []
        for h, v in enumerate(views):
            T = torch.as_tensor(poses[h], device=self.device)
            instances.append(self.view_cloud(v) @ T[:3, :3].T + T[:3, 3]
                             if valid[h] else None)
        explained, outliers = counts(instances, ws, self.inlier,
                                     self.occlusion, tf32)
        valid_t = torch.as_tensor(valid, device=self.device)
        verified = search(explained, outliers, valid_t, self.lam_out)

        def of(chosen):
            return float(cost(chosen[None] & valid_t[None], explained,
                              outliers, self.lam_out)[0])

        return dict(explained=explained.sum(1).cpu().numpy(),
                    outliers=outliers.cpu().numpy(), valid=valid,
                    verified=verified.cpu().numpy(), cost=of)

    def hv_numbers(self, reply: dict, i: int) -> Dict[str, float]:
        """``hv_count_gap`` and ``hv_cost_gap`` of one reply; infinite
        where the reply claims a verdict on a hypothesis it calls
        invalid."""
        m = reply["metrics"]
        ref = self.recount(reply, i)
        valid = ref["valid"]
        verified = np.asarray(m["hv_verified"], bool)
        if (verified & ~valid).any():
            return dict(hv_count_gap=float("inf"), hv_cost_gap=float("inf"))
        gaps = [0.0]
        for name in ("explained", "outliers"):
            got = np.asarray(m[f"hv_{name}"], np.float64)[valid]
            gaps.append(float(np.abs(got - ref[name][valid]).max(initial=0)))
        best = ref["cost"](torch.as_tensor(ref["verified"],
                                           device=self.device))
        claimed = ref["cost"](torch.as_tensor(verified, device=self.device))
        return dict(hv_count_gap=max(gaps),
                    hv_cost_gap=(claimed - best) / max(abs(best), 1.0))

    def control(self, replies: List[dict], i: int) -> List[dict]:
        """The control's replies to entry ``i``: the program's, with the
        GO-HV counts and verdict and the winner's fitness taken over by the
        reference at TF32 operands."""
        out = []
        for r in check.Reference.control(self, replies, i):
            c = self.recount(r, i, tf32=True)
            out.append(dict(r, metrics=dict(
                r["metrics"], hv_explained=c["explained"].tolist(),
                hv_outliers=c["outliers"].tolist(),
                hv_verified=c["verified"].tolist())))
        return out


SAMPLE_NUMBERS = ("ws_gap", "hv_count_gap", "hv_cost_gap", "fit_gap",
                  "view_gap", "obb_gap")


def judge_window(ref: Reference, records: List[dict], seed: int,
                 limits: dict, sample: int, control: bool = False) -> dict:
    """Judge every record of a window by the gate and the joints named, and
    a sample of ``sample`` replies drawn from ``seed`` by the reference
    numbers (with ``control``, the control's replies in the program's
    place). Returns dict(correct, numbers: {name: (value, limit)},
    judged)."""
    gate = ref.config["gate"]
    poses = ref.pool["poses"]
    failed = sum(1 for r in records if r["reply"] is None)
    replies = [r for r in records if r["reply"] is not None]
    rng = random.Random(int(seed))
    picked = rng.sample(replies, min(sample, len(replies)))
    by_entry: Dict[int, List[dict]] = {}
    for r in picked:
        by_entry.setdefault(r["index"], []).append(r["reply"])
    worst = {k: 0.0 for k in SAMPLE_NUMBERS}
    for i, group in sorted(by_entry.items()):
        if control:
            group = ref.control(group, i)
        ws = ref.working_set(i).shape[0]
        for r in group:
            row = dict(ws_gap=abs(float(r["metrics"]["scene_points"]) - ws),
                       **ref.hv_numbers(r, i))
            for k, v in row.items():
                worst[k] = max(worst[k], v)
        accepted = [r for r in group if r["accepted"]]
        for row in (ref.judge(accepted, i) if accepted else []):
            for k in ("fit_gap", "view_gap", "obb_gap"):
                worst[k] = max(worst[k], row[k])
    wrong = missed = 0
    rot = trans = 0.0
    for r in replies:
        w, taken, (a, t) = named(r["reply"], poses, gate)
        wrong += w
        missed += len(taken) < len(poses)
        rot, trans = max(rot, a), max(trans, t)
    numbers = {
        "failed": (float(failed), 0.0),
        "wrong_instances": (float(wrong), float(limits["wrong_instances"])),
        "missed_share": (missed / max(len(replies), 1),
                         float(limits["missed_share"])),
        "rot_err_deg": (rot, float(gate["rot_deg"])),
        "trans_err_mm": (trans, float(gate["trans_mm"])),
    }
    for k in SAMPLE_NUMBERS:
        numbers[k] = (worst[k], float(limits[k]))
    correct = bool(replies) and all(v <= lim for v, lim in numbers.values())
    return dict(correct=correct, numbers=numbers, judged=len(picked))
