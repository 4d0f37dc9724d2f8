"""Judge the replies of a window against the reference: the judge of a
configuration that names none (``benchmark/cells.py::judge``), for a
scene of one joint.

Every reply is held to the configuration's gate against the true pose
(the frame maker's ``pool["pose"]``): an accepted pose lies within the
stated rotation and translation errors (``bench.py``'s stream gate), and
at least the stated share of the frames is accepted; a request that raised
is a failure. A sample of the replies, drawn from the seed, is also held
to what the reference works out again from the same depth frame, in
float64:

* ``ws_gap``  — |the reply's working-set count − the reference's|: the
  organized ingest's tile winners;
* ``fit_gap`` — |the reply's full-CAD fitness − the reference's| over the
  reference's: the CAD rows moved by the reply's pose, mean squared
  distance to their nearest working-set point (the search K1 makes);
* ``view_gap`` — the largest entry of |pose − view_pose · P[view]|, P the
  reference's own bank view pose: the winning view is the one the pose was
  composed with;
* ``obb_gap`` — the largest difference, in metres, of the box's centre and
  its sorted side lengths against the PCA box of the reference's render of
  the winning view moved by the reply's view pose.

Each number is printed beside its limit; ``correct`` holds when every
number is within its limit. The control (``benchmark/control.py``) puts the
reference in the program's place where the program's float32 precision
switch cannot reach: the fitness, with every nearest neighbour taken from
distances in TF32 (``judge_window(..., control=True)``).
"""
from __future__ import annotations

import math
import random
from typing import Dict, List

import numpy as np
import torch

from benchmark.reference import ingest, joint

def rot_trans_err(T: np.ndarray, G: np.ndarray):
    """(rotation error in degrees, translation error in mm) of pose ``T``
    against the true pose ``G``, in float64."""
    T = np.asarray(T, np.float64)
    G = np.asarray(G, np.float64)
    Rd = T[:3, :3] @ G[:3, :3].T
    c = np.clip((np.trace(Rd) - 1.0) / 2.0, -1.0, 1.0)
    return math.degrees(math.acos(c)), 1000.0 * float(
        np.linalg.norm(T[:3, 3] - G[:3, 3]))


def passes(reply: dict, pool: dict, gate: dict) -> bool:
    """A reply that came and that the gate lets through: an honest
    rejection, or an accepted pose within the gate's errors of the true
    pose ``pool["pose"]``."""
    if reply is None:
        return False
    if not reply["accepted"]:
        return True
    rot, trans = rot_trans_err(reply["pose"], pool["pose"])
    return rot <= gate["rot_deg"] and trans <= gate["trans_mm"]


def _box(xyz: torch.Tensor):
    """(centre [3], sorted side lengths [3]) of the PCA box of ``xyz``."""
    c = xyz.mean(0)
    d = xyz - c
    _, V = torch.linalg.eigh(d.T @ d / xyz.shape[0])
    local = d @ V
    lo, hi = local.amin(0), local.amax(0)
    return V @ (0.5 * (lo + hi)) + c, torch.sort(hi - lo).values


def _move(T: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """``xyz`` [N, 3] moved by the poses ``T`` [B, 4, 4]: [B, N, 3]."""
    return torch.einsum("bij,nj->bni", T[:, :3, :3], xyz) + T[:, None, :3, 3]


def _poses(replies: List[dict], device) -> torch.Tensor:
    """The replies' poses, float64[B, 4, 4] on ``device``."""
    return torch.as_tensor(np.stack([np.asarray(r["pose"], np.float64)
                                     for r in replies]), device=device)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10-bit mantissa (nearest, ties
    away from zero)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _nearest(moved: torch.Tensor, target: torch.Tensor, tf32: bool):
    """(squared distance, index) of the nearest ``target`` point of every
    row of ``moved`` [B, N, 3]: exact differences, or with ``tf32`` the
    expanded form |a|² + |b|² − 2 a·b in float32 with the product's
    operands rounded to TF32, as the tensor cores take them."""
    if tf32:
        a, b = moved.float(), target.float()
        d2 = ((a * a).sum(-1, keepdim=True) + (b * b).sum(-1)
              - 2.0 * (_tf32(a) @ _tf32(b).T))
    else:
        d2 = torch.cdist(moved, target[None].expand(moved.shape[0], -1, -1),
                         compute_mode="donot_use_mm_for_euclid_dist") ** 2
    d2, idx = d2.min(-1)
    return d2.to(moved.dtype), idx


class Reference:
    """What the reference knows of one cell: the configuration, the frames
    and their true pose; working sets and views are worked out once each,
    on ``device``."""

    def __init__(self, config: dict, pool: dict, device):
        self.config = config
        self.pool = pool
        self.device = device
        det = config["detection"]
        self.capacity = int(det["scene_capacity"])
        bank = config["bank"]
        self.model_xyz = joint.joint_model(bank["model"])
        self.rows = torch.as_tensor(
            joint.cad_rows(self.model_xyz, int(bank["icp_capacity"])),
            dtype=torch.float64, device=device)
        self.view_poses = joint.view_poses(self.model_xyz, int(bank["level"]))
        self.resolution = int(bank["resolution"])
        self.fov = float(config["sensor"]["fov_deg"])
        self._ws: Dict[int, torch.Tensor] = {}
        self._views: Dict[int, torch.Tensor] = {}

    def working_set(self, i: int) -> torch.Tensor:
        """The reference working set of pool entry ``i``, float64[n, 3]."""
        if i not in self._ws:
            depth = self.pool["depth"][i]
            H, W = depth.shape
            block = ingest.tile_block(H, W, self.capacity)
            self._ws[i] = ingest.working_set(ingest.unproject(depth, self.fov),
                                             block, self.capacity,
                                             device=self.device)
        return self._ws[i]

    def fitness(self, i: int, poses: torch.Tensor,
                tf32: bool = False) -> torch.Tensor:
        """Mean squared distance of the CAD rows at each of ``poses`` to
        their nearest point of entry ``i``'s working set, float64[B]."""
        dt = torch.float32 if tf32 else torch.float64
        d2, _ = _nearest(_move(poses.to(dt), self.rows.to(dt)),
                         self.working_set(i).to(dt), tf32)
        return d2.double().mean(-1)

    def view_box(self, v: int, view_pose: np.ndarray):
        if v not in self._views:
            cloud = joint.render_view(self.model_xyz, self.view_poses[v],
                                      self.resolution, self.fov)
            self._views[v] = torch.as_tensor(cloud, dtype=torch.float64,
                                             device=self.device)
        T = torch.as_tensor(np.asarray(view_pose, np.float64),
                            device=self.device)
        return _box(self._views[v] @ T[:3, :3].T + T[:3, 3])

    def control(self, replies: List[dict], i: int) -> List[dict]:
        """The control's replies to entry ``i``: the program's, with its
        fitness taken over by the reference at TF32 neighbours."""
        fit = self.fitness(i, _poses(replies, self.device), tf32=True)
        return [dict(r, full_fitness=f) for r, f in zip(replies, fit.tolist())]

    def judge(self, replies: List[dict], i: int) -> List[Dict[str, float]]:
        """The sample numbers of replies to pool entry ``i``."""
        ws = self.working_set(i)
        fit = self.fitness(i, _poses(replies, self.device))
        out = []
        for r, f in zip(replies, fit.tolist()):
            P = self.view_poses[int(r["view_idx"])].astype(np.float64)
            composed = np.asarray(r["view_pose"], np.float64) @ P
            centre, sides = self.view_box(int(r["view_idx"]), r["view_pose"])
            obb = r["obb"]
            out.append({
                "ws_gap": abs(float(r["metrics"]["scene_points"])
                              - ws.shape[0]),
                "fit_gap": abs(float(r["full_fitness"]) - f) / f,
                "view_gap": float(np.abs(np.asarray(r["pose"], np.float64)
                                         - composed).max()),
                "obb_gap": max(
                    float(np.abs(np.asarray(obb["position"])
                                 - centre.cpu().numpy()).max()),
                    float(np.abs(np.sort(np.asarray(obb["extents"]))
                                 - sides.cpu().numpy()).max())),
            })
        return out


SAMPLE_NUMBERS = ("ws_gap", "fit_gap", "view_gap", "obb_gap")


def judge_window(ref: Reference, records: List[dict], seed: int,
                 limits: dict, sample: int, control: bool = False) -> dict:
    """Judge every record of a window by the configuration's gate, and a
    sample of ``sample`` replies drawn from ``seed`` by the reference
    numbers (with ``control``, the control's replies in the program's
    place). Returns dict(correct, numbers: {name: (value, limit)},
    judged)."""
    gate = ref.config["gate"]
    G = ref.pool["pose"]
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
        for row in ref.judge(group, i):
            for k, v in row.items():
                worst[k] = max(worst[k], v)
    rot = trans = 0.0
    accepted = 0
    for r in replies:
        if not r["reply"]["accepted"]:
            continue
        a, t = rot_trans_err(r["reply"]["pose"], G)
        rot, trans = max(rot, a), max(trans, t)
        accepted += 1
    numbers = {
        "failed": (float(failed), 0.0),
        "rejected_share": (1.0 - accepted / max(len(replies), 1),
                           1.0 - float(gate["min_accepted_share"])),
        "rot_err_deg": (rot, float(gate["rot_deg"])),
        "trans_err_mm": (trans, float(gate["trans_mm"])),
    }
    for k in SAMPLE_NUMBERS:
        numbers[k] = (worst[k], float(limits[k]))
    correct = bool(replies) and all(v <= lim for v, lim in numbers.values())
    return dict(correct=correct, numbers=numbers, judged=len(picked))
