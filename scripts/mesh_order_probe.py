"""Why a view-sharded ``detect_batch`` can differ from a scene's single
``detect`` on a card: threads, or the view blocks? Port only (no JAX);
needs one CUDA card.

    python3 scripts/mesh_order_probe.py

On the bench bank (42 views, built on the card) and phase 6's generic
cloud plus 3 copies jittered by N(0, 1e-4) (``chip_smoke.py`` 15.2's
scenes, ``synthetic.generic_config``):

``threads``: ``detect_batch`` on meshes naming ``cuda:0`` four times (2 x 2
and 4 x 1), issued from one thread per data row (``mesh.run_on`` keyed by
entry) 8 times against 3 one-thread runs, bit for bit; the same for
``detect_organized_batch`` over 4 shares of 8 jittered frames.

``hough``: ``hough_group``'s steps (weights, their sums, the centre, the
accumulator, peaks, rotation modes, votes, poses) over blocks of 21, 14, 7
and 6 views against one call over all 42: the steps that differ, with the
number of differing values and the largest difference.

``match``: ``match_bank``'s fields over each block of views against the
same columns of one call over all 42.
"""
from __future__ import annotations

import dataclasses
import importlib
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpu_joints_torch import synthetic as syn  # noqa: E402
from tpu_joints_torch.core.cloud import make_cloud  # noqa: E402
from tpu_joints_torch.core.ops import scatter_add, top_k  # noqa: E402
from tpu_joints_torch.core.transforms import umeyama  # noqa: E402
from tpu_joints_torch.distributed import (detect_batch, make_mesh,  # noqa: E402
                                          shard_inputs, stack_clouds)
from tpu_joints_torch.distributed import mesh as mesh_mod  # noqa: E402
from tpu_joints_torch.modelbank.bank import build_bank  # noqa: E402
from tpu_joints_torch.neighbors import pallas_knn as pk  # noqa: E402
D = importlib.import_module("tpu_joints_torch.pipelines.detect")  # noqa: E402
from tpu_joints_torch.recognize import hough as H  # noqa: E402
from tpu_joints_torch.serve.batching import tree_map  # noqa: E402


def leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


def bit_equal(a, b):
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def issued(threaded: bool):
    mesh_mod._issuer = ((lambda i, d: i) if threaded else (lambda i, d: d))


def hough_steps(f, bank, corrs, cfg, sl):
    """``hough.hough_group`` on the views ``sl``, its steps kept."""
    ck = {}
    keys, rf, kv = bank.key_xyz[sl], bank.rf[sl], bank.key_valid[sl]
    c = corrs._replace(**{k: getattr(corrs, k)[sl] for k in corrs._fields})
    V, M = keys.shape[0], f.keys.xyz.shape[0]
    dev = keys.device
    mi = c.model_idx.long()
    cvalid = (c.valid & f.rf_ok[None] & torch.gather(kv, 1, mi)
              & torch.gather(kv, 1, mi))
    local = H.model_local_votes(keys, rf, kv)
    ck["model-local votes"] = local
    votes = f.keys.xyz[None] + torch.einsum("mji,vmj->vmi", f.rf,
                                            H._gather_rows(local, mi))
    ck["votes"] = votes
    cv = cvalid.to(torch.float32)
    nvalid = torch.clamp_min(cv.sum(1), 1.0)
    w = 1.0 / (1.0 + c.dist_sq) * cv
    ck["w.sum(1)"] = w.sum(1)
    w = w * (nvalid / torch.clamp_min(w.sum(1), 1e-9))[:, None]
    ck["w"] = w
    wsum = torch.clamp_min(w.sum(1), 1e-6)
    center = (votes * w[..., None]).sum(1) / wsum[:, None]
    ck["centre"] = center
    lo = center - (H.GRID / 2.0) * cfg.cg_size
    bin_t = torch.full((), cfg.cg_size, dtype=torch.float32, device=dev)
    ijk = torch.clamp(torch.floor((votes - lo[:, None, :]) / bin_t)
                      .to(torch.int64), 0, H.GRID - 1)
    flat = (ijk[..., 0] * H.GRID + ijk[..., 1]) * H.GRID + ijk[..., 2]
    ck["bins"] = flat
    G3 = H.GRID ** 3
    acc = scatter_add((flat + torch.arange(V, device=dev)[:, None] * G3)
                      .reshape(-1), w.reshape(-1), V * G3)
    ck["accumulator"] = acc.reshape(V, G3)
    acc3 = acc.reshape(V, 1, H.GRID, H.GRID, H.GRID)
    peak = (acc3 >= F.max_pool3d(acc3, 3, stride=1, padding=1)) \
        & (acc3 >= cfg.cg_thresh)
    split = cfg.split_rotation_modes and cfg.max_instances_per_view % 2 == 0
    n_peaks = cfg.max_instances_per_view // (2 if split else 1)
    top_votes, top_bins = top_k(torch.where(peak, acc3, -1.0).reshape(V, G3),
                                n_peaks)
    ck["peaks"] = top_bins
    ck["peak votes"] = top_votes
    mem = (flat[:, None, :] == top_bins[:, :, None]) & cvalid[:, None, :]
    if split:
        R_corr = torch.einsum("mts,vmtk->vmsk", f.rf, H._gather_rows(rf, mi))
        ck["rotations"] = R_corr
        m1, cos1 = H._consensus(mem, w, R_corr)
        m2, _ = H._consensus(mem & (cos1 <= H._MODE_COS), w, R_corr)
        mem = torch.stack([m1, m2], dim=2).reshape(V, 2 * n_peaks, M)
        ck["memberships"] = mem
        ck["instance votes"] = (mem.to(torch.float32) * w[:, None, :]).sum(-1)
    P = mem.shape[1]
    ck["poses"] = umeyama(
        H._gather_rows(keys, mi)[:, None].expand(V, P, M, 3),
        f.keys.xyz[None, None].expand(V, P, M, 3),
        mem.to(torch.float32) * w[:, None, :])
    return ck


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda:0")
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip().splitlines()[0]
    print(f"# {smi}", flush=True)
    pk.build_all()
    cfg = syn.bench_config()
    bank = build_bank(syn.joint_model(), **syn.bench_bank_kwargs(cfg),
                      device=dev)
    gen = syn.generic_config()
    T = syn.bench_pose()
    xyz_h, valid_h = syn.frame(T, 42, with_table=False)
    base = syn.scene_points(xyz_h[valid_h], gen.scene_capacity)
    pts = [base] + [base + np.random.default_rng(s).normal(
        0, 1e-4, base.shape).astype(np.float32) for s in (1, 2, 3)]
    clouds = [make_cloud(p, capacity=gen.scene_capacity, device=dev)
              for p in pts]
    singles = [D.detect(c, bank, gen) for c in clouds]
    print(f"threads: single detects, views {[int(r.view_idx) for r in singles]}"
          f", accepted {[bool(r.accepted) for r in singles]}", flush=True)

    # --- threads --------------------------------------------------------
    stacked = stack_clouds(clouds)
    for model in (2, 1):
        mesh = make_mesh(devices=[dev] * 4, model_parallel=model)
        placed = shard_inputs(stacked, bank, mesh)
        issued(False)
        serial = [detect_batch(*placed, gen, mesh=mesh) for _ in range(3)]
        issued(True)
        threaded = [detect_batch(*placed, gen, mesh=mesh) for _ in range(8)]
        issued(False)
        print(f"threads: {4 // model} x {model} mesh, one-thread runs equal "
              f"each other {all(bit_equal(s, serial[0]) for s in serial)}; "
              f"threaded runs equal to them "
              f"{sum(bit_equal(t, serial[0]) for t in threaded)} of 8; views "
              f"{serial[0].view_idx.tolist()}", flush=True)
    det_cfg = dataclasses.replace(cfg, segment_scene=False,
                                  remove_plane=False)
    imgs = torch.as_tensor(syn.batch_frames(xyz_h, 8), device=dev)
    vms = torch.as_tensor(np.broadcast_to(valid_h, imgs.shape[:3]).copy(),
                          device=dev)
    shares = np.array_split(np.arange(8), 4)

    def org():
        return mesh_mod.run_on([dev] * 4, lambda i, d: D.detect_organized_batch(
            imgs[shares[i]], vms[shares[i]], bank, det_cfg, block=4,
            half_window=5)[0])

    ref = org()
    issued(True)
    same = sum(bit_equal(a, b) for _ in range(8) for a, b in zip(org(), ref))
    issued(False)
    print(f"threads: detect_organized_batch over 4 shares, threaded share runs "
          f"equal to the one-thread ones: {same} of 32", flush=True)

    # --- hough and match ------------------------------------------------
    tcfg = D._tier_cfg(bank, gen)
    V = bank.n_views
    for n, c_ in enumerate(clouds):
        f = D.prepare_scene(c_, tcfg)
        corrs = D.match_bank(f.desc, f.desc_valid, bank.desc, bank.key_valid,
                             tcfg)
        whole = hough_steps(f, bank, corrs, tcfg, slice(0, V))
        for m in (2, 3, 6, 7):
            Vl = V // m
            blocks = [hough_steps(f, bank, corrs, tcfg,
                                  slice(j * Vl, (j + 1) * Vl)) for j in range(m)]
            diffs = []
            for k, v in whole.items():
                cat = torch.cat([b[k] for b in blocks])
                if not torch.equal(cat, v):
                    mx = (f"{float((cat.double() - v.double()).abs().max()):.3e}"
                          if v.dtype.is_floating_point else "-")
                    diffs.append(f"{k} ({int((cat != v).sum())} values, {mx})")
            match = []
            for j in range(m):
                sl = slice(j * Vl, (j + 1) * Vl)
                part = D.match_bank(f.desc, f.desc_valid, bank.desc[sl],
                                    bank.key_valid[sl], tcfg)
                dd = float((part.dist_sq - corrs.dist_sq[sl]).abs().max())
                eq = all(torch.equal(getattr(part, k), getattr(corrs, k)[sl])
                         for k in corrs._fields)
                match.append("equal" if eq else f"dist_sq {dd:.3e}")
            print(f"scene {n}, {Vl} views a block: Hough steps that differ "
                  f"from one call over {V}: {diffs or 'none'}; match per "
                  f"block: {match}", flush=True)


if __name__ == "__main__":
    main()
