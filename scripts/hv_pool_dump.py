"""Frames of ``joint_hv.cams2``'s pool for one seed (0, 1 and 2 unless
named), made on the card as the benchmark makes them, and the port's
replies to them served as the cell serves them (``batch_max`` 2: each
alone, then the first two together), for ``scripts/hv_pool_served.py``'s cross-check with the JAX
package on the CPU. Imports neither JAX nor the JAX package. On the card,
from the repository root:

    env PYTHONPATH=. python3 scripts/hv_pool_dump.py SEED [OUT_DIR [0,1,2]]

writes ``OUT_DIR/hv_frames_SEED.npz`` (the frames in the order named) and
``OUT_DIR/hv_replies_SEED.json`` (frame i's reply under ``alone_<i>``)
(``OUT_DIR`` defaults to the working directory) and prints each reply's
GOOD list."""
import json
import sys
import threading

import numpy as np

from benchmark import cells, frames as frames_mod
from benchmark.reference import joint
from tpu_joints_torch.config import DetectionConfig
from tpu_joints_torch.modelbank.bank import build_bank
from tpu_joints_torch.serve.server import DetectionService


def main():
    seed = int(sys.argv[1])
    out_dir = sys.argv[2] if len(sys.argv) > 2 else "."
    which = [int(i) for i in (sys.argv[3] if len(sys.argv) > 3
                              else "0,1,2").split(",")]
    cell = cells.resolve("joint_hv.cams2")
    config, mix = cell["config"], cell["traffic"]
    scene = frames_mod.Scene(config)
    fov = scene.fov_deg
    pool = frames_mod.make_pool(scene, int(mix["pool"]), seed, "cuda")
    np.savez_compressed(f"{out_dir}/hv_frames_{seed}.npz",
                        depth=pool["depth"][which], poses=pool["poses"],
                        index=np.asarray(which))
    recipe = dict(config["bank"])
    bank = build_bank(joint.joint_model(recipe.pop("model")), device="cuda",
                      **recipe)
    svc = DetectionService(bank, DetectionConfig(**config["detection"]),
                           batch_max=2, batch_window_ms=4.0, max_pending=8)
    svc.warmup(depth_shape=(scene.height, scene.width), fov_deg=fov)
    keep = ("instances", "accepted", "pose", "view_idx", "metrics")
    out = {}
    for i in which:
        r = svc.detect_depth(pool["depth"][i], fov_deg=fov)
        out[f"alone_{i}"] = {k: r[k] for k in keep}
    pair = {}

    def one(i):
        pair[i] = svc.detect_depth(pool["depth"][i], fov_deg=fov)

    threads = [threading.Thread(target=one, args=(i,)) for i in which[:2]]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i in which[:2]:
        out[f"paired_{i}"] = {k: pair[i][k] for k in keep}
    out["batches"] = [svc.n_batches, svc.n_batched_frames]
    with open(f"{out_dir}/hv_replies_{seed}.json", "w") as f:
        json.dump(out, f)
    for k, r in out.items():
        if k != "batches":
            m = r["metrics"]
            print(k, "accepted", r["accepted"], "GOOD at",
                  [np.round(np.asarray(g["pose"])[:3, 3], 3).tolist()
                   for g in r["instances"]],
                  "verified", sum(m["hv_verified"]), "of valid",
                  sum(m["hv_valid"]))
    print("batches, frames", out["batches"])


if __name__ == "__main__":
    main()
