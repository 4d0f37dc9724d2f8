"""Readings of the correctness check: the program as it runs, and its
control, on several seeds of one cell, in one process.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 \\
        --seconds 6 [--tf32 1]

The control is the program with its own TF32 path switched on
(``torch.backends.cuda.matmul.allow_tf32`` and ``cudnn.allow_tf32``, which
the package switches off at import: it states float32), and where that
switch cannot reach — the nearest-neighbour search of its fitness, which
kernel K1 makes in float32 — the reference put in the program's place with
its neighbours taken from TF32 distances (the cell's judge's
``Reference.control``, ``benchmark/reference/check.py``'s by default):
TF32 is the precision below float32 that a later change would be tempted
to take, in the matrix products and in a search made as one. Each run is a
whole cell run (set-up, window, reference) at the cell's own size and
load, with a short window; every compared number is printed per seed as
one JSON line, and the largest (program) or smallest (control) of each over
the seeds at the end. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys


def readings(workload: str, seeds, seconds: float, tf32: bool,
             device: str = "cuda") -> list:
    """One dict of compared numbers per seed (plus ``correct``)."""
    import torch

    import tpu_joints_torch  # noqa: F401 — its import switches TF32 off
    from benchmark import cells
    from benchmark.run import run_cell

    cell = cells.resolve(workload)
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    out = []
    try:
        for seed in seeds:
            torch.backends.cuda.matmul.allow_tf32 = tf32
            torch.backends.cudnn.allow_tf32 = tf32
            line, notes = run_cell(cell, seed, seconds, False, device=device,
                                   control=tf32)
            row = {k: c["value"] for k, c in line["compared"].items()}
            row.update(seed=seed, tf32=tf32, correct=line["correct"],
                       frames=notes["window_frames"])
            out.append(row)
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = before
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=6.0)
    p.add_argument("--tf32", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    rows = readings(args.workload, [int(s) for s in args.seeds.split(",")],
                    args.seconds, bool(args.tf32))
    keys = [k for k in rows[0] if k not in ("seed", "tf32", "correct",
                                            "frames")]
    pick = min if args.tf32 else max
    summary = dict(workload=args.workload, tf32=bool(args.tf32),
                   seeds=[r["seed"] for r in rows],
                   correct=[r["correct"] for r in rows],
                   **{k: pick(r[k] for r in rows) for k in keys})
    for r in rows + [summary]:
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
