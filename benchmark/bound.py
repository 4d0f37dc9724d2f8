"""Least times on one H100 from the work an algorithm needs, at the published
peaks (NVIDIA's data sheet, SXM part, 700 W): a copy of ``chip_smoke.py``'s
``_bound`` and its peaks, and the launches of kernel K1 (the exact k = 1
nearest-neighbour search) that a detection's refinement runs, counted from
the configuration."""
from __future__ import annotations

FP32_FLOPS = 67e12          # fp32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12   # HBM3


def knn_bound(M, N, n_valid, k, B=1):
    """(ms, what bounds it): the least time for an exact kNN of M queries
    over N sources of which n_valid are valid (with B batch entries: M
    queries and N sources per entry, n_valid the valid sources of all
    entries together, each searched by its entry's M queries) — each input
    read once (query xyz, the N mask bytes and the valid sources' xyz,
    float32), each output written once (float32 + int32 per slot), 9 fp32
    flops per (query, valid source) pair for the difference-form distance."""
    t_bytes = (B * (12 * M + N + 8 * M * k) + 12 * n_valid) / HBM_BYTES_PER_S
    t_ops = 9 * M * n_valid / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


# the bank keeps at most this many CAD points (``build_bank``)
CAD_POINTS = 8192


def k1_launches(det: dict, bank: dict, n_ws: int):
    """The K1 searches of one frame's two-tier refinement, as (queries,
    sources, valid sources), counted from the algorithm: the ICP iterations
    and their fitness searches of CAD rows against the working set (``n_ws``
    valid points of ``scene_capacity`` lanes), and the two coverage
    searches of the working set's valid points (each candidate's) against
    CAD rows. The lanes the program pads to are not work."""
    C, S = det["max_candidates"], det["scene_capacity"]
    Ni, R = bank["icp_capacity"], det["refine_top"]
    stride = max(1, Ni // det["tier1_rows"])
    rows = (Ni + stride - 1) // stride
    view_iters = det["tier1_view_iterations"] or det["tier1_iterations"] \
        or det["icp_iterations"]
    polish_iters = det["tier1_polish_iterations"] or min(
        det["tier1_iterations"], det["final_icp_iterations"]) \
        or det["final_icp_iterations"]
    fit = 0 if det["tier1_skip_view_fitness"] else 1
    out = [(C * (Ni // stride), S, n_ws)] * (view_iters + fit)
    out += [(C * rows, S, n_ws)] * (polish_iters + 1)
    cov1 = min(CAD_POINTS, 2048)
    out += [(C * n_ws, cov1, cov1)]
    out += [(R * Ni, S, n_ws)] * (det["final_icp_iterations"] + 1)
    cov2 = min(CAD_POINTS, max(4096, Ni))
    out += [(R * n_ws, cov2, cov2)]
    return out


def k1_frame_ms(det: dict, bank: dict, n_ws: int) -> float:
    """The least time of one frame's K1 work, ms."""
    return sum(knn_bound(M, N, n, 1)[0] for M, N, n in
               k1_launches(det, bank, n_ws))


def k1_frame_flops(det: dict, bank: dict, n_ws: int) -> float:
    """The operations of one frame's K1 searches."""
    return sum(9.0 * M * n for M, _, n in k1_launches(det, bank, n_ws))


def match_flops(det: dict, bank: dict, n_views: int, desc_dim: int) -> float:
    """The operations of the descriptor match: one [keys, D] × [D, views ·
    bank keys] product."""
    return 2.0 * det["scene_key_capacity"] * desc_dim * n_views \
        * bank["key_capacity"]


# descriptor lengths: SHOT-352 and FPFH-33
DESC_DIM = {"shot": 352, "fpfh": 33}


def n_views(level: int) -> int:
    """Views of an icosphere bank: its vertices at subdivision ``level``."""
    return 10 * 4 ** level + 2
