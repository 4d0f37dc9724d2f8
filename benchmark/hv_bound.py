"""The K1 searches of one frame of a configuration with the global
hypothesis verification on, and their least time: the refinement's
(``bound.k1_launches``) and GO-HV's two, counted from the configuration
and the reply's own counts (``scene_points``, ``hv_instance_points``) with
valid queries and valid sources only, so that the count is the same
whatever implements K1."""
from __future__ import annotations

import functools

from benchmark.bound import k1_launches, knn_bound
from benchmark.reference import joint


@functools.lru_cache(maxsize=4)
def _view_capacity(n_chord: int, n_stub: int, seed: int, level: int,
                   resolution: int) -> int:
    model = joint.joint_model(dict(n_chord=n_chord, n_stub=n_stub, seed=seed))
    most = max(joint.render_view(model, T, resolution).shape[0]
               for T in joint.view_poses(model, level))
    size = 256
    while size < most:
        size *= 2
    return size


def view_capacity(bank: dict) -> int:
    """The lanes of a bank view: its largest rendered view rounded up to a
    power of two (at least 256), as ``build_bank`` pads them."""
    m = bank["model"]
    return _view_capacity(m["n_chord"], m["n_stub"], m["seed"],
                          bank["level"], bank["resolution"])


def hv_launches(det: dict, bank: dict, n_ws: int, n_inst: int):
    """(queries, sources, valid sources, batch entries) of every K1 search
    of one frame: the refinement's, then GO-HV's scene → instance search
    (one batch entry per hypothesis: the ``n_ws`` valid scene points
    against each instance's lanes, ``n_inst`` valid instance points in
    all) and its instance → scene search (the ``n_inst`` points folded
    into one launch against the working set)."""
    out = [(M, N, n, 1) for M, N, n in k1_launches(det, bank, n_ws)]
    out.append((n_ws, view_capacity(bank), n_inst, det["max_candidates"]))
    out.append((n_inst, det["scene_capacity"], n_ws, 1))
    return out


def hv_frame_ms(det: dict, bank: dict, n_ws: int, n_inst: int) -> float:
    """The least time of one frame's K1 work, ms."""
    return sum(knn_bound(M, N, n, 1, B)[0]
               for M, N, n, B in hv_launches(det, bank, n_ws, n_inst))
