"""The harness's copy of ``chip_smoke.py::_bound`` gives the same least
times, at the same published peaks."""
import importlib.util

import pytest

from benchmark import bound
from benchmark.cells import ROOT


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_copy",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("M,N,n_valid,k,B", [
    (8192, 2560, 900, 1, 1), (40960, 2048, 2048, 1, 1),
    (8192, 2560, 7000, 1, 8), (2048, 2048, 1600, 16, 1), (16, 16, 1, 1, 1)])
def test_bound_equals_chip_smoke(M, N, n_valid, k, B):
    cs = _chip_smoke()
    assert bound.knn_bound(M, N, n_valid, k, B) == cs._bound(M, N, n_valid, k, B)
    assert (bound.FP32_FLOPS, bound.HBM_BYTES_PER_S) == (cs.FP32_FLOPS,
                                                         cs.HBM_BYTES_PER_S)


def test_k1_launches_of_a_frame():
    """18 K1 searches a frame (16 ICP, 2 coverage) for the organized chain's
    three tier-1 view iterations, the count the card's profiler showed
    (PERF.md); the coverage searches count the working set's valid points,
    not the lanes it is padded to."""
    import json

    from benchmark.cells import HERE

    org = json.loads((HERE / "configs" / "joint_organized.json").read_text())
    det, bank = org["detection"], org["bank"]
    launches = bound.k1_launches(det, bank, 900)
    assert len(launches) == 18
    cov = [m for m, n, v in launches if n == v]
    assert cov == [det["max_candidates"] * 900, det["refine_top"] * 900]
