"""GO-HV's greedy search as the CUDA kernel ``hv_greedy`` runs it, held on
the CPU to the plain version ``recognize/hv.py::_greedy_verify``.

The kernel does not price a flip with a [H, Ns] product: it keeps the
covered and exactly-once points as 32-point bit words, the covered count
C, the cover sum S and the outlier sum O as integers, counts a flip's
change with ``popc(ex_h & ~covered)`` (on) or ``popc(ex_h & once)`` (off),
and rebuilds ``_cost``'s float32 expression ``(-C + λ_out·O) + λ_mult·(S −
C)`` from those counts. These tests hold that identity bit for bit, and an
emulation of the kernel's whole search (the same words, counts, float32
operations, first minimum and margin) to ``_greedy_verify``'s verdicts on
every case of ``recognize/hv_cases.py``. The kernel itself is held to the
plain version on the card (``tests/test_torch_cuda.py``)."""
import numpy as np
import pytest
import torch

from tpu_joints_torch.recognize import hv as thv
from tpu_joints_torch.recognize import hv_cases

CASES = hv_cases.cases()
LO, LM = np.float32(hv_cases.LAMBDA_OUT), np.float32(hv_cases.LAMBDA_MULT)
MARGIN = np.float32(1e-6)


def _pack(ex):
    """bool[H, Ns] -> uint32[H, ceil(Ns / 32)], bit i of word w = point
    32w + i (the kernel's layout)."""
    H, Ns = ex.shape
    W = (Ns + 31) // 32
    padded = np.zeros((H, 32 * W), bool)
    padded[:, :Ns] = ex
    return np.packbits(padded, axis=1, bitorder="little").view("<u4")


def _cost(C, O, M):
    """The kernel's rebuild, each float32 operation rounded on its own."""
    C, O, M = (np.asarray(x).astype(np.float32) for x in (C, O, M))
    return (-C + LO * O) + LM * M


def _popc(words):
    return np.bitwise_count(words).sum(-1, dtype=np.int64)


def counted_search(ex, outliers, valid):
    """The kernel's search in numpy on prepared inputs: (active, steps,
    improved, off) — ``off`` the moves that switched a hypothesis off."""
    H = ex.shape[0]
    words = _pack(ex)
    size = _popc(words)
    out = np.where(np.isfinite(outliers), outliers, 0).astype(np.float32)
    cov = np.zeros(words.shape[1], np.uint32)
    once = np.zeros_like(cov)
    act = np.zeros(H, bool)
    C = S = 0
    O = np.float32(0)
    cur = _cost(0, 0, 0)
    improved = off = 0
    for _ in range(2 * H):
        on = ~act
        n = _popc(words & np.where(on[:, None], ~cov, once))
        C2 = np.where(on, C + n, C - n)
        S2 = np.where(on, S + size, S - size)
        O2 = np.where(on, O + out, O - out).astype(np.float32)
        costs = np.where(valid, _cost(C2, O2, S2 - C2), _cost(C, O, S - C))
        j = int(np.argmin(costs))            # the first minimum
        if not costs[j] < np.float32(cur - MARGIN):
            continue
        C, S, O, cur = int(C2[j]), int(S2[j]), O2[j], costs[j]
        act[j] = on[j]
        improved += 1
        off += int(not on[j])
        cover = act.astype(np.int64) @ ex.astype(np.int64)
        cov = _pack(cover[None] >= 1)[0]
        once = _pack(cover[None] == 1)[0]
    return act, 2 * H, improved, off


def _prepared(name):
    return hv_cases.prepare(*CASES[name])


def _torch(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@pytest.mark.parametrize("name", sorted(CASES))
def test_counted_search_equals_greedy_verify(name):
    """The kernel's search from integer counts gives ``_greedy_verify``'s
    active set, steps and improving steps on every case."""
    ex, out, valid = _prepared(name)
    act, steps, improved, _ = counted_search(ex, out, valid)
    want = thv._greedy_verify(*_torch(ex, out, valid), hv_cases.LAMBDA_OUT,
                              hv_cases.LAMBDA_MULT)
    np.testing.assert_array_equal(act, want[0].numpy())
    assert (steps, improved) == (int(want[1]), int(want[2]))
    assert not act[~valid].any()


def test_the_cases_switch_a_hypothesis_off():
    """The switched-off union of ``hv_cases.union_dropped`` happens: every
    random case moves a hypothesis off at least once, so the kernel's
    recount branch is exercised wherever those cases run."""
    for H, Ns in hv_cases.SHAPES:
        ex, out, valid = _prepared(f"random_H{H}_N{Ns}")
        act, _, _, off = counted_search(ex, out, valid)
        assert off >= 1 and not act[0] and act[1] and act[2], (H, Ns)


def _patterns(H, rng):
    """Activation patterns: random ones, the empty set, every single bit,
    and every single flip of one random pattern (near ties)."""
    base = rng.uniform(size=H) < 0.3
    return np.concatenate([rng.uniform(size=(32, H)) < 0.25,
                           np.zeros((1, H), bool), np.eye(H, dtype=bool),
                           base[None] ^ np.eye(H, dtype=bool)])


@pytest.mark.parametrize("name", ["random_H24_N1000", "random_H48_N8192",
                                  "invalid_would_win", "outliers_decide",
                                  "margin_ties", "invalid_bit_ties"])
def test_cost_from_counts_equals_cost(name):
    """``_cost`` of each pattern equals ``(-C + λ_out·O) + λ_mult·(S − C)``
    built from integer counts in float32, bit for bit."""
    ex, out, valid = _prepared(name)
    rng = np.random.default_rng(len(name))
    pats = _patterns(ex.shape[0], rng) & valid[None]
    out_vec = np.where(np.isfinite(out), out, 0).astype(np.float32)
    want = thv._cost(*_torch(pats.astype(np.float32), ex.astype(np.float32),
                             out_vec), hv_cases.LAMBDA_OUT,
                     hv_cases.LAMBDA_MULT).numpy()
    cover = pats.astype(np.int64) @ ex.astype(np.int64)
    C, S = (cover >= 1).sum(1), cover.sum(1)
    O = pats.astype(np.int64) @ out_vec.astype(np.int64)
    got = _cost(C, O, S - C)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("name", ["random_H17_N1000", "random_H64_N16384",
                                  "outliers_decide"])
def test_flip_counts_from_bit_planes(name):
    """For random active sets, ``popc(ex_h & ~covered)`` is the covered
    count gained by switching h on and ``popc(ex_h & once)`` the count lost
    by switching it off, against counts recomputed from the bools."""
    ex, _, _ = _prepared(name)
    H = ex.shape[0]
    words = _pack(ex)
    ex_f = ex.astype(np.float32)        # covers up to H: exact in float32
    rng = np.random.default_rng(H)
    for act in _patterns(H, rng)[:40]:
        cover = act.astype(np.float32) @ ex_f
        cov, once = _pack(cover[None] >= 1)[0], _pack(cover[None] == 1)[0]
        flipped = act[None] ^ np.eye(H, dtype=bool)
        C = (cover >= 1).sum()
        C2 = ((flipped.astype(np.float32) @ ex_f) >= 1).sum(1)
        gained, lost = _popc(words & ~cov), _popc(words & once)
        np.testing.assert_array_equal(np.where(act, C - lost, C + gained), C2)


def test_hv_greedy_on_cpu_is_the_plain_search(monkeypatch):
    """On CPU tensors the wrapper is ``_greedy_verify`` (frame by frame
    under a batch axis) and launches nothing; ``_select_hypotheses`` sends
    H > 16 to it and H <= 16 to the exhaustive sweep."""
    frames = [_prepared(n) for n in ("random_H24_N8192", "invalid_would_win",
                                     "all_empty")]
    single = [thv._greedy_verify(*_torch(*f), 0.001, 1.0) for f in frames]
    batch = thv.hv_greedy(*_torch(*(np.stack(a) for a in zip(*frames))))
    for i, want in enumerate(single):
        for got, w in zip(batch, want):
            assert torch.equal(got[i], w)
    before = thv.hv_greedy.launches
    seen = []
    real = thv.hv_greedy
    monkeypatch.setattr(thv, "hv_greedy",
                        lambda *a: seen.append(a[0].shape) or real(*a))
    for name in ("random_H17_N1000", "invalid_bit_ties"):
        ex, out, valid = CASES[name]
        got = thv._select_hypotheses(*_torch(ex, out, valid))
        if ex.shape[0] > 16:
            want = thv._greedy_verify(*_torch(*_prepared(name)), 0.001, 1.0)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert seen == [(17, 1000)]
    assert real.launches == before


@pytest.mark.parametrize("bad", ["dtype", "outliers", "valid", "ndim"])
def test_hv_greedy_rejects_malformed_inputs(bad):
    ex, out, valid = _torch(*_prepared("random_H17_N1000"))
    if bad == "dtype":
        ex = ex.to(torch.uint8)
    elif bad == "outliers":
        out = out[:-1]
    elif bad == "valid":
        valid = valid.to(torch.int32)
    else:
        ex = ex[0]
    with pytest.raises(ValueError):
        thv.hv_greedy(ex, out, valid)
