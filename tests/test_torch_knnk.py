"""Port parity, kernel K2 (exact 3-D k nearest valid sources, 2 <= k <= 32):
its plain version against the Pallas kernel (interpret mode) and against a
numpy statement of the contract, the device dispatch and ``knn``'s routing.
K2 itself is checked against its plain version on the card by
``tests/test_torch_cuda.py``."""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_joints.neighbors.pallas_knn import knn_pallas
from tpu_joints_torch.core.cloud import SENTINEL
from tpu_joints_torch.neighbors import bruteforce
from tpu_joints_torch.neighbors import pallas_knn as pk
from tpu_joints_torch.neighbors.knn_cases import CASES

# (M, N, masked share): masked sources, M and N off the Pallas tiles, all
# sources masked, and N < k for the larger k
SHAPES = [(100, 300, 0.25), (70, 100, 0.25), (64, 256, 1.0), (40, 10, 0.25),
          (256, 2048, 0.0)]


def _points(M, N, seed, masked):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(M, 3)).astype(np.float32)
    s = rng.normal(size=(N, 3)).astype(np.float32)
    m = rng.uniform(size=N) >= masked
    return q, s, m


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _contract(q, s, m, k):
    """K2's contract in numpy: ((dx²+dy²)+dz²)+pen rounded op by op in
    float32, the k smallest per row in ascending order with ties to the
    lowest source index, (3e38, 0) in slots without a valid source."""
    d = [q[:, i:i + 1] - s[None, :, i] for i in range(3)]
    pen = np.where(m, np.float32(0.0), np.float32(3e38))
    dist = ((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]) + pen
    order = np.argsort(dist, axis=1, kind="stable")[:, :k]
    v = np.take_along_axis(dist, order, 1)
    if v.shape[1] < k:
        pad = k - v.shape[1]
        v = np.concatenate([v, np.full((len(q), pad), 3e38, np.float32)], 1)
        order = np.concatenate([order, np.zeros((len(q), pad), np.int64)], 1)
    take = v < np.float32(3e38)
    return (np.where(take, v, np.float32(3e38)),
            np.where(take, order, 0).astype(np.int32))


@pytest.mark.parametrize("k", [2, 8, 16, 32])
@pytest.mark.parametrize("shape", SHAPES)
def test_knnk_plain_matches_pallas_interpret(k, shape):
    """Index sets equal the Pallas kernel's in every slot with a valid
    source; distances within 2 ulp (rtol 2**-22) after sorting the Pallas
    kernel's unsorted best-list: XLA's CPU backend contracts the
    interpreted body into fused multiply-adds while K2 (built with
    --fmad=false) and its plain version round every product (see
    ``test_nn1_plain_matches_pallas_interpret``). Empty slots are
    (3e38, 0) in both."""
    M, N, masked = shape
    q, s, m = _points(M, N, 31 * k + M + N, masked)
    d, i = pk.knnk_reference(_t(q), _t(s), k, _t(m))
    assert d.shape == i.shape == (M, k)
    assert d.dtype == torch.float32 and i.dtype == torch.int32
    dp, ip = knn_pallas(jnp.asarray(q), jnp.asarray(s), k,
                        source_mask=jnp.asarray(m), tm=64, tn=256,
                        interpret=True)
    dp, ip = np.asarray(dp), np.asarray(ip)
    order = np.argsort(dp, axis=1, kind="stable")
    dp, ip = np.take_along_axis(dp, order, 1), np.take_along_axis(ip, order, 1)
    d, i = d.numpy(), i.numpy()
    valid = dp < 1e30
    np.testing.assert_array_equal(d < 1e30, valid)
    assert valid.sum(1).max() <= min(k, int(m.sum()))
    for r in range(M):
        assert set(i[r][valid[r]]) == set(ip[r][valid[r]]), r
    np.testing.assert_allclose(d, dp, rtol=2.0 ** -22, atol=0)
    assert (i[~valid] == 0).all() and (d[~valid] == np.float32(3e38)).all()
    if not m.any():
        assert not valid.any()


@pytest.mark.parametrize("k", [2, 5, 16, 30, 32])
@pytest.mark.parametrize("shape", [(100, 300, 0.25), (40, 10, 0.0),
                                   (33, 64, 1.0)])
def test_knnk_plain_matches_contract(k, shape):
    """Exactly the numpy contract: same distances bit for bit, same indices
    in the same (ascending) order — with duplicated source points, so that
    exact ties must go to the lowest index."""
    M, N, masked = shape
    q, s, m = _points(M, N, 7 * k + N, masked)
    s[N // 2:N // 2 + 4] = s[1]              # exact ties with source 1
    q[0] = s[1]                              # ... at distance 0
    d, i = pk.knnk_reference(_t(q), _t(s), k, _t(m))
    dc, ic = _contract(q, s, m, k)
    np.testing.assert_array_equal(d.numpy(), dc)
    np.testing.assert_array_equal(i.numpy(), ic)
    assert (np.diff(d.numpy(), axis=1) >= 0).all()


@pytest.mark.parametrize("k", [2, 16, 32])
@pytest.mark.parametrize("case", sorted(CASES))
def test_knnk_plain_on_split_stressing_orders(case, k):
    """The orders, ties and sizes that stress a source sweep split over
    lanes and merged (sources approaching every query in scan order, all
    distances tied, a masked twin before its valid copy, N = 1, N < k,
    N = 33): the plain version equals the numpy contract exactly, and its
    index sets equal the Pallas kernel's (interpret mode) with distances
    within 2 ulp, as in ``test_knnk_plain_matches_pallas_interpret``."""
    q, s, m = CASES[case](k)
    d, i = pk.knnk_reference(_t(q), _t(s), k, _t(m))
    dc, ic = _contract(q, s, m, k)
    np.testing.assert_array_equal(d.numpy(), dc)
    np.testing.assert_array_equal(i.numpy(), ic)
    dp, ip = knn_pallas(jnp.asarray(q), jnp.asarray(s), k,
                        source_mask=jnp.asarray(m), tm=64, tn=256,
                        interpret=True)
    dp, ip = np.asarray(dp), np.asarray(ip)
    order = np.argsort(dp, axis=1, kind="stable")
    dp, ip = np.take_along_axis(dp, order, 1), np.take_along_axis(ip, order, 1)
    valid = dp < 1e30
    np.testing.assert_array_equal(dc < 1e30, valid)
    for r in range(len(q)):
        assert set(ic[r][valid[r]]) == set(ip[r][valid[r]]), r
    np.testing.assert_allclose(dc, dp, rtol=2.0 ** -22, atol=0)
    if case == "all_identical":
        np.testing.assert_array_equal(ic, np.broadcast_to(np.arange(k), ic.shape))
    if case == "scan_approach":                 # the last k sources, nearest first
        np.testing.assert_array_equal(ic[:, 0], len(s) - 1)
    if case == "masked_twin":
        np.testing.assert_array_equal(ic[:, 0], 2 * np.arange(len(q)) + 1)
        assert (dc[:, 0] == 0).all()


@pytest.mark.parametrize("k", [1, 2, 16, 30, 32])
@pytest.mark.parametrize("shape", [(100, 300, 0.25), (64, 256, 1.0),
                                   (40, 10, 0.25)])
def test_knn_pallas_matches_the_tpu_kernel(k, shape):
    """The port's ``knn_pallas`` (the TPU kernel's entry: K1 at k = 1, K2
    above) on CPU tensors against the JAX package's in interpret mode, with
    masked sources, rows with no valid source and N < k: its distances and
    indices equal its plain version's bit for bit; the Pallas kernel's
    best-list, put in the contract's order (its indices by the contract's
    distance, ties to the lowest index), has the same indices in every
    slot, and distances within 2 ulp (the interpreted body's fused
    multiply-adds, see ``test_knnk_plain_matches_pallas_interpret``)."""
    M, N, masked = shape
    q, s, m = _points(M, N, 11 * k + M + N, masked)
    d, i = pk.knn_pallas(_t(q), _t(s), k, _t(m))
    dr, ir = (pk.nn1_reference(_t(q), _t(s), _t(m)) if k == 1
              else pk.knnk_reference(_t(q), _t(s), k, _t(m)))
    assert d.shape == i.shape == (M, k)
    assert torch.equal(d, dr) and torch.equal(i, ir)
    dp, ip = knn_pallas(jnp.asarray(q), jnp.asarray(s), k,
                        source_mask=jnp.asarray(m), tm=64, tn=256,
                        interpret=True)
    dp, ip = np.asarray(dp), np.asarray(ip)
    full = [q[:, c:c + 1] - s[None, :, c] for c in range(3)]
    pen = np.where(m, np.float32(0.0), np.float32(3e38))
    full = ((full[0] * full[0] + full[1] * full[1]) + full[2] * full[2]) + pen
    valid = dp < 1e30
    key = np.where(valid, np.take_along_axis(full, ip, 1), np.inf)
    order = np.lexsort((ip, key), axis=1)
    ip = np.take_along_axis(ip, order, 1)
    dp = np.take_along_axis(dp, order, 1)
    np.testing.assert_array_equal(i.numpy(), ip)
    np.testing.assert_array_equal(d.numpy() < 1e30, dp < 1e30)
    np.testing.assert_allclose(d.numpy(), dp, rtol=2.0 ** -22, atol=0)
    if not m.any():
        assert (i.numpy() == 0).all() and (d.numpy() == np.float32(3e38)).all()


def test_knn_pallas_takes_1_to_32(monkeypatch):
    """k outside 1..32 raises, as the TPU kernel's callers never send it;
    the TPU tiling and interpret mode are accepted; without a card
    ``pallas_available`` is false and builds nothing."""
    q = torch.zeros(4, 3)
    for k in (0, 33):
        with pytest.raises(ValueError, match="1 <= k <= 32"):
            pk.knn_pallas(q, q, k)
    d, i = pk.knn_pallas(q, q, 1, tm=8, tn=16, interpret=True)
    assert d.shape == i.shape == (4, 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(pk, "build_all", lambda: pytest.fail("built"))
    assert pk.pallas_available() is False


def test_build_key_covers_shared_headers(tmp_path, monkeypatch):
    """Editing a header under csrc/ changes every kernel's build key, so a
    stale library in _build/ is never loaded for a changed header."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in pk._CSRC.iterdir():
        if f.suffix in (".cu", ".cuh"):
            (csrc / f.name).write_bytes(f.read_bytes())
    headers = sorted(csrc.glob("*.cuh"))
    assert headers
    key = {n: pk._library_path(n) for n in pk._ENTRY}
    monkeypatch.setattr(pk, "_CSRC", csrc)
    assert key == {n: pk._library_path(n) for n in pk._ENTRY}
    headers[0].write_text(headers[0].read_text() + "\n// edited\n")
    after = {n: pk._library_path(n) for n in pk._ENTRY}
    assert all(key[n] != after[n] for n in pk._ENTRY)
    assert all(p.parent == pk._BUILD_DIR for p in after.values())


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("argv", [[], ["--against", "somewhere"]])
def test_chip_smoke_needs_a_card(monkeypatch, argv):
    """The smoke and its comparison with another version's kernels run on
    a CUDA card only: without one they raise before building anything."""
    smoke = _chip_smoke()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.argv", ["chip_smoke.py", *argv])
    with pytest.raises(RuntimeError, match="CUDA device"):
        smoke.main()


def test_chip_smoke_bound_counts_valid_sources_only():
    """The bound's operations are 9 flops per (query, valid source) pair:
    masked sources cost the mask byte only, which a kernel that drops them
    while staging also pays."""
    bound = _chip_smoke()._bound
    ms, by = bound(16384, 16384, 8073, 30)
    assert by == "operations"
    assert ms == pytest.approx(9 * 16384 * 8073 / 67e12 * 1e3)
    assert bound(16384, 16384, 16384, 30)[0] > 2 * ms
    ms0, by0 = bound(64, 256, 0, 8)
    assert by0 == "bytes"
    assert ms0 == pytest.approx((12 * 64 + 256 + 8 * 64 * 8) / 3.35e12 * 1e3)


def test_knnk_keeps_valid_sentinel_sources_and_drops_masked_ones():
    """A valid source at the padding sentinel (d ≈ 3e12, below 3e38) is a
    neighbour like any other, as in the TPU kernel; a masked one never is,
    however near."""
    q = np.zeros((2, 3), np.float32)
    s = np.array([[0.1, 0, 0], [SENTINEL] * 3, [0, 0, 0], [0.2, 0, 0]],
                 np.float32)
    m = np.array([True, True, False, True])
    d, i = pk.knnk_reference(_t(q), _t(s), 4, _t(m))
    np.testing.assert_array_equal(i.numpy(), [[0, 3, 1, 0]] * 2)
    assert 1e12 < float(d[0, 2]) < 1e13 and float(d[0, 3]) == np.float32(3e38)


def test_knnk_dispatches_by_device():
    """CPU tensors take the plain version: no kernel launch, same result."""
    q, s, m = _points(50, 80, 3, 0.25)
    before = pk.knnk.launches
    d, i = pk.knnk(_t(q), _t(s), 6, _t(m))
    dk, ik = bruteforce.knn(_t(q), _t(s), 6, source_mask=_t(m))
    dr, ir = pk.knnk_reference(_t(q), _t(s), 6, _t(m))
    assert pk.knnk.launches == before
    for a, b in ((d, dr), (i, ir), (dk, dr), (ik, ir)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("k,D,routed", [(1, 3, False), (2, 3, True),
                                        (32, 3, True), (33, 3, False),
                                        (96, 3, False), (2, 352, False)])
def test_knn_routes_2_to_32_in_3d_to_knnk(monkeypatch, k, D, routed):
    """``knn`` sends D = 3 with 2 <= k <= 32 to K2 and nothing else: k = 1
    goes to K1, larger k and descriptor space to the sort path."""
    calls = []

    def spy(*args, **kwargs):
        calls.append(args[2])
        return pk.knnk(*args, **kwargs)

    monkeypatch.setattr(bruteforce, "knnk", spy)
    rng = np.random.default_rng(k + D)
    q = _t(rng.normal(size=(20, D)).astype(np.float32))
    s = _t(rng.normal(size=(120, D)).astype(np.float32))
    d, i = bruteforce.knn(q, s, k)
    assert calls == ([k] if routed else [])
    assert d.shape == i.shape == (20, k)


def test_knnk_rejects_bad_inputs():
    q = torch.zeros(4, 3)
    for k in (0, 1, 33):
        with pytest.raises(ValueError):
            pk.knnk(q, q, k)
    with pytest.raises(ValueError):
        pk.knnk(torch.zeros(4, 2), q, 4)
    with pytest.raises(TypeError):
        pk.knnk(q.double(), q.double(), 4)
    with pytest.raises(ValueError):
        pk.knnk(q, q, 4, torch.ones(3, dtype=torch.bool))
    with pytest.raises(ValueError):
        pk.knnk(q, torch.zeros(0, 3), 4)
    with pytest.raises(ValueError):
        pk.knnk(q.to("meta"), q.to("meta"), 4)     # neither CPU nor CUDA
