"""Port parity, neighbour search: kernel K1's plain version against the
Pallas kernel (interpret mode) and k>1 ``knn`` / ``radius_neighbors``
against ``bruteforce.knn`` on the CPU. K1 itself is checked against its
plain version on the card by ``tests/test_torch_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_joints.neighbors import knn as jknn
from tpu_joints.neighbors import radius_neighbors as jradius
from tpu_joints.neighbors.pallas_knn import knn_pallas
from tpu_joints_torch.neighbors import pallas_knn as k1
from tpu_joints_torch.neighbors.bruteforce import knn, radius_neighbors
from tpu_joints_torch.neighbors.knn_cases import CASES

SHAPES = [(100, 300), (256, 2048), (70, 100)]


def _points(M, N, seed, masked=0.25):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(M, 3)).astype(np.float32)
    s = rng.normal(size=(N, 3)).astype(np.float32)
    m = rng.uniform(size=N) >= masked
    return q, s, m


def _kernel_contract(q, s, m):
    """K1's arithmetic in numpy, op by op: ((dx²+dy²)+dz²)+pen in float32,
    first minimum in source order, (3e38, 0) without a valid source."""
    d = [q[:, i:i + 1] - s[None, :, i] for i in range(3)]
    pen = np.where(m, np.float32(0.0), np.float32(3e38))
    dist = ((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]) + pen
    i = dist.argmin(1)
    v = dist[np.arange(len(q)), i]
    take = v < np.float32(3e38)
    return (np.where(take, v, np.float32(3e38))[:, None],
            np.where(take, i, 0).astype(np.int32)[:, None])


@pytest.mark.parametrize("shape", SHAPES + [(64, 256, 1.0)])
def test_nn1_plain_matches_pallas_interpret(shape):
    """Indices equal the Pallas kernel's. Distances equal the kernel
    contract exactly; against the interpreted Pallas kernel they differ by
    at most 1 ulp (measured), because XLA's CPU backend contracts the
    Pallas body into fused multiply-adds, fma(dz, dz, fma(dx, dx, dy·dy)),
    while the CUDA kernel (built with --fmad=false) and its plain version
    round every product — so the check against Pallas is 2 ulp (rtol
    2**-22), not bit equality."""
    M, N = shape[:2]
    q, s, m = _points(M, N, M + N, masked=shape[2] if len(shape) > 2 else 0.25)
    d, i = k1.nn1_reference(torch.from_numpy(q), torch.from_numpy(s),
                            torch.from_numpy(m))
    dc, ic = _kernel_contract(q, s, m)
    np.testing.assert_array_equal(d.numpy(), dc)
    np.testing.assert_array_equal(i.numpy(), ic)
    dp, ip = knn_pallas(jnp.asarray(q), jnp.asarray(s), 1,
                        source_mask=jnp.asarray(m), tm=64, tn=256,
                        interpret=True)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ip))
    np.testing.assert_allclose(d.numpy(), np.asarray(dp), rtol=2.0 ** -22,
                               atol=0)
    if not m.any():
        assert (d.numpy() >= 1e30).all() and (i.numpy() == 0).all()


@pytest.mark.parametrize("case", sorted(set(CASES) - {"fewer_than_k"}))
def test_nn1_plain_on_split_stressing_orders(case):
    """K1's plain version on the orders, ties and sizes that stress a
    source sweep split over lanes and merged (sources approaching every
    query in scan order, all distances tied, a masked twin before its valid
    copy, N = 1, N = 33; N < k cannot happen at k = 1): equal to the kernel
    contract exactly, and to the Pallas kernel (interpret mode) in indices
    and within 2 ulp in distances, as in
    ``test_nn1_plain_matches_pallas_interpret``."""
    q, s, m = CASES[case](1)
    d, i = k1.nn1_reference(torch.from_numpy(q), torch.from_numpy(s),
                            torch.from_numpy(m))
    dc, ic = _kernel_contract(q, s, m)
    np.testing.assert_array_equal(d.numpy(), dc)
    np.testing.assert_array_equal(i.numpy(), ic)
    dp, ip = knn_pallas(jnp.asarray(q), jnp.asarray(s), 1,
                        source_mask=jnp.asarray(m), tm=64, tn=256,
                        interpret=True)
    np.testing.assert_array_equal(ic, np.asarray(ip))
    np.testing.assert_allclose(dc, np.asarray(dp), rtol=2.0 ** -22, atol=0)
    expect = {"scan_approach": len(s) - 1, "all_identical": 0,
              "masked_twin": 2 * np.arange(len(q)) + 1}
    if case in expect:
        np.testing.assert_array_equal(ic[:, 0], expect[case])


def test_knn_k1_dispatches_to_nn1_by_device():
    q, s, m = _points(50, 80, 3)
    before = k1.nn1.launches
    d, i = knn(torch.from_numpy(q), torch.from_numpy(s), 1,
               source_mask=torch.from_numpy(m))
    dr, ir = k1.nn1_reference(torch.from_numpy(q), torch.from_numpy(s),
                              torch.from_numpy(m))
    assert k1.nn1.launches == before          # CPU tensors: plain version
    np.testing.assert_array_equal(d.numpy(), dr.numpy())
    np.testing.assert_array_equal(i.numpy(), ir.numpy())


def test_nn1_rejects_bad_inputs():
    q = torch.zeros(4, 3)
    with pytest.raises(ValueError):
        k1.nn1(torch.zeros(4, 2), q)
    with pytest.raises(TypeError):
        k1.nn1(q.double(), q.double())
    with pytest.raises(ValueError):
        k1.nn1(q, q, torch.ones(3, dtype=torch.bool))


def _sets_equal(a, b, valid):
    return all(set(x[v]) == set(y[v]) for x, y, v in zip(a, b, valid))


@pytest.mark.parametrize("k", [4, 16, 96])
@pytest.mark.parametrize("shape", SHAPES + [(512, 2560)])
def test_knn_matches_bruteforce(k, shape):
    """Index sets equal to XLA's ``bruteforce.knn`` path. Distances: k = 96
    stays on the port's sort path, which expands |q|²+|s|²−2q·s as XLA
    does, with the 3-D squared norms as XLA's chained FMAs
    (``core.ops.fused_sumsq``): within rtol 1e-5 (measured bit-equal; with
    plain products the two sat up to 4e-6 apart). k = 4 and 16 go to
    kernel K2, which takes the TPU kernel's difference form, so there the
    distances are held to the Pallas kernel (interpret mode) — the path the
    JAX package takes for these k on its device — within 2 ulp (see
    ``test_nn1_plain_matches_pallas_interpret``); against XLA's expansion
    they differ by its cancellation error (measured up to 1.8e-6 absolute
    at d ≈ 0.03 for |q|² ≈ 3). No k-th-place near-tie broke set equality
    on these inputs (0 rows)."""
    M, N = shape
    if k > N:
        pytest.skip("k > N")
    q, s, m = _points(M, N, 7 * k + M)
    dj, ij = jknn(jnp.asarray(q), jnp.asarray(s), k, source_mask=jnp.asarray(m),
                  allow_pallas=False)
    dt, it = knn(torch.from_numpy(q), torch.from_numpy(s), k,
                 source_mask=torch.from_numpy(m))
    dj, ij = np.asarray(dj), np.asarray(ij)
    valid = dj < 1e30
    np.testing.assert_array_equal(dt.numpy() < 1e30, valid)
    assert _sets_equal(ij, it.numpy(), valid)
    if k <= k1.MAX_K:
        dp, ip = knn_pallas(jnp.asarray(q), jnp.asarray(s), k,
                            source_mask=jnp.asarray(m), tm=64, tn=256,
                            interpret=True)
        assert _sets_equal(np.asarray(ip), it.numpy(), valid)
        np.testing.assert_allclose(dt.numpy(), np.sort(np.asarray(dp), 1),
                                   rtol=2.0 ** -22, atol=0)
    else:
        np.testing.assert_allclose(dt.numpy()[valid], dj[valid], rtol=1e-5,
                                   atol=1e-6)
    assert (np.diff(dt.numpy(), axis=1) >= 0).all()   # ascending


def test_knn_rows_with_few_valid_sources_pad_like_jax():
    q, s, m = _points(20, 40, 5)
    m[:] = False
    m[[3, 17]] = True
    dj, ij = jknn(jnp.asarray(q), jnp.asarray(s), 5, source_mask=jnp.asarray(m),
                  allow_pallas=False)
    dt, it = knn(torch.from_numpy(q), torch.from_numpy(s), 5,
                 source_mask=torch.from_numpy(m))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5)


def test_radius_neighbors_k96_matches():
    rng = np.random.default_rng(4)
    s = rng.uniform(-0.2, 0.2, size=(2560, 3)).astype(np.float32)
    q = s[rng.choice(2560, 512, replace=False)]
    m = rng.uniform(size=2560) > 0.1
    ij, vj, dj = jradius(jnp.asarray(q), jnp.asarray(s), 0.06, 96,
                         source_mask=jnp.asarray(m))
    it, vt, dt = radius_neighbors(torch.from_numpy(q), torch.from_numpy(s),
                                  0.06, 96, source_mask=torch.from_numpy(m))
    vj = np.asarray(vj)
    np.testing.assert_array_equal(vt.numpy(), vj)
    assert _sets_equal(np.asarray(ij), it.numpy(), vj)
    np.testing.assert_allclose(dt.numpy()[vj], np.asarray(dj)[vj], rtol=1e-5,
                               atol=1e-7)
