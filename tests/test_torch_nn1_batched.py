"""Port parity, kernel K1's batch mode: its plain version against B plain
unbatched searches (bit for bit) and against ``jax.vmap`` of the Pallas
kernel in interpret mode (indices equal, distances within 2 ulp: XLA's CPU
backend contracts the Pallas body into fused multiply-adds, see
``tests/test_torch_knn.py``). The kernel itself is held to its plain
version on the card by ``tests/test_torch_cuda.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_joints.neighbors.pallas_knn import knn_pallas
from tpu_joints_torch.neighbors import pallas_knn as k1
from tpu_joints_torch.neighbors.bruteforce import knn, knn_batched
from tpu_joints_torch.neighbors.knn_cases import batches

CASES = sorted(set(batches()) - {"rows_fill_the_card"})


def _case(name):
    return tuple(torch.from_numpy(a) for a in batches()[name])


@pytest.mark.parametrize("name", sorted(batches()))
def test_nn1_batched_plain_equals_unbatched(name):
    """B plain K1 searches, stacked: bit-equal; the wrapper takes the plain
    version on CPU tensors and ``knn_batched`` routes k = 1 to it."""
    q, s, m = _case(name)
    d, i = k1.nn1_batched_reference(q, s, m)
    assert d.shape == i.shape == (*q.shape[:2], 1)
    assert d.dtype == torch.float32 and i.dtype == torch.int32
    for b in range(q.shape[0]):
        db, ib = k1.nn1_reference(q[b], s[b], m[b])
        assert torch.equal(d[b], db) and torch.equal(i[b], ib), b
    before = k1.nn1_batched.launches
    for fn in (k1.nn1_batched, lambda *a: knn_batched(a[0], a[1], 1, a[2])):
        dw, iw = fn(q, s, m)
        assert torch.equal(dw, d) and torch.equal(iw, i)
    assert k1.nn1_batched.launches == before       # no kernel on the CPU
    empty = ~m.any(1)
    assert bool((d[empty] >= 1e30).all()) and bool((i[empty] == 0).all())


@pytest.mark.parametrize("name", CASES)
def test_nn1_batched_plain_matches_vmapped_pallas(name):
    q, s, m = batches()[name]
    d, i = k1.nn1_batched_reference(*_case(name))

    def one(qb, sb, mb):
        return knn_pallas(qb, sb, 1, source_mask=mb, tm=64, tn=256,
                          interpret=True)

    dp, ip = jax.vmap(one)(jnp.asarray(q), jnp.asarray(s), jnp.asarray(m))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ip))
    np.testing.assert_allclose(d.numpy(), np.asarray(dp), rtol=2.0 ** -22,
                               atol=0)


def test_nn1_batched_defaults_and_checks():
    q, s, m = _case("masks_differ")
    d, i = k1.nn1_batched(q, s)                    # no mask: all valid
    dr, ir = k1.nn1_batched(q, s, torch.ones_like(m))
    assert torch.equal(d, dr) and torch.equal(i, ir)
    d0, i0 = k1.nn1_batched(q[:0], s[:0], m[:0])
    assert d0.shape == (0, q.shape[1], 1) and i0.dtype == torch.int32
    for bad in ((q[0], s, m), (q, s[:2], m[:2]), (q, s, m[:, :5]),
                (q.double(), s, m), (q, s, m.float())):
        with pytest.raises((ValueError, TypeError)):
            k1.nn1_batched(*bad)


def test_knn_batched_expansion_form_matches_per_entry():
    """k > 1 (the k_max support gather of a batch of frames): each entry
    equals the unbatched search, indices exactly, distances within 1e-6
    (the batched product may round the last bit differently)."""
    from tpu_joints_torch.neighbors.bruteforce import knn, radius_neighbors

    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.normal(size=(3, 40, 3)).astype(np.float32))
    s = torch.from_numpy(rng.normal(size=(3, 200, 3)).astype(np.float32))
    m = torch.from_numpy(rng.uniform(size=(3, 200)) > 0.2)
    d, i = knn_batched(q, s, 48, m)
    idx, within, dist = radius_neighbors(q, s, 0.8, 48, m)
    for b in range(3):
        db, ib = knn(q[b], s[b], 48, m[b])
        assert torch.equal(i[b], ib)
        np.testing.assert_allclose(d[b].numpy(), db.numpy(), atol=1e-6)
        jb, wb, _ = radius_neighbors(q[b], s[b], 0.8, 48, m[b])
        assert torch.equal(idx[b], jb) and torch.equal(within[b], wb)


@pytest.mark.parametrize("k", [2, 16, 32])
def test_knn_batched_refuses_k2_orders(k):
    """``knn`` sends a 3-D search with 2 <= k <= 32 to K2's difference form;
    K2 has no batch mode, so the batched search takes K2 entry by entry and
    equals B ``knn`` calls exactly, never another form. Other widths keep
    the expansion form at any k."""
    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.normal(size=(2, 8, 3)).astype(np.float32))
    s = torch.from_numpy(rng.normal(size=(2, 40, 3)).astype(np.float32))
    m = torch.from_numpy(rng.uniform(size=(2, 40)) > 0.3)
    for mask in (None, m):
        d, i = knn_batched(q, s, k, source_mask=mask)
        for b in range(2):
            db, ib = knn(q[b], s[b], k,
                         source_mask=None if mask is None else mask[b])
            assert torch.equal(d[b], db) and torch.equal(i[b], ib)
    q4, s4 = torch.cat([q, q[..., :1]], -1), torch.cat([s, s[..., :1]], -1)
    d, i = knn_batched(q4, s4, k)
    assert d.shape == (2, 8, k) and i.dtype == torch.int32
