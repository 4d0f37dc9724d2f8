"""Port parity, ``distributed/``: the JAX package's multi-device surface on
the suite's virtual 8-CPU mesh (``tests/conftest.py``) against the port's
on an 8-entry CPU mesh (``[torch.device("cpu")] * 8``), same numpy inputs
from a seed, and the port's mesh paths against its own single-device ones.

Tolerances are those of ``tests/test_distributed.py``, stated at each
test: ring kNN distances rtol 1e-5 / atol 1e-6 (indices through the
distances they select, as ties may order differently); bank-sharded vote
counts exact; ring ICP poses within 5e-4 and fitness within 1e-6 (of JAX's
ring ICP and of the port's single-device ``icp``); halo neighbour sets
equal and sorted distances rtol 1e-5 / atol 1e-7. The batch, the mesh
server and ``serve --devices`` are in ``test_torch_distributed_batch.py``.
"""
import contextlib
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.util import joint_points
from tpu_joints.distributed import (make_mesh as jmake_mesh,
                                    ring_icp as jring_icp,
                                    ring_knn as jring_knn,
                                    sharded_match_votes as jmatch_votes)
from tpu_joints.distributed import halo_radius_neighbors as jhalo
from tpu_joints_torch import distributed as tdist
from tpu_joints_torch.core.cloud import make_cloud
from tpu_joints_torch.neighbors import bruteforce as tbf
ticp = importlib.import_module("tpu_joints_torch.recognize.icp")

CPU8 = [torch.device("cpu")] * 8


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def meshes():
    """(JAX 4 x 2, port 4 x 2, JAX 1 x 8, port 1 x 8)."""
    assert len(jax.devices()) == 8
    return (jmake_mesh(8, model_parallel=2),
            tdist.make_mesh(devices=CPU8, model_parallel=2),
            jmake_mesh(8, model_parallel=8),
            tdist.make_mesh(devices=CPU8, model_parallel=8))


def test_mesh_shape(meshes):
    jm, tm, _, tm1 = meshes
    assert tm.shape == dict(jm.shape) == {"data": 4, "model": 2}
    assert tm1.shape == {"data": 1, "model": 8}
    assert tm.size == 8 and tm.axis_devices("model") == CPU8[:2]
    with pytest.raises(ValueError, match="model_parallel"):
        tdist.make_mesh(devices=CPU8[:6], model_parallel=4)
    with pytest.raises(ValueError, match="asked for"):
        tdist.make_mesh(9, devices=CPU8)


def test_mesh_naming_an_absent_card_raises(monkeypatch):
    """No fallback: a card the process cannot see is refused, and without
    a card the default mesh raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdist.make_mesh()
    with pytest.raises(RuntimeError, match="cannot see"):
        tdist.make_mesh(devices=["cuda:0", "cuda:1"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert tdist.make_mesh().shape == {"data": 2, "model": 1}
    with pytest.raises(RuntimeError, match="cuda:3"):
        tdist.make_mesh(devices=["cuda:0", "cuda:3"])


def test_run_on_fails_with_a_failing_shard(monkeypatch):
    """A failing shard fails the call, after every shard ran to its end;
    distinct devices run at once (a barrier of one party per device), a
    device named twice runs its entries in order on one thread."""
    import threading

    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    for devs, n_devices in ((CPU8[:4], 1),
                            ([torch.device("cuda", i) for i in (0, 1, 0, 2)],
                             3)):
        done, threads = [], {}
        barrier = threading.Barrier(n_devices, timeout=30)

        def work(i, dev):
            threads.setdefault(dev, set()).add(threading.get_ident())
            if i == devs.index(dev):             # each device's first entry
                barrier.wait()
            done.append(i)
            if i == 1:
                raise RuntimeError("shard 1 failed")
            return i * 10

        with pytest.raises(RuntimeError, match="shard 1"):
            tdist.mesh.run_on(devs, work)
        assert sorted(done) == [0, 1, 2, 3]
        assert all(len(t) == 1 for t in threads.values())
        barrier.reset()
        assert tdist.mesh.run_on(devs, lambda i, d: i * 10) == [0, 10, 20, 30]


def test_ring_knn_matches(meshes):
    """JAX's ring kNN and the port's (1 x 8 mesh, 8 query and 16 source
    rows per device, k = 5; the port also at k = 24 > n_local): distances
    rtol 1e-5 / atol 1e-6; the port's indices select those distances; both
    against the port's dense search."""
    _, _, jm1, tm1 = meshes
    rng = np.random.default_rng(3)
    q = rng.normal(size=(64, 3)).astype(np.float32)
    s = rng.normal(size=(128, 3)).astype(np.float32)
    mask = rng.uniform(size=128) > 0.2
    dj, _ = jring_knn(jnp.asarray(q), jnp.asarray(s), jnp.asarray(mask), 5,
                      jm1, axis="model")
    for k in (5, 24):
        dt, it = tdist.ring_knn(_t(q), _t(s), _t(mask), k, tm1, axis="model")
        assert it.dtype == torch.int32 and dt.shape == (64, k)
        dd, _ = tbf.knn(_t(q), _t(s), k, source_mask=_t(mask))
        want = np.asarray(dj) if k == 5 else dd.numpy()
        np.testing.assert_allclose(dt.numpy(), want, rtol=1e-5, atol=1e-6)
        gathered = ((q[:, None, :] - s[it.numpy()]) ** 2).sum(-1)
        np.testing.assert_allclose(gathered, want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(dt.numpy(), dd.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_ring_knn_blocking_does_not_change_the_result(meshes, monkeypatch):
    """Query blocks of 3 rows (against the default of all rows at once)
    give bit-equal results."""
    _, _, _, tm1 = meshes
    rng = np.random.default_rng(8)
    q, s = (_t(rng.normal(size=(n, 3)).astype(np.float32)) for n in (40, 80))
    m = _t(rng.uniform(size=80) > 0.3)
    whole = tdist.ring_knn(q, s, m, 7, tm1)
    monkeypatch.setattr(tdist.halo, "_BLOCK_ELEMS", 3 * 10)
    for a, b in zip(tdist.ring_knn(q, s, m, 7, tm1), whole):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_sharded_match_votes_match(meshes):
    """Per-view counts exact against JAX's and the dense float64 oracle,
    views split 1 x 8 and 4 x 2."""
    _, tm, jm1, tm1 = meshes
    rng = np.random.default_rng(4)
    Ms, V, Mk, D = 32, 8, 16, 33
    sd = rng.normal(size=(Ms, D)).astype(np.float32)
    bd = rng.normal(size=(V, Mk, D)).astype(np.float32)
    bv = rng.uniform(size=(V, Mk)) > 0.3
    want = np.asarray(jmatch_votes(jnp.asarray(sd), jnp.asarray(bd),
                                   jnp.asarray(bv), 30.0, jm1, axis="model"))
    d = np.sum((sd.astype(np.float64)[:, None, None, :] - bd[None]) ** 2, -1)
    oracle = (np.where(bv[None], d, np.inf).min(-1) < 30.0).sum(0)
    np.testing.assert_array_equal(want, oracle)
    for mesh in (tm1, tm):
        got = tdist.sharded_match_votes(_t(sd), _t(bd), _t(bv), 30.0, mesh)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), oracle)


def _icp_problem():
    rng = np.random.default_rng(11)
    model, _ = joint_points(rng, n_chord=600, n_stub=360)
    ang = np.radians(8.0)
    R = np.array([[np.cos(ang), -np.sin(ang), 0],
                  [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
    scene = model @ R.T + np.array([0.02, -0.015, 0.01], np.float32)
    return model[:960].astype(np.float32), scene[:960].astype(np.float32), R


def test_ring_icp_matches(meshes):
    """The port's ring ICP against JAX's (atol 5e-4 on T, fitness within
    1e-6), against the port's single-device ``icp`` (the same), and the
    rigid motion recovered (5e-3)."""
    _, _, jm1, tm1 = meshes
    src, tgt, R = _icp_problem()
    ones = np.ones(960, bool)
    kw = dict(iterations=12, max_corr_dist=0.1)
    Tj, fj = jring_icp(jnp.asarray(src), jnp.asarray(ones), jnp.asarray(tgt),
                       jnp.asarray(ones), jm1, axis="model", **kw)
    Tt, ft = tdist.ring_icp(_t(src), _t(ones), _t(tgt), _t(ones), tm1,
                            axis="model", **kw)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=5e-4)
    assert abs(float(ft) - float(fj)) < 1e-6
    Tr, fr = ticp.icp(make_cloud(src, capacity=960, device="cpu"),
                      make_cloud(tgt, capacity=960, device="cpu"),
                      torch.eye(4), **kw)
    np.testing.assert_allclose(Tt.numpy(), Tr.numpy(), atol=5e-4)
    assert abs(float(ft) - float(fr)) < 1e-6
    np.testing.assert_allclose(Tt.numpy()[:3, :3], R, atol=5e-3)


def _slab_cloud():
    rng = np.random.default_rng(11)
    N = 1024
    theta = rng.uniform(0, 2 * np.pi, N)
    xyz = np.stack([rng.uniform(-1.0, 1.0, N), 0.1 * np.cos(theta),
                    0.1 * np.sin(theta)], 1)
    xyz += rng.normal(0, 1e-3, xyz.shape)
    xyz = np.asarray(xyz[np.argsort(xyz[:, 0])], np.float32)
    return xyz, rng.uniform(size=N) > 0.1


def test_halo_radius_neighbors_match(meshes):
    """Slab-sorted cylinder, 128 points per device, halo 128 (the JAX
    test's): the neighbour sets of JAX's halo exchange and the port's
    equal, the sorted distances rtol 1e-5 / atol 1e-7 (both the expansion
    form)."""
    _, _, jm1, tm1 = meshes
    xyz, mask = _slab_cloud()
    ij, vj, dj = (np.asarray(a) for a in jhalo(
        jnp.asarray(xyz), jnp.asarray(mask), 0.08, 12, jm1, axis="model",
        halo=128))
    it, vt, dt = (a.numpy() for a in tdist.halo_radius_neighbors(
        _t(xyz), _t(mask), 0.08, 12, tm1, axis="model", halo=128))
    assert it.dtype == np.int32
    for q in range(1024):
        assert set(it[q][vt[q]].tolist()) == set(ij[q][vj[q]].tolist()), q
    np.testing.assert_allclose(_sorted(dt, vt), _sorted(dj, vj), rtol=1e-5,
                               atol=1e-7)


def _sorted(d, v):
    return np.sort(np.where(v, d, 1e9), axis=1)


@pytest.mark.parametrize("halo", [64, 256])
def test_halo_bands_and_clamp(meshes, halo):
    """A band narrower than the shard (64 of 128 points: only the boundary
    band crosses each link) and one wider (256, clamped to the shard: every
    shard sends everything) against the port's dense search: neighbour
    sets equal, distances atol 1e-6 (the dense search takes kernel K2's
    difference form, the halo the expansion form, which cancels at
    |x|^2 ~ 1)."""
    _, _, _, tm1 = meshes
    xyz, mask = _slab_cloud()
    it, vt, dt = (a.numpy() for a in tdist.halo_radius_neighbors(
        _t(xyz), _t(mask), 0.08, 12, tm1, axis="model", halo=halo))
    ir, vr, dr = (a.numpy() for a in tbf.radius_neighbors(
        _t(xyz), _t(xyz), 0.08, 12, source_mask=_t(mask)))
    for q in range(1024):
        assert set(it[q][vt[q]].tolist()) == set(ir[q][vr[q]].tolist()), q
    np.testing.assert_allclose(_sorted(dt, vt), _sorted(dr, vr), rtol=0,
                               atol=1e-6)
