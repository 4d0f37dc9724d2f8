"""Port parity, ``neighbors/grid.py`` and ``bruteforce.pairwise_sq_dist``:
the JAX package's voxel-hash search and the port's on the CPU, same numpy
inputs (``tests/util.joint_points`` from a seed), and the port's grid
against its own dense search.

Tolerances. The grid is integer and gather work over the same float32
distances (the chained-FMA squared norm XLA's CPU backend forms), so the
index, the hashes, the order, the occupancy and the search's idx / valid /
dist_sq are held equal to JAX's. Against the dense search the contract of
``tests/test_grid.py``: equal neighbour sets wherever the dense search did
not truncate at k_max. ``pairwise_sq_dist``: rtol 1e-5, atol 1e-6 (the
tolerance of ``tests/test_distributed.py`` for the expansion form; the
two products round differently)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.util import joint_points
from tpu_joints.neighbors import bruteforce as jbf
from tpu_joints.neighbors import grid as jgrid
from tpu_joints_torch.neighbors import bruteforce as tbf
from tpu_joints_torch.neighbors import grid as tgrid


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def cloud():
    """A joint of 1400 points in 2048 lanes, every third lane masked out
    among the valid ones."""
    xyz, _ = joint_points(np.random.default_rng(0), n_chord=900, n_stub=500)
    pad = np.full((2048 - xyz.shape[0], 3), 1.0e6, np.float32)
    pts = np.concatenate([xyz, pad]).astype(np.float32)
    mask = np.arange(2048) < xyz.shape[0]
    mask[::3] = False
    return pts, mask


def _grids(pts, mask, cell):
    j = jgrid.build_grid(jnp.asarray(pts), jnp.asarray(mask), cell_size=cell)
    t = tgrid.build_grid(_t(pts), _t(mask), cell_size=cell)
    return j, t


def test_cell_hash_wraps_like_int32():
    """Large, negative and overflowing cells, and the cell whose hash is
    INT32_MIN (abs keeps it negative; the remainder is non-negative)."""
    rng = np.random.default_rng(1)
    cells = rng.integers(-(1 << 31), (1 << 31) - 1, size=(500, 3))
    cells = np.concatenate([cells, [[-(1 << 31), 0, 0], [0, 0, 0],
                                    [1, -1, 7], [(1 << 31) - 1] * 3]])
    for table in (4096, 8191, 1 << 20):
        want = np.asarray(jgrid._cell_hash(jnp.asarray(cells, jnp.int32),
                                           table))
        got = tgrid._cell_hash(torch.from_numpy(cells).long(), table).numpy()
        np.testing.assert_array_equal(got, want)
        assert (got >= 0).all() and (got < table).all()


@pytest.mark.parametrize("cell", [0.03, 0.06])
def test_build_grid_and_occupancy_match(cloud, cell):
    j, t = _grids(*cloud, cell)
    np.testing.assert_array_equal(t.order.numpy(), np.asarray(j.order))
    np.testing.assert_array_equal(t.hashes.numpy(), np.asarray(j.hashes))
    np.testing.assert_array_equal(t.xyz.numpy(), np.asarray(j.xyz))
    assert t.table_size == j.table_size == 4 * 2048
    assert int(tgrid.max_cell_occupancy(t)) == int(
        jgrid.max_cell_occupancy(j))


@pytest.mark.parametrize("radius", [0.03, 0.06])
@pytest.mark.parametrize("chunk", [0, 128])
def test_grid_radius_neighbors_match(cloud, radius, chunk):
    """300 queries (300 % 128 != 0: the ragged last block), cap 64, k_max
    32 (< 27 * 64) and 2000 (> 27 * 64: the padding)."""
    pts, mask = cloud
    j, t = _grids(pts, mask, radius)
    q = pts[np.random.default_rng(5).choice(1400, 300, replace=False)]
    for k_max in (32, 2000):
        want = jgrid.grid_radius_neighbors(j, jnp.asarray(q), radius, k_max,
                                           bucket_cap=64, query_chunk=chunk)
        got = tgrid.grid_radius_neighbors(t, _t(q), radius, k_max,
                                          bucket_cap=64, query_chunk=chunk)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if chunk:
        ref = tgrid.grid_radius_neighbors(t, _t(q), radius, 32, bucket_cap=64)
        got = tgrid.grid_radius_neighbors(t, _t(q), radius, 32, bucket_cap=64,
                                          query_chunk=chunk)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), r.numpy())


def test_grid_matches_dense_search(cloud):
    """At a cap sized from the occupancy (plus collision margin) the grid
    equals the port's dense search wherever that did not truncate."""
    pts, mask = cloud
    radius, k_max = 0.04, 64
    _, t = _grids(pts, mask, radius)
    cap = int(np.ceil(int(tgrid.max_cell_occupancy(t)) * 1.5 / 32) * 32)
    q = _t(pts[:400])
    gi, gv, gd = tgrid.grid_radius_neighbors(t, q, radius, k_max,
                                             bucket_cap=cap)
    di, dv, dd = tbf.radius_neighbors(q, _t(pts), radius, k_max,
                                      source_mask=_t(mask))
    for r in range(400):
        want = set(di[r][dv[r]].tolist())
        got = set(gi[r][gv[r]].tolist())
        if len(want) < k_max:
            assert got == want, r
        assert mask[list(got)].all()


def test_grid_no_neighbors():
    t = tgrid.build_grid(torch.zeros(64, 3), None, cell_size=0.05)
    idx, valid, d = tgrid.grid_radius_neighbors(
        t, torch.full((4, 3), 10.0), 0.05, 8)
    assert not valid.any() and (d == np.float32(3e38)).all()


def test_pairwise_sq_dist_matches():
    rng = np.random.default_rng(2)
    a = rng.normal(size=(70, 3)).astype(np.float32)
    b = rng.normal(size=(90, 3)).astype(np.float32)
    want = np.asarray(jbf.pairwise_sq_dist(jnp.asarray(a), jnp.asarray(b)))
    got = tbf.pairwise_sq_dist(_t(a), _t(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tbf.pairwise_sq_dist(_t(a), _t(a))
                                  .diagonal().numpy() >= 0, True)
