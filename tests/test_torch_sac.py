"""Port parity, RANSAC segmentation: the reference's random draw (threefry
uniforms, XLA's cumulative sum, the weighted ``choice``) and ``sac_plane`` /
``sac_cylinder`` — JAX package vs port on the CPU, same inputs from a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_joints.core.cloud import Cloud as JCloud
from tpu_joints.segment import sac as jsac
from tpu_joints_torch.core import prng
from tpu_joints_torch.core.cloud import Cloud
from tpu_joints_torch.core.ops import xla_cumsum
from tpu_joints_torch.segment import sac as tsac


def _t(a):
    return torch.from_numpy(np.array(a))


def _mask_weights(n, fill, seed):
    m = np.random.default_rng(seed).uniform(size=n) < fill
    p = m.astype(np.float32)
    return p / np.maximum(p.sum(), np.float32(1.0))


@pytest.mark.parametrize("fill", [0.05, 0.5, 0.9])
@pytest.mark.parametrize("n", [5, 16, 17, 1000, 2560, 3072, 4800, 19200])
def test_xla_cumsum_equals_jnp_cumsum(n, fill):
    """Bit-equal to ``jnp.cumsum`` on mask weights 5-90% full, at the
    working-set and lattice sizes and around one row of 16."""
    p = _mask_weights(n, fill, n)
    np.testing.assert_array_equal(xla_cumsum(_t(p)).numpy(),
                                  np.asarray(jnp.cumsum(jnp.asarray(p))))


def test_xla_cumsum_is_not_the_sequential_sum():
    """The order matters: numpy's sequential float32 sum differs on a
    19,200-lane mask (otherwise this module would not be needed)."""
    p = _mask_weights(19200, 0.5, 1)
    assert not np.array_equal(xla_cumsum(_t(p)).numpy(), np.cumsum(p))


@pytest.mark.parametrize("shape", [(256, 3), (1024, 2), (7,), (33, 5)])
@pytest.mark.parametrize("seed", [0, 1, 123456])
def test_uniforms_equal_jax_random_uniform(seed, shape):
    u = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape))
    np.testing.assert_array_equal(prng.uniform(seed, shape), u)
    np.testing.assert_array_equal(
        prng.uniform_on(seed, shape, torch.device("cpu")).numpy(), u)


@pytest.mark.parametrize("shape", [(256, 3), (1024, 2)])
@pytest.mark.parametrize("n,fill", [(1000, 0.3), (2560, 0.9), (3072, 0.6),
                                    (19200, 0.05), (19200, 0.5)])
def test_choice_indices_equal_jax_random_choice(n, fill, shape):
    """The drawn indices are equal, every one (they depend on the frame
    through the cumulative sum of the mask weights)."""
    p = _mask_weights(n, fill, n + shape[0])
    idx = np.asarray(jax.random.choice(jax.random.PRNGKey(0), n, shape,
                                       p=jnp.asarray(p)))
    got = prng.choice(_t(prng.uniform(0, shape)), _t(p)).numpy()
    np.testing.assert_array_equal(got, idx)
    assert (p[got] > 0).all()


def _table_and_cylinder(seed, n_table=1800, n_cyl=900, capacity=3072):
    """A tilted table plane (60%) and a cylinder standing on it, with their
    analytic normals, σ = 1 mm position noise and ~1° normal noise, in a
    padded cloud with masked lanes scattered through it."""
    rng = np.random.default_rng(seed)
    uv = rng.uniform(-0.35, 0.35, (n_table, 2))
    table = np.concatenate([uv, np.zeros((n_table, 1))], 1)
    tn = np.tile([0.0, 0.0, 1.0], (n_table, 1))
    th = rng.uniform(0, 2 * np.pi, n_cyl)
    h = rng.uniform(0.0, 0.3, n_cyl)
    cyl = np.stack([0.06 * np.cos(th) + 0.05, 0.06 * np.sin(th) - 0.02, h], 1)
    cn = np.stack([np.cos(th), np.sin(th), np.zeros(n_cyl)], 1)
    a = np.radians(25.0)
    R = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)],
                  [0, np.sin(a), np.cos(a)]])
    pts = np.concatenate([table, cyl]) @ R.T + np.array([0.02, -0.03, 1.1])
    nrm = np.concatenate([tn, cn]) @ R.T
    pts = pts + rng.normal(0, 1e-3, pts.shape)
    nrm = nrm + rng.normal(0, 0.02, nrm.shape)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    lanes = np.sort(rng.choice(capacity, pts.shape[0], replace=False))
    xyz = np.full((capacity, 3), 1.0e6, np.float32)
    normals = np.zeros((capacity, 3), np.float32)
    mask = np.zeros(capacity, bool)
    xyz[lanes], normals[lanes], mask[lanes] = pts, nrm, True
    is_table = np.zeros(capacity, bool)
    is_table[lanes[:n_table]] = True
    return xyz, normals, mask, is_table


def _clouds(xyz, mask):
    rgb = np.zeros_like(xyz)
    return (JCloud(jnp.asarray(xyz), jnp.asarray(mask), jnp.asarray(rgb)),
            Cloud(_t(xyz), _t(mask), _t(rgb)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sac_plane_matches(seed):
    """Same winning hypothesis: coefficients within 1e-6 (measured 1.2e-7).
    ``torch.acos`` and XLA's ``arccos`` differ by ulps, so a lane whose
    metric sits on the threshold may flip: inliers and score are held
    within 2 such lanes (measured: 0 on these clouds). The plane found is
    the table."""
    xyz, normals, mask, is_table = _table_and_cylinder(seed)
    jc, tc = _clouds(xyz, mask)
    rj = jsac.sac_plane(jc, jnp.asarray(normals), jax.random.PRNGKey(0),
                        n_hypotheses=256, distance_threshold=0.02)
    rt = tsac.sac_plane(tc, _t(normals), seed=0, n_hypotheses=256,
                        distance_threshold=0.02)
    np.testing.assert_allclose(rt.coefficients.numpy(),
                               np.asarray(rj.coefficients), rtol=0, atol=1e-6)
    flipped = int((rt.inliers.numpy() != np.asarray(rj.inliers)).sum())
    assert flipped <= 2, flipped
    assert abs(int(rt.score) - int(rj.score)) <= flipped
    assert int(rt.score) == int(rt.inliers.sum())
    inl = rt.inliers.numpy()
    assert inl[is_table].mean() > 0.95 and inl[mask & ~is_table].mean() < 0.2


@pytest.mark.parametrize("seed", [0, 1])
def test_sac_cylinder_matches(seed):
    """The cylinder alone (the table removed, as the reference's chain
    runs it): same winning hypothesis (coefficients within 1e-6; measured
    7.5e-9), inliers and score within 2 threshold lanes (measured: 0); the
    radius found is the cylinder's 6 cm within 1 cm."""
    xyz, normals, mask, is_table = _table_and_cylinder(seed)
    mask = mask & ~is_table
    xyz = np.where(mask[:, None], xyz, np.float32(1.0e6))
    jc, tc = _clouds(xyz, mask)
    rj = jsac.sac_cylinder(jc, jnp.asarray(normals), jax.random.PRNGKey(0),
                           n_hypotheses=1024, distance_threshold=0.01,
                           radius_max=0.1)
    rt = tsac.sac_cylinder(tc, _t(normals), seed=0, n_hypotheses=1024,
                           distance_threshold=0.01, radius_max=0.1)
    np.testing.assert_allclose(rt.coefficients.numpy(),
                               np.asarray(rj.coefficients), rtol=0, atol=1e-6)
    flipped = int((rt.inliers.numpy() != np.asarray(rj.inliers)).sum())
    assert flipped <= 2, flipped
    assert abs(int(rt.score) - int(rj.score)) <= flipped
    assert abs(float(rt.coefficients[6]) - 0.06) < 0.01
    assert int(rt.score) > 0.8 * mask.sum()
