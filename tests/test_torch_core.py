"""Port parity, core layer: config, transforms, eigensolver, tensor helpers
and the synthetic-scene copies — each against its JAX-package original on
the same numpy inputs (the port runs its plain CPU path)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.util import random_rigid
from tpu_joints import config as jconfig
from tpu_joints.core import cloud as jcloud
from tpu_joints.core import transforms as jtr
from tpu_joints.features import eigen3 as jeig
from tpu_joints_torch import config as tconfig
from tpu_joints_torch import synthetic as syn
from tpu_joints_torch.core import cloud as tcloud
from tpu_joints_torch.core import ops
from tpu_joints_torch.core import transforms as ttr
from tpu_joints_torch.features import eigen3 as teig


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_config_has_the_reference_fields_and_defaults():
    jf = [(f.name, f.default) for f in dataclasses.fields(jconfig.DetectionConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tconfig.DetectionConfig)]
    assert jf == tf
    bench = pytest.importorskip("bench")
    jcfg = bench._make_config()
    assert dataclasses.asdict(tconfig.from_dict(dataclasses.asdict(jcfg))) \
        == dataclasses.asdict(jcfg)
    # the port's copy of bench.py's full-size scene_latency config
    assert dataclasses.asdict(syn.bench_config()) == dataclasses.asdict(jcfg)


def test_make_cloud_matches():
    rng = np.random.default_rng(1)
    xyz = rng.normal(size=(300, 3)).astype(np.float32)
    xyz[5] = np.nan
    a = jcloud.make_cloud(xyz)
    b = tcloud.make_cloud(xyz, device="cpu")
    assert jcloud.bucket_size(300) == tcloud.bucket_size(300) == 512
    for f in ("xyz", "mask", "rgb"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      getattr(b, f).numpy())


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_umeyama_weighted_matches(seed):
    rng = np.random.default_rng(seed)
    T = random_rigid(rng)
    src = rng.normal(size=(64, 3)).astype(np.float32)
    dst = (src @ T[:3, :3].T + T[:3, 3]
           + rng.normal(scale=0.01, size=(64, 3))).astype(np.float32)
    w = rng.uniform(size=64).astype(np.float32)
    w[rng.uniform(size=64) < 0.3] = 0.0
    a = np.asarray(jax.jit(jtr.umeyama)(jnp.asarray(src), jnp.asarray(dst),
                                        jnp.asarray(w)))
    b = ttr.umeyama(_t(src), _t(dst), _t(w)).numpy()
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)


def test_umeyama_batched_and_zero_weights_give_identity():
    rng = np.random.default_rng(5)
    src = rng.normal(size=(3, 40, 3)).astype(np.float32)
    dst = (src + 0.1).astype(np.float32)
    w = np.ones((3, 40), np.float32)
    w[1] = 0.0
    out = ttr.umeyama(_t(src), _t(dst), _t(w)).numpy()
    np.testing.assert_array_equal(out[1], np.eye(4, dtype=np.float32))
    for c in (0, 2):
        ref = np.asarray(jtr.umeyama(jnp.asarray(src[c]), jnp.asarray(dst[c]),
                                     jnp.asarray(w[c])))
        np.testing.assert_allclose(out[c], ref, rtol=0, atol=1e-5)


def test_umeyama_sources_at_one_point_match():
    """Every weighted source at one point (Hough matches piled onto one
    model key) makes the cross covariance exactly 0: the JAX package's SVD
    then returns the identity rotation, and the port does the same, with
    the translation taking the centroids onto each other."""
    rng = np.random.default_rng(7)
    src = np.repeat(rng.normal(size=(1, 3)), 5, axis=0).astype(np.float32)
    dst = rng.normal(size=(5, 3)).astype(np.float32)
    w = np.array([1, 1, 0.5, 0, 2], np.float32)
    ref = np.asarray(jtr.umeyama(jnp.asarray(src), jnp.asarray(dst),
                                 jnp.asarray(w)))
    np.testing.assert_array_equal(ref[:3, :3], np.eye(3, dtype=np.float32))
    out = ttr.umeyama(_t(src), _t(dst), _t(w)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


def test_compose_invert_geodesic_match():
    rng = np.random.default_rng(9)
    A, B = random_rigid(rng), random_rigid(rng)
    np.testing.assert_allclose(ttr.compose(_t(A), _t(B)).numpy(),
                               np.asarray(jtr.compose(A, B)), atol=1e-6)
    np.testing.assert_allclose(ttr.invert_rigid(_t(A)).numpy(),
                               np.asarray(jtr.invert_rigid(A)), atol=1e-6)
    np.testing.assert_allclose(
        float(ttr.rotation_geodesic_deg(_t(A[:3, :3]), _t(B[:3, :3]))),
        float(jtr.rotation_geodesic_deg(A[:3, :3], B[:3, :3])), atol=1e-3)


def _sym(rng, n, vals):
    """Symmetric matrices with the given eigenvalue triples."""
    Q = np.stack([np.linalg.qr(rng.normal(size=(3, 3)))[0] for _ in range(n)])
    return (Q * np.asarray(vals, np.float64)[:, None, :]) @ Q.transpose(0, 2, 1)


@pytest.mark.parametrize("kind", ["random", "plane", "line", "isotropic"])
def test_eigh3x3_matches(kind):
    """Random matrices (spectra with gaps >= 20% of the largest eigenvalue):
    eigenvalues within 1e-5 of the largest one's magnitude and all three
    eigenvectors within 1e-5 up to sign (measured 3e-7 and 2e-7).

    Degenerate matrices: inside a repeated eigenvalue's eigenspace any
    basis is right, so only the distinct eigenvector is compared, at 1e-4:
    on the plane class both packages sit up to 6e-5 from the float64
    eigenvector of the same float32 matrix (measured 5.9e-5 and 3.5e-5), so
    that is the closed form's own accuracy there, not a port difference.
    Eigenvalues are compared at 5e-4 of the largest: at a repeated
    root the closed form takes acos near ±1, which turns a 1-ulp change in
    r = det(B)/2p³ (XLA fuses the reference's products into FMAs) into a
    ~sqrt(ulp) change of the angle — measured 1.9e-4 between the packages,
    and already 1.6e-4 between the reference's own jitted and eager runs.
    """
    rng = np.random.default_rng(11)
    n = 256
    s = rng.uniform(1e-4, 1e-2, (n, 1))
    vals = {"random": s * np.stack([np.ones(n), rng.uniform(0.3, 0.7, n),
                                    rng.uniform(0.0, 0.1, n)], 1),
            "plane": np.repeat([[4e-4, 4e-4, 1e-7]], n, 0),
            "line": np.repeat([[5e-4, 1e-8, 1e-8]], n, 0),
            "isotropic": np.repeat([[1e-3, 1e-3, 1e-3]], n, 0)}[kind]
    A = _sym(rng, n, vals).astype(np.float32)
    vj, Vj = jax.jit(jeig.eigh3x3)(jnp.asarray(A))
    vt, Vt = teig.eigh3x3(_t(A))
    vj, Vj, vt, Vt = map(np.asarray, (vj, Vj, vt.numpy(), Vt.numpy()))
    scale = np.abs(vj).max(-1, keepdims=True)
    tol = 1e-5 if kind == "random" else 5e-4
    assert (np.abs(vt - vj) <= tol * scale).all()
    cols = {"random": [0, 1, 2], "plane": [2], "line": [0],
            "isotropic": []}[kind]
    for c in cols:
        a, b = Vj[..., c], Vt[..., c]
        b = b * np.sign((a * b).sum(-1, keepdims=True))
        np.testing.assert_allclose(b, a, rtol=0, atol=tol / 5)
    if kind == "random":
        # simple spectrum: an orthonormal, right-handed basis
        np.testing.assert_allclose(Vt.transpose(0, 2, 1) @ Vt,
                                   np.broadcast_to(np.eye(3), Vt.shape),
                                   atol=1e-5)
        np.testing.assert_allclose(np.linalg.det(Vt), 1.0, atol=1e-5)


def test_scatter_add_sums_each_slot_in_lane_order():
    rng = np.random.default_rng(2)
    idx = rng.integers(0, 7, 200)
    val = rng.normal(size=200).astype(np.float32)
    ref = np.zeros(9, np.float32)
    for i, v in zip(idx, val):        # the sequential scatter XLA runs on CPU
        ref[i] = np.float32(ref[i] + v)
    out = ops.scatter_add(_t(idx), _t(val), 9).numpy()
    np.testing.assert_array_equal(out, ref)
    jref = np.asarray(jnp.zeros(9, jnp.float32).at[idx].add(val))
    np.testing.assert_array_equal(out, jref)


def test_top_k_breaks_ties_like_lax():
    x = np.array([[1.0, 3.0, 3.0, 0.5, 3.0, 2.0]], np.float32)
    for k in (1, 2, 4):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = ops.top_k(_t(x), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_synthetic_copies_equal_the_originals():
    bench = pytest.importorskip("bench")
    from tpu_joints.serve import depth

    np.testing.assert_array_equal(syn.bench_pose(), bench._bench_pose())
    np.testing.assert_array_equal(syn.pose(-15.0, -30.0, [-0.03, 0.0, 1.05]),
                                  bench._pose(-15.0, -30.0, [-0.03, 0.0, 1.05]))
    for a, b in zip(syn.joint_parts(), bench._joint_parts()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(syn.joint_model(), bench._joint_model())
    T = syn.bench_pose()
    np.testing.assert_array_equal(
        syn.raycast_cylinders(syn.CYLINDERS, T, width=160, height=120,
                              rects=syn.TABLE),
        depth.raycast_cylinders(bench._CYLINDERS, T, width=160, height=120,
                                rects=bench._TABLE))
    xs, vs = syn.frame(T, 42, with_table=True)
    xb, vb = bench._frame(T, 42, with_table=True)
    np.testing.assert_array_equal(xs, xb)
    np.testing.assert_array_equal(vs, vb)
