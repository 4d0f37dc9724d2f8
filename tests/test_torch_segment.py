"""Port parity, segmentation: ``region_growing``, ``cluster_curvature_filter``
and the clustered OBB against the JAX package on the CPU, same inputs.

Scene: a 320×240 frame of the bench joint in front of the workshop table
(two separate structures, so the graph has several components), strided
to 2048 points by the CLI's recipe. Both packages get the JAX package's
normals and curvature, so the region growing is compared on its own. Its
kNN graph differs in arithmetic only: the JAX path expands
|q|²+|s|²−2q·s, the port's kernel K2 takes the difference form; no
neighbour set or edge differed on these inputs (labels are equal).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_joints.core.cloud import Cloud as JCloud
from tpu_joints.features.normals import estimate_normals as jnormals
from tpu_joints.recognize.obb import oriented_bounding_box_clustered as jobb
from tpu_joints.segment.region_growing import cluster_curvature_filter as jfilter
from tpu_joints.segment.region_growing import region_growing as jrg
from tpu_joints_torch import synthetic as syn
from tpu_joints_torch.core.cloud import make_cloud
from tpu_joints_torch.modelbank.scanner import render_views
from tpu_joints_torch.recognize.obb import oriented_bounding_box_clustered as tobb
trg_mod = importlib.import_module("tpu_joints_torch.segment.region_growing")
from tpu_joints_torch.segment.region_growing import Clusters as TClusters
from tpu_joints_torch.segment.region_growing import cluster_curvature_filter as tfilter
from tpu_joints_torch.segment.region_growing import region_growing as trg

CFG = syn.generic_config()
RG = dict(k=16, smoothness_deg=CFG.rg_smoothness_deg,
          curvature_threshold=CFG.rg_curvature,
          min_cluster_size=CFG.rg_min_cluster, max_edge=CFG.rg_max_edge)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jcloud(c):
    return JCloud(jnp.asarray(c.xyz.numpy()), jnp.asarray(c.mask.numpy()),
                  jnp.asarray(c.rgb.numpy()))


@pytest.fixture(scope="module")
def scene():
    """(port cloud, JAX cloud, normals, curvature) of the table scene."""
    xyz, valid = syn.frame(syn.bench_pose(), 5, with_table=True, width=320,
                           height=240)
    c = make_cloud(syn.scene_points(xyz[valid], 2048), capacity=2304,
                   device="cpu")
    jc = _jcloud(c)
    n, curv = jnormals(jc, k=16, allow_pallas=False)
    return c, jc, np.asarray(n), np.asarray(curv)


@pytest.mark.parametrize("kw", [{}, {"max_sweeps": 2}, {"max_sweeps": 9},
                                {"smoothness_deg": 5.0, "max_edge": 3.0e38,
                                 "min_cluster_size": 20}])
def test_region_growing_matches(scene, kw):
    """Labels and sizes equal, exactly: at convergence, and stopped early
    by ``max_sweeps`` (inside the first 8-sweep chunk, and one sweep into
    the second)."""
    c, jc, n, curv = scene
    args = {**RG, **kw}
    cj = jrg(jc, jnp.asarray(n), jnp.asarray(curv), **args)
    ct = trg(c, _t(n), _t(curv), **args)
    np.testing.assert_array_equal(ct.labels.numpy(), np.asarray(cj.labels))
    np.testing.assert_array_equal(ct.sizes.numpy(), np.asarray(cj.sizes))
    labels = np.asarray(cj.labels)
    if not kw:     # the converged default run really finds several regions
        assert len(np.unique(labels[labels >= 0])) >= 2


def test_region_growing_host_checks_follow_the_schedule(scene):
    """One host read per 8-sweep chunk, none for a chunk that ends at
    ``max_sweeps``; the converged run needs at least one read."""
    c, _, n, curv = scene
    for max_sweeps, expect in ((3, 0), (8, 0)):
        before = trg_mod.region_growing.host_checks
        trg(c, _t(n), _t(curv), **RG, max_sweeps=max_sweeps)
        assert trg_mod.region_growing.host_checks - before == expect
    before = trg_mod.region_growing.host_checks
    trg(c, _t(n), _t(curv), **RG)
    assert trg_mod.region_growing.host_checks - before >= 1


@pytest.mark.parametrize("max_mean", [CFG.cluster_max_curvature, 0.01])
def test_cluster_curvature_filter_matches(scene, max_mean):
    c, jc, n, curv = scene
    cj = jrg(jc, jnp.asarray(n), jnp.asarray(curv), **RG)
    kj = jfilter(cj, jnp.asarray(curv), jc.mask, max_mean)
    kt = tfilter(TClusters(_t(cj.labels), _t(cj.sizes)), _t(curv), c.mask,
                 max_mean)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    assert 0 < int(kt.sum()) < int(c.mask.sum())


@pytest.mark.parametrize("view", [0, 5])
def test_oriented_bounding_box_clustered_matches(view):
    """The box of a bank view's largest smooth cluster (k = 30 normals and
    graph, both on K2 in the port): box within 1e-4 — the normals and
    eigenbasis are float32 sums taken in other orders."""
    views, _, _ = render_views(syn.joint_model(3000, 1800), level=0,
                                   resolution=64)
    c = make_cloud(views[view], capacity=1024, device="cpu")
    bj = jobb(_jcloud(c), min_cluster_size=CFG.rg_min_cluster)
    bt = tobb(c, min_cluster_size=CFG.rg_min_cluster)
    for f in ("position", "rotation", "extents", "euler", "centroid"):
        np.testing.assert_allclose(getattr(bt, f).numpy(),
                                   np.asarray(getattr(bj, f)), rtol=0,
                                   atol=1e-4, err_msg=f)
