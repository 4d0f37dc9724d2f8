"""Port parity, the command-line flow (mirrors ``tests/test_cli.py``): render
views, build a bank, detect a scene (one bank, two part banks, the cluster
tree), the scene loop with and without hypothesis verification, and the
utility subcommands — the port's CLI run in-process with ``--device cpu``
and the JAX package's CLI on the same files, in one module fixture.

Scale: ``tests/test_cli.py``'s (the joint of ``tests/util.py`` at 800
points, level-0 views at 64 px, ``--key_capacity 48``, ``COMMON``).

Tolerances. Rendered views, pose files, crops, segmentations, edge clouds
and the repository's PCDs are equal. Bank descriptors: the level-0
tolerance of ``tests/test_torch_detect.py`` (95% within 1e-4, all within
1e-2). Detections (both CLIs on the JAX package's bank): the accept flag,
view and correspondence count equal, the pose within 1e-3 of JAX's per
entry; the scene loops' verdicts and GOOD lines' views equal, their
translations within 1e-3. Variance descriptors within 1e-4 per line (see
``tests/test_torch_aux.py``).
"""
import importlib
import json
import os
import re

import numpy as np
import pytest
import torch

from tests.util import joint_points
from tpu_joints.core.io import PointData, load_pcd, save_pcd
from tpu_joints.modelbank import load_bank as jload_bank
from tpu_joints_torch.core import io as tio
from tpu_joints_torch.modelbank import bank as tbank

COMMON = ["--preset", "shot", "--descr_rad", "0.12", "--model_ss", "0.04",
          "--scene_ss", "0.04", "--scene_capacity", "1024"]
CPU = ["--device", "cpu"]
# the packages re-export a function named like the module
jmain = importlib.import_module("tpu_joints.cli.main")
tmain = importlib.import_module("tpu_joints_torch.cli.main")


def jcli(argv):
    """The JAX CLI in-process. Its platform switch also points JAX at a
    persistent compilation cache; the suite's JAX already runs on the CPU
    (conftest) and keeps no cache, so the switch is skipped here."""
    sync = jmain._sync_platform
    jmain._sync_platform = lambda: None
    try:
        jmain.main(argv)
    finally:
        jmain._sync_platform = sync


def tcli(argv):
    tmain.main(argv)


def _run(capsys, fn, argv):
    capsys.readouterr()
    fn(argv)
    return capsys.readouterr().out


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """Model, each CLI's rendered views and bank (with dumps), and a
    tabletop scene; everything later tests read is built here."""
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(0)
    model_xyz, _ = joint_points(rng, n_chord=500, n_stub=300)
    save_pcd(str(d / "model.pcd"), PointData(xyz=model_xyz))
    out = {}
    for tag, cli, extra in (("jax", jcli, []), ("port", tcli, CPU)):
        cli(["render", str(d / "model.pcd"), "--out", str(d / f"views_{tag}"),
             "--level", "0", "--resolution", "64"])
        cli(["bank", str(d / "model.pcd"), "--out", str(d / f"bank_{tag}.npz"),
             "--level", "0", "--resolution", "64", "--key_capacity", "48",
             "--dump-txt", str(d / f"dumps_{tag}")] + COMMON + extra)
    rng = np.random.default_rng(1)
    # plane + cylinder scene like segmentation.cpp's tabletop
    plane = np.stack([rng.uniform(-0.5, 0.5, 800), rng.uniform(-0.5, 0.5, 800),
                      np.full(800, 1.0)], 1)
    theta = rng.uniform(0, 2 * np.pi, 600)
    h = rng.uniform(0.5, 0.9, 600)
    cyl = np.stack([0.05 * np.cos(theta), 0.05 * np.sin(theta), h], 1)
    save_pcd(str(d / "table.pcd"),
             PointData(xyz=np.concatenate([plane, cyl]).astype(np.float32)))
    views = sorted((d / "views_jax").glob("*.pcd"),
                   key=lambda p: int(p.stem))
    sizes = [(load_pcd(str(p)).xyz.shape[0], p) for p in views]
    out["scene"] = str(max(sizes)[1])      # the largest view: a known pose
    out["views"] = [str(p) for p in views]
    return d, out


def test_cli_render_matches(workdir):
    d, _ = workdir
    files = sorted(os.listdir(d / "views_port"))
    assert files == sorted(os.listdir(d / "views_jax"))
    assert sum(f.endswith(".pcd") for f in files) == 12
    for f in files:
        a, b = d / "views_port" / f, d / "views_jax" / f
        assert a.read_bytes() == b.read_bytes(), f


def test_cli_bank_interchange(workdir):
    """Each CLI's bank loads in the other package; the port's descriptors
    within the level-0 tolerance of JAX's; the dumps hold the valid
    descriptors, one component per line."""
    d, _ = workdir
    jb = jload_bank(str(d / "bank_jax.npz"))
    tb = tbank.load_bank(str(d / "bank_port.npz"), device="cpu")
    tj = tbank.load_bank(str(d / "bank_jax.npz"), device="cpu")
    pj = jload_bank(str(d / "bank_port.npz"))
    for k in ("view_xyz", "view_mask", "key_xyz", "key_valid", "poses",
              "model_xyz", "model_mask", "icp_xyz", "icp_mask"):
        np.testing.assert_array_equal(getattr(tb, k).numpy(),
                                      np.asarray(getattr(jb, k)), err_msg=k)
        np.testing.assert_array_equal(getattr(tj, k).numpy(),
                                      np.asarray(getattr(jb, k)), err_msg=k)
        np.testing.assert_array_equal(np.asarray(getattr(pj, k)),
                                      getattr(tb, k).numpy(), err_msg=k)
    kv = np.asarray(jb.key_valid)
    dd = np.abs(tb.desc.numpy() - np.asarray(jb.desc)).max(-1)[kv]
    assert kv.sum() > 50
    assert (dd <= 1e-4).mean() >= 0.95 and dd.max() < 1e-2, (dd > 1e-4).sum()
    assert tb.params_hash == jb.params_hash
    for tag, bank in (("port", tb), ("jax", tj)):
        dumps = sorted((d / f"dumps_{tag}").glob("Partial_View*.txt"))
        assert len(dumps) == bank.n_views
        vals = np.loadtxt(str(d / f"dumps_{tag}" / "Partial_View0.txt"))
        valid = bank.key_valid[0].numpy()
        np.testing.assert_allclose(
            vals.reshape(int(valid.sum()), -1), bank.desc[0].numpy()[valid],
            rtol=1e-4, atol=1e-6)


_HEAD = re.compile(r"--- (\S+) \[(\S+)\]: accepted=(\w+) fitness=(\S+) "
                   r"view=(\d+) corrs=(\d+)")


def _results(out):
    """(name, part, accepted, view, corrs, 4x4 pose) per printed result."""
    lines = out.splitlines()
    res = []
    for i, line in enumerate(lines):
        m = _HEAD.match(line)
        if m:
            T = np.array([[float(v) for v in lines[i + 1 + r].split()]
                          for r in range(4)])
            res.append((m[1], m[2], m[3], int(m[5]), int(m[6]), T))
    return res


def _same_results(a, b, tol=1e-3):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x[:5] == y[:5], (x[:5], y[:5])
        np.testing.assert_allclose(x[5], y[5], atol=tol)


@pytest.mark.parametrize("extra", [["--json"], ["--tree", "3"],
                                   ["two-part"]], ids=["json", "tree",
                                                       "two-part"])
def test_cli_detect_matches(workdir, capsys, extra):
    """``detect`` on the largest view with the JAX package's bank: one bank
    (``--json``: the same accept flag, part and pose), the cluster tree,
    and two ``name=path`` part banks."""
    d, w = workdir
    bank = str(d / "bank_jax.npz")
    banks = ["--bank", bank]
    if extra == ["two-part"]:
        banks, extra = ["--bank", f"chord={bank}", "--bank", f"stub={bank}"], []
    argv = ["detect", w["scene"], *banks, *extra] + COMMON
    jout = _run(capsys, jcli, argv)
    tout = _run(capsys, tcli, argv + CPU)
    _same_results(_results(tout), _results(jout))
    if extra == ["--json"]:
        tj, jj = (json.loads(o.strip().splitlines()[-1]) for o in (tout, jout))
        assert tj["accepted"] == jj["accepted"] is True
        assert tj["part"] == jj["part"] == "model"
        np.testing.assert_allclose(tj["pose"], jj["pose"], atol=1e-4)
        for k in ("scene_points", "scene_keypoints", "correspondences"):
            assert tj["metrics"][k] == jj["metrics"][k], k
    if extra == ["--tree", "3"]:
        assert _results(tout)[0][2] == "True"


def test_cli_resolution_scaling_matches(workdir):
    """``-r``: the radii scaled by the scene's mean nearest-other-point
    spacing (a k = 1 ``exclude_self`` search, the sort path) equal the JAX
    CLI's, on a view and on a cloud above the 4096-point stride."""
    d, w = workdir
    args = tmain.build_parser().parse_args(
        ["detect", w["scene"], "--bank", "b.npz"] + COMMON)
    cfg = tmain._config_from_args(args)
    jcfg = jmain._config_from_args(jmain.build_parser().parse_args(
        ["detect", w["scene"], "--bank", "b.npz"] + COMMON))
    big = np.concatenate([load_pcd(v).xyz for v in w["views"]])
    for pts in (load_pcd(w["scene"]).xyz, big):
        got = tmain._apply_resolution(cfg, pts, torch.device("cpu"))
        want = jmain._apply_resolution(jcfg, pts)
        for f in ("model_ss", "scene_ss", "rf_rad", "descr_rad", "cg_size"):
            assert getattr(got, f) == getattr(want, f), f
        assert got.scene_ss != cfg.scene_ss
    assert big.shape[0] > 4096


@pytest.mark.parametrize("hv", [False, True], ids=["plain", "hv"])
def test_cli_scenes_matches(workdir, capsys, hv):
    """``scenes`` over two views (``--hv``: with the hypothesis
    verification): the same results, verdicts and GOOD lines."""
    d, w = workdir
    argv = (["scenes", w["views"][0], w["scene"], "--bank",
             str(d / "bank_jax.npz")] + (["--hv"] if hv else []) + COMMON)
    jout = _run(capsys, jcli, argv)
    tout = _run(capsys, tcli, argv + CPU)
    _same_results(_results(tout), _results(jout))
    verdicts = [[ln for ln in o.splitlines() if "verdict:" in ln
                 or "scenes accepted" in ln] for o in (tout, jout)]
    assert verdicts[0] == verdicts[1] and len(verdicts[0]) == 3
    good = [[re.match(r".*instance (\d+) is GOOD! view=(\d+) .*t=\((.*)\)",
                      ln).groups() for ln in o.splitlines() if "GOOD!" in ln]
            for o in (tout, jout)]
    assert len(good[0]) == len(good[1]) > 0
    for a, b in zip(*good):
        assert a[:2] == b[:2]
        np.testing.assert_allclose(np.array(a[2].split(", "), float),
                                   np.array(b[2].split(", "), float), atol=1e-3)


def test_cli_crop_segment_match(workdir, capsys):
    """``crop`` and ``segment`` (both RANSAC models with the seed's key)
    write the JAX CLI's clouds and print its lines."""
    d, w = workdir
    outs = {}
    for tag, cli, extra in (("jax", jcli, []), ("port", tcli, CPU)):
        outs[tag] = _run(capsys, cli, [
            "crop", w["scene"], "--out", str(d / f"crop_{tag}.pcd"),
            "--xmin", "-1", "--xmax", "0.05", "--zmin", "-5", "--zmax", "5"]
            + extra)
        outs[tag] += _run(capsys, cli, [
            "segment", str(d / "table.pcd"), "--plane_out",
            str(d / f"plane_{tag}.pcd"), "--cylinder_out",
            str(d / f"cyl_{tag}.pcd"), "--zmin", "0", "--zmax", "1.5",
            "--seed", "3"] + extra)
    assert outs["port"].replace("_port", "_jax") == outs["jax"]
    for name in ("crop", "plane", "cyl"):
        a = load_pcd(str(d / f"{name}_port.pcd")).xyz
        np.testing.assert_array_equal(a, load_pcd(str(d / f"{name}_jax.pcd")).xyz)
        assert a.shape[0] > 0, name
    p = load_pcd(str(d / "plane_port.pcd")).xyz
    assert p.shape[0] > 500 and abs(p[:, 2].mean() - 1.0) < 0.02


@pytest.mark.parametrize("k", ["100", "20"])
def test_cli_edges_match(workdir, capsys, k):
    """``edges`` at the default k = 100 (the sort path) and k = 20 (K2's
    plain version): the same edge clouds."""
    d, w = workdir
    outs = {}
    for tag, cli, extra in (("jax", jcli, []), ("port", tcli, CPU)):
        out = _run(capsys, cli, ["edges", w["scene"], "--out",
                                 str(d / f"edges{k}_{tag}.pcd"), "--leaf",
                                 "0.01", "-k", k] + extra)
        outs[tag] = re.sub(r" in \S+s ", " ", out)     # the wall clock
    assert outs["port"].replace("_port", "_jax") == outs["jax"]
    a = load_pcd(str(d / f"edges{k}_port.pcd")).xyz
    np.testing.assert_array_equal(a, load_pcd(str(d / f"edges{k}_jax.pcd")).xyz)
    assert a.shape[0] > 0


def test_cli_var_desc_matches(workdir, capsys):
    d, w = workdir
    outs = {}
    for tag, cli, extra in (("jax", jcli, []), ("port", tcli, CPU)):
        outs[tag] = _run(capsys, cli, [
            "var-desc", w["scene"], "--out", str(d / f"var_{tag}.txt"),
            "--radius", "0.05", "--sampling", "0.03", "--key_capacity", "64"]
            + extra)
    assert outs["port"].replace("_port", "_jax") == outs["jax"]
    a, b = (np.loadtxt(str(d / f"var_{t}.txt")) for t in ("port", "jax"))
    assert a.shape == b.shape and a.size % 3 == 0 and a.size > 0
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)


def test_cli_pngs(workdir, capsys):
    """``detect --png -c`` and ``visualize`` write their PNGs (matplotlib
    imported at first use), as the JAX CLI's test checks them."""
    d, w = workdir
    tcli(["detect", w["scene"], "--bank", str(d / "bank_port.npz"), "-c",
          "--png", str(d / "corr.png")] + COMMON + CPU)
    assert (d / "corr.png").stat().st_size > 10_000
    scene = w["views"][0]
    png = os.path.splitext(scene)[0] + ".png"
    out = _run(capsys, tcli, ["visualize", scene])
    assert out.strip() == f"wrote {png}" and os.path.exists(png)


@pytest.mark.parametrize("name", ["cylinder.pcd", "plane.pcd"])
def test_cli_loads_repo_pcds(name):
    """The repository's sample clouds load equal in both packages, through
    the CLIs' own loaders."""
    a = tmain._load_points(name)
    np.testing.assert_array_equal(a, jmain._load_points(name))
    np.testing.assert_array_equal(tio.load_pcd(name).xyz, load_pcd(name).xyz)
    assert a.shape[0] > 0


def test_cli_help_and_device(workdir, capsys):
    """The same ten subcommands as the JAX CLI; ``--device cuda`` without a
    card raises instead of running on the CPU."""
    jparser = jmain.build_parser

    def subcommands(parser):
        act = next(a for a in parser._actions
                   if a.__class__.__name__ == "_SubParsersAction")
        return list(act.choices)

    assert subcommands(tmain.build_parser()) == subcommands(jparser())
    assert len(subcommands(jparser())) == 10
    d, w = workdir
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for argv in (["crop", w["scene"], "--out", str(d / "x.pcd")],
                 ["detect", w["scene"], "--bank", str(d / "bank_port.npz")],
                 ["bank", str(d / "model.pcd"), "--out", str(d / "x.npz")]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tcli(argv)
