"""The port's public API against the JAX package's: every subpackage exports
the reference's names (in the same ``__all__`` order), each bound to the
object of the port's defining module and of the same kind as the
reference's; each subpackage imports first in a fresh interpreter without
an import cycle and without loading ``jax`` or ``tpu_joints``; and the
README's Python API runs at small size through both packages' exports on
the CPU.

Scale of the README block: a level-0 bank (12 views) of the small joint
model at the README's ``build_bank`` defaults otherwise, each package
building its own, and ``chip_smoke.py`` phase 16's scene recipe (the bench
frame's valid points, strided) at 3072 lanes and 256 keys under
``PRESETS["shot"]``'s own radii. At ``chip_smoke.py``'s small-path
sampling (scene_ss 0.03) and a 64-key bank the only Hough instance rests
on three matches piled onto one model key: its rotation is undefined (any
rotation fits), so the two packages' ICPs start apart and the comparison
would mean nothing.
"""
import ast
import dataclasses
import importlib
import inspect
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from tpu_joints.config import PRESETS as JPRESETS
from tpu_joints.core.cloud import make_cloud as jmake_cloud
from tpu_joints.modelbank import build_bank as jbuild_bank
from tpu_joints.pipelines import detect as jdetect
from tpu_joints_torch import synthetic as syn
from tpu_joints_torch.config import PRESETS
from tpu_joints_torch.core.cloud import make_cloud
from tpu_joints_torch.modelbank import build_bank
from tpu_joints_torch.pipelines import detect

ROOT = Path(__file__).resolve().parent.parent
# "" is the top-level package (its one export, ``Cloud``)
PACKAGES = ["", "core", "features", "filters", "modelbank", "neighbors",
            "pipelines", "recognize", "segment", "cli", "distributed",
            "native", "serve", "viz"]
CAPACITY = 3072


def _name(root, pkg):
    return root + (f".{pkg}" if pkg else "")


def _reference_exports(pkg):
    """(name, module it is imported from) for every name the JAX package's
    ``__init__.py`` of ``pkg`` imports, in order."""
    path = ROOT / "tpu_joints" / pkg / "__init__.py"
    return [(a.asname or a.name, node.module)
            for node in ast.parse(path.read_text()).body
            if isinstance(node, ast.ImportFrom) and node.module != "__future__"
            for a in node.names]


def _kind(obj):
    if isinstance(obj, types.ModuleType):
        return "module"
    if inspect.isclass(obj):
        return "class"
    return "callable" if callable(obj) else "value"


def _port(name):
    return name.replace("tpu_joints", "tpu_joints_torch", 1)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_exports_match_the_reference(pkg):
    """Every name the reference's ``__init__`` imports is exported by the
    port's counterpart, is the very object of the port's defining module
    (``tpu_joints_torch.pipelines.detect`` is the function of the
    ``pipelines.detect`` module), and is of the reference's kind; where the
    reference has an ``__all__``, the port's is equal, order included."""
    jpkg = importlib.import_module(_name("tpu_joints", pkg))
    tpkg = importlib.import_module(_name("tpu_joints_torch", pkg))
    exports = _reference_exports(pkg)
    assert exports
    if hasattr(jpkg, "__all__"):
        assert tpkg.__all__ == jpkg.__all__
    for name, src in exports:
        got = getattr(tpkg, name)
        tsrc = _port(src)
        if tsrc == tpkg.__name__:            # ``from pkg import module``
            want = sys.modules[f"{tsrc}.{name}"]
        else:
            want = vars(importlib.import_module(tsrc))[name]
        assert got is want, (pkg, name)
        assert _kind(got) == _kind(getattr(jpkg, name)), (pkg, name)


def test_readme_imports_bind_the_reference_kind():
    """Each ``from tpu_joints... import ...`` line of the README's Python
    blocks, with the port's package name, binds an object of the kind the
    reference's line binds (a function where it binds a function)."""
    text = (ROOT / "README.md").read_text()
    blocks = re.findall(r"```python\n(.*?)```", text, re.S)
    lines = [ln for b in blocks for ln in b.splitlines()
             if ln.startswith("from tpu_joints.")]
    assert len(lines) >= 5
    for line in lines:
        node = ast.parse(line).body[0]
        jmod = importlib.import_module(node.module)
        tmod = importlib.import_module(_port(node.module))
        for a in node.names:
            assert _kind(getattr(tmod, a.name)) == _kind(
                getattr(jmod, a.name)), line


@pytest.mark.parametrize("pkg", PACKAGES)
def test_first_import_loads_no_jax(pkg):
    """A fresh interpreter imports ``tpu_joints_torch.<pkg>`` first: no
    import cycle in that order, and no ``jax`` or ``tpu_joints`` module is
    loaded by it."""
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        f"import {_name('tpu_joints_torch', pkg)}\n"
        "bad = sorted(m for m in set(sys.modules) - before\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'tpu_joints'))\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]


def _small(preset):
    return dataclasses.replace(preset, scene_capacity=CAPACITY,
                               scene_key_capacity=256)


def test_readme_python_api_matches_the_reference():
    """The README's block at small size through both packages' exports:
    the same accept flag and winning view, full_pose within 5e-4 (as
    ``tests/test_torch_generic.py``), fitness within rtol 1e-3."""
    model = syn.joint_model(3000, 1800)
    xyz, valid = syn.frame(syn.bench_pose(), 42, with_table=False)
    scene_xyz = syn.scene_points(xyz[valid], CAPACITY)

    jbank = jbuild_bank(model, level=0)
    jscene = jmake_cloud(scene_xyz, capacity=CAPACITY)
    jres = jdetect(jscene, jbank, _small(JPRESETS["shot"]))

    bank = build_bank(model, level=0, device="cpu")
    scene = make_cloud(scene_xyz, capacity=CAPACITY, device="cpu")
    res = detect(scene, bank, _small(PRESETS["shot"]))

    assert bool(res.accepted) == bool(jres.accepted)
    assert int(res.view_idx) == int(jres.view_idx)
    np.testing.assert_allclose(res.full_pose.numpy(),
                               np.asarray(jres.full_pose), rtol=0, atol=5e-4)
    np.testing.assert_allclose(float(res.fitness), float(jres.fitness),
                               rtol=1e-3)
    assert np.isfinite(res.full_pose.numpy()).all()
