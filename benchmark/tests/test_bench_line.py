"""The result line and the run's guards: the last line's keys are the
contract's (compared numbers last); without a card a run prints no result
and exits non-zero; no module the harness loads is JAX or the JAX package,
top-level names compared whole."""
import json
import subprocess
import sys

from benchmark import run
from benchmark.cells import ROOT

CONTRACT = ["correct", "attempted", "failed", "metrics", "device"]


def test_a_run_without_a_card_prints_no_result():
    p = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "joint_organized.cam1", "--seed", str(2 ** 31 + 7), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert p.returncode == 2
    assert p.stdout == ""
    assert "needs 1 CUDA device" in p.stderr


def test_foreign_names_are_compared_whole(monkeypatch):
    for name in ("tpu_joints_torch.serve", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert run.foreign_modules() == []
    monkeypatch.setitem(sys.modules, "tpu_joints.pipelines", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert run.foreign_modules() == ["jaxlib", "tpu_joints"]


def test_the_line_of_a_cpu_run(tiny_cell):
    """A tiny run on the CPU (the harness's own code path, minus the look
    for a card): the line carries exactly the contract's keys and then the
    compared numbers, and its numbers are all it names."""
    line, notes = run.run_cell(tiny_cell("joint_organized.cam1"),
                               2 ** 31 + 11, 1.0, False, device="cpu")
    assert list(line) == CONTRACT + ["compared"]
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert line["device"]["platform"] == "cpu"   # never passed off as gpu
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in line["compared"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(line)
    assert notes["errors"] == []


def test_the_harness_loads_no_jax():
    """In a fresh interpreter, after a tiny run on the CPU, no loaded
    module's top-level name is jax, jaxlib, flax or tpu_joints."""
    code = (
        "import sys\n"
        "from benchmark import cells, run\n"
        "cell = cells.resolve('joint_organized.cam1')\n"
        "cell['config']['bank'].update(level=0, resolution=64)\n"
        "cell['traffic'].update(pool=2, warm_rounds=1)\n"
        "run.run_cell(cell, 3, 0.5, False, device='cpu')\n"
        "print(run.foreign_modules())\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}"
        " & {'jax', 'jaxlib', 'flax', 'tpu_joints', 'tpu_joints_torch'}))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    last = p.stdout.strip().splitlines()[-2:]
    assert last == ["[]", "['tpu_joints_torch']"]
