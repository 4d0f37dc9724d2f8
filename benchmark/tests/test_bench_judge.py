"""The judge a configuration names: without a ``judge`` key a cell is held
by ``benchmark/reference/check.py`` to the same numbers and limits as
before; a named judge is loaded from its own file; an unknown name fails
when the cell is resolved. A configuration of two joints with a judge of
its own, both new files, runs through ``run_cell`` on the CPU with no edit
of the harness."""
import json
from pathlib import Path

import numpy as np
import pytest

from benchmark import cells, run
from tpu_joints_torch import synthetic

# the numbers joint_organized.cam1 is held to, each with its limit
CAM1_LIMITS = {"failed": 0.0, "rejected_share": 0.30000000000000004,
               "rot_err_deg": 5.0, "trans_err_mm": 20.0, "ws_gap": 0.0,
               "fit_gap": 0.0003, "view_gap": 1e-05, "obb_gap": 2e-05}


def test_no_judge_key_resolves_to_check(tiny_cell):
    cell = tiny_cell("joint_organized.cam1")
    cell["config"]["bank"].update(level=0, resolution=64)
    assert "judge" not in cell["config"]
    assert Path(cell["judge"].__file__) == cells.HERE / "reference" / "check.py"
    line, _ = run.run_cell(cell, 2 ** 31 + 17, 1.0, False, device="cpu")
    assert {k: c["limit"] for k, c in line["compared"].items()} == CAM1_LIMITS
    assert list(line["compared"]) == list(CAM1_LIMITS)


def test_an_unknown_judge_raises_at_resolve(tmp_path, monkeypatch):
    for sub in ("configs", "traffic", "reference"):
        (tmp_path / sub).mkdir()
    cfg = json.loads((cells.HERE / "configs" / "joint_organized.json")
                     .read_text())
    cfg.update(name="joint_other", judge="nope")
    (tmp_path / "configs" / "joint_other.json").write_text(json.dumps(cfg))
    (tmp_path / "traffic" / "cam1.json").write_text(json.dumps({}))
    (tmp_path / "reference" / "check.py").write_text("")
    monkeypatch.setattr(cells, "HERE", tmp_path)
    bench = dict(workloads=[dict(name="joint_other.cam1", config="joint_other",
                                 traffic="cam1", chips=1)],
                 end_to_end=[], per_layer=[])
    with pytest.raises(KeyError, match=r"no judge 'nope'.*\['check'\]"):
        cells.resolve("joint_other.cam1", bench)


# A judge of two joints: which true joints each reply's instances name
# within the configuration's gate, and whether any names none.
PAIR_JUDGE = '''
from benchmark.reference.check import rot_trans_err

SEEN = []


def named(reply, pool, gate):
    """(the true joints the reply's instances name, instances naming none)"""
    hits, wrong = set(), 0
    for inst in reply["instances"]:
        near = [k for k, G in enumerate(pool["poses"])
                if all(e <= lim for e, lim in zip(
                    rot_trans_err(inst["pose"], G),
                    (gate["rot_deg"], gate["trans_mm"])))]
        hits.update(near)
        wrong += not near
    return hits, wrong


def passes(reply, pool, gate):
    SEEN.append(pool["poses"])
    return reply is not None and named(reply, pool, gate)[1] == 0


class Reference:
    def __init__(self, config, pool, device):
        self.config, self.pool = config, pool


def judge_window(ref, records, seed, limits, sample, control=False):
    replies = [r["reply"] for r in records if r["reply"] is not None]
    gate = ref.config["gate"]
    wrong = sum(named(r, ref.pool, gate)[1] > 0 for r in replies)
    numbers = dict(failed=(float(len(records) - len(replies)), 0.0),
                   wrong_instances=(float(wrong), float(limits["wrong"])))
    return dict(correct=bool(replies) and all(v <= lim for v, lim in
                                              numbers.values()),
                numbers=numbers, judged=len(replies))
'''


def test_two_joints_and_a_named_judge_run_through_run_cell(tmp_path,
                                                           cpu_trace,
                                                           monkeypatch):
    """A configuration whose scene shows two joints and names the judge
    above, a two-camera mix and a reader of the poses, all as new files, at
    a small size on the CPU: the judge gets both true poses, its numbers
    are the line's compared numbers, and the readers' ctx carries them."""
    for sub in ("configs", "traffic", "metrics", "reference"):
        (tmp_path / sub).mkdir()
    cfg = json.loads((cells.HERE / "configs" / "joint_organized.json")
                     .read_text())
    del cfg["scene"]["pose"]
    cfg["scene"]["instances"] = [
        dict(ay_deg=25.0, ax_deg=-15.0, t=[-0.30, -0.16, 1.05]),
        dict(ay_deg=-20.0, ax_deg=20.0, t=[0.30, 0.18, 1.00])]
    cfg["bank"].update(level=0, resolution=64)
    cfg["sensor"].update(width=160, height=120)
    cfg.update(name="joint_pair", judge="pair", limits=dict(wrong=1e9))
    (tmp_path / "configs" / "joint_pair.json").write_text(json.dumps(cfg))
    (tmp_path / "traffic" / "cams2.json").write_text(json.dumps(dict(
        cameras=2, pool=2, batch_max=1, batch_window_ms=4.0, max_pending=8,
        warm_rounds=1)))
    (tmp_path / "reference" / "pair.py").write_text(PAIR_JUDGE)
    (tmp_path / "metrics" / "x.instances.py").write_text(
        "def read(ctx):\n    return float(len(ctx['poses']))\n")
    monkeypatch.setattr(cells, "HERE", tmp_path)
    bench = dict(workloads=[dict(name="joint_pair.cams2", config="joint_pair",
                                 traffic="cams2", chips=1)],
                 end_to_end=cells.spec()["end_to_end"],
                 per_layer=[dict(name="x.instances", unit="n")])
    cell = cells.resolve("joint_pair.cams2", bench)
    line, notes = run.run_cell(cell, 2 ** 31 + 23, 0.5, True, device="cpu")
    assert notes["errors"] == []
    assert list(line["compared"]) == ["failed", "wrong_instances"]
    assert line["compared"]["failed"]["value"] == 0.0
    assert line["metrics"]["x.instances"]["value"] == 2.0
    seen = cell["judge"].SEEN
    assert len(seen) == line["attempted"]
    for poses in seen:
        np.testing.assert_array_equal(poses,
                                      np.stack(synthetic.two_instance_poses()))
