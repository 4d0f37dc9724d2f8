"""The cell resolver finds configurations, mixes and metric readers by
file name, for every name BENCHMARK.json gives."""
import json

import pytest

from benchmark import cells


def test_every_cell_resolves_to_its_files():
    bench = cells.spec()
    for w in bench["workloads"]:
        cell = cells.resolve(w["name"], bench)
        assert cell["config"]["name"] == w["config"]
        assert (cells.HERE / "configs" / f"{w['config']}.json").exists()
        assert (cells.HERE / "traffic" / f"{w['traffic']}.json").exists()
        assert {m["name"] for m in cell["end_to_end"]} >= {"setup_s"}
        assert cell["per_layer"]


def test_every_per_layer_metric_has_a_reader():
    for m in cells.spec()["per_layer"]:
        assert callable(cells.reader(m["name"]))


def test_a_metric_lists_its_cells():
    """A per-layer metric with a ``workloads`` key is reported only in the
    cells it lists; one without it, in every cell."""
    bench = cells.spec()
    bench = dict(bench, per_layer=bench["per_layer"] + [
        dict(name="x.only_elsewhere", workloads=["joint_organized.other"])])
    names = {m["name"] for m in cells.resolve("joint_organized.cam1",
                                              bench)["per_layer"]}
    assert "x.only_elsewhere" not in names
    assert {m["name"] for m in cells.spec()["per_layer"]} <= names


JUDGE = """
def passes(reply, pool, gate):
    return reply is not None


class Reference:
    def __init__(self, config, pool, device):
        self.pool = pool


def judge_window(ref, records, seed, limits, sample, control=False):
    n = float(len(ref.pool["poses"]))
    return dict(correct=bool(records), numbers=dict(instances=(n, n)),
                judged=0)
"""


def test_new_files_are_found_by_name(tmp_path, monkeypatch):
    """A configuration, a mix, a judge and a reader that a later change
    adds as new files are found with no edit of the harness."""
    for sub in ("configs", "traffic", "metrics", "reference"):
        (tmp_path / sub).mkdir()
    cfg = json.loads((cells.HERE / "configs" / "joint_organized.json")
                     .read_text())
    cfg.update(name="joint_other", judge="other_judge")
    (tmp_path / "configs" / "joint_other.json").write_text(json.dumps(cfg))
    (tmp_path / "traffic" / "burst.json").write_text(json.dumps({"cameras": 2}))
    (tmp_path / "metrics" / "x.count.py").write_text(
        "def read(ctx):\n    return 7.0\n")
    (tmp_path / "reference" / "other_judge.py").write_text(JUDGE)
    monkeypatch.setattr(cells, "HERE", tmp_path)
    bench = dict(workloads=[dict(name="joint_other.burst", config="joint_other",
                                 traffic="burst", chips=1)],
                 end_to_end=[dict(name="setup_s")],
                 per_layer=[dict(name="x.count")])
    cell = cells.resolve("joint_other.burst", bench)
    assert cell["config"]["name"] == "joint_other"
    assert cell["traffic"] == {"cameras": 2}
    assert cells.reader("x.count")({}) == 7.0
    assert cell["judge"].__file__ == str(tmp_path / "reference" /
                                         "other_judge.py")
    assert cell["judge"].passes({}, {}, {}) and hasattr(cell["judge"],
                                                        "Reference")


def test_an_unknown_cell_raises():
    with pytest.raises(KeyError):
        cells.resolve("joint_organized.nope")
