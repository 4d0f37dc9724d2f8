"""Find a cell's parts by name.

A cell ``<config>.<mix>`` is an entry of ``workloads`` in ``BENCHMARK.json``;
its configuration is ``benchmark/configs/<config>.json``, its traffic mix
``benchmark/traffic/<mix>.json``, and each per-layer metric ``<name>`` is
read by ``benchmark/metrics/<name>.py`` (a module with ``read(ctx)`` that
returns a number, or None when it finds nothing to read). The
configuration's ``judge`` (``check`` where it names none) is
``benchmark/reference/<judge>.py``, a module with ``passes(reply, pool,
gate)``, ``Reference(config, pool, device)`` and ``judge_window(ref,
records, seed, limits, sample, control=False)``. Adding a configuration, a
mix, a judge or a metric is adding files and entries.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def spec() -> dict:
    """The benchmark's ``BENCHMARK.json``."""
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def resolve(workload: str, bench: dict = None) -> dict:
    """dict(workload, config, traffic, judge, end_to_end, per_layer) of
    the cell named ``workload``: the judge is its configuration's module,
    loaded, and the metrics are the spec's entries that the cell
    reports."""
    bench = bench or spec()
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    cell = cells[workload]
    with open(HERE / "configs" / f"{cell['config']}.json") as f:
        config = json.load(f)
    with open(HERE / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)

    def reports(m):
        return "workloads" not in m or workload in m["workloads"]

    return dict(workload=cell, config=config, traffic=traffic,
                judge=judge(config.get("judge", "check")),
                end_to_end=[m for m in bench["end_to_end"] if reports(m)],
                per_layer=[m for m in bench["per_layer"] if reports(m)])


def _load(kind: str, path: Path) -> ModuleType:
    """The module of ``benchmark/<kind>/<name>.py``, loaded from its file."""
    name = path.stem.replace(".", "_").replace("-", "_")
    sp = importlib.util.spec_from_file_location(f"benchmark.{kind}.{name}",
                                                path)
    if sp is None:
        raise FileNotFoundError(f"no {path}")
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod


def reader(name: str) -> Callable:
    """``read`` of ``benchmark/metrics/<name>.py``."""
    return _load("metrics", HERE / "metrics" / f"{name}.py").read


def judge(name: str) -> ModuleType:
    """The judge module ``benchmark/reference/<name>.py``; an unknown name
    raises, listing the modules there are."""
    path = HERE / "reference" / f"{name}.py"
    if not path.is_file():
        have = sorted(p.stem for p in (HERE / "reference").glob("*.py")
                      if p.stem != "__init__")
        raise KeyError(f"no judge {name!r} in benchmark/reference "
                       f"(have {have})")
    return _load("reference", path)
