"""Find a cell's parts by name.

A cell ``<config>.<mix>`` is an entry of ``workloads`` in ``BENCHMARK.json``;
its configuration is ``benchmark/configs/<config>.json``, its traffic mix
``benchmark/traffic/<mix>.json``, and each per-layer metric ``<name>`` is
read by ``benchmark/metrics/<name>.py`` (a module with ``read(ctx)`` that
returns a number, or None when it finds nothing to read). Adding a
configuration, a mix or a metric is adding files and entries.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def spec() -> dict:
    """The benchmark's ``BENCHMARK.json``."""
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def resolve(workload: str, bench: dict = None) -> dict:
    """dict(workload, config, traffic, end_to_end, per_layer) of the cell
    named ``workload``: the metrics are the spec's entries that the cell
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
                end_to_end=[m for m in bench["end_to_end"] if reports(m)],
                per_layer=[m for m in bench["per_layer"] if reports(m)])


def reader(name: str) -> Callable:
    """``read`` of ``benchmark/metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    mod_name = "benchmark.metrics." + name.replace(".", "_").replace("-", "_")
    sp = importlib.util.spec_from_file_location(mod_name, path)
    if sp is None:
        raise FileNotFoundError(f"no reader {path}")
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.read
