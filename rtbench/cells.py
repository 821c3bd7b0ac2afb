"""A cell from `BENCHMARK.json`, with everything found by name: its
configuration file, its traffic mix (`rtbench/traffic/<traffic>.json`),
its limits (`rtbench/limits/<workload>.json`) and the readers of its
per-layer metrics (`rtbench/metrics/<metric>.py`, each a `read(run)`
that returns a number, or None where the run has nothing to read)."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list      # the BENCHMARK.json entries this cell reports
    per_layer: list


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load(workload: str, bench_path: str = "BENCHMARK.json") -> Cell:
    """The cell named `workload`; raises LookupError or OSError where the
    benchmark or a file it names is missing."""
    with open(bench_path) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise LookupError(f"no workload {workload!r} in {bench_path}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(configs[w["config"]]["file"]) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    with open(os.path.join(HERE, "limits", workload + ".json")) as f:
        limits = json.load(f)
    return Cell(workload, int(w["chips"]), config, traffic, limits,
                [m for m in bench["end_to_end"] if _reports(m, workload)],
                [m for m in bench["per_layer"] if _reports(m, workload)])


def metric_reader(name: str):
    """The `read` function of per-layer metric `name`."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"rtbench.metrics.{name.replace('.', '_')}", path)
    if spec is None:
        raise LookupError(f"no reader for metric {name!r} at {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
