"""Find a cell and everything it names, by name.

Every configuration, traffic mix, driver and per-layer metric is a file of
its own under ``portbench/``, found from the names in ``BENCHMARK.json``:

- ``configs/<config>.json`` (the entry's ``file``): the deployment's sizes;
- ``traffic/<traffic>.json``: the mix's parameters, which name the driver;
- ``drivers/<driver>.py``: ``setup``, ``window`` and ``check`` of one entry
  point of the program;
- ``metrics/<metric>.py``: ``read(run)`` of one per-layer metric.

A later change adds a cell by adding such files and entries, and edits no
file that is there.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parents[1]  # portbench/
ROOT = HERE.parent  # the checkout


@dataclass
class Cell:
    """One workload of BENCHMARK.json with what it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list = field(default_factory=list)  # the metric entries this cell reports
    per_layer: list = field(default_factory=list)


def load_benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"no BENCHMARK.json at {root}")
    return json.loads(path.read_text())


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric["workloads"] if "workloads" in metric else True


def resolve(bench: dict, workload: str, root: Path = ROOT, here: Path = HERE) -> Cell:
    """The cell named ``workload``: its configuration file and traffic
    file read, and the metrics it reports."""
    by_name = {w["name"]: w for w in bench["workloads"]}
    if workload not in by_name:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have: {', '.join(sorted(by_name))})")
    w = by_name[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    centry = configs[w["config"]]
    config = json.loads((root / centry["file"]).read_text())
    traffic = json.loads((here / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload)]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if _reports(m, workload) and m["moves"] in e2e_names]
    return Cell(workload, int(w["chips"]), config, traffic, e2e, layer)


def _module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # dataclasses look their module up by name
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, here: Path = HERE):
    """``drivers/<name>.py`` as a module."""
    return _module(here / "drivers" / f"{name}.py", f"portbench_driver_{name}")


def metric_reader(name: str, here: Path = HERE):
    """``read`` of ``metrics/<name>.py``."""
    safe = name.replace(".", "_").replace("-", "_")
    return _module(here / "metrics" / f"{name}.py", f"portbench_metric_{safe}").read


def read_metrics(cell: Cell, run: dict, here: Path = HERE) -> dict:
    """Each per-layer metric of the cell that its reader finds something
    for, as ``{name: {"value", "unit"}}``; a reader that finds nothing
    returns None and the metric is left out."""
    out = {}
    for m in cell.per_layer:
        value: Optional[float] = metric_reader(m["name"], here)(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
