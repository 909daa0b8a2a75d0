"""Find a cell's pieces by name: ``BENCHMARK.json``'s entry, its configuration's file, its
traffic mix, its limits, its driver and the readers of its metrics.

A later change adds a configuration, a traffic mix, a metric or a cell as new files and
new entries of ``BENCHMARK.json``; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent.parent  # portbench/
ROOT = HERE.parent  # the checkout
BENCHMARK = ROOT / "BENCHMARK.json"

_LOADED: Dict[Path, ModuleType] = {}


def load_module(path: Path) -> ModuleType:
    """The Python file ``path`` as a module (file names may hold dots and hyphens)."""
    path = Path(path).resolve()
    if path not in _LOADED:
        name = "portbench_" + re.sub(r"[^0-9A-Za-z_]", "_", str(path.relative_to(HERE).with_suffix("")))
        spec = importlib.util.spec_from_file_location(name, path)
        if spec is None or spec.loader is None:
            raise FileNotFoundError(path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _LOADED[path] = module
    return _LOADED[path]


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One entry of ``workloads`` with everything it names."""

    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)

    def driver(self) -> ModuleType:
        return load_module(HERE / "drivers" / f"{self.traffic['driver']}.py")

    def reference(self) -> ModuleType:
        return load_module(HERE / "reference" / f"{self.config_name}.py")


def _reported_in(metric: dict, cell: str, cells_reporting: Optional[set]) -> bool:
    """Whether ``metric`` is reported in ``cell``: its ``workloads`` list, else every cell
    that reports the end-to-end metric it moves (``cells_reporting``; None: every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return cells_reporting is None or cell in cells_reporting


def cell(name: str, bench: Optional[dict] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (or of ``bench``)."""
    bench = read_json(BENCHMARK) if bench is None else bench
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are {sorted(entries)}")
    w = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    conf = configs[w["config"]]
    e2e = [m for m in bench["end_to_end"] if _reported_in(m, name, None)]
    reporting = {m["name"]: {x["name"] for x in bench["workloads"] if _reported_in(m, x["name"], None)}
                 for m in bench["end_to_end"]}
    layers = [m for m in bench["per_layer"] if _reported_in(m, name, reporting.get(m["moves"]))]
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config_name=conf["name"],
        config=read_json(ROOT / conf["file"]),
        traffic_name=w["traffic"],
        traffic=read_json(HERE / "traffic" / f"{w['traffic']}.json"),
        limits=read_json(HERE / "limits" / f"{name}.json"),
        end_to_end=e2e,
        per_layer=layers,
    )


def reader(metric: str) -> ModuleType:
    """The reader of ``metric``: ``metrics/<metric>.py`` with ``read(run) -> float | None``;
    where there is none, the reader of the name without its last dotted part (one
    ``metrics/launches.py`` reads ``launches.fit`` and ``launches.train``)."""
    name = metric
    while not (HERE / "metrics" / f"{name}.py").is_file() and "." in name:
        name = name.rsplit(".", 1)[0]
    return load_module(HERE / "metrics" / f"{name}.py")
