"""Find the pieces of a cell by the names ``BENCHMARK.json`` gives them.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. Each lives in a file of its own:

* ``configs/<config>.json``: the configuration as it is run;
* ``families/<family>.py``: how a configuration of that model family is
  handed to the program (its policy, weights and inputs from the seed);
* ``reference/<family>.py``: the family's plain forward pass;
* ``flops/<family>.py``: its operations and bytes, from shapes;
* ``mixes/<traffic>.json``: a traffic mix's parameters, which name its
  unit of work (``"unit"``, the mix's own name where it is left out);
* ``mixes/<unit>.py``: the unit of work that reads them (its
  ``Workload``), shared by every mix that names it;
* ``metrics/<metric>.py``: one reader per metric. A metric named
  ``<reader>.<property>`` with no file of its own is read by
  ``metrics/<reader>.py``: the same quantity under a bound or a cell set
  of its own (``updates_per_s.device_bound``);
* ``limits/<workload>.json``: the limits of the output check.

A later cell, configuration or metric is new files and new entries;
nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Any, Dict

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SPEC_FILE = ROOT / "BENCHMARK.json"

_modules: Dict[Path, ModuleType] = {}


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(SPEC_FILE)


def metric_reader(name: str) -> ModuleType:
    """The reader of metric ``name``: ``metrics/<name>.py``, or, for a
    name ``<reader>.<property>`` with no file of its own,
    ``metrics/<reader>.py``."""
    if not (HERE / "metrics" / f"{name}.py").is_file() and "." in name:
        return load_module("metrics", name.rsplit(".", 1)[0])
    return load_module("metrics", name)


def load_module(kind: str, name: str) -> ModuleType:
    """``<kind>/<name>.py`` under this folder, loaded by its path (names
    may hold ``.`` and ``-``)."""
    path = HERE / kind / f"{name}.py"
    if path not in _modules:
        if not path.is_file():
            raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
        mod_name = "benchmark_" + kind + "_" + re.sub(r"\W", "_", name)
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _modules[path] = mod
    return _modules[path]


class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    def __init__(self, name: str, bench: dict = None):
        bench = benchmark() if bench is None else bench
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
        self.entry = cells[name]
        self.name = name
        self.chips = int(self.entry["chips"])
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = load_json(ROOT / self.config_entry["file"])
        self.mix = load_json(HERE / "mixes" / f"{self.entry['traffic']}.json")
        self.unit = load_module("mixes",
                                self.mix.get("unit", self.entry["traffic"]))
        self.family = load_module("families", self.config["family"])
        self.reference = load_module("reference", self.config["family"])
        self.flops = load_module("flops", self.config["family"])
        self.limits = load_json(HERE / "limits" / f"{name}.json")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]
