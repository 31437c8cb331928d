"""The benchmark's definition, read from data: ``BENCHMARK.json`` names the
cells, the configurations and the metrics; each configuration, traffic mix,
per-layer metric and decoder family is a file of its own under the
benchmark's folder, found by its name.  Adding one adds files and entries,
and edits none."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from types import ModuleType
from typing import Dict, List


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    source: str
    better: str
    moves: str = ""
    layer: str = ""


@dataclasses.dataclass
class Cell:
    name: str
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<mix>.json
    chips: int
    end_to_end: List[Metric]  # setup_s and the cell's other end-to-end metrics
    per_layer: List[Metric]  # the per-layer metrics read in this cell's traced runs


class Bench:
    """``BENCHMARK.json`` at ``root`` and the files it names."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        with open(os.path.join(self.root, "BENCHMARK.json")) as f:
            self.spec = json.load(f)
        self.folder = os.path.join(self.root, self.spec["paths"][0])
        self._modules: Dict[str, ModuleType] = {}

    def _json(self, path: str) -> dict:
        with open(os.path.join(self.root, path)) as f:
            return json.load(f)

    def cell(self, name: str) -> Cell:
        cells = {w["name"]: w for w in self.spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(cells)})")
        w = cells[name]
        conf = next(c for c in self.spec["configs"] if c["name"] == w["config"])
        config = self._json(conf["file"])
        traffic = self._json(os.path.join(self.folder, "traffic", w["traffic"] + ".json"))

        def applies(m: dict) -> bool:
            return name in m.get("workloads", [name])

        e2e = [Metric(m["name"], m["unit"], m["source"], m["better"])
               for m in self.spec["end_to_end"] if applies(m)]
        per_layer = [Metric(m["name"], m["unit"], m["source"], m["better"], m["moves"],
                            m["layer"])
                     for m in self.spec["per_layer"] if applies(m)
                     and any(e.name == m["moves"] for e in e2e)]
        return Cell(name, config, traffic, int(w["chips"]), e2e, per_layer)

    def _module(self, kind: str, name: str) -> ModuleType:
        """``<kind>/<name>.py`` under the benchmark's folder, loaded by path
        once."""
        path = os.path.join(self.folder, kind, name + ".py")
        if path not in self._modules:
            if not os.path.isfile(path):
                raise FileNotFoundError(f"no {kind} {name!r}: {path} does not exist")
            spec = importlib.util.spec_from_file_location(
                f"port_bench_{kind}_" + name.replace(".", "_").replace("-", "_"), path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            self._modules[path] = module
        return self._modules[path]

    def reader(self, metric: str) -> ModuleType:
        """The reader module ``metrics/<metric>.py``: ``read(run)`` gives the
        metric's value, or None where the run holds nothing to read."""
        return self._module("metrics", metric)

    def family(self, name: str) -> ModuleType:
        """The decoder family ``families/<name>.py`` that a configuration's
        ``"family"`` names (``families/__init__.py`` says what it gives)."""
        return self._module("families", name)
