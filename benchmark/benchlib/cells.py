"""Finding a cell's pieces by name.

``BENCHMARK.json`` at the root of the checkout names each cell's
configuration and traffic mix. Each piece is a file of its own under the
benchmark's folder, so a later change adds a cell, a configuration, a
mix, a driver or a per-layer metric by adding files and entries, and
edits none:

- ``configs/<config>.json``: one deployment (its path is the
  configuration's ``file`` in ``BENCHMARK.json``); its ``driver`` names
- ``drivers/<driver>.py``: builds and searches one kind of index;
- ``traffic/<traffic>.json``: one traffic mix;
- ``metrics/<metric>.py``: one per-layer metric's reader, ``read(ctx)``.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCHMARK_FILE = "BENCHMARK.json"


class Cell:
    """One workload of ``BENCHMARK.json`` with its pieces loaded."""

    def __init__(self, root: Path, name: str):
        self.root = Path(root)
        self.bench = json.loads((self.root / BENCHMARK_FILE).read_text())
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in {BENCHMARK_FILE}; "
                           f"known: {sorted(cells)}")
        self.workload = cells[name]
        self.name = name
        self.dir = self.root / self.bench["paths"][0]
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config = json.loads(
            (self.root / self.config_entry["file"]).read_text())
        self.traffic = json.loads(
            (self.dir / "traffic" / f"{self.workload['traffic']}.json")
            .read_text())
        self.driver = load_module(self.dir / "drivers"
                                  / f"{self.config['driver']}.py",
                                  f"bench_driver_{self.config['driver']}")

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])

    def _reports(self, metric: Dict) -> bool:
        if "workloads" in metric:
            return self.name in metric["workloads"]
        return True

    def end_to_end(self) -> List[Dict]:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.bench["end_to_end"] if self._reports(m)]

    def per_layer(self) -> List[Dict]:
        """The per-layer metrics this cell reports: those that list it,
        and those with no list that move one of its end-to-end metrics."""
        moved = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if self._reports(m) and m["moves"] in moved]

    def reader(self, metric: str) -> ModuleType:
        return load_module(self.dir / "metrics" / f"{metric}.py",
                           "bench_metric_" + metric.replace(".", "_")
                           .replace("-", "_"))


def load_module(path: Path, name: str) -> ModuleType:
    """Import a file of the benchmark by its path (its name may hold a
    dot or a dash)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
