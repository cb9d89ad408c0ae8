"""Find a cell's configuration, traffic mix, driver and metric readers by name.

Everything that belongs to one configuration, traffic mix, entry or
per-layer metric sits in a file of its own, found from the names in
``BENCHMARK.json``:

* ``configs/<config>.json``: the configuration as it is run;
* ``traffic/<traffic>.json``: the traffic mix, naming its ``driver``;
* ``drivers/<driver>.py``: one entry of the port, ``run(cell) -> Outcome``;
* ``metrics/<metric>.py``: one reader, ``read(ctx) -> number or None``.

Nothing is imported that the cell does not name.
"""

from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """The Python file at ``path`` as a module (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name.replace(".", "_").replace("-", "_"), path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of ``BENCHMARK.json`` with what it names."""

    def __init__(self, name: str, root: str = ROOT):
        self.root = root
        self.bench_dir = os.path.join(root, "benchmark")
        self.spec = load_json(os.path.join(root, "BENCHMARK.json"))
        found = [w for w in self.spec["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.workload = found[0]
        self.name = name
        self.chips = int(self.workload["chips"])
        cfg_entry = [c for c in self.spec["configs"] if c["name"] == self.workload["config"]][0]
        self.config = load_json(os.path.join(root, cfg_entry["file"]))
        self.traffic = load_json(os.path.join(self.bench_dir, "traffic",
                                              self.workload["traffic"] + ".json"))

    def driver(self):
        name = self.traffic["driver"]
        return load_module(os.path.join(self.bench_dir, "drivers", name + ".py"), "driver_" + name)

    def _applies(self, metric: dict, e2e_names: set) -> bool:
        if "workloads" in metric:
            return self.name in metric["workloads"]
        return metric.get("moves", metric["name"]) in e2e_names

    def end_to_end(self) -> list:
        """The cell's end-to-end metrics (a metric without ``workloads`` is
        every cell's)."""
        return [m for m in self.spec["end_to_end"]
                if "workloads" not in m or self.name in m["workloads"]]

    def per_layer(self) -> list:
        e2e = {m["name"] for m in self.end_to_end()}
        return [m for m in self.spec["per_layer"] if self._applies(m, e2e)]

    def reader(self, metric_name: str):
        return load_module(os.path.join(self.bench_dir, "metrics", metric_name + ".py"),
                           "metric_" + metric_name)
