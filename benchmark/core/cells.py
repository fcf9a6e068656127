"""Finding a cell's files by the names in BENCHMARK.json.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
Each lives in files of its own, found by name:

* ``configs/<config>.json``: the configuration as it is run (the port's
  YAML parameters, with ``source``, ``reduced`` and ``assumed`` beside);
* ``traffic/<traffic>.json``: the traffic mix's parameters, whose ``kind``
  names the generator that reads them, ``traffic/<kind>.py``;
* ``workloads/<cell>.json``: the cell's own check: the sample that is
  compared with the reference and each number's limit;
* ``metrics/<metric>.py``: the reader of a per-layer metric.

Adding a configuration, a mix, a cell or a per-layer metric adds files and
entries; no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH_DIR)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """The Python file at ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict           # its line in BENCHMARK.json's workloads
    config: dict          # configs/<config>.json
    mix: dict             # traffic/<traffic>.json
    check: dict           # workloads/<cell>.json
    end_to_end: list      # BENCHMARK.json's end-to-end metrics it reports
    per_layer: list       # and its per-layer metrics
    root: str             # the benchmark's directory

    def kind(self):
        """The module of the mix's kind, ``traffic/<kind>.py``."""
        kind = self.mix["kind"]
        return load_module(os.path.join(self.root, "traffic", f"{kind}.py"),
                           f"benchmark_traffic_{kind}")

    def reader(self, metric: str):
        """The reader of a per-layer metric, ``metrics/<metric>.py``."""
        return load_module(os.path.join(self.root, "metrics",
                                        f"{metric}.py"),
                           "benchmark_metric_" + metric.replace(".", "_"))


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find(name: str, root: str = BENCH_DIR) -> Cell:
    """The cell ``name`` of the BENCHMARK.json beside ``root``."""
    spec = load_json(os.path.join(os.path.dirname(root), "BENCHMARK.json"))
    entries = {w["name"]: w for w in spec["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(has {sorted(entries)})")
    entry = entries[name]
    config = next(c for c in spec["configs"] if c["name"] == entry["config"])
    e2e = [m for m in spec["end_to_end"] if _applies(m, name)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in moved)]
    return Cell(
        name=name, entry=entry,
        config=load_json(os.path.join(os.path.dirname(root),
                                      config["file"])),
        mix=load_json(os.path.join(root, "traffic",
                                   f"{entry['traffic']}.json")),
        check=load_json(os.path.join(root, "workloads", f"{name}.json")),
        end_to_end=e2e, per_layer=per_layer, root=root)
