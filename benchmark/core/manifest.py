"""``BENCHMARK.json`` and the files its names lead to.

A cell's configuration is the file its ``configs`` entry names; its
traffic mix is ``benchmark/traffic/<traffic>.json``, whose ``driver`` key
names the module ``benchmark/traffic/<driver>.py`` that runs it; a
per-layer metric is read by ``benchmark/metrics/<metric>.py``.
"""

import importlib
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Manifest:
    def __init__(self, root):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.data = json.load(f)

    def workload(self, name):
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name):
        for c in self.data["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"])) as f:
                    return json.load(f)
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def end_to_end(self, cell):
        """The end-to-end metrics the cell reports."""
        return [m for m in self.data["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell):
        """The per-layer metrics read in the cell's traced run."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.data["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]


def traffic(name):
    with open(os.path.join(BENCH_DIR, "traffic", name + ".json")) as f:
        return json.load(f)


def driver(name):
    return importlib.import_module(f"benchmark.traffic.{name}")


def reader(metric):
    """The ``read`` function of ``benchmark/metrics/<metric>.py``."""
    path = os.path.join(BENCH_DIR, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
