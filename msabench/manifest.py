"""BENCHMARK.json and the files it names, found by name.

``Manifest(root)`` reads ``root/BENCHMARK.json``; a cell's configuration
is the file its ``configs`` entry names, its traffic mix
``msabench/traffic/<traffic>.json``, each metric's reader
``msabench/metrics/<name>.py`` and each check that the configuration's
``limits`` name ``msabench/checks/<name>.py``, all under ``root``.
Nothing here knows a cell, a mix, a metric or a check by name: a later
one is an added file and an added entry.
"""

import importlib.util
import json
import os
import re

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
END_TO_END_SOURCES = ("host_clock", "device_trace")
PACKAGE = "msabench"


class Manifest:
    """The benchmark under ``root`` (the checkout's root)."""

    def __init__(self, root: str):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as fh:
            self.data = json.load(fh)
        self._readers = {}

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        """The configuration's file, as a dict."""
        for c in self.data["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"])) as fh:
                    return json.load(fh)
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic_path(self, name: str) -> str:
        return os.path.join(self.root, PACKAGE, "traffic", name + ".json")

    def traffic(self, name: str) -> dict:
        with open(self.traffic_path(name)) as fh:
            return json.load(fh)

    def metric_path(self, name: str) -> str:
        return os.path.join(self.root, PACKAGE, "metrics", name + ".py")

    def check_path(self, name: str) -> str:
        return os.path.join(self.root, PACKAGE, "checks", name + ".py")

    def _load(self, kind: str, name: str, path: str):
        key = (kind, name)
        if key not in self._readers:
            spec = importlib.util.spec_from_file_location(
                f"{PACKAGE}_{kind}_"
                f"{name.replace('.', '_').replace('-', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._readers[key] = mod
        return self._readers[key]

    def reader(self, name: str):
        """The metric's reader module (loaded from its file once)."""
        return self._load("metric", name, self.metric_path(name))

    def check(self, name: str):
        """The check's module (loaded from its file once)."""
        return self._load("check", name, self.check_path(name))

    def metrics(self, cell: str, trace: bool):
        """The metric entries a run of the cell reports: with trace the
        per-layer ones, else the end-to-end ones; an entry with a
        ``workloads`` key only in the cells it lists."""
        key = "per_layer" if trace else "end_to_end"
        return [m for m in self.data[key]
                if cell in m.get("workloads", [cell])]
