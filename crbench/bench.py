"""Finding a cell's parts by name: ``BENCHMARK.json`` names the cell,
its configuration and traffic mix, and its metrics; each part is a file
of its own under the benchmark's directory, so a later change adds a
part by adding a file:

    <dir>/configs/<configuration>.json   (the path BENCHMARK.json gives)
    <dir>/traffic/<traffic>.json
    <dir>/metrics/<metric>.py            (``read(record) -> float | None``;
                                          ``<base>.<part>`` falls back to
                                          ``<base>.py``)
    <dir>/limits/<configuration>.json    (the limits ``correct`` uses)
    <dir>/reference/<model>.py           (a configuration's ``reference``)
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path


class Bench:
    def __init__(self, root):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dir = self.root / self.spec["paths"][0]

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        entry = next(c for c in self.spec["configs"] if c["name"] == name)
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def limits(self, config: str) -> dict:
        return json.loads((self.dir / "limits" / f"{config}.json").read_text())

    def metrics(self, workload: str, traced: bool) -> list:
        """[(entry, reader module)] of the metrics a run of `workload`
        reports: its end-to-end metrics, or with a trace its per-layer
        ones."""
        return [(m, self._reader(m["name"]))
                for m in self.spec["per_layer" if traced else "end_to_end"]
                if self.reports(m, workload)]

    def reports(self, m: dict, workload: str) -> bool:
        """Whether a run of `workload` reports metric `m`: the cells its
        ``workloads`` lists; without that key, every cell (an end-to-end
        metric) or every cell that reports the end-to-end metric it
        ``moves`` (a per-layer one)."""
        if "workloads" in m:
            return workload in m["workloads"]
        if "moves" in m:
            return self.reports(next(e for e in self.spec["end_to_end"]
                                     if e["name"] == m["moves"]), workload)
        return True

    def _reader(self, name: str):
        """``metrics/<name>.py``. A metric split by the end-to-end metric
        it moves, ``<base>.<part>``, reads with ``metrics/<base>.py``
        where it has no file of its own."""
        if not (self.dir / "metrics" / f"{name}.py").exists():
            name = name.split(".")[0]
        return self._module("metrics", name)

    def reference(self, model: str):
        return self._module("reference", model)

    def _module(self, kind: str, name: str):
        path = self.dir / kind / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"crbench_{kind}_{name.replace('.', '_').replace('-', '_')}",
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
