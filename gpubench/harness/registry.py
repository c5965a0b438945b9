"""Everything a run needs, found by name.

``BENCHMARK.json`` at the checkout's root names the cells, configurations
and metrics; each has files of its own under ``gpubench/``:

- ``workloads/<cell>.json``: the cell's configuration and traffic (as in
  the manifest), the environment it sets, and the limit of each number
  its check compares;
- ``configs/<config>.json``: the model's sizes as run, with ``source``,
  ``reduced`` and ``assumed``; its plain reference is
  ``reference/<reference>.py``;
- ``traffic/<mix>.json``: the mix's parameters, read by
  ``harness/feed.py``, and the ``loop`` (``loops/<loop>.py``) that
  runs it;
- ``metrics/<metric>.py``: the reader of each metric;
- ``work/<op>.py``: an op's call sites, and its operations and bytes.

A later cell, mix, configuration, metric or op is a new file and a new
manifest entry; nothing here names one.
"""

import importlib.util
import json
import os


class Registry:
    """The manifest and the files of the checkout at ``root``."""

    def __init__(self, root, manifest=None):
        self.root, self.dir = root, os.path.join(root, "gpubench")
        if manifest is None:
            with open(os.path.join(root, "BENCHMARK.json")) as f:
                manifest = json.load(f)
        self.manifest = manifest

    def _json(self, kind, name):
        with open(os.path.join(self.dir, kind, name + ".json")) as f:
            return json.load(f)

    def cell(self, name):
        entry = next((w for w in self.manifest["workloads"] if w["name"] == name), None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        cell = self._json("workloads", name)
        for key in ("config", "traffic"):
            if cell[key] != entry[key]:
                raise ValueError(f"workloads/{name}.json names {key} {cell[key]!r}, "
                                 f"BENCHMARK.json {entry[key]!r}")
        return dict(cell, name=name, chips=entry["chips"])

    def config(self, name):
        return self._json("configs", name)

    def traffic(self, name):
        return self._json("traffic", name)

    def _module(self, kind, name):
        path = os.path.join(self.dir, kind, name + ".py")
        spec = importlib.util.spec_from_file_location(f"gpubench.{kind}.{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def metric(self, name):
        return self._module("metrics", name)

    def work(self, op):
        return self._module("work", op)

    def loop(self, name):
        return self._module("loops", name)

    def metrics_of(self, cell, section):
        """The manifest's metrics of ``section`` that ``cell`` reports: those
        that list it, and those without a list whose moved metric it
        reports (end-to-end metrics without a list: every cell)."""
        e2e = {m["name"] for m in self.manifest["end_to_end"]
               if cell in m.get("workloads", [cell])}
        out = []
        for m in self.manifest[section]:
            if "workloads" in m:
                if cell in m["workloads"]:
                    out.append(m)
            elif section == "end_to_end" or m["moves"] in e2e:
                out.append(m)
        return out
