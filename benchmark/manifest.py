"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
Everything else is looked up from those names, so a new configuration, mix,
metric or entry is a new file and a new entry in ``BENCHMARK.json``, never an
edit:

- ``configs/<config>.json``: the deployment, as it is run;
- ``traffic/<traffic>.json``: the mix; its ``entry`` names the adapter;
- ``entries/<entry>.py``: the adapter around one entry point of the port;
- ``work/<entry>.py``: the bytes and operations a request of it needs;
- ``faults/<entry>.py``: the faults the CPU tests plant under it;
- ``metrics/<metric>.py``: the reader of one per-layer metric.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def load_manifest(path: Path = MANIFEST) -> dict:
    return json.loads(Path(path).read_text())


def cell(manifest: dict, workload: str) -> dict:
    for c in manifest["workloads"]:
        if c["name"] == workload:
            return c
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def _json(folder: str, name: str) -> dict:
    if not NAME.fullmatch(name):
        raise ValueError(f"not a name: {name!r}")
    return json.loads((HERE / folder / f"{name}.json").read_text())


def config(name: str) -> dict:
    return _json("configs", name)


def traffic(name: str) -> dict:
    return _json("traffic", name)


def _module(folder: str, name: str) -> ModuleType:
    """Load ``<folder>/<name>.py``. Metric names hold dots, so files are
    loaded by path, not imported by dotted name."""
    if not NAME.fullmatch(name):
        raise ValueError(f"not a name: {name!r}")
    qualified = f"benchmark.{folder}.{name}"
    if qualified in sys.modules:
        return sys.modules[qualified]
    path = HERE / folder / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(qualified, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[qualified] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[qualified]
        raise
    return mod


def entry(name: str) -> ModuleType:
    return _module("entries", name)


def work(name: str) -> ModuleType:
    return _module("work", name)


def faults(name: str) -> ModuleType:
    return _module("faults", name)


def metric_reader(name: str) -> ModuleType:
    return _module("metrics", name)


def quantity(name: str) -> str:
    """What a metric measures: its name before any suffix that splits one
    quantity among cells (``request_p50_ms.b1`` is ``request_p50_ms``)."""
    return name.split(".")[0]


def reports(metric: dict, workload: str) -> bool:
    """Whether a cell reports an end-to-end metric: listed in the metric's
    ``workloads``, or, without that key, in every cell."""
    return "workloads" not in metric or workload in metric["workloads"]


def end_to_end(manifest: dict, workload: str) -> list[dict]:
    return [m for m in manifest["end_to_end"] if reports(m, workload)]


def per_layer(manifest: dict, workload: str) -> list[dict]:
    """The per-layer metrics of a cell: those that list it, and those with
    no list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end(manifest, workload)}
    return [m for m in manifest["per_layer"]
            if workload in m.get("workloads", ()) or ("workloads" not in m and m["moves"] in e2e)]
