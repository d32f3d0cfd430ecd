"""Find a cell's pieces by name: ``BENCHMARK.json`` at the root of the
checkout lists the cells, configurations and metrics; a configuration's
sizes are the JSON file its entry names, and its ``"family"`` key names the
module ``benchmark/families/<family>.py`` that builds, drives and checks
it; a traffic mix is ``benchmark/traffic/<traffic>.json``; a metric is read
by ``benchmark/metrics/<metric>.py``. Adding a family, a cell, a
configuration, a mix or a metric adds files and entries and edits none of
this code.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(name: str, spec: dict = None) -> dict:
    """The cell ``name``: its entry, its configuration (``config``, the
    file's contents) and its traffic mix (``traffic``)."""
    spec = spec or benchmark()
    found = [w for w in spec["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json "
                       f"(cells: {', '.join(w['name'] for w in spec['workloads'])})")
    entry = found[0]
    cfg_entry = next(c for c in spec["configs"] if c["name"] == entry["config"])
    cfg = json.loads((ROOT / cfg_entry["file"]).read_text())
    if "family" not in cfg:
        raise KeyError(f"{cfg_entry['file']}: no \"family\" key (the module "
                       f"benchmark/families/<family>.py that runs the configuration)")
    return {"entry": entry,
            "config": cfg,
            "traffic": json.loads((BENCH_DIR / "traffic" / f"{entry['traffic']}.json").read_text())}


def metrics_of(name: str, trace: bool, spec: dict = None) -> List[dict]:
    """The metrics a run of cell ``name`` reports: with ``trace`` the
    per-layer ones, else the end-to-end ones; a metric with a
    ``workloads`` list only in those cells, one without in every cell that
    reports the end-to-end metric it moves."""
    spec = spec or benchmark()
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    mine = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (name in m["workloads"] if "workloads" in m else m["moves"] in mine)]


_readers: Dict[str, ModuleType] = {}


def reader(metric: str) -> ModuleType:
    """The module ``benchmark/metrics/<metric>.py``; its ``read(run)``
    returns the metric's value, or None where it finds nothing to read."""
    if metric not in _readers:
        path = BENCH_DIR / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"bench_metric_{metric.replace('.', '_')}",
                                                      path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _readers[metric] = mod
    return _readers[metric]


def family(cfg: dict) -> ModuleType:
    """The module ``benchmark/families/<family>.py`` of configuration
    ``cfg`` (its ``"family"`` key), imported on first use."""
    name = cfg["family"]
    if not name.isidentifier() or not (BENCH_DIR / "families" / f"{name}.py").is_file():
        raise ValueError(f"configuration {cfg.get('name')!r}: no family module "
                         f"benchmark/families/{name}.py")
    return importlib.import_module(f"{__package__.rpartition('.')[0]}.families.{name}")
