"""Resolve a cell of ``BENCHMARK.json`` into the files that define it.

Every piece is found by the name ``BENCHMARK.json`` gives it, so a new
configuration, traffic mix, per-layer metric or reference is a new file
and a new entry, never an edit:

* the configuration: the ``file`` of its ``configs`` entry;
* the traffic mix: ``portbench/traffic/<traffic>.json``;
* the plain reference: ``portbench/reference/<family>.py``, where
  ``family`` is the configuration file's ``reference`` key;
* the limits of the comparison: ``portbench/limits/<cell>.json``;
* each per-layer metric: ``portbench/metrics/<metric>.py``.  Every cell
  loads every reader, and a reader that finds nothing to read in a cell
  returns None, so the metric is left out of that cell's line; a metric's
  ``workloads`` list tells the driver where to expect it, and the harness
  does not read it.

A name that resolves to no file raises ``MissingPiece``.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent
BENCH_DIR = HERE.parent
ROOT = BENCH_DIR.parent


class MissingPiece(LookupError):
    """A name in ``BENCHMARK.json`` that resolves to no file."""


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with everything it names, loaded."""
    name: str
    chips: int
    config: dict            # the configuration file
    traffic: dict           # the traffic mix's parameters
    limits: dict            # {reading: limit}
    reference: ModuleType   # the plain reference of the config's family
    end_to_end: List[dict]  # the entries that apply to this cell
    per_layer: Dict[str, ModuleType]   # metric name -> its reader module
    per_layer_spec: List[dict]


def load_benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise MissingPiece(f"no BENCHMARK.json at {root}")
    return json.loads(path.read_text())


def _json(path: Path, what: str) -> dict:
    if not path.is_file():
        raise MissingPiece(f"{what}: no file {path}")
    return json.loads(path.read_text())


def load_module(path: Path, what: str) -> ModuleType:
    """Import the Python file ``path`` under a name of its own (metric
    names hold dots, so they are not importable as package members)."""
    if not path.is_file():
        raise MissingPiece(f"{what}: no file {path}")
    name = "portbench_piece_" + "".join(
        c if c.isalnum() else "_" for c in str(path.relative_to(
            path.parents[1])))
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``, resolved."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise MissingPiece(f"no workload {name!r} in BENCHMARK.json; have "
                           f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    if w["config"] not in configs:
        raise MissingPiece(f"workload {name!r}: no config {w['config']!r}")
    config = _json(root / configs[w["config"]]["file"],
                   f"config {w['config']!r}")
    bench_dir = root / "portbench"
    traffic = _json(bench_dir / "traffic" / f"{w['traffic']}.json",
                    f"traffic {w['traffic']!r}")
    limits = _json(bench_dir / "limits" / f"{name}.json",
                   f"limits of {name!r}")
    reference = load_module(
        bench_dir / "reference" / f"{config['reference']}.py",
        f"reference {config['reference']!r}")
    per_layer_spec = bench["per_layer"]
    per_layer = {m["name"]: load_module(
        bench_dir / "metrics" / f"{m['name']}.py", f"metric {m['name']!r}")
        for m in per_layer_spec}
    end_to_end = [m for m in bench["end_to_end"] if _applies(m, name)]
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=limits["limits"],
                reference=reference, end_to_end=end_to_end,
                per_layer=per_layer, per_layer_spec=per_layer_spec)


def port_config(config: dict):
    """The port's ``ArchConfig`` as the configuration file states it: the
    registered arch ``config["port"]["arch"]`` with every field of
    ``config["port"]["fields"]`` (a field name, or ``<group>.<field>`` for
    a field of a nested group such as ``moe`` or ``ssm``, mapped to a key
    of the file) set to the file's value."""
    from repro_torch import configs
    port = config["port"]
    cfg = configs.get(port["arch"])
    top, groups = {}, {}
    for field, key in port["fields"].items():
        if key not in config:
            raise MissingPiece(f"config {config['name']!r}: port field "
                               f"{field!r} names no key {key!r}")
        group, _, sub = field.rpartition(".")
        if group:
            groups.setdefault(group, {})[sub] = config[key]
        else:
            top[field] = config[key]
    for group, fields in groups.items():
        top[group] = dataclasses.replace(getattr(cfg, group), **fields)
    return dataclasses.replace(cfg, **top)
