"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; its parameters live in ``benchmark/cells/<cell>.json``, the
configuration's in the file its ``configs`` entry names, each per-layer
metric's reader in ``benchmark/metrics/<metric>.py``, each kind of a
cell's labels in ``benchmark/traffic/<kind>.py``, each solver's reading of
the program's optimizer state in ``benchmark/solvers/<method>.py``, each
model family's reference in ``benchmark/reference/<family>.py`` and each
kernel count in ``benchmark/roofline/<kernel>.py``. Adding any of them is
adding a file and an entry; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType, SimpleNamespace
from typing import List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _by_name(entries: List[dict], name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"{what} {name!r} is not in BENCHMARK.json")


def applies(metric: dict, cell: str, reported: List[str]) -> bool:
    """Whether ``metric`` is read in ``cell``: those listed under its
    ``workloads``, else (a per-layer metric) every cell that reports the
    end-to-end metric it moves, else every cell."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        return metric["moves"] in reported
    return True


def load_module(path: Path, name: str) -> ModuleType:
    """The Python file at ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def resolve(manifest: dict, workload: str, root: Path = ROOT) -> SimpleNamespace:
    """Everything one cell needs, by name: its entry, its traffic file, its
    configuration's entry and file, and the end-to-end and per-layer
    metrics it reports."""
    entry = _by_name(manifest["workloads"], workload, "workload")
    config = _by_name(manifest["configs"], entry["config"], "config")
    traffic = load_json(root / "benchmark" / "cells" / f"{workload}.json")
    if traffic.get("traffic") != entry["traffic"] or traffic.get("config") != entry["config"]:
        raise ValueError(f"benchmark/cells/{workload}.json does not match its BENCHMARK.json entry")
    end_to_end = [m for m in manifest["end_to_end"] if applies(m, workload, [])]
    names = [m["name"] for m in end_to_end]
    per_layer = [m for m in manifest["per_layer"] if applies(m, workload, names)]
    return SimpleNamespace(name=workload, entry=entry, traffic=traffic, config=config,
                           spec=load_json(root / config["file"]), end_to_end=end_to_end,
                           per_layer=per_layer)


def reader(metric: str, root: Path = ROOT) -> ModuleType:
    """The reader of per-layer metric ``metric``: ``benchmark/metrics/<metric>.py``."""
    return load_module(root / "benchmark" / "metrics" / f"{metric}.py", f"bench_metric_{metric}")


def traffic_kind(kind: str, root: Path = ROOT) -> ModuleType:
    """The maker of a cell's ``infos`` for labels of ``kind``:
    ``benchmark/traffic/<kind>.py``."""
    return load_module(root / "benchmark" / "traffic" / f"{kind}.py", f"bench_traffic_{kind}")


def solver(method: str, root: Path = ROOT) -> ModuleType:
    """How the first gradient is read from the program's optimizer state:
    ``benchmark/solvers/<method>.py``."""
    return load_module(root / "benchmark" / "solvers" / f"{method}.py", f"bench_solver_{method}")


def reference(family: str) -> ModuleType:
    """The plain reference of a model family: ``benchmark/reference/<family>.py``."""
    return importlib.import_module(f"reference.{family}")
