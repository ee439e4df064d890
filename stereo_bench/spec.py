"""Finding the benchmark's pieces by name: the cells of ``BENCHMARK.json``,
their configurations (``configs/<name>.json``), traffic mixes
(``traffic/<name>.json``) and per-layer metric readers
(``metrics/<name>.py``)."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# what a metric reader declares beside its ``read``
READER_KEYS = ("LAYER", "UNIT", "SOURCE", "MOVES", "BETTER")


def benchmark(root: Path = ROOT) -> Dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(kind: str, name: str, here: Path = HERE) -> Dict:
    """``configs/<name>.json`` or ``traffic/<name>.json``."""
    if not NAME.match(name):
        raise ValueError(f"{name!r} is not a name")
    with open(here / kind / f"{name}.json") as f:
        return json.load(f)


def cell(name: str, root: Path = ROOT, here: Path = HERE) -> Dict:
    """The workload ``name`` with its configuration and traffic mix read."""
    bench = benchmark(root)
    for w in bench["workloads"]:
        if w["name"] == name:
            return {**w, "config_data": load_json("configs", w["config"], here),
                    "traffic_data": load_json("traffic", w["traffic"], here)}
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"(cells: {[w['name'] for w in bench['workloads']]})")


def reader(name: str, here: Path = HERE) -> ModuleType:
    """The module ``metrics/<name>.py`` (a metric's name may hold dots, so it
    is loaded from its path)."""
    if not NAME.match(name):
        raise ValueError(f"{name!r} is not a name")
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"stereo_bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    missing = [k for k in READER_KEYS + ("read", "reads") if not hasattr(mod, k)]
    if missing:
        raise AttributeError(f"metrics/{name}.py lacks {missing}")
    return mod


def metrics_for(cell_name: str, kind: str, root: Path = ROOT) -> List[Dict]:
    """The ``end_to_end`` or ``per_layer`` entries that apply to a cell: those
    without ``workloads`` and those whose ``workloads`` name it."""
    return [m for m in benchmark(root)[kind]
            if "workloads" not in m or cell_name in m["workloads"]]
