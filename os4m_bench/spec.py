"""Find a cell's configuration, traffic and metrics by name.

``BENCHMARK.json`` at the root of the checkout names every cell
(``workloads``), the configuration and traffic mix it runs, and the
metrics it reports. Each of those is a file of its own under this
directory, found by its name: ``configs/<config>.json``,
``traffic/<traffic>.json``, ``metrics/<metric>.py``. A later cell, mix or
metric is new files and entries, never an edit of these.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, List

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
BENCHMARK_JSON = ROOT / "BENCHMARK.json"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@dataclasses.dataclass(frozen=True)
class Metric:
    """One metric of ``BENCHMARK.json`` and the reader that computes it."""

    name: str
    unit: str
    read: Callable            # read(run) -> float | None


@dataclasses.dataclass(frozen=True)
class Cell:
    """One workload of ``BENCHMARK.json`` with its files loaded."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]


def _checked(name: str, what: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"{what} {name!r} is not a valid name")
    return name


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_reader(name: str) -> Callable:
    """``metrics/<name>.py``'s ``read`` function."""
    path = BENCH_DIR / "metrics" / f"{_checked(name, 'metric')}.py"
    spec = importlib.util.spec_from_file_location(
        "os4m_bench_metric_" + re.sub(r"\W", "_", name), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _metrics(entries: list, cell: str) -> List[Metric]:
    """The metrics of ``entries`` that ``cell`` reports: those that list it
    under ``workloads``, and those with no such list."""
    return [Metric(e["name"], e["unit"], load_reader(e["name"]))
            for e in entries if cell in e.get("workloads", (cell,))]


def load_cell(workload: str) -> Cell:
    """The cell named ``workload`` in ``BENCHMARK.json``, its files loaded.

    Raises ``KeyError`` for a name the benchmark does not hold."""
    bench = load_json(BENCHMARK_JSON)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; it has {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[w["config"]]["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{_checked(w['traffic'], 'traffic')}.json")
    return Cell(workload, int(w["chips"]), config, traffic,
                _metrics(bench["end_to_end"], workload), _metrics(bench["per_layer"], workload))
