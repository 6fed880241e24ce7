"""BENCHMARK.json and the files it names, found by name.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric sits in a file of its own, so a later change adds a cell by
adding files and entries, never by editing one:

  portbench/configs/<config>.json    the configuration as it is run
  portbench/traffic/<traffic>.json   the mix: parameters the one generator reads
  portbench/metrics/<metric>.py      the reader of one per-layer metric
  portbench/limits/<workload>.json   the limits of the numbers `correct` compares
"""

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def check_name(name: str) -> str:
    if not isinstance(name, str) or not NAME_RE.match(name):
        raise ValueError(f"not a valid name: {name!r}")
    return name


def check_unit(unit: str) -> str:
    if not isinstance(unit, str) or not UNIT_RE.match(unit):
        raise ValueError(f"not a valid unit: {unit!r}")
    return unit


@dataclass
class Cell:
    """One workload of BENCHMARK.json with everything it names, loaded."""

    name: str
    chips: int
    config: dict  # the configuration file's document
    traffic: dict  # the traffic file's parameters
    limits: dict  # {number: limit}
    end_to_end: list  # the metric entries this cell reports with --trace 0
    per_layer: list  # ... and with --trace 1
    bench_dir: Path = BENCH_DIR  # where its files were found


def _applies(metric: dict, workload: str) -> bool:
    return workload in metric.get("workloads", [workload])


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def load_cell(name: str, bench: dict | None = None, bench_dir: Path = BENCH_DIR) -> Cell:
    """The workload `name` with its configuration, traffic, limits and metrics."""
    bench = load_benchmark() if bench is None else bench
    check_name(name)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(by_name)})")
    w = by_name[name]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((bench_dir.parent / cfg_entry["file"]).read_text())
    traffic = json.loads((bench_dir / "traffic" / f"{check_name(w['traffic'])}.json").read_text())
    limits = json.loads((bench_dir / "limits" / f"{name}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, name) and m["moves"] in e2e_names]
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic, limits=limits, end_to_end=e2e,
                per_layer=per_layer, bench_dir=Path(bench_dir))


def load_reader(metric: str, bench_dir: Path = BENCH_DIR):
    """The `read(run)` function of portbench/metrics/<metric>.py."""
    path = bench_dir / "metrics" / f"{check_name(metric)}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
