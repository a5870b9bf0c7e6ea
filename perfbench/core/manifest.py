"""BENCHMARK.json and the files it names, resolved by name.

A cell (an entry of "workloads") joins a configuration and a traffic
mix. Each piece is found by its name alone:

  configs/<config>.json        the configuration (published flags, sizes)
  traffic/<traffic>.json       the traffic mix: its loop and parameters
  loops/<loop>.py              the loop the mix names (set-up, window,
                               check): shared by every mix of that loop
  reference/<config>.py        the configuration's plain reference
  counts/<config>.py           its matmul FLOPs and kernel bytes
  metrics/<metric>.py          one reader per metric
  limits/<workload>.json       the limits of the cell's correctness check

staged.json holds entries of the same form for cells that are written
and proven correct but that BENCHMARK.json does not hold yet; run.py,
the tests and the tools resolve them by name as well.

A name whose file is missing fails at load, naming what is missing.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


class ManifestError(ValueError):
    """A cell, configuration, mix or metric that cannot be resolved."""


def load_benchmark(root: Path = ROOT) -> dict:
    path = Path(root) / "BENCHMARK.json"
    if not path.exists():
        raise ManifestError(f"no BENCHMARK.json at {path}")
    with open(path) as f:
        return json.load(f)


GROUPS = ("configs", "workloads", "end_to_end", "per_layer")


def catalog(root: Path = ROOT) -> dict:
    """BENCHMARK.json with staged.json's entries after its own; a staged
    entry whose name BENCHMARK.json already holds is left out, so that a
    cell moves into the benchmark by entries added there alone."""
    bench = load_benchmark(root)
    staged = BENCH_DIR / "staged.json"
    if staged.exists():
        with open(staged) as f:
            extra = json.load(f)
        bench = dict(bench)
        for group in GROUPS:
            have = {e["name"] for e in bench[group]}
            bench[group] = bench[group] + [
                e for e in extra.get(group, []) if e["name"] not in have]
    return bench


def load_json(path: Path, what: str) -> dict:
    if not path.exists():
        raise ManifestError(f"{what}: missing file {path.relative_to(ROOT)}")
    with open(path) as f:
        return json.load(f)


def load_file(path: Path, what: str) -> ModuleType:
    """Import a Python file by path (metric names hold dots)."""
    if not path.exists():
        raise ManifestError(f"{what}: missing file {path.relative_to(ROOT)}")
    name = "perfbench_file_" + re.sub(r"\W", "_", str(
        path.relative_to(BENCH_DIR)))
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    kind: str                      # "end_to_end" or "per_layer"
    entry: dict
    reader: ModuleType


@dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    loop: ModuleType
    reference: ModuleType
    counts: ModuleType
    limits: Dict[str, float]
    end_to_end: List[Metric] = field(default_factory=list)
    per_layer: List[Metric] = field(default_factory=list)


def _metrics_for(bench: dict, kind: str, cell: str) -> List[Metric]:
    out = []
    for m in bench.get(kind, []):
        if "workloads" in m and cell not in m["workloads"]:
            continue
        reader = load_file(BENCH_DIR / "metrics" / f"{m['name']}.py",
                           f"metric {m['name']}")
        if not hasattr(reader, "read"):
            raise ManifestError(f"metric {m['name']}: its reader has no "
                                "read(record)")
        out.append(Metric(m["name"], m["unit"], m["better"], m["source"],
                          kind, m, reader))
    return out


def resolve(workload: str, root: Path = ROOT,
            bench: Optional[dict] = None) -> Cell:
    """The cell `workload` (of BENCHMARK.json or staged.json) with every
    file it needs loaded."""
    bench = catalog(root) if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise ManifestError(f"no workload {workload!r} in BENCHMARK.json "
                            f"or staged.json (have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    if w["config"] not in configs:
        raise ManifestError(f"workload {workload}: no config "
                            f"{w['config']!r}")
    entry = configs[w["config"]]
    config = load_json(ROOT / entry["file"], f"config {w['config']}")
    traffic = load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json",
                        f"traffic {w['traffic']}")
    loop_name = traffic.get("loop", "")
    if not NAME_RE.match(loop_name) or "." in loop_name:
        raise ManifestError(f"traffic {w['traffic']}: bad loop "
                            f"{loop_name!r}")
    if not (BENCH_DIR / "loops" / f"{loop_name}.py").exists():
        raise ManifestError(f"traffic {w['traffic']}: missing loop file "
                            f"perfbench/loops/{loop_name}.py")
    loop = importlib.import_module(f"perfbench.loops.{loop_name}")
    reference = load_file(BENCH_DIR / "reference" / f"{w['config']}.py",
                          f"reference of {w['config']}")
    counts = load_file(BENCH_DIR / "counts" / f"{w['config']}.py",
                       f"counts of {w['config']}")
    limits = load_json(BENCH_DIR / "limits" / f"{workload}.json",
                       f"limits of {workload}")
    return Cell(workload, w["config"], w["traffic"], int(w["chips"]),
                config, traffic, loop, reference, counts, limits,
                _metrics_for(bench, "end_to_end", workload),
                _metrics_for(bench, "per_layer", workload))


def check_names(bench: dict) -> List[str]:
    """Every name, unit and path rule of the contract that a file can
    break on its own -> the breaches (empty when none)."""
    bad = []
    names = [c["name"] for c in bench["configs"]]
    names += [w["name"] for w in bench["workloads"]]
    names += [w["config"] for w in bench["workloads"]]
    names += [w["traffic"] for w in bench["workloads"]]
    for c in bench["configs"]:
        names += list(c.get("reduced", []))
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            names.append(m["name"])
            if not UNIT_RE.match(m["unit"]):
                bad.append(f"unit {m['unit']!r} of {m['name']}")
            if m["better"] not in ("lower", "higher"):
                bad.append(f"better of {m['name']}")
    bad += [f"name {n!r}" for n in names if not NAME_RE.match(n)]
    for group in ("configs", "workloads"):
        seen = [x["name"] for x in bench[group]]
        if len(seen) != len(set(seen)):
            bad.append(f"duplicate names in {group}")
    metric_names = [m["name"] for k in ("end_to_end", "per_layer")
                    for m in bench[k]]
    if len(metric_names) != len(set(metric_names)):
        bad.append("duplicate metric names")
    return bad
