"""Resolve a cell of BENCHMARK.json into the files that define it.

Everything that belongs to one configuration, traffic mix, stage, per-layer
metric or cell's limits sits in a file of its own under the benchmark's
folder and is found by name:

  configs/<config>.json        sizes and settings of a deployment
  traffic/<traffic>.json       the frame stream (names a generator)
  generators/<generator>.py    a general generator of streams
  stages/<stage>.json          functions the traced run wraps in a range
  metrics/<metric>.py          reader of one per-layer metric; a metric
                               named <family>.<arg> without a file of its
                               own is read by metrics/<family>.py with arg
  checks/<cell>.json           limits of the numbers that decide `correct`
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.dirname(BENCH_DIR)


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    stages: dict           # stage name -> list of "module:attribute" targets
    end_to_end: list       # manifest entries of this cell's end-to-end metrics
    per_layer: list        # manifest entries of this cell's per-layer metrics
    limits: dict           # compared number -> limit
    run_seconds: int


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest_path(root: str = REPO_DIR) -> str:
    return os.path.join(root, "BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_stages(bench_dir: str = BENCH_DIR) -> dict:
    out = {}
    d = os.path.join(bench_dir, "stages")
    for fn in sorted(os.listdir(d)):
        if fn.endswith(".json"):
            st = load_json(os.path.join(d, fn))
            out[st["name"]] = list(st["targets"])
    return out


def resolve(cell_name: str, manifest: dict | None = None, bench_dir: str = BENCH_DIR) -> Cell:
    manifest = manifest if manifest is not None else load_json(manifest_path())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no workload {cell_name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[cell_name]
    configs = {c["name"]: c for c in manifest["configs"]}
    cfg_entry = configs[w["config"]]
    checks = os.path.join(bench_dir, "checks", f"{cell_name}.json")
    return Cell(
        name=cell_name,
        config_name=w["config"],
        config=load_json(os.path.join(os.path.dirname(bench_dir), cfg_entry["file"])),
        traffic_name=w["traffic"],
        traffic=load_json(os.path.join(bench_dir, "traffic", f"{w['traffic']}.json")),
        stages=load_stages(bench_dir),
        end_to_end=[m for m in manifest["end_to_end"] if _reports(m, cell_name)],
        per_layer=[m for m in manifest["per_layer"] if _reports(m, cell_name)],
        limits=load_json(checks)["limits"] if os.path.exists(checks) else {},
        run_seconds=int(manifest["run_seconds"]),
    )


def _load_module(path: str, name: str):
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench_dir: str = BENCH_DIR):
    """(read function, argument) of a per-layer metric: metrics/<name>.py
    with no argument, else metrics/<family>.py with the rest of the name."""
    d = os.path.join(bench_dir, "metrics")
    own = os.path.join(d, f"{name}.py")
    if os.path.exists(own):
        return _load_module(own, f"cfbench_metric_{name}").read, None
    family, _, arg = name.partition(".")
    path = os.path.join(d, f"{family}.py")
    if not arg or not os.path.exists(path):
        raise FileNotFoundError(f"no reader for metric {name!r} in {d}")
    return _load_module(path, f"cfbench_metric_{family}").read, arg


def generator(name: str, bench_dir: str = BENCH_DIR):
    return _load_module(os.path.join(bench_dir, "generators", f"{name}.py"), f"cfbench_gen_{name}")
