"""BENCHMARK.json against the contract's shapes, and every cell resolving its
configuration, traffic, stages, metric readers and limits by name."""

import importlib
import json
import os
import re

import cfbench_paths  # noqa: F401
import pytest

from harness import cell as cells

MANIFEST = cells.load_json(cells.manifest_path())
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_size():
    assert set(MANIFEST) == KEYS
    assert os.path.getsize(cells.manifest_path()) <= 64 * 1024
    assert MANIFEST["paths"] == ["cfbench"]
    assert MANIFEST["command"] == ["python3", "cfbench/run.py"]
    assert 1 <= MANIFEST["run_seconds"] <= 51 and isinstance(MANIFEST["run_seconds"], int)


def test_names_units_and_keys():
    names = []
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("cfbench/") and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        names += [w["name"], w["traffic"]]
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        allowed = {"name", "unit", "better", "bound", "source", "workloads"} if "bound" in m else \
            {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert set(m) <= allowed
        assert UNIT_RE.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    for n in names:
        assert NAME_RE.match(n), n
    for text in [c["source"] for c in MANIFEST["configs"]] + [m.get("layer", "x") for m in MANIFEST["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert set(e2e) == {"setup_s", "frame_ms", "frame_ms_p95"}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert "workloads" not in m


def test_per_layer_metrics_move_frame_ms_in_listed_cells():
    cell_names = [w["name"] for w in MANIFEST["workloads"]]
    for m in MANIFEST["per_layer"]:
        assert m["moves"] == "frame_ms"
        assert m["workloads"] and set(m["workloads"]) <= set(cell_names)


@pytest.mark.parametrize("name", [w["name"] for w in MANIFEST["workloads"]])
def test_cell_resolves_by_name(name):
    c = cells.resolve(name, MANIFEST)
    assert c.config["camera"]["width"] == 640 and c.config["engine"]["max_surfels"] == 9437184
    assert c.traffic["generator"] and cells.generator(c.traffic["generator"]).make_stream
    assert c.limits, f"checks/{name}.json holds no limit"
    for m in c.per_layer:
        read, arg = cells.metric_reader(m["name"])
        assert callable(read)
        if m["name"].startswith(("stage_ms.", "stage_launches.")) and arg != "other":
            assert arg in c.stages
    assert {m["name"] for m in c.end_to_end} == {"setup_s", "frame_ms", "frame_ms_p95"}


def test_stage_targets_exist_in_the_program():
    for stage, targets in cells.load_stages().items():
        for t in targets:
            mod, _, attr = t.partition(":")
            assert mod.split(".")[0] == "cofusion_tpu_torch"
            assert callable(getattr(importlib.import_module(mod), attr)), t


def test_configs_state_source_reduced_and_assumed():
    for c in MANIFEST["configs"]:
        path = os.path.join(cells.REPO_DIR, c["file"])
        cfg = json.load(open(path))
        assert cfg["source"] and cfg["reduced"] == {} and cfg["assumed"] and cfg["upstream"]
        assert c["reduced"] == []


@pytest.mark.parametrize("name", [c["name"] for c in MANIFEST["configs"]])
def test_configs_keep_the_upstream_command_line_defaults(name, tmp_path):
    """Every fusion and engine setting a configuration states is the
    upstream default, as the port's command line (MainController's flags
    and defaults) parses it."""
    from cofusion_tpu_torch import cli

    cfg = cells.load_json(os.path.join(cells.REPO_DIR, next(c["file"] for c in MANIFEST["configs"]
                                                            if c["name"] == name)))
    for fn in ("Color0000.png", "Depth0000.png"):
        (tmp_path / fn).touch()
    argv = ["-dir", str(tmp_path), "-ns", "4096", "-device", "cpu"] + ([] if cfg["multi_model"] else ["-static"])
    _, engine, _ = cli.build_from_args(argv)
    for key, value in cfg["fusion"].items():
        assert getattr(engine.fusion, key) == value, key
    cam = engine.cfg.camera
    assert [cam.width, cam.height, cam.fx, cam.fy, cam.cx, cam.cy] == list(cfg["camera"].values())
    assert list(engine.cfg.gn_iters) == cfg["engine"]["gn_iters"]
    assert engine.cfg.max_models == cfg["engine"]["max_models"]
