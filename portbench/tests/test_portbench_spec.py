"""BENCHMARK.json keeps to its contract's shapes, and every name it gives is
found as a file: configurations, traffic mixes, limits and metric readers,
including ones added from another directory without editing a file."""

import hashlib
import json
import re
import shutil

import pytest

from portbench.harness import spec
from portbench.harness.spec import BENCH_DIR, ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and BENCH["command"][1] == "portbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
                         + [m["name"] for m in METRICS] + [w["traffic"] for w in BENCH["workloads"]])
def test_names_keep_to_the_character_set(name):
    assert spec.check_name(name) == name


@pytest.mark.parametrize("bad", ["", "a b", "a,b", "a/b", "-x" * 40, "μs", ".x"])
def test_bad_names_are_refused(bad):
    with pytest.raises(ValueError):
        spec.check_name(bad)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entries(metric):
    assert spec.check_unit(metric["unit"]) == metric["unit"]
    assert metric["better"] in ("lower", "higher")
    assert (BENCH_DIR / "metrics" / f"{metric['name']}.py").exists()
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace") and 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert re.fullmatch(r"[^\n\t]{1,200}", metric["layer"])


def test_bad_units_are_refused():
    for bad in ("tokens per second", "", "x" * 17, "μs"):
        with pytest.raises(ValueError):
            spec.check_unit(bad)


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_and_reports_enough(workload):
    cell = spec.load_cell(workload, BENCH)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    assert cell.chips == 1 and cell.limits
    assert cell.traffic["kind"] in ("train", "serve")


def test_every_config_is_used_and_every_file_is_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).exists()
        doc = json.loads((ROOT / c["file"]).read_text())
        assert doc["source"] == c["source"] and doc["reduced"] == c["reduced"]


def _digest(root):
    return {p.relative_to(root): hashlib.sha1(p.read_bytes()).hexdigest() for p in sorted(root.rglob("*")) if p.is_file()}


def test_a_cell_is_added_by_new_files_alone(tmp_path):
    """A configuration, a traffic mix, limits and a per-layer metric added as
    new files and new entries are found by name; no existing file changes."""
    bench_dir = tmp_path / "portbench"
    shutil.copytree(BENCH_DIR, bench_dir, ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(bench_dir)
    doc = json.loads(json.dumps(BENCH))
    cfg = json.loads((bench_dir / "configs" / "ngp-base-oadd.json").read_text())
    cfg["name"] = "ngp-big-hash"
    cfg["model"]["network"]["encoding"]["log2_hashmap_size"] = 21
    (bench_dir / "configs" / "ngp-big-hash.json").write_text(json.dumps(cfg))
    (bench_dir / "traffic" / "orbit-spp4.json").write_text(json.dumps(
        dict(json.loads((bench_dir / "traffic" / "orbit-spp1.json").read_text()), spp=4)))
    (bench_dir / "limits" / "big-orbit-spp4.json").write_text(json.dumps({"pixel_gap_mean": 1.0}))
    (bench_dir / "metrics" / "frames_counted.serve.py").write_text("def read(run):\n    return len(run.frames) or None\n")
    doc["configs"].append({"name": "ngp-big-hash", "source": cfg["source"], "file": "portbench/configs/ngp-big-hash.json",
                           "reduced": cfg["reduced"], "why": "a larger table"})
    doc["workloads"].append({"name": "big-orbit-spp4", "config": "ngp-big-hash", "traffic": "orbit-spp4", "chips": 1,
                             "why": "spp-4 orbit"})
    doc["per_layer"].append({"name": "frames_counted.serve", "unit": "frames", "better": "higher",
                             "source": "program_counter", "layer": "renderer", "moves": "frame_ms",
                             "workloads": ["big-orbit-spp4"]})
    doc["end_to_end"] = [dict(m, workloads=m["workloads"] + ["big-orbit-spp4"]) if m["name"] == "frame_ms" else m
                         for m in doc["end_to_end"]]
    cell = spec.load_cell("big-orbit-spp4", doc, bench_dir)
    assert cell.traffic["spp"] == 4 and cell.config["model"]["network"]["encoding"]["log2_hashmap_size"] == 21
    assert [m["name"] for m in cell.per_layer] == ["frames_counted.serve"]
    assert {m["name"] for m in cell.end_to_end} == {"frame_ms", "setup_s"}
    reader = spec.load_reader("frames_counted.serve", bench_dir)
    assert reader(type("Run", (), {"frames": [1, 2, 3]})()) == 3
    after = _digest(bench_dir)
    assert all(after[p] == d for p, d in before.items())
