"""Each mix rehearsed end to end on the CPU at a tiny size, with the port's
plain kernel versions: set-up, window, traced stretch, the check against
the reference, the result. Then the check's teeth: the control (the
reference at float8 operands in the port's place) and the faults planted in
the port each turn `correct` false under the cells' own limits."""

import contextlib

import numpy as np
import pytest
import torch

from portbench.harness import scene
from portbench.harness.cell import run_cell
from portbench.reference import compare
from portbench.tests.tiny import shrink, tiny_cell

SEED = 2**31 + 17  # above 32 signed bits, as the driver's seeds are


@pytest.fixture(autouse=True)
def _scene_cache(tmp_path_factory, monkeypatch):
    monkeypatch.setattr(scene, "SCENE_CACHE", tmp_path_factory.getbasetemp() / "portbench_scene")
    torch.set_num_threads(2)


def run(name, trace=False, seconds=0.5):
    return run_cell(tiny_cell(name), SEED, seconds, trace, 0.0, device="cpu", tweak=shrink)


@pytest.mark.parametrize("name", ["oadd-train-800", "tcnn-train-800", "oadd-orbit-spp1", "oadd-testviews-spp8"])
def test_rehearsal(name):
    out = run(name)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert "setup_s" in out["metrics"] and len(out["metrics"]) >= 2
    assert list(out)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in out["checks"].values() if c["limit"] is not None)


@pytest.mark.parametrize("name", ["oadd-train-800", "oadd-testviews-spp8"])
def test_traced_rehearsal(name):
    out = run(name, trace=True)
    assert out["correct"]
    # the CPU has no device trace: no device metric is reported from it
    assert not any(k.startswith(("torch_ops", "hash_kernels", "fused_mlp_roofline", "device_idle")) for k in out["metrics"])
    assert out["device"]["window_s"] > 0 and "breakdown" in out


@contextlib.contextmanager
def patched(obj, attr, make):
    orig = getattr(obj, attr)
    setattr(obj, attr, make(orig))
    try:
        yield
    finally:
        setattr(obj, attr, orig)


def test_fault_state_unchanged():
    from ngp_tpu_torch.train.optimizer import Optimizer

    with patched(Optimizer, "apply", lambda orig: lambda self, grads, hyper: None):
        out = run("oadd-train-800")
    assert not out["correct"] and out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", ["oadd-train-800", "tcnn-train-800"])
def test_fault_half_batch(name):
    from portbench.calibrate import half_batch

    with half_batch():
        out = run(name)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", ["oadd-train-800", "tcnn-train-800"])
def test_fault_in_the_timed_call_alone(name):
    """Half of the batch left out only in the loop's fused call (the path the
    window's calls take; on the card a CUDA graph), not in the first call's
    per-step path: the first steps read sound and the checked call fails."""
    from ngp_tpu_torch.train.trainer import TrainCall
    from portbench.calibrate import half_batch

    def broken(orig):
        def call(self, ds, draws, out):
            with half_batch():
                return orig(self, ds, draws, out)
        return call

    with patched(TrainCall, "__call__", broken):
        out = run(name)
    checks = out["checks"]
    assert all(c["value"] <= c["limit"] for k, c in checks.items() if not k.startswith("call_")), checks
    assert not out["correct"]
    assert any(c["limit"] is not None and c["value"] > c["limit"] for k, c in checks.items() if k.startswith("call_"))


def test_fault_answer_altered():
    from ngp_tpu_torch.testbed import Testbed

    def altered(orig):
        def render(self, *a, **kw):
            img = orig(self, *a, **kw).copy()
            img[:4, :4, :3] += 0.25
            return img
        return render

    with patched(Testbed, "render", altered):
        out = run("oadd-orbit-spp1")
    assert not out["correct"] and out["checks"]["pixel_gap_max"]["value"] >= 0.2


@pytest.mark.parametrize("name", ["oadd-train-800", "tcnn-train-800"])
def test_control_fails_training(name):
    from portbench.calibrate import train_readings

    readings = train_readings(tiny_cell(name), SEED, "cpu", control=True, fault=False, tweak=shrink)
    limits = tiny_cell(name).limits
    assert compare.judge(readings["program"], limits)[0]
    assert not compare.judge(readings["control"], limits)[0], readings["control"]


@pytest.mark.parametrize("name", ["oadd-orbit-spp1", "oadd-testviews-spp8"])
def test_control_fails_serving(name):
    from portbench.calibrate import serve_readings

    readings = serve_readings(tiny_cell(name), SEED, "cpu", control=True, tweak=shrink)
    limits = tiny_cell(name).limits
    assert compare.judge(readings["program"], limits)[0]
    assert not compare.judge(readings["control"], limits)[0], readings["control"]


def test_orbit_and_test_view_poses_follow_the_seed():
    from portbench.harness.cell import frame_poses

    cell = tiny_cell("oadd-orbit-spp1")
    a, b = frame_poses(cell.traffic, cell.config["scene"], 1), frame_poses(cell.traffic, cell.config["scene"], 2)
    np.testing.assert_array_equal(a(3), frame_poses(cell.traffic, cell.config["scene"], 1)(3))
    assert not np.allclose(a(0), b(0))
    # the elevation stays in the mix's band, at the cameras' radius
    for k in range(0, 90, 7):
        eye = a(k)[:, 3]
        assert np.linalg.norm(eye) == pytest.approx(4.0, rel=1e-5)
        assert 15.0 - 1e-3 <= np.degrees(np.arcsin(eye[2] / 4.0)) <= 45.0 + 1e-3


def test_a_depth_mix_added_from_new_files_runs(tmp_path, monkeypatch):
    """A traffic mix in another render mode, added as a new data file with
    its cell's entry and limits in a copy of the benchmark, runs through the
    one generator on the port and on the reference without an edit to any
    existing file."""
    import json
    import shutil

    from ngp_tpu_torch.testbed import Testbed
    from portbench.harness.spec import BENCH_DIR, load_benchmark

    bench_dir = tmp_path / "portbench"
    shutil.copytree(BENCH_DIR, bench_dir, ignore=shutil.ignore_patterns("__pycache__"))
    mix = dict(json.loads((bench_dir / "traffic" / "orbit-spp1.json").read_text()), rendering={"render_mode": "Depth"})
    (bench_dir / "traffic" / "orbit-depth-spp1.json").write_text(json.dumps(mix))
    (bench_dir / "limits" / "oadd-orbit-depth-spp1.json").write_text(json.dumps({"pixel_gap_mean": 1e-2, "pixel_gap_max": 1e-1}))
    doc = load_benchmark()
    doc["workloads"].append({"name": "oadd-orbit-depth-spp1", "config": "ngp-base-oadd", "traffic": "orbit-depth-spp1",
                             "chips": 1, "why": "the orbit in the Depth mode"})
    doc["end_to_end"] = [dict(m, workloads=m["workloads"] + ["oadd-orbit-depth-spp1"]) if m["name"] == "frame_ms" else m
                         for m in doc["end_to_end"]]
    modes = []

    def spy(orig):
        def render(self, *a, **kw):
            modes.append(self.rendering_buffer.render_mode)
            return orig(self, *a, **kw)
        return render

    with patched(Testbed, "render", spy):
        out = run_cell(tiny_cell("oadd-orbit-depth-spp1", bench=doc, bench_dir=bench_dir), SEED, 0.5, False, 0.0,
                       device="cpu", tweak=shrink)
    assert out["correct"], out["checks"]
    assert modes and set(modes) == {"Depth"}
    assert set(out["metrics"]) == {"frame_ms", "setup_s"}
