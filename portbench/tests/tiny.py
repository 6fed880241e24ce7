"""Cells of BENCHMARK.json cut to a size the CPU runs in seconds, for the
rehearsals: the TINY model of tests/test_end_to_end.py, a 32x32 scene, a
few calls and frames. Widths and the traffic's kinds and poses stay."""

import copy

from portbench.harness.spec import BENCH_DIR, load_cell

TINY_MODEL = {
    "samlper": {"aabb_scale": 1, "grid_size": 32, "maximum_marching_steps": 256},
    "network": {"encoding": {"n_levels": 8, "log2_hashmap_size": 14, "base_resolution": 16, "desired_resolution": 256}},
}
TINY_SCENE = {"n_train": 4, "n_test": 6, "width": 32, "height": 32}
TINY_TRAFFIC = {"steps_per_call": 4, "batch": 1 << 12, "warm_calls": 2, "warm_frames": 1, "width": 24, "height": 16,
                "check_frames": 2, "profile_frames": 1, "profile_calls": 1}
CAPACITY = 1 << 13


def merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def tiny_cell(name: str, limits=None, bench=None, bench_dir=BENCH_DIR):
    cell = load_cell(name, bench, bench_dir)
    cell.config = merge(cell.config, {"model": TINY_MODEL, "scene": TINY_SCENE})
    cell.traffic = merge(cell.traffic, {k: v for k, v in TINY_TRAFFIC.items() if k in cell.traffic})
    if limits is not None:
        cell.limits = limits
    return cell


def shrink(tb):
    tb._trainer.sample_capacity = CAPACITY
