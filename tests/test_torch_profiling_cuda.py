"""Card tests of the port's spans and counters (utils/profiling.py); each skips
without a card. The file imports torch, numpy and ngp_tpu_torch only, so on a
machine with a card (where jax is not installed) it runs from the repository
root as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_profiling_cuda.py -q
"""

import warnings

import numpy as np
import pytest
import torch

from ngp_tpu_torch.utils import profiling

TINY = {
    "samlper": {"aabb_scale": 1, "grid_size": 32, "maximum_marching_steps": 256},
    "network": {
        "encoding": {"n_levels": 8, "log2_hashmap_size": 14, "base_resolution": 16, "desired_resolution": 256},
        "network": {"n_neurons": 64, "n_hidden_layers": 1},
        "dir_encoding": {"degree": 4},
        "rgb_network": {"n_neurons": 64, "n_hidden_layers": 2},
    },
}
FRAME = (200, 160)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A TINY model trained on a small procedural scene on the card, its
    calls graphed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    from ngp_tpu_torch import Testbed
    from ngp_tpu_torch.data.synthetic import write_synthetic_dataset
    from ngp_tpu_torch.ops.mlp import exact_fp32_matmul

    exact_fp32_matmul()
    train_json, _ = write_synthetic_dataset(tmp_path_factory.mktemp("scene"), n_train=8, n_test=1, width=64, height=64,
                                            device="cuda")
    tb = Testbed()
    tb.load_model_config_dict(TINY)
    tb.load_training_data(train_json)
    for _ in range(12):
        tb.train(16, 1 << 16)
    return tb


def _orbit_pose(k: int) -> np.ndarray:
    """A nerf (OpenGL) camera on a ring of radius 4 at 30 degrees, looking at the origin."""
    from ngp_tpu_torch.data.synthetic import look_at_pose

    theta = np.deg2rad(6.0 * k)
    elev = np.deg2rad(30.0)
    eye = 4.0 * np.array([np.cos(elev) * np.cos(theta), np.cos(elev) * np.sin(theta), np.sin(elev)])
    return look_at_pose(eye)


def _synchronisations(fn) -> int:
    """The synchronisations torch's sync debug mode reports while fn() runs."""
    seen = []
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = lambda message, *args, **kw: seen.append(str(message))
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing CUDA operation" in m for m in seen)


@pytest.mark.cuda
@pytest.mark.parametrize("spp", [1, 8])
def test_host_syncs_count_every_synchronisation(trained, spp):
    """render.host_syncs counts exactly the synchronisations of a frame that
    sync debug mode reports, on an orbit frame (spp 1) and an spp-8 frame."""
    tb = trained
    tb.set_nerf_camera_matrix(_orbit_pose(5))
    tb.render(*FRAME, spp, True)  # warm: the allocator, cuBLAS
    torch.cuda.synchronize()
    before = profiling.get("render.host_syncs")
    n = _synchronisations(lambda: tb.render(*FRAME, spp, True))
    counted = profiling.get("render.host_syncs") - before
    assert n > 0 and counted == n, (counted, n)


@pytest.mark.cuda
def test_a_frame_read_back_is_its_own_array(trained):
    """The frame comes back through a page-locked buffer that the next frame
    reuses: each returned array is a copy of its own."""
    tb = trained
    tb.set_nerf_camera_matrix(_orbit_pose(3))
    first = tb.render(*FRAME, 1, True)
    kept = first.copy()
    tb.set_nerf_camera_matrix(_orbit_pose(20))
    second = tb.render(*FRAME, 1, True)
    assert not np.shares_memory(first, second)
    assert np.array_equal(first, kept) and not np.array_equal(first, second)


@pytest.mark.cuda
def test_captured_phases_time_a_graphed_call(trained):
    """A graphed call's captured phase events give positive device ms, and
    over one replay of its graph their sum is within 10 % of the replay's
    own CUDA-event time."""
    tb = trained
    profiling.enable()
    try:
        for _ in range(4):
            tb.train(16, 1 << 16)
            if tb.training_buffer.graphed:
                break
        assert tb.training_buffer.graphed
        rec = profiling.records("train")[-1]
    finally:
        profiling.enable(False)
    for name in ("step.batch", "step.forward", "step.backward", "step.optimizer"):
        assert rec["device_n"][name] > 0 and rec["device_ms"][name] > 0, name
    assert rec["device_ms"]["train.grid_update"] > 0
    call = next(c for c in tb._trainer._cache.values() if getattr(c, "graph", None) is not None and c.timed)
    assert len(call.timed) == 4 * call.n_steps
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    call.graph.replay()
    e1.record()
    torch.cuda.synchronize()
    phases = sum(a.elapsed_time(b) for _, a, b in call.timed)
    whole = e0.elapsed_time(e1)
    assert phases > 0 and abs(phases - whole) <= 0.1 * whole, (phases, whole)
