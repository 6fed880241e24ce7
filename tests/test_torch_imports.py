"""The port stands alone: importing ngp_tpu_torch pulls in neither jax nor ngp_tpu."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, pkgutil, sys
import ngp_tpu_torch
names = [m.name for m in pkgutil.walk_packages(ngp_tpu_torch.__path__, "ngp_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.") or m == "ngp_tpu" or m.startswith("ngp_tpu."))
print(",".join(names), ",".join(bad))
"""

# the training slice's modules, beside the serving slice's
TRAINING_MODULES = (
    "data.png", "data.nerf_synthetic", "data.synthetic", "ops.kernels", "ops.layout", "ops.losses",
    "render.composite", "sampling.training", "sampling.lattice", "grid.occupancy", "train.optimizer", "train.trainer",
    "train.snapshot", "utils.device",
)
# the protocol's evaluation path: the CLI, its image IO and the metrics
PROTOCOL_MODULES = ("experiment", "experiment.common", "experiment.run", "metrics", "flip")
# the reference-snapshot interchange
INTERCHANGE_MODULES = ("utils.morton",)


def test_port_imports_no_jax_and_no_ngp_tpu():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True, text=True, timeout=120, check=True
    ).stdout.split()
    names = out[0].split(",")
    assert len(names) >= 42, out
    assert {f"ngp_tpu_torch.{m}" for m in TRAINING_MODULES + PROTOCOL_MODULES + INTERCHANGE_MODULES} <= set(names)
    assert len(out) == 1, f"port imported {out[1]}"


def test_chip_smoke_imports_no_jax():
    src = (ROOT / "chip_smoke.py").read_text()
    for word in ("import jax", "from jax", "import ngp_tpu\n", "from ngp_tpu.", "import ngp_tpu."):
        assert word not in src


def test_exact_scatter_bench_imports_no_jax():
    src = (ROOT / "exact_scatter_bench.py").read_text()
    for word in ("import jax", "from jax", "import ngp_tpu\n", "from ngp_tpu.", "import ngp_tpu."):
        assert word not in src


def test_testbed_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from ngp_tpu_torch import Testbed

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Testbed()
    assert Testbed(device="cpu").device.type == "cpu"


def test_data_helpers_default_to_cuda_and_raise_without_it(monkeypatch, tmp_path):
    """The procedural scene writer renders on the card unless asked for the
    CPU (fault j, ROADMAP queue 3): without CUDA it raises."""
    from ngp_tpu_torch.data import synthetic

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        synthetic.write_synthetic_dataset(tmp_path, n_train=1, n_test=1, width=4, height=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        synthetic.render_ground_truth(synthetic.look_at_pose([1.5, -2.5, 2.8]), 4, 4, 0.69)
    img = synthetic.render_ground_truth(synthetic.look_at_pose([1.5, -2.5, 2.8]), 4, 4, 0.69, n_steps=8, device="cpu")
    assert img.device.type == "cpu" and img.shape == (4, 4, 4) and torch.isfinite(img).all()


def test_cli_defaults_to_cuda_and_raises_without_it(monkeypatch, tmp_path):
    from ngp_tpu_torch.experiment import run

    assert run.parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run.run(run.parse_args(["--load_snapshot", str(tmp_path / "none.msgpack")]))


def test_constructors_and_loaders_default_to_cuda_and_raise_without_it(monkeypatch, tmp_path):
    """NGPModel, load_nerf_synthetic, create_grid_state, cell_centers and
    grid_from_numpy run on the card unless asked for the CPU (fault m,
    ROADMAP queue 3): without CUDA each raises, and device="cpu" works."""
    from ngp_tpu_torch.data.nerf_synthetic import load_nerf_synthetic
    from ngp_tpu_torch.data.synthetic import write_synthetic_dataset
    from ngp_tpu_torch.grid.occupancy import cell_centers, create_grid_state
    from ngp_tpu_torch.models.interop import grid_from_numpy
    from ngp_tpu_torch.models.ngp import NGPModel
    from ngp_tpu_torch.utils.config import NGPConfig

    cfg = NGPConfig.from_json({"samlper": {"grid_size": 16}, "network": {"encoding": {"n_levels": 2, "log2_hashmap_size": 10}}})
    train_json, _ = write_synthetic_dataset(tmp_path, n_train=1, n_test=1, width=4, height=4, device="cpu")
    dens = np.zeros(cfg.sampler.n_total_elements, np.float32)
    calls = {
        "NGPModel": lambda **kw: NGPModel(cfg.network, **kw).hash_table,
        "NGPModel.create": lambda **kw: NGPModel.create(cfg.network, **kw).hash_table,
        "load_nerf_synthetic": lambda **kw: load_nerf_synthetic(train_json, **kw).images,
        "create_grid_state": lambda **kw: create_grid_state(cfg.sampler, **kw).density,
        "cell_centers": lambda **kw: cell_centers(cfg.sampler, 0, **kw),
        "grid_from_numpy": lambda **kw: grid_from_numpy(cfg.sampler, dens, 0, **kw).occupancy,
    }
    for name, call in calls.items():
        assert call(device="cpu").device.type == "cpu", name
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
