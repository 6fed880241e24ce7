"""The port stands alone: importing ngp_tpu_torch pulls in neither jax nor ngp_tpu."""

import subprocess
import sys
from pathlib import Path

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
print(len(names), ",".join(bad))
"""


def test_port_imports_no_jax_and_no_ngp_tpu():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True, text=True, timeout=120, check=True
    ).stdout.split()
    n_modules = int(out[0])
    assert n_modules >= 16, out
    assert len(out) == 1, f"port imported {out[1]}"


def test_chip_smoke_imports_no_jax():
    src = (ROOT / "chip_smoke.py").read_text()
    for word in ("import jax", "from jax", "import ngp_tpu\n", "from ngp_tpu.", "import ngp_tpu."):
        assert word not in src


def test_testbed_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from ngp_tpu_torch import Testbed

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Testbed()
    assert Testbed(device="cpu").device.type == "cpu"
