"""The rehearsal on the card: each mix at the tiny size through the port's
CUDA kernels, checked against the reference on the card. Run on a machine
with a card (the root conftest imports jax, which such a machine lacks):

    python -m pytest --noconftest -p no:cacheprovider portbench/tests/test_portbench_card.py -q
"""

import pytest
import torch

from portbench.harness import scene
from portbench.harness.cell import run_cell
from portbench.tests.tiny import shrink, tiny_cell


@pytest.fixture
def card(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    monkeypatch.setattr(scene, "SCENE_CACHE", tmp_path / "scene")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["oadd-train-800", "tcnn-train-800", "oadd-orbit-spp1", "oadd-testviews-spp8"])
def test_tiny_cell_on_the_card(card, name):
    out = run_cell(tiny_cell(name), 2**31 + 3, 1.0, True, 0.0, device=card, tweak=shrink)
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0 and out["device"]["memory_peak_bytes"] > 0
