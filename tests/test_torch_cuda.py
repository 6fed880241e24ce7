"""Tests of the port that need a CUDA card; each skips without one.

This file imports torch, numpy and ngp_tpu_torch only, so it also runs where
jax is not installed. On a machine with a card, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(--noconftest skips the root conftest.py, which imports jax.)
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

# bf16 operands: another fp32 summation order can move a hidden activation to
# the neighbouring bf16 value (the tolerances of tests/test_fused_mlp.py)
RTOL, ATOL = 2e-2, 3e-2


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from ngp_tpu_torch.ops.mlp import exact_fp32_matmul

    exact_fp32_matmul()
    return torch.device("cuda")


def _weights(gen, n_in, width, n_out, hidden, device):
    dims = [n_in] + [width] * hidden + [n_out]
    out = []
    for i in range(len(dims) - 1):
        b = float(np.sqrt(6.0 / (dims[i] + dims[i + 1])))
        out.append(((torch.rand((dims[i], dims[i + 1]), generator=gen) * 2.0 - 1.0) * b).to(device))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,d_hidden,r_hidden,width,d_in,d_sh",
    [(2**16 + 37, 1, 2, 64, 32, 16), (1000, 3, 3, 16, 32, 16), (4096, 1, 2, 128, 32, 16), (777, 2, 2, 40, 24, 9), (5, 1, 1, 64, 32, 16)],
)
def test_fused_mlp_kernel_matches_plain(card, n, d_hidden, r_hidden, width, d_in, d_sh):
    from ngp_tpu_torch.ops import fused_mlp as fm

    gen = torch.Generator().manual_seed(n)
    fw = fm.pack_weights(
        _weights(gen, d_in, width, 16, d_hidden, card), _weights(gen, 16 + d_sh, width, 3, r_hidden, card)
    )
    enc = torch.randn((n, d_in), generator=gen).to(card)
    sh = torch.randn((n, d_sh), generator=gen).to(card)
    before = fm.N_LAUNCHES
    k_rgb, k_dens = fm.fused_mlp_fwd(enc, sh, fw)
    torch.cuda.synchronize()
    assert fm.N_LAUNCHES == before + 1
    p_rgb, p_dens = fm.fused_mlp_fwd_plain(enc, sh, fw)
    torch.testing.assert_close(k_rgb, p_rgb, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(k_dens, p_dens, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_fused_mlp_rejects_cpu_weights_on_card(card):
    from ngp_tpu_torch.ops import fused_mlp as fm

    gen = torch.Generator().manual_seed(0)
    fw = fm.pack_weights(_weights(gen, 32, 64, 16, 1, "cpu"), _weights(gen, 32, 64, 3, 2, "cpu"))
    with pytest.raises(ValueError):
        fm.fused_mlp_fwd(torch.zeros((8, 32), device=card), torch.zeros((8, 16), device=card), fw)


@pytest.mark.cuda
def test_card_frame_matches_cpu_frame(card):
    """A small frame at a small width: the card (kernel) and the CPU (plain
    versions) agree on the same weights and grid."""
    from ngp_tpu_torch import Testbed
    from ngp_tpu_torch.models.ngp import NGPModel

    doc = {
        "samlper": {"grid_size": 32},
        "network": {
            "encoding": {"n_levels": 4, "log2_hashmap_size": 12, "base_resolution": 8, "desired_resolution": 64},
            "network": {"n_neurons": 32, "n_hidden_layers": 1},
            "rgb_network": {"n_neurons": 32, "n_hidden_layers": 2},
        },
    }
    g = 32
    ax = (np.arange(g) + 0.5) / g
    z, y, x = np.meshgrid(ax, ax, ax, indexing="ij")
    dens = np.zeros((2, g, g, g), np.float32)
    dens[0] = np.exp(-((x - 0.5) ** 2 + (y - 0.45) ** 2 + (z - 0.55) ** 2) / 0.02)
    cam = np.array([[1, 0, 0, 0], [0, 0.8, -0.6, -0.9], [0, 0.6, 0.8, 1.2]], np.float32)
    frames = []
    for device in (card, "cpu"):
        tb = Testbed(device=device)
        tb.load_model_config_dict(doc)
        params = NGPModel(tb.config.network).init(torch.Generator().manual_seed(3)).params()
        params["density_mlp"][-1][:, 0] = params["density_mlp"][-1][:, 0].abs() * 4.0 + 0.5
        tb.set_state(params, dens.reshape(-1))
        tb.set_nerf_camera_matrix(cam)
        tb.render(48, 32, spp=2, to_srgb=False)
        frames.append(tb._accum.cpu())
    err = (frames[0] - frames[1]).abs()
    assert frames[1][..., 3].max() > 0.05
    assert err.max() <= 2e-2 and err.mean() <= 1e-3
