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


# the tolerances of tests/test_fused_mlp.py:59 for gradients
BWD_RTOL, BWD_ATOL = 3e-2, 3e-2


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,d_hidden,r_hidden,width",
    [
        (2**16, 1, 2, 64),
        (2**16 + 37, 1, 2, 64),
        (1000, 3, 3, 16),
        (4096, 1, 2, 128),
        (5, 1, 1, 64),
        (777, 2, 2, 40),
        (641, 1, 2, 64),  # one row past five 128-row tiles
    ],
)
def test_fused_mlp_bwd_kernel_matches_plain(card, n, d_hidden, r_hidden, width):
    from ngp_tpu_torch.ops import fused_mlp as fm

    gen = torch.Generator().manual_seed(n + width)
    fw = fm.pack_weights(_weights(gen, 32, width, 16, d_hidden, card), _weights(gen, 32, width, 3, r_hidden, card))
    enc, sh = torch.randn((n, 32), generator=gen).to(card), torch.randn((n, 16), generator=gen).to(card)
    g_rgb, g_dens = torch.randn((n, 3), generator=gen).to(card), torch.zeros((n, 16)).to(card)
    g_dens[:, 0] = torch.randn((n,), generator=gen).to(card)
    before = fm.N_LAUNCHES_BWD
    k_enc, k_w = fm.fused_mlp_bwd(enc, sh, g_rgb, g_dens, fw)
    torch.cuda.synchronize()
    assert fm.N_LAUNCHES_BWD == before + 1
    p_enc, p_w = fm.fused_mlp_bwd_plain(enc, sh, g_rgb, g_dens, fw)
    torch.testing.assert_close(k_enc, p_enc, rtol=BWD_RTOL, atol=BWD_ATOL * p_enc.abs().max().item())
    torch.testing.assert_close(k_w, p_w, rtol=BWD_RTOL, atol=BWD_ATOL * p_w.abs().max().item())
    # deterministic: the block reduction runs in a fixed order
    assert torch.equal(fm.fused_mlp_bwd(enc, sh, g_rgb, g_dens, fw)[1], k_w)


@pytest.mark.cuda
def test_fused_mlp_bwd_raises_when_shared_memory_is_short(card):
    from ngp_tpu_torch.ops import fused_mlp as fm

    gen = torch.Generator().manual_seed(4)
    fw = fm.pack_weights(_weights(gen, 32, 128, 16, 4, card), _weights(gen, 32, 128, 3, 4, card))
    z = torch.zeros((64, 32), device=card)
    with pytest.raises(ValueError, match="shared memory"):
        fm.fused_mlp_bwd(z, z[:, :16], z[:, :3], z[:, :16], fw)


ADAM_KW = dict(lr=1e-2, bc1=1 - 0.9**10, bc2=1 - 0.99**10, b1=0.9, b2=0.99, eps=1e-15, decay=0.95)


# n % 4 of 0, 3 and 1: the last elements that do not fill a 16-byte group
@pytest.mark.cuda
@pytest.mark.parametrize("n,lazy,l2", [(1 << 20, True, 0.0), (4099, False, 1e-6), (1001, True, 0.0), (3, True, 0.0)])
def test_adam_ema_kernel_matches_plain(card, n, lazy, l2):
    from ngp_tpu_torch.train import optimizer as opt

    gen = torch.Generator().manual_seed(n)
    g = torch.randn((n,), generator=gen) * 0.01
    g[torch.rand((n,), generator=gen) > 0.04] = 0.0
    g[-1] = 0.01  # a visited element among the last ones
    state = [torch.randn((n,), generator=gen) * s for s in (1e-3, 1e-4, 1e-2, 1e-2)]
    state[1] = state[1].abs()
    kw = dict(ADAM_KW, l2=l2, lazy=lazy)
    plain = [s.clone() for s in state]
    opt.adam_ema_plain(g, *plain, **kw)
    dev = [s.to(card) for s in state]
    before = opt.N_LAUNCHES
    opt.adam_ema(g.to(card), *dev, **kw)
    torch.cuda.synchronize()
    assert opt.N_LAUNCHES == before + 1
    for got, want in zip(dev, plain, strict=True):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-12)


@pytest.mark.cuda
def test_adam_ema_rejects_unaligned_buffers(card):
    from ngp_tpu_torch.train import optimizer as opt

    bufs = [torch.zeros((1001,), device=card) for _ in range(5)]
    before = opt.N_LAUNCHES
    with pytest.raises(ValueError, match="16-byte"):
        opt.adam_ema(*(b[1:] for b in bufs), **ADAM_KW, lazy=True)
    assert opt.N_LAUNCHES == before
