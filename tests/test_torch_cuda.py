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
    [
        (2**16 + 37, 1, 2, 64, 32, 16),
        (1000, 3, 3, 16, 32, 16),
        (4096, 1, 2, 128, 32, 16),
        (777, 2, 2, 40, 24, 9),
        (5, 1, 1, 64, 32, 16),
        # each bucket's edges (padded widths 32, 48, 64, 80, 128) at a 128-row
        # block tile and one row either side of it, N = 1, deep heads (nd + nr >= 8)
        (2047, 1, 2, 32, 32, 16),
        (2048, 1, 2, 48, 32, 16),
        (2049, 1, 2, 64, 32, 16),
        (4097, 1, 2, 80, 32, 16),
        (4095, 1, 2, 128, 32, 16),
        (1, 1, 2, 64, 32, 16),
        (3000, 4, 3, 64, 32, 16),
        (1000, 4, 4, 32, 24, 9),
    ],
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
        (641, 1, 2, 64),  # one row past ten 64-row tiles
        # each bucket's edges at a 64-row block tile and one row either side
        # of it, N = 1, deep heads (nd + nr >= 8) in the register bucket (32
        # wide) and with the sums in shared memory (64 wide)
        (4095, 1, 2, 32),
        (4096, 1, 2, 48),
        (4097, 1, 2, 80),
        (4097, 1, 2, 128),
        (1, 1, 2, 64),
        (2000, 4, 3, 32),
        (3000, 4, 3, 64),
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


# the TINY encoding of tests/test_end_to_end.py: dense and hash levels
HASH_TINY = {"n_levels": 8, "log2_hashmap_size": 14, "base_resolution": 16, "desired_resolution": 256}


def _hash_case(n, n_features, rate, seed, device):
    from ngp_tpu_torch.ops import hash_encoding as he
    from ngp_tpu_torch.utils.config import HashEncodingConfig

    spec = he.HashGridSpec.create(
        HashEncodingConfig(**HASH_TINY, n_features_per_level=n_features, stochastic_level_rate=rate)
    )
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    m = n // 8
    pos[np.arange(m), rng.integers(0, 3, m)] = rng.choice([0.0, 1.0], m)  # box faces: the dense clamp
    table = rng.uniform(-1.0, 1.0, (spec.n_levels, spec.padded_size, n_features)).astype(np.float32)
    # small integers x 2^-8: every fp32 sum of them is exact in any order
    g_dyadic = rng.integers(-8, 9, (n, spec.n_output_dims)).astype(np.float32) * 2.0**-8
    g = rng.normal(size=(n, spec.n_output_dims)).astype(np.float32)
    return spec, *(torch.from_numpy(x).to(device) for x in (table, pos, g_dyadic, g))


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_features", [(2**16 + 37, 2), (4096, 1), (4096, 4), (1000, 8), (3, 2)])
def test_hash_encode_kernel_matches_plain(card, n, n_features):
    from ngp_tpu_torch.ops import hash_encoding as he

    spec, table, pos, _, _ = _hash_case(n, n_features, 2, n, card)
    before = he.N_LAUNCHES_HASH_FWD
    out = he.hash_encode(table, pos, spec)
    torch.cuda.synchronize()
    assert he.N_LAUNCHES_HASH_FWD == before + 1
    # only the order of the fp32 8-term sum differs; |out| <= 1
    torch.testing.assert_close(out, he.hash_encode_plain(table, pos, spec), rtol=0, atol=1e-5)


# kr = 2 on an even N, and the fallback to kr = 1 on a ragged N and rate 1
@pytest.mark.cuda
@pytest.mark.parametrize("n,n_features,rate", [(2**16, 2, 2), (2**16 + 37, 2, 2), (4096, 2, 1), (4096, 4, 2), (999, 1, 3)])
def test_hash_deposits_match_plain(card, n, n_features, rate):
    from ngp_tpu_torch.ops import hash_encoding as he

    spec, _, pos, g_dyadic, g = _hash_case(n, n_features, rate, n + 1, card)
    before = (he.N_LAUNCHES_HASH_BWD_STOCHASTIC, he.N_LAUNCHES_HASH_BWD_EXACT)
    stochastic = he.hash_bwd_oadd_stochastic(pos, spec, g_dyadic)
    exact = he.hash_bwd_oadd(pos, spec, g)
    torch.cuda.synchronize()
    assert (he.N_LAUNCHES_HASH_BWD_STOCHASTIC, he.N_LAUNCHES_HASH_BWD_EXACT) == (before[0] + 1, before[1] + 1)
    # the same draws and rows, exact sums: bit for bit
    assert torch.equal(stochastic, he.hash_bwd_oadd_stochastic_plain(pos, spec, g_dyadic))
    # w * g summed in another order (atomics)
    want = he.hash_bwd_oadd_plain(pos, spec, g)
    torch.testing.assert_close(exact, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())


@pytest.mark.cuda
def test_input_gradient_matches_cpu(card):
    """input_gradient on the card (gather kernel, plain d/dpos, cuBLAS head)
    against the CPU, and no gradient left on the parameters."""
    from ngp_tpu_torch.models.ngp import NGPModel
    from ngp_tpu_torch.utils.config import NGPConfig

    cfg = NGPConfig.from_json({"network": {"encoding": HASH_TINY}}).network
    model = NGPModel(cfg).init(torch.Generator().manual_seed(5))
    pos = torch.rand((5000, 3), generator=torch.Generator().manual_seed(6))
    want = model.input_gradient(pos)
    got = model.to(card).input_gradient(pos.to(card))
    assert all(p.grad is None for p in model.parameters())
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-3 * want.abs().max().item())


def _kernel_spec(n_levels, n_features, rate):
    from ngp_tpu_torch.ops import hash_encoding as he
    from ngp_tpu_torch.utils.config import HashEncodingConfig

    enc = dict(HASH_TINY, n_levels=n_levels, n_features_per_level=n_features, stochastic_level_rate=rate)
    return he.HashGridSpec.create(HashEncodingConfig(**enc))


def _kernel_positions(kind, n, spec, rng):
    """(n, 3) float32: "uniform"; "rays", ray-major samples sqrt(3)/1024
    apart, 128 a ray, as the render and training batches lie (many lanes of
    a warp share a row at the coarse levels); "wrap", uniform points whose
    cell puts a hash level's corner pair at r = size - 1 first."""
    from ngp_tpu_torch.ops import hash_encoding as he

    if kind == "rays":
        n_rays = -(-n // 128)
        d = rng.normal(size=(n_rays, 1, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        t = (np.arange(128) * np.sqrt(3.0) / 1024)[None, :, None]
        return (rng.uniform(0.25, 0.75, (n_rays, 1, 3)) + t * d).reshape(-1, 3)[:n].astype(np.float32)
    pos = rng.uniform(0.0, 1.0, (max(n, 1 << 16), 3)).astype(np.float32)
    if kind == "wrap":
        rows = he.corner_rows(torch.from_numpy(pos), spec)
        rows = rows - (torch.arange(spec.n_levels) * spec.padded_size)[None, :, None]
        at_end = (rows[..., 0::2] == torch.tensor(spec.sizes)[None, :, None] - 1).any(-1).any(-1).numpy()
        assert at_end.sum() >= min(n, 8)
        pos = np.concatenate([pos[at_end], pos[~at_end]])
    return pos[:n]


# (N, features, levels, positions): ray-major batches, hash-level pairs at
# r = size - 1, level counts that are no multiple of the kernels' level group
# (8 / features), every feature width, and N = 1, 3 and 2^16 + 37
HASH_GROUP_CASES = [
    (2**16 + 37, 2, 8, "rays"),
    (4096, 2, 8, "wrap"),
    (4096, 1, 8, "wrap"),
    (4099, 2, 5, "rays"),
    (4100, 2, 6, "uniform"),
    (4096, 1, 5, "rays"),
    (4096, 4, 6, "rays"),
    (1000, 8, 5, "rays"),
    (2**16 + 37, 4, 8, "uniform"),
    (1, 2, 8, "uniform"),
    (3, 1, 6, "rays"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_features,n_levels,kind", HASH_GROUP_CASES)
def test_hash_kernels_match_plain_by_level_group(card, n, n_features, n_levels, kind):
    """The gather within 1e-5 of its plain version and the stochastic deposit
    bit for bit (dyadic g) at level rates 1 and 2."""
    from ngp_tpu_torch.ops import hash_encoding as he

    rng = np.random.default_rng(n + 10 * n_features + n_levels)
    spec = _kernel_spec(n_levels, n_features, 2)
    pos = torch.from_numpy(_kernel_positions(kind, n, spec, rng)).to(card)
    table = torch.from_numpy(
        rng.uniform(-1.0, 1.0, (n_levels, spec.padded_size, n_features)).astype(np.float32)
    ).to(card)
    g = torch.from_numpy(rng.integers(-8, 9, (n, spec.n_output_dims)).astype(np.float32) * np.float32(2.0**-8)).to(card)
    before = he.N_LAUNCHES_HASH_FWD
    out = he.hash_encode(table, pos, spec)
    torch.cuda.synchronize()
    assert he.N_LAUNCHES_HASH_FWD == before + 1
    torch.testing.assert_close(out, he.hash_encode_plain(table, pos, spec), rtol=0, atol=1e-5)
    for rate in (1, 2):
        sp = _kernel_spec(n_levels, n_features, rate)
        before = he.N_LAUNCHES_HASH_BWD_STOCHASTIC
        got = he.hash_bwd_oadd_stochastic(pos, sp, g)
        torch.cuda.synchronize()
        assert he.N_LAUNCHES_HASH_BWD_STOCHASTIC == before + 1
        assert torch.equal(got, he.hash_bwd_oadd_stochastic_plain(pos, sp, g))
