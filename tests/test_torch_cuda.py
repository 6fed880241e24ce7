"""Tests of the port that need a CUDA card; each skips without one.

This file imports torch, numpy and ngp_tpu_torch only, so it also runs where
jax is not installed. On a machine with a card, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(--noconftest skips the root conftest.py, which imports jax.)
"""

import numpy as np
import pytest
import torch

from ngp_tpu_torch.ops.kernels import launch_counts

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
    before = launch_counts()["fused_mlp_fwd"]
    k_rgb, k_dens = fm.fused_mlp_fwd(enc, sh, fw)
    torch.cuda.synchronize()
    assert launch_counts()["fused_mlp_fwd"] == before + 1
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


def _card_and_cpu_frames(card, spp, mode="Shade", envmap=None):
    """The same small scene (seeded weights at a small width, one Gaussian
    blob, the envmap (H_e, W_e, 4) behind it where given) rendered on the
    card (kernels) and on the CPU (plain versions): the two accumulated
    (H, W, 4) buffers."""
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
    if envmap is not None:
        doc["envmap"] = {"train": True, "height": envmap.shape[0], "width": envmap.shape[1]}
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
        params = NGPModel(tb.config.network, device="cpu").init(torch.Generator().manual_seed(3)).params()
        params["density_mlp"][-1][:, 0] = params["density_mlp"][-1][:, 0].abs() * 4.0 + 0.5
        tb.set_state(params, dens.reshape(-1))
        if envmap is not None:
            tb._trainer.envmap.ema_params.copy_(torch.from_numpy(envmap))
        tb.set_nerf_camera_matrix(cam)
        tb.rendering_buffer.render_mode = mode
        tb.render(48, 32, spp=spp, to_srgb=False)
        frames.append(tb._accum.cpu())
    return frames


@pytest.mark.cuda
def test_card_frame_matches_cpu_frame(card):
    """A small frame at a small width: the card (kernel) and the CPU (plain
    versions) agree on the same weights and grid."""
    frames = _card_and_cpu_frames(card, 2)
    err = (frames[0] - frames[1]).abs()
    assert frames[1][..., 3].max() > 0.05
    assert err.max() <= 2e-2 and err.mean() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["Shade", "Depth"])
def test_card_spp8_frame_matches_cpu_frame(card, mode):
    """The protocol's spp-8 frame (Shade: one shared evaluation per cover
    point; Depth: every pass evaluated) on the card and on the CPU, within
    the spp-1 frame's limits."""
    before = launch_counts()["fused_mlp_fwd"]
    frames = _card_and_cpu_frames(card, 8, mode)
    assert launch_counts()["fused_mlp_fwd"] > before
    err = (frames[0] - frames[1]).abs()
    assert frames[1][..., 3].max() > 0.05
    assert err.max() <= 2e-2 and err.mean() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("spp", [1, 8])
def test_card_envmap_frame_matches_cpu_frame(card, spp):
    """Frames over an envmap (rays culled by the premask and missed rays show
    it alone, hit rays blend over it; at spp 8 per pass) on the card and on
    the CPU, within the spp-1 frame's limits."""
    env = np.random.default_rng(4).uniform(0.0, 1.0, (16, 32, 4)).astype(np.float32)
    frames = _card_and_cpu_frames(card, spp, envmap=env)
    err = (frames[0] - frames[1]).abs()
    assert frames[1][..., 3].min() > 0.0  # the envmap lies behind every ray
    assert err.max() <= 2e-2 and err.mean() <= 1e-3


@pytest.mark.cuda
def test_snapshot_with_optimizer_saved_on_card_loads_on_cpu(card, tmp_path):
    """An optimizer state stepped on the card (adam_ema kernel) goes through
    save_snapshot(path, True) and comes back on the CPU unchanged."""
    from ngp_tpu_torch import Testbed

    doc = {"network": {"encoding": {"n_levels": 4, "log2_hashmap_size": 12}, "network": {"n_neurons": 32},
                       "rgb_network": {"n_neurons": 32}}}
    tb = Testbed(device=card)
    tb.load_model_config_dict(doc)
    opt = tb._trainer.optimizer
    gen = torch.Generator().manual_seed(4)
    for _ in range(3):
        opt.step([torch.randn(p.shape, generator=gen).to(card) * 1e-2 for p in opt.params])
    tb.save_snapshot(str(tmp_path / "card.msgpack"), True)
    cpu = Testbed(device="cpu")
    cpu.load_snapshot(str(tmp_path / "card.msgpack"))
    got = cpu._trainer.optimizer
    assert (got.count, got.sched_count) == (opt.count, opt.sched_count) == (3, 3)
    for a, b in zip(got.mu + got.nu + got.params, opt.mu + opt.nu + opt.params, strict=True):
        assert torch.equal(a, b.detach().cpu())
    assert opt.mu[0].abs().max() > 0


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
    before = launch_counts()["fused_mlp_bwd"]
    k_enc, k_w = fm.fused_mlp_bwd(enc, sh, g_rgb, g_dens, fw)
    torch.cuda.synchronize()
    assert launch_counts()["fused_mlp_bwd"] == before + 1
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


ADAM_KW = dict(b1=0.9, b2=0.99, eps=1e-15, decay=0.95)
ADAM_ROW = (1e-2, 1 - 0.9**10, 1 - 0.99**10)  # the step's (lr, bc1, bc2), read by the kernel from the card


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
    row = torch.tensor(ADAM_ROW, dtype=torch.float32)
    plain = [s.clone() for s in state]
    opt.adam_ema_plain(g, *plain, row, **kw)
    dev = [s.to(card) for s in state]
    before = launch_counts()["adam_ema"]
    opt.adam_ema(g.to(card), *dev, row.to(card), **kw)
    torch.cuda.synchronize()
    assert launch_counts()["adam_ema"] == before + 1
    for got, want in zip(dev, plain, strict=True):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-12)
    # the plain version on the card, from the same device row: bit for bit
    plain_card = [s.to(card) for s in state]
    opt.adam_ema_plain(g.to(card), *plain_card, row.to(card), **kw)
    for got, want in zip(dev, plain_card, strict=True):
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_adam_ema_on_the_envmap_leaf_matches_plain_bit_for_bit(card):
    """The envmap's step (create_optimizer_flat): a 256x256x4 fp32 leaf,
    dense (a zero gradient still moves its entry), L2 1e-10, eps 1e-10 and
    the EMA decay 0.99, bit for bit as the plain version on the card."""
    from ngp_tpu_torch.train import optimizer as opt
    from ngp_tpu_torch.utils.config import EnvmapConfig

    cfg = EnvmapConfig().optimizer
    gen = torch.Generator().manual_seed(9)
    shape = (256, 256, 4)
    g = torch.randn(shape, generator=gen) * 1e-4
    g[torch.rand(shape[:2], generator=gen) > 0.3] = 0.0
    state = [torch.randn(shape, generator=gen) * s for s in (1e-5, 1e-9, 1e-1, 1e-1)]
    state[1] = state[1].abs()
    kw = dict(b1=cfg.adam.beta1, b2=cfg.adam.beta2, eps=cfg.adam.epsilon, decay=cfg.ema_decay, l2=cfg.adam.l2_reg, lazy=False)
    row = torch.tensor(ADAM_ROW, dtype=torch.float32, device=card)
    dev = [s.to(card) for s in state]
    plain = [s.to(card) for s in state]
    before = launch_counts()["adam_ema"]
    opt.adam_ema(g.to(card), *dev, row, **kw)
    assert launch_counts()["adam_ema"] == before + 1
    opt.adam_ema_plain(g.to(card), *plain, row, **kw)
    for got, want in zip(dev, plain, strict=True):
        assert torch.equal(got, want)
    assert bool((dev[2] != state[2].to(card))[g.to(card) == 0].all())  # unvisited entries moved


@pytest.mark.cuda
def test_envmap_steps_through_adam_ema_once_a_call(card, tmp_path):
    """A TINY model with envmap.train on the card: each train() call, graphed
    or step by step, launches adam_ema once a step per network leaf and once
    for the envmap, which moves."""
    from ngp_tpu_torch import Testbed
    from ngp_tpu_torch.data.synthetic import write_synthetic_dataset

    train_json, _ = write_synthetic_dataset(tmp_path, n_train=4, n_test=1, width=32, height=32, device=card)
    tb = Testbed(device=card)
    tb.load_model_config_dict({**TRAIN_TINY, "envmap": {"train": True, "height": 32, "width": 64}})
    tb._trainer.sample_capacity = 1 << 14
    tb.load_training_data(train_json)
    n_leaves = len(tb._trainer.model.param_list())
    graphed = []
    for _ in range(4):
        before = launch_counts()["adam_ema"]
        tb.train(16, 1 << 14)
        torch.cuda.synchronize()
        assert launch_counts()["adam_ema"] - before == 16 * n_leaves + 1
        graphed.append(tb.training_buffer.graphed)
    env = tb._trainer.envmap
    assert any(graphed) and env.optimizer.count == 4 and env.params.abs().max() > 0


@pytest.mark.cuda
def test_adam_ema_rejects_unaligned_buffers(card):
    from ngp_tpu_torch.train import optimizer as opt

    bufs = [torch.zeros((1001,), device=card) for _ in range(5)]
    before = launch_counts()["adam_ema"]
    with pytest.raises(ValueError, match="16-byte"):
        opt.adam_ema(*(b[1:] for b in bufs), torch.tensor(ADAM_ROW, device=card), **ADAM_KW, lazy=True)
    assert launch_counts()["adam_ema"] == before


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
    before = launch_counts()["hash_encode_fwd"]
    out = he.hash_encode(table, pos, spec)
    torch.cuda.synchronize()
    assert launch_counts()["hash_encode_fwd"] == before + 1
    # only the order of the fp32 8-term sum differs; |out| <= 1
    torch.testing.assert_close(out, he.hash_encode_plain(table, pos, spec), rtol=0, atol=1e-5)


# kr = 2 on an even N, and the fallback to kr = 1 on a ragged N and rate 1
@pytest.mark.cuda
@pytest.mark.parametrize("n,n_features,rate", [(2**16, 2, 2), (2**16 + 37, 2, 2), (4096, 2, 1), (4096, 4, 2), (999, 1, 3)])
def test_hash_deposits_match_plain(card, n, n_features, rate):
    from ngp_tpu_torch.ops import hash_encoding as he

    spec, _, pos, g_dyadic, g = _hash_case(n, n_features, rate, n + 1, card)
    before = (launch_counts()["hash_encode_bwd_stochastic"], launch_counts()["hash_encode_bwd_exact"])
    stochastic = he.hash_bwd_oadd_stochastic(pos, spec, g_dyadic)
    exact = he.hash_bwd_exact(pos, spec, g)
    torch.cuda.synchronize()
    assert (launch_counts()["hash_encode_bwd_stochastic"], launch_counts()["hash_encode_bwd_exact"]) == (before[0] + 1, before[1] + 1)
    # the same draws and rows, exact sums: bit for bit
    assert torch.equal(stochastic, he.hash_bwd_oadd_stochastic_plain(pos, spec, g_dyadic))
    # w * g summed in another order (atomics)
    want = he.hash_bwd_exact_plain(pos, spec, g)
    torch.testing.assert_close(exact, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())


@pytest.mark.cuda
def test_input_gradient_matches_cpu(card):
    """input_gradient on the card (gather kernel, plain d/dpos, cuBLAS head)
    against the CPU, and no gradient left on the parameters."""
    from ngp_tpu_torch.models.ngp import NGPModel
    from ngp_tpu_torch.utils.config import NGPConfig

    cfg = NGPConfig.from_json({"network": {"encoding": HASH_TINY}}).network
    model = NGPModel(cfg, device="cpu").init(torch.Generator().manual_seed(5))
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
    cell puts a hash level's corner pair at r = size - 1 first; "one_cell",
    each point 32 times in a row, so the 32 lanes of a warp share every
    cell; "x_clamp", uniform points with x = 1, where the dense levels
    clamp x at res - 1."""
    from ngp_tpu_torch.ops import hash_encoding as he

    if kind == "one_cell":
        return np.repeat(rng.uniform(0.0, 1.0, (-(-n // 32), 3)), 32, axis=0)[:n].astype(np.float32)
    if kind == "x_clamp":
        pos = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
        pos[:, 0] = 1.0
        return pos
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
    before = launch_counts()["hash_encode_fwd"]
    out = he.hash_encode(table, pos, spec)
    torch.cuda.synchronize()
    assert launch_counts()["hash_encode_fwd"] == before + 1
    torch.testing.assert_close(out, he.hash_encode_plain(table, pos, spec), rtol=0, atol=1e-5)
    for rate in (1, 2):
        sp = _kernel_spec(n_levels, n_features, rate)
        before = launch_counts()["hash_encode_bwd_stochastic"]
        got = he.hash_bwd_oadd_stochastic(pos, sp, g)
        torch.cuda.synchronize()
        assert launch_counts()["hash_encode_bwd_stochastic"] == before + 1
        assert torch.equal(got, he.hash_bwd_oadd_stochastic_plain(pos, sp, g))


# the TINY config of tests/test_end_to_end.py, and a bucketed step shape with
# the occupied window and the two-level march on
TRAIN_TINY = {
    "samlper": {"aabb_scale": 1, "grid_size": 32, "maximum_marching_steps": 256},
    "network": {"encoding": HASH_TINY, "network": {"n_neurons": 64, "n_hidden_layers": 1}, "dir_encoding": {"degree": 4},
                "rgb_network": {"n_neurons": 64, "n_hidden_layers": 2}},
}
TRAIN_SHAPE = dict(n_rays=512, capacity=1 << 14, s_pad=256, n_window=256, s_short=32, n_long=128, n_seg_cap=16)


def _card_trainer(card, seed=0):
    """A trainer on the card at TRAIN_TINY from seeded weights, a blob grid
    and a small random dataset."""
    from types import SimpleNamespace

    from ngp_tpu_torch.data.synthetic import look_at_pose
    from ngp_tpu_torch.models.interop import grid_from_numpy
    from ngp_tpu_torch.models.ngp import NGPModel
    from ngp_tpu_torch.train.trainer import Trainer
    from ngp_tpu_torch.utils.camera import opengl_to_opencv
    from ngp_tpu_torch.utils.config import NGPConfig

    cfg = NGPConfig.from_json(TRAIN_TINY)
    params = NGPModel(cfg.network, device="cpu").init(torch.Generator().manual_seed(seed)).params()
    params["hash_table"] = params["hash_table"] * 1e3
    tr = Trainer.create(cfg, params, card)
    g = cfg.sampler.grid_size
    ax = (np.arange(g) + 0.5) / g
    z, y, x = np.meshgrid(ax, ax, ax, indexing="ij")
    dens = np.zeros((cfg.sampler.n_cascades, g, g, g), np.float32)
    dens[0] = 3.0 * np.exp(-((x - 0.5) ** 2 + (y - 0.45) ** 2 + (z - 0.55) ** 2) / 0.01)
    tr.grid = grid_from_numpy(cfg.sampler, dens.reshape(-1), 0, device=card)
    rng = np.random.default_rng(seed)
    poses = [look_at_pose(4.0 * np.array([np.cos(2.4 * k) * 0.8, np.sin(2.4 * k) * 0.8, 0.6])) for k in range(4)]
    ds = SimpleNamespace(
        images=torch.from_numpy(rng.uniform(0, 1, (4, 24, 32, 4)).astype(np.float16)).to(card),
        xforms=opengl_to_opencv(np.stack(poses), 0.33, [0.5, 0.5, 0.5]).to(card),
        focal_length=(40.0, 40.0),
    )
    return tr, ds


@pytest.mark.cuda
def test_captured_call_matches_the_same_steps_eager(card):
    """train_call(fuse=4) captured in a CUDA graph and replayed against four
    eager steps from the same state and draw table: every step's loss_sum
    within 1e-4 relative, the integer stats equal, the parameters within 1e-3
    relative L2 (the stochastic deposit adds in float atomics, so the last
    bits follow the order of the adds); the replay counts the graph's kernel
    launches."""
    from ngp_tpu_torch.ops import kernels
    from ngp_tpu_torch.train.trainer import STAT_KEYS

    (a, ds), (b, _) = _card_trainer(card), _card_trainer(card)
    s = TRAIN_SHAPE
    table = torch.from_numpy(a.draw_table(torch.Generator().manual_seed(1), 5, 77, s["n_rays"])).to(card)
    # the gate: an eager step of the shape runs before any capture, on both
    warm = torch.zeros((5, len(STAT_KEYS)), dtype=torch.float64, device=card)
    for tr in (a, b):
        tr.train_step(**s)(ds, table[0], warm[0])
    eager = torch.zeros_like(warm)
    step = b.train_step(**s)
    for k in range(1, 5):
        step(ds, table[k], eager[k])
    call = a.train_call(s["n_rays"], s["capacity"], s["s_pad"], 4, s["n_window"], s["s_short"], s["n_long"], s["n_seg_cap"])
    before = kernels.launch_counts()
    graphed = torch.zeros_like(warm)
    call(ds, table[1:], graphed[1:])
    torch.cuda.synchronize()
    assert call.graph is not None
    after = kernels.launch_counts()
    assert after["adam_ema"] - before["adam_ema"] == 4 * len(a.model.param_list())
    assert all(after[k] - before[k] == 4 for k in ("fused_mlp_fwd", "fused_mlp_bwd", "hash_encode_bwd_stochastic"))
    e, g = eager[1:].cpu(), graphed[1:].cpu()
    torch.testing.assert_close(g[:, 0], e[:, 0], rtol=1e-4, atol=0)
    assert torch.equal(g[:, 1:], e[:, 1:]) and bool((g[:, 1] > 0).all())
    for x, y in zip(a.model.param_list(), b.model.param_list(), strict=True):
        rel = ((x - y).norm() / y.norm()).item()
        assert rel < 1e-3, rel
    # a second replay runs on from the graph's own state
    call(ds, table[1:], graphed[1:])
    torch.cuda.synchronize()
    assert bool(torch.isfinite(graphed).all())


@pytest.mark.cuda
def test_training_step_does_not_sync_with_the_host(card):
    """After one warm-up step, a whole training step at a bucketed shape
    (batch generation, loss, backward, optimizer) runs under
    torch.cuda.set_sync_debug_mode("error"): no synchronising call and no
    copy from pageable host memory."""
    from ngp_tpu_torch.train.trainer import STAT_KEYS

    tr, ds = _card_trainer(card)
    s = TRAIN_SHAPE
    table = torch.from_numpy(tr.draw_table(torch.Generator().manual_seed(2), 2, 5, s["n_rays"])).to(card)
    out = torch.zeros((2, len(STAT_KEYS)), dtype=torch.float64, device=card)
    step = tr.train_step(**s)
    step(ds, table[0], out[0])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(ds, table[1], out[1])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(out).all()) and float(out[1, 1]) > 0


# (variant, N, features, levels, positions): both ported variants over ray-major
# batches, hash-level pairs at r = size - 1, level counts that are no multiple
# of the gather's level group, every feature width, and N = 1 and 2^16 + 37
HASH_VARIANT_CASES = [
    (variant, *case)
    for variant in ("xadd", "tcnn")
    for case in ((2**16 + 37, 2, 8, "rays"), (4096, 2, 8, "wrap"), (4099, 1, 5, "uniform"), (4096, 4, 6, "rays"),
                 (1000, 8, 5, "uniform"), (1, 2, 8, "uniform"))
]


@pytest.mark.cuda
@pytest.mark.parametrize("variant,n,n_features,n_levels,kind", HASH_VARIANT_CASES)
def test_hash_variant_kernels_match_plain(card, variant, n, n_features, n_levels, kind):
    """The xadd and tcnn instantiations of the gather (within 1e-5) and of
    the exact scatter (w * g summed in another order: rtol 1e-5, atol 1e-5 x
    the gradient's max) against their plain versions; the one-corner
    deposit refuses them and launches nothing."""
    import dataclasses

    from ngp_tpu_torch.ops import hash_encoding as he

    rng = np.random.default_rng(n + 10 * n_features + n_levels + len(variant))
    spec = dataclasses.replace(_kernel_spec(n_levels, n_features, 2), variant=variant)
    pos = torch.from_numpy(_kernel_positions(kind, n, spec, rng)).to(card)
    table = torch.from_numpy(rng.uniform(-1.0, 1.0, (n_levels, spec.padded_size, n_features)).astype(np.float32)).to(card)
    g = torch.from_numpy(rng.normal(size=(n, spec.n_output_dims)).astype(np.float32)).to(card)
    before = (launch_counts()["hash_encode_fwd"], launch_counts()["hash_encode_bwd_exact"], launch_counts()["hash_encode_bwd_stochastic"])
    out = he.hash_encode(table, pos, spec)
    d = he.hash_bwd_exact(pos, spec, g)
    torch.cuda.synchronize()
    assert (launch_counts()["hash_encode_fwd"], launch_counts()["hash_encode_bwd_exact"]) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(out, he.hash_encode_plain(table, pos, spec), rtol=0, atol=1e-5)
    want = he.hash_bwd_exact_plain(pos, spec, g)
    torch.testing.assert_close(d, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())
    with pytest.raises(ValueError, match="oadd"):
        he.hash_bwd_oadd_stochastic_cuda(pos, spec, g)
    assert launch_counts()["hash_encode_bwd_stochastic"] == before[2]


# the exact scatter of every variant over HASH_GROUP_CASES, plus warps whose 32
# samples share every cell (every merge key equal) and tcnn's dense levels
# where x clamps at res - 1 (corners k and k|1 on one row)
EXACT_CASES = [
    *((variant, *case) for variant in ("oadd", "xadd", "tcnn") for case in HASH_GROUP_CASES),
    *((variant, 4096, 2, 8, "one_cell") for variant in ("oadd", "xadd", "tcnn")),
    ("tcnn", 4096, 2, 8, "x_clamp"),
    ("tcnn", 4099, 1, 8, "x_clamp"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("variant,n,n_features,n_levels,kind", EXACT_CASES)
def test_exact_scatter_matches_plain(card, variant, n, n_features, n_levels, kind):
    """The exact scatter against its plain version: w * g summed in another
    order (atomics in any order, lanes merged by shuffles), so rtol 1e-5 and
    atol 1e-5 x the gradient's max."""
    import dataclasses

    from ngp_tpu_torch.ops import hash_encoding as he

    rng = np.random.default_rng(n + 10 * n_features + n_levels + 7 * len(kind))
    spec = dataclasses.replace(_kernel_spec(n_levels, n_features, 1), variant=variant)
    pos = torch.from_numpy(_kernel_positions(kind, n, spec, rng))
    if kind == "x_clamp":
        rows = he.corner_rows(pos, spec)
        assert (rows[..., 0::2] == rows[..., 1::2]).any()  # the clamp puts a pair on one row
    pos = pos.to(card)
    g = torch.from_numpy(rng.normal(size=(n, spec.n_output_dims)).astype(np.float32)).to(card)
    before = launch_counts()["hash_encode_bwd_exact"]
    d = he.hash_bwd_exact(pos, spec, g)
    torch.cuda.synchronize()
    assert launch_counts()["hash_encode_bwd_exact"] == before + 1
    want = he.hash_bwd_exact_plain(pos, spec, g)
    torch.testing.assert_close(d, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())


@pytest.mark.cuda
def test_exact_scatter_refuses_an_odd_row_count(card):
    """At F <= 2 a deposit adds two flat rows, so the kernel takes only an
    even L * T_pad (every HashGridSpec.create spec has one): an odd one
    raises and launches nothing."""
    from ngp_tpu_torch.ops import hash_encoding as he

    spec = he.HashGridSpec(n_levels=1, n_features=2, scales=(2.0,), resolutions=(3,), dense=(True,), sizes=(27,),
                           offsets=(0,), variant="tcnn")
    pos = torch.rand((64, 3), device=card)
    g = torch.randn((64, 2), device=card)
    before = launch_counts()["hash_encode_bwd_exact"]
    with pytest.raises(RuntimeError, match="exact"):
        he.hash_bwd_exact(pos, spec, g)
    assert launch_counts()["hash_encode_bwd_exact"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["oadd", "xadd", "tcnn"])
def test_exact_scatter_replays_from_a_cuda_graph(card, variant):
    """The exact scatter, zero fill included, captured in a CUDA graph and
    replayed on new positions and g, twice: each replay equals the same
    call eager up to the order of the adds (a replay that skipped the zero
    fill would hold twice the gradient)."""
    import dataclasses

    from ngp_tpu_torch.ops import hash_encoding as he

    spec = dataclasses.replace(_kernel_spec(8, 2, 1), variant=variant)
    gen = torch.Generator(device=card).manual_seed(3)
    n = 4096
    pos = torch.zeros((n, 3), device=card)
    g = torch.zeros((n, spec.n_output_dims), device=card)
    stream = torch.cuda.Stream(card)
    stream.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(stream):
        he.hash_bwd_exact(pos, spec, g)  # warm-up: load the library outside the capture
    torch.cuda.current_stream(card).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        d = he.hash_bwd_exact(pos, spec, g)
    for _ in range(2):
        pos.copy_(torch.rand((n, 3), generator=gen, device=card))
        g.copy_(torch.randn(g.shape, generator=gen, device=card))
        graph.replay()
        graph.replay()
        torch.cuda.synchronize()
        want = he.hash_bwd_exact(pos, spec, g)
        torch.testing.assert_close(d, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())
