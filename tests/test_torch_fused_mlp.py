"""Port parity: the fused MLP forward's plain version vs ngp_tpu's Pallas kernel
(interpret mode) and mlp_apply chain, and the padding logic. The CUDA kernel
itself is held against this plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_tpu.ops.fused_mlp import fused_rgbsigma
from ngp_tpu.ops.mlp import mlp_apply as j_mlp_apply
from ngp_tpu_torch.ops import fused_mlp as t_fused
from ngp_tpu_torch.ops.mlp import mlp_apply as t_mlp_apply

torch.set_num_threads(2)

# the tolerances of tests/test_fused_mlp.py: bf16 re-rounding of a hidden
# activation can flip one bf16 ulp between two fp32 summation orders
RTOL, ATOL = 2e-2, 3e-2


def _weights(rng, n_in, width, n_out, hidden):
    dims = [n_in] + [width] * hidden + [n_out]
    out = []
    for i in range(len(dims) - 1):
        b = np.sqrt(6.0 / (dims[i] + dims[i + 1]))
        out.append(rng.uniform(-b, b, (dims[i], dims[i + 1])).astype(np.float32))
    return out


def _case(seed, n, d_hidden, r_hidden, width, d_in=32, d_sh=16, dd=16):
    rng = np.random.default_rng(seed)
    dmlp = _weights(rng, d_in, width, dd, d_hidden)
    rmlp = _weights(rng, dd + d_sh, width, 3, r_hidden)
    enc = rng.normal(size=(n, d_in)).astype(np.float32)
    sh = rng.normal(size=(n, d_sh)).astype(np.float32)
    return dmlp, rmlp, enc, sh


def _plain(dmlp, rmlp, enc, sh):
    fw = t_fused.pack_weights([torch.from_numpy(w) for w in dmlp], [torch.from_numpy(w) for w in rmlp])
    rgb, dens = t_fused.fused_mlp_fwd(torch.from_numpy(enc), torch.from_numpy(sh), fw)
    return rgb.numpy(), dens.numpy()


@pytest.mark.parametrize(
    "n,d_hidden,r_hidden,width",
    [(512, 1, 2, 64), (2048 + 257, 1, 2, 64), (333, 3, 3, 32), (640, 1, 2, 128), (100, 2, 1, 16)],
)
def test_plain_matches_jax_fused_and_chain(n, d_hidden, r_hidden, width):
    dmlp, rmlp, enc, sh = _case(n, n, d_hidden, r_hidden, width)
    rgb, dens = _plain(dmlp, rmlp, enc, sh)
    assert rgb.shape == (n, 3) and dens.shape == (n, 16)

    j_rgb, j_dens = jax.jit(fused_rgbsigma)([jnp.asarray(w) for w in dmlp], [jnp.asarray(w) for w in rmlp], enc, sh)
    np.testing.assert_allclose(rgb, np.asarray(j_rgb), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(dens, np.asarray(j_dens), rtol=RTOL, atol=ATOL)

    c_dens = j_mlp_apply([jnp.asarray(w) for w in dmlp], enc)
    c_rgb = j_mlp_apply([jnp.asarray(w) for w in rmlp], jnp.concatenate([c_dens, sh], axis=-1))
    np.testing.assert_allclose(rgb, np.asarray(c_rgb), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(dens, np.asarray(c_dens), rtol=RTOL, atol=ATOL)

    # the port's own chain (no split, no padding) agrees with the JAX chain too
    t_dens = t_mlp_apply([torch.from_numpy(w) for w in dmlp], torch.from_numpy(enc))
    np.testing.assert_allclose(t_dens.numpy(), np.asarray(c_dens), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("d_in,d_sh,dd,width", [(24, 9, 12, 40), (32, 16, 16, 50)])
def test_padding_is_exact(d_in, d_sh, dd, width):
    """Dims off the multiple of 16 are zero-padded; the result equals the
    unpadded mlp_apply chain on the same numerics."""
    dmlp, rmlp, enc, sh = _case(7, 200, 2, 2, width, d_in=d_in, d_sh=d_sh, dd=dd)
    fw = t_fused.pack_weights([torch.from_numpy(w) for w in dmlp], [torch.from_numpy(w) for w in rmlp])
    assert (fw.d_in, fw.d_sh, fw.dd) == tuple(-(-x // 16) * 16 for x in (d_in, d_sh, dd))
    assert fw.wd == fw.wr == -(-width // 16) * 16
    assert fw.packed.dtype == torch.bfloat16
    assert fw.packed.numel() == sum(k * n for k, n in sum(fw.shapes(), []))
    dmats, rmats = fw.matrices()
    # padding rows/cols are zero; the real block is the bf16-rounded weight
    np.testing.assert_array_equal(dmats[0][d_in:].float().numpy(), 0.0)
    np.testing.assert_array_equal(rmats[-1][:, 3:].float().numpy(), 0.0)
    np.testing.assert_array_equal(
        dmats[0][:d_in, :width].float().numpy(), torch.from_numpy(dmlp[0]).bfloat16().float().numpy()
    )
    rgb, dens = _plain(dmlp, rmlp, enc, sh)
    t_d = t_mlp_apply([torch.from_numpy(w) for w in dmlp], torch.from_numpy(enc))
    t_r = t_mlp_apply([torch.from_numpy(w) for w in rmlp], torch.cat([t_d, torch.from_numpy(sh)], dim=-1))
    np.testing.assert_allclose(dens, t_d.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(rgb, t_r.numpy(), rtol=RTOL, atol=ATOL)


def test_pack_rejects_what_the_kernel_does_not_take():
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError, match="128"):
        t_fused.pack_weights(
            [torch.from_numpy(w) for w in _weights(rng, 32, 160, 16, 1)],
            [torch.from_numpy(w) for w in _weights(rng, 32, 64, 3, 2)],
        )
    with pytest.raises(ValueError, match="hidden"):
        t_fused.pack_weights([torch.zeros(32, 16)], [torch.zeros(32, 64), torch.zeros(64, 3)])


def test_supports_gate():
    from ngp_tpu.ops.fused_mlp import supports as j_supports
    from ngp_tpu.utils.config import NGPConfig as JCfg
    from ngp_tpu_torch.utils.config import NGPConfig as TCfg

    for doc in ({}, {"network": {"network": {"activation": "Tanh"}}}, {"network": {"rgb_network": {"n_neurons": 256}}}):
        a, b = JCfg.from_json(doc).network, TCfg.from_json(doc).network
        assert t_fused.supports(b.density_mlp, b.rgb_mlp) == j_supports(a.density_mlp, a.rgb_mlp)


def _fw(width, hidden, d_in=32, d_sh=16):
    return t_fused.pack_weights(
        [torch.zeros(d_in, width)] + [torch.zeros(width, width)] * (hidden - 1) + [torch.zeros(width, 16)],
        [torch.zeros(16 + d_sh, width)] + [torch.zeros(width, width)] * (hidden - 1) + [torch.zeros(width, 3)],
    )


@pytest.mark.parametrize("hidden", [1, 2, 3, 4])
@pytest.mark.parametrize("width", [16, 32, 48, 64, 80, 96, 112, 128])
def test_kernel_bucket_and_weight_tiles(width, hidden):
    """The kernels' instantiation is the smallest of 32, 64 and 128 that holds
    every padded width (enc's 32 included), and the backward keeps its sums
    in registers only in the 32- and 64-wide buckets with at most 24 x 4
    m16n8 weight-gradient tiles."""
    fw = _fw(width, hidden)
    assert t_fused.mlp_bucket(fw) == (32 if width <= 32 else 64 if width <= 64 else 128)
    d = [(32, width)] + [(width, width)] * (hidden - 1) + [(width, 16)]
    r = [(16, width), (16, width)] + [(width, width)] * (hidden - 1) + [(width, 16)]
    tiles = sum((k // 16) * (n // 8) for k, n in d + r)
    assert t_fused.weight_tiles(fw) == tiles
    assert t_fused.bwd_sums_in_registers(fw) == (width <= 64 and tiles <= 96)


def test_kernel_bucket_rejects_widths_above_128():
    # base.json widths (64 wide; 1 density, 2 rgb hidden layers): 80 tiles in registers
    base = t_fused.pack_weights(
        [torch.zeros(32, 64), torch.zeros(64, 16)], [torch.zeros(32, 64), torch.zeros(64, 64), torch.zeros(64, 3)]
    )
    assert (t_fused.mlp_bucket(base), t_fused.weight_tiles(base), t_fused.bwd_sums_in_registers(base)) == (64, 80, True)
    assert t_fused.mlp_bucket(_fw(64, 1, d_in=128)) == 128
    with pytest.raises(ValueError, match="128"):
        t_fused.mlp_bucket(_fw(64, 1, d_in=144))
    with pytest.raises(ValueError, match="128"):
        t_fused.mlp_bucket(_fw(64, 1, d_sh=130))
