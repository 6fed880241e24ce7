"""Port parity: the fused MLP backward's plain version and the autograd
wrapper against jax.grad of ngp_tpu's fused_rgbsigma (the Pallas
_bwd_kernel in interpret mode). The CUDA kernel is held against this plain
version on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_tpu.ops.fused_mlp import fused_rgbsigma
from ngp_tpu_torch.ops import fused_mlp as t_fused

torch.set_num_threads(2)

# the tolerances of tests/test_fused_mlp.py:59 (bf16 operands: another fp32
# summation order can move a hidden activation to the neighbouring bf16 value)
RTOL, ATOL = 3e-2, 3e-2


def _weights(rng, n_in, width, n_out, hidden):
    dims = [n_in] + [width] * hidden + [n_out]
    return [
        rng.uniform(-np.sqrt(6.0 / (dims[i] + dims[i + 1])), np.sqrt(6.0 / (dims[i] + dims[i + 1])), (dims[i], dims[i + 1])).astype(np.float32)
        for i in range(len(dims) - 1)
    ]


def _case(n, d_hidden, r_hidden, width, seed=0):
    rng = np.random.default_rng(seed)
    dmlp = _weights(rng, 32, width, 16, d_hidden)
    rmlp = _weights(rng, 32, width, 3, r_hidden)
    enc = rng.normal(size=(n, 32)).astype(np.float32)
    sh = rng.normal(size=(n, 16)).astype(np.float32)
    g_rgb = rng.normal(size=(n, 3)).astype(np.float32)
    g_dens = np.zeros((n, 16), np.float32)
    g_dens[:, 0] = rng.normal(size=n)
    return dmlp, rmlp, enc, sh, g_rgb, g_dens


def _close(got, want):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * scale)


# the cases of tests/test_fused_mlp.py:23-26
@pytest.mark.parametrize("n,d_hidden,r_hidden,width", [(512, 1, 2, 64), (2048 + 257, 1, 2, 64), (333, 3, 3, 32), (640, 1, 2, 128)])
def test_backward_matches_jax_grad(n, d_hidden, r_hidden, width):
    dmlp, rmlp, enc, sh, g_rgb, g_dens = _case(n, d_hidden, r_hidden, width, seed=n)

    def f(dw, rw, x):
        return fused_rgbsigma(dw, rw, x, jnp.asarray(sh))

    _, vjp = jax.vjp(jax.jit(f), [jnp.asarray(w) for w in dmlp], [jnp.asarray(w) for w in rmlp], jnp.asarray(enc))
    j_dw, j_rw, j_dx = vjp((jnp.asarray(g_rgb), jnp.asarray(g_dens)))

    # the plain version, in packed form
    fw = t_fused.pack_weights([torch.from_numpy(w) for w in dmlp], [torch.from_numpy(w) for w in rmlp])
    d_enc, flat = t_fused.fused_mlp_bwd(*(torch.from_numpy(a) for a in (enc, sh, g_rgb, g_dens)), fw)
    assert flat.shape == fw.packed.shape and flat.dtype == torch.float32
    dg, rg = t_fused.unpack_grads(fw, flat)
    _close(d_enc.numpy(), np.asarray(j_dx))
    for got, want in zip(dg + rg, list(j_dw) + list(j_rw), strict=True):
        assert got.shape == want.shape
        _close(got.numpy(), np.asarray(want))

    # the autograd wrapper gives the same gradients
    tw = [torch.from_numpy(w).requires_grad_(True) for w in dmlp + rmlp]
    te = torch.from_numpy(enc).requires_grad_(True)
    rgb, dens = t_fused.fused_heads(te, torch.from_numpy(sh), tw[: len(dmlp)], tw[len(dmlp) :])
    grads = torch.autograd.grad((rgb, dens), [te, *tw], (torch.from_numpy(g_rgb), torch.from_numpy(g_dens)))
    np.testing.assert_array_equal(grads[0].numpy(), d_enc.numpy())
    for got, want in zip(grads[1:], dg + rg, strict=True):
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_padding_rows_and_dims_are_exact():
    """Widths off the multiple of 16: the padded kernel layout unpacks to the
    same gradients as autograd of the unpadded mlp_apply-style chain."""
    from ngp_tpu_torch.ops.mlp import bf16_round

    rng = np.random.default_rng(5)
    dmlp = _weights(rng, 24, 40, 12, 2)
    rmlp = _weights(rng, 12 + 9, 40, 3, 2)
    n = 200
    enc, sh = rng.normal(size=(n, 24)).astype(np.float32), rng.normal(size=(n, 9)).astype(np.float32)
    g_rgb, g_dens = rng.normal(size=(n, 3)).astype(np.float32), rng.normal(size=(n, 12)).astype(np.float32)
    fw = t_fused.pack_weights([torch.from_numpy(w) for w in dmlp], [torch.from_numpy(w) for w in rmlp])
    d_enc, flat = t_fused.fused_mlp_bwd_plain(*(torch.from_numpy(a) for a in (enc, sh, g_rgb, g_dens)), fw)
    dg, rg = t_fused.unpack_grads(fw, flat)

    tw = [bf16_round(torch.from_numpy(w)).requires_grad_(True) for w in dmlp + rmlp]
    x = torch.from_numpy(enc).requires_grad_(True)
    h = x
    for i, w in enumerate(tw[:3]):
        h = bf16_round(h) @ w
        h = torch.relu(h) if i < 2 else h
    r = torch.cat([h, torch.from_numpy(sh)], dim=-1)
    for i, w in enumerate(tw[3:]):
        r = bf16_round(r) @ w
        r = torch.relu(r) if i < 2 else r
    want = torch.autograd.grad((r, h), [x, *tw], (torch.from_numpy(g_rgb), torch.from_numpy(g_dens)))
    _close(d_enc.numpy(), want[0].numpy())
    for got, w in zip(dg + rg, want[1:], strict=True):
        _close(got.numpy(), w.numpy())
