"""Port parity: the hash-grid table gradient (stochastic one-corner and exact
oadd backwards) against ngp_tpu's, and the autograd wrapper."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_tpu.ops import hash_encoding as j_he
from ngp_tpu.utils.config import HashEncodingConfig as JEnc
from ngp_tpu_torch.ops import hash_encoding as t_he
from ngp_tpu_torch.utils.config import HashEncodingConfig as TEnc

torch.set_num_threads(2)

# the TINY encoding of tests/test_end_to_end.py
ENC = {"n_levels": 8, "log2_hashmap_size": 14, "base_resolution": 16, "desired_resolution": 256}


def _specs(stochastic, rate=2):
    kw = dict(ENC, stochastic_corner_backward=stochastic, stochastic_level_rate=rate)
    return j_he.HashGridSpec.create(JEnc(**kw)), t_he.HashGridSpec.create(TEnc(**kw))


def _inputs(spec, n, seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    pos[:8] = [[0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5], [1, 0, 1], [0.25, 0.75, 0.0], [0.999, 0.001, 0.5], [0, 1, 0], [0.1, 0.2, 0.3]]
    g = rng.normal(size=(n, spec.n_output_dims)).astype(np.float32)
    table = rng.uniform(-1e-4, 1e-4, (spec.n_levels, spec.padded_size, spec.n_features)).astype(np.float32)
    return table, pos, g


def _jax_bwd(jspec, table, pos, g, stochastic, acc_dtype):
    if stochastic:
        return np.asarray(j_he._bwd_oadd_stochastic(jnp.asarray(table), jnp.asarray(pos), jspec, jnp.asarray(g), acc_dtype=acc_dtype))
    return np.asarray(j_he._bwd_oadd(jnp.asarray(table), jnp.asarray(pos), jspec, jnp.asarray(g), need_pos_grad=False, acc_dtype=acc_dtype)[0])


def _port_bwd(tspec, pos, g, stochastic):
    fn = t_he.hash_bwd_oadd_stochastic if stochastic else t_he.hash_bwd_oadd
    return fn(torch.from_numpy(pos), tspec, torch.from_numpy(g)).numpy()


# n = 4096 is even (level rate 2 on); n = 4097 is odd (ngp_tpu's rule turns it off)
@pytest.mark.parametrize("stochastic,n", [(True, 4096), (True, 4097), (False, 3000)])
def test_hash_backward_matches_jax_fp32(stochastic, n):
    jspec, tspec = _specs(stochastic)
    table, pos, g = _inputs(jspec, n, n)
    want = _jax_bwd(jspec, table, pos, g, stochastic, jnp.float32)
    got = _port_bwd(tspec, pos, g, stochastic)
    assert got.shape == want.shape == table.shape
    np.testing.assert_array_equal(np.any(got != 0, axis=-1), np.any(want != 0, axis=-1))  # visited rows
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if stochastic:
        # every level receives deposits; with rate 2 on, each sample feeds half
        n_dep = (np.abs(got).sum(-1) > 0).sum()
        n_full = (np.abs(_port_bwd(_specs(True, rate=1)[1], pos, g, True)).sum(-1) > 0).sum()
        assert (n_dep < 0.75 * n_full) == (n % 2 == 0)


@pytest.mark.parametrize("stochastic", [True, False])
def test_hash_backward_near_jax_bf16_default(stochastic):
    jspec, tspec = _specs(stochastic)
    table, pos, g = _inputs(jspec, 4096, 7)
    want = _jax_bwd(jspec, table, pos, g, stochastic, jnp.bfloat16)
    got = _port_bwd(tspec, pos, g, stochastic)
    # ngp_tpu rounds every deposit and partial sum to bf16 (8 bits of mantissa)
    assert np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want)


def test_autograd_wrapper_gives_table_gradient():
    jspec, tspec = _specs(True)
    table, pos, g = _inputs(jspec, 1024, 3)
    tt = torch.from_numpy(table).requires_grad_(True)
    out = t_he.hash_encode_const_pos(tt, torch.from_numpy(pos), tspec)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_he.hash_encode(jnp.asarray(table), pos, jspec)), atol=1e-5)
    (d,) = torch.autograd.grad(out, tt, torch.from_numpy(g))
    want = jax.vjp(lambda t: j_he.hash_encode_const_pos(t, jnp.asarray(pos), jspec), jnp.asarray(table))[1](jnp.asarray(g))[0]
    # JAX's custom_vjp uses the bf16 default
    assert np.linalg.norm(d.numpy() - np.asarray(want)) <= 1e-2 * np.linalg.norm(np.asarray(want))
    np.testing.assert_array_equal(d.numpy(), _port_bwd(tspec, pos, g, True))
