"""Port parity: the hash-grid table gradient (stochastic one-corner and exact
oadd backwards) and the analytic position gradient against ngp_tpu's, and
the autograd wrappers."""

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


def _edge_positions(rng, n):
    """Random points plus the box's faces and corners and points just under
    1, where the dense levels clamp their corner pair (dlive = 0)."""
    pos = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    faces = rng.uniform(0.0, 1.0, (64, 3)).astype(np.float32)
    faces[np.arange(64), rng.integers(0, 3, 64)] = rng.choice([0.0, 1.0], 64)
    corners = np.array([[(k >> d) & 1 for d in range(3)] for k in range(8)], np.float32)
    near_top = 1.0 - rng.uniform(0.0, 0.02, (32, 3)).astype(np.float32)
    return np.concatenate([pos, faces, corners, near_top])


SMALL = {"n_levels": 4, "log2_hashmap_size": 12, "base_resolution": 8, "desired_resolution": 64}


@pytest.mark.parametrize("enc", [SMALL, ENC])
def test_hash_dpos_matches_jax(enc):
    """hash_dpos_oadd against _bwd_oadd's d/dpos on both a small spec and the
    TINY one (dense and hash levels), at the dense clamp's edges too."""
    jspec, tspec = (m.HashGridSpec.create(c(**enc)) for m, c in ((j_he, JEnc), (t_he, TEnc)))
    assert any(tspec.dense) and not all(tspec.dense)
    rng = np.random.default_rng(11)
    pos = _edge_positions(rng, 1000)
    table = rng.uniform(-1.0, 1.0, (tspec.n_levels, tspec.padded_size, tspec.n_features)).astype(np.float32)
    g = rng.normal(size=(pos.shape[0], tspec.n_output_dims)).astype(np.float32)
    want = np.asarray(j_he._bwd_oadd(jnp.asarray(table), jnp.asarray(pos), jspec, jnp.asarray(g), acc_dtype=jnp.float32)[1])
    got = t_he.hash_dpos_oadd(torch.from_numpy(table), torch.from_numpy(pos), tspec, torch.from_numpy(g)).numpy()
    assert got.shape == want.shape == pos.shape
    # fp32, the same products summed in another order: 1e-5 of the largest
    # component (levels' scales reach 255, so components reach ~1e3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    _, _, dlive = t_he.oct_base_w0(torch.from_numpy(pos), t_he._level_constants(tspec, "cpu"), with_dlive=True)
    assert (dlive == 0).any()  # the clamped dense dims are among the cases


def test_pos_grad_wrapper_gives_both_gradients():
    """hash_encode_pos_grad's table gradient is _bwd_oadd's (fp32
    accumulation) and its pos gradient hash_dpos_oadd's."""
    jspec, tspec = _specs(False)
    table, pos, g = _inputs(jspec, 2048, 5)
    tt = torch.from_numpy(table).requires_grad_(True)
    tp = torch.from_numpy(pos).requires_grad_(True)
    out = t_he.hash_encode_pos_grad(tt, tp, tspec)
    d_table, d_pos = torch.autograd.grad(out, (tt, tp), torch.from_numpy(g))
    want_table, want_pos = (np.asarray(x) for x in j_he._bwd_oadd(jnp.asarray(table), jnp.asarray(pos), jspec, jnp.asarray(g), acc_dtype=jnp.float32))
    np.testing.assert_allclose(d_table.numpy(), want_table, rtol=0, atol=1e-6)
    np.testing.assert_allclose(d_pos.numpy(), want_pos, rtol=0, atol=1e-5 * np.abs(want_pos).max())
    # only what is asked for: no table gradient for a table that needs none
    (d_pos_only,) = torch.autograd.grad(t_he.hash_encode_pos_grad(torch.from_numpy(table), tp, tspec), tp, torch.from_numpy(g))
    torch.testing.assert_close(d_pos_only, d_pos, rtol=0, atol=0)


def _ray_ordered(rng, n_rays, n_per_ray):
    """Ray-major positions, as a training batch lies: consecutive samples
    sqrt(3)/1024 apart along one ray (base.json's step), so at the coarse
    levels many neighbouring samples deposit into the same row."""
    d = rng.normal(size=(n_rays, 1, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = (np.arange(n_per_ray) * np.sqrt(3.0) / 1024)[None, :, None]
    return (rng.uniform(0.25, 0.75, (n_rays, 1, 3)) + t * d).reshape(-1, 3).astype(np.float32)


@pytest.mark.parametrize("rate", [1, 2])
def test_stochastic_deposit_matches_jax_on_ray_ordered_positions(rate):
    """The one-corner deposit against _bwd_oadd_stochastic's fp32 path on a
    ray-major batch; g of small integers x 2^-8 makes every sum exact, so
    the two agree bit for bit whatever the order of their adds."""
    jspec, tspec = _specs(True, rate)
    rng = np.random.default_rng(17 + rate)
    pos = _ray_ordered(rng, 32, 128)
    g = rng.integers(-8, 9, (pos.shape[0], tspec.n_output_dims)).astype(np.float32) * np.float32(2.0**-8)
    table = np.zeros((tspec.n_levels, tspec.padded_size, tspec.n_features), np.float32)
    want = _jax_bwd(jspec, table, pos, g, True, jnp.float32)
    got = _port_bwd(tspec, pos, g, True)
    # level 0: far fewer rows than deposits, so many samples share a row
    assert 0 < (np.abs(want[0]).sum(-1) > 0).sum() < 0.25 * pos.shape[0] / rate
    np.testing.assert_array_equal(got, want)
