"""Port parity: the occupancy grid's upkeep (_pcg4d, sample_grid_positions,
splat_density_ema, mark_untrained_grid) against ngp_tpu, exactly, with JAX's
threefry salts injected."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_tpu.grid import occupancy as j_occ
from ngp_tpu.utils.config import NGPConfig as JCfg
from ngp_tpu_torch.grid import occupancy as t_occ
from ngp_tpu_torch.utils.config import NGPConfig as TCfg

torch.set_num_threads(2)


def _cfgs(doc):
    return JCfg.from_json(doc).sampler, TCfg.from_json(doc).sampler


def test_pcg4d_bit_exact():
    rng = np.random.default_rng(0)
    v = rng.integers(0, 2**32, (4096, 4), dtype=np.uint64).astype(np.uint32)
    v[:4] = [[0, 0, 0, 0], [2**32 - 1] * 4, [1, 2, 3, 4], [0x9E3779B9, 7, 0, 2**31]]
    want = [np.asarray(h) for h in j_occ._pcg4d(jnp.asarray(v))]
    got = t_occ.pcg4d(*(torch.from_numpy(v[:, k].astype(np.int64)) for k in range(4)))
    for w, g in zip(want, got, strict=True):
        np.testing.assert_array_equal(g.numpy(), w.astype(np.int64))


@pytest.mark.parametrize("n_uniform,n_nonuniform,step", [(5000, 0, 0), (3000, 3000, 300), (64, 4000, 2**31 + 5)])
def test_sample_grid_positions_exact(n_uniform, n_nonuniform, step):
    jc, tc = _cfgs({"samlper": {"grid_size": 32}})
    rng = np.random.default_rng(step % 1000)
    dens = np.where(rng.random(jc.n_total_elements) < 0.3, rng.uniform(0, 0.05, jc.n_total_elements), -1.0)
    dens = dens.astype(np.float32)
    key = jax.random.PRNGKey(step % 97)
    salts = np.asarray(jax.random.bits(key, (2,), jnp.uint32))
    j_pos, j_idx = j_occ.sample_grid_positions(jc, jnp.asarray(dens), key, n_uniform, n_nonuniform, jnp.uint32(step))
    t_pos, t_idx = t_occ.sample_grid_positions(tc, torch.from_numpy(dens), salts.tolist(), n_uniform, n_nonuniform, step)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(t_pos.numpy(), np.asarray(j_pos))


def test_splat_density_ema_exact():
    jc, tc = _cfgs({"samlper": {"grid_size": 16}})
    rng = np.random.default_rng(3)
    n = jc.n_total_elements
    prev = np.where(rng.random(n) < 0.1, -1.0, rng.uniform(0, 0.02, n)).astype(np.float32)
    idx = rng.integers(0, n, 3 * n)
    dens = rng.exponential(2.0, 3 * n).astype(np.float32)
    js = j_occ.splat_density_ema(jc, j_occ.create_grid_state(jc)._replace(density=jnp.asarray(prev)), jnp.asarray(idx), jnp.asarray(dens))
    ts = t_occ.splat_density_ema(tc, t_occ.create_grid_state(tc)._replace(density=torch.from_numpy(prev)), torch.from_numpy(idx), torch.from_numpy(dens))
    np.testing.assert_array_equal(ts.density.numpy(), np.asarray(js.density))
    assert ts.step == 1


@pytest.mark.parametrize("aabb_scale", [1, 4])
def test_mark_untrained_grid_exact(aabb_scale):
    jc, tc = _cfgs({"samlper": {"grid_size": 32, "aabb_scale": aabb_scale}})
    rng = np.random.default_rng(aabb_scale)
    xforms = []
    for _ in range(7):
        eye = rng.normal(size=3)
        eye = 0.5 + 1.3 * eye / np.linalg.norm(eye)
        fwd = (0.5 - eye) / np.linalg.norm(0.5 - eye)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        up = np.cross(fwd, right)
        xforms.append(np.stack([right, up, fwd, eye], axis=1))
    xforms = np.asarray(xforms, np.float32)
    want = np.asarray(j_occ.mark_untrained_grid(jc, (64, 48), (70.0, 70.0), xforms))
    got = t_occ.mark_untrained_grid(tc, (64, 48), (70.0, 70.0), torch.from_numpy(xforms)).numpy()
    assert 0 < (want == 0).mean() < 1
    np.testing.assert_array_equal(got, want)
