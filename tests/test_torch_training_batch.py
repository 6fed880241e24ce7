"""Port parity: build_layout / pad_layout and generate_training_batch against
ngp_tpu's (called with occ_aabb=None, s_short=0, n_long=0, n_seg_cap=0, the
port's single-bucket full-lattice march), exactly, with JAX's salts injected."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_tpu.grid import occupancy as j_occ
from ngp_tpu.ops import layout as j_lay
from ngp_tpu.sampling.lattice import n_lattice_points as j_nlat
from ngp_tpu.sampling.training import generate_training_batch as j_gen
from ngp_tpu.utils.aabb import AABB as JAABB
from ngp_tpu.utils.config import NGPConfig as JCfg
from ngp_tpu_torch.data.synthetic import look_at_pose
from ngp_tpu_torch.grid import occupancy as t_occ
from ngp_tpu_torch.ops import layout as t_lay
from ngp_tpu_torch.sampling.training import generate_training_batch as t_gen
from ngp_tpu_torch.utils.aabb import AABB as TAABB
from ngp_tpu_torch.utils.camera import opengl_to_opencv
from ngp_tpu_torch.utils.config import NGPConfig as TCfg

torch.set_num_threads(2)

TINY_SAMPLER = {"aabb_scale": 1, "grid_size": 32, "maximum_marching_steps": 256}


def test_layout_matches_jax():
    rng = np.random.default_rng(0)
    R, C, S = 300, 2000, 24
    counts = rng.integers(0, 40, R)
    counts[rng.random(R) < 0.2] = 0
    counts = np.minimum(counts, S)
    valid = counts > 0
    res = np.where(valid, counts, 0)
    base = np.cumsum(res) - res
    valid &= base + res <= C
    jl = j_lay.build_layout(jnp.asarray(base, jnp.int32), jnp.asarray(counts, jnp.int32), jnp.asarray(valid), C, S)
    tl = t_lay.build_layout(torch.from_numpy(base), torch.from_numpy(counts), torch.from_numpy(valid), C, S)
    for name in ("counts", "ray_ids", "pos_in_ray", "flat_valid", "pad_valid"):
        np.testing.assert_array_equal(getattr(tl, name).numpy(), np.asarray(getattr(jl, name)), err_msg=name)

    flat = rng.normal(size=(C, 4)).astype(np.float32)
    g = rng.normal(size=(R, S, 4)).astype(np.float32)
    j_val, j_vjp = jax.vjp(lambda f: j_lay.pad_layout(jl, f), jnp.asarray(flat))
    tf = torch.from_numpy(flat).requires_grad_(True)
    t_val = t_lay.pad_layout(tl, tf)
    (t_grad,) = torch.autograd.grad(t_val, tf, torch.from_numpy(g))
    np.testing.assert_array_equal(t_val.detach().numpy(), np.asarray(j_val))
    np.testing.assert_array_equal(t_grad.numpy(), np.asarray(j_vjp(jnp.asarray(g))[0]))
    np.testing.assert_array_equal(
        t_lay.flat_layout(tl, torch.from_numpy(g)).numpy(), np.asarray(j_lay.flat_layout(jl, jnp.asarray(g)))
    )


def _scene(n_images=5, h=24, w=32, seed=0):
    rng = np.random.default_rng(seed)
    poses = []
    for k in range(n_images):
        phi = 2.4 * k
        eye = 4.0 * np.array([np.cos(phi) * 0.8, np.sin(phi) * 0.8, 0.6])
        poses.append(look_at_pose(eye))
    xforms = opengl_to_opencv(np.stack(poses), 0.33, [0.5, 0.5, 0.5]).numpy()
    images = rng.uniform(0, 1, (n_images, h, w, 4)).astype(np.float16)
    return images, xforms, (40.0, 40.0)


def _density(cfg, seed):
    g = cfg.grid_size
    rng = np.random.default_rng(seed)
    ax = (np.arange(g) + 0.5) / g
    z, y, x = np.meshgrid(ax, ax, ax, indexing="ij")
    dens = np.zeros((cfg.n_cascades, g, g, g), np.float32)
    for _ in range(3):
        c = rng.uniform(0.35, 0.65, 3)
        dens[0] += np.exp(-(((x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2) / 0.01)).astype(np.float32)
    return dens.reshape(-1)


@pytest.mark.parametrize(
    "n_rays,shift,capacity,s_pad,cone",
    [(512, 0, 1 << 14, 256, 0.0), (1024, 2**32 - 100, 6000, 32, 0.0), (256, 77, 1 << 13, 64, 0.01)],
)
def test_generate_training_batch_exact(n_rays, shift, capacity, s_pad, cone):
    doc = {"samlper": {**TINY_SAMPLER, "cone_angle_constant": cone}}
    jc, tc = JCfg.from_json(doc).sampler, TCfg.from_json(doc).sampler
    dens = _density(jc, n_rays)
    jg = j_occ.update_occupancy(jc, j_occ.create_grid_state(jc)._replace(density=jnp.asarray(dens)))
    tg = t_occ.update_occupancy(tc, t_occ.create_grid_state(tc)._replace(density=torch.from_numpy(dens)))
    images, xforms, focal = _scene(seed=n_rays)
    key = jax.random.PRNGKey(n_rays + 1)
    salts = np.asarray(jax.random.bits(key, (2,), jnp.uint32)).tolist()

    jb = j_gen(
        jc, JAABB.scene(1), jnp.asarray(images), jnp.asarray(xforms), focal, (0.5, 0.5), jg.occupancy, key,
        n_rays, jnp.uint32(shift), capacity, j_nlat(jc), s_pad,
    )
    tb = t_gen(
        tc, TAABB.scene(1), torch.from_numpy(images), torch.from_numpy(xforms), focal, (0.5, 0.5), tg.occupancy,
        salts, n_rays, shift, capacity, s_pad,
    )
    assert int(tb.n_samples) == int(jb.n_samples) > 0
    assert int(tb.max_ray_count) == int(jb.max_ray_count)
    np.testing.assert_array_equal(tb.rays_d.numpy(), np.asarray(jb.rays_d))
    np.testing.assert_array_equal(tb.rays_o.numpy(), np.asarray(jb.rays_o))
    np.testing.assert_array_equal(tb.rgba.numpy(), np.asarray(jb.rgba))
    np.testing.assert_array_equal(tb.ray_valid.numpy(), np.asarray(jb.ray_valid))
    for name in ("counts", "ray_ids", "pos_in_ray", "flat_valid", "pad_valid"):
        np.testing.assert_array_equal(getattr(tb.layout, name).numpy(), np.asarray(getattr(jb.layout, name)), err_msg=name)
    if cone:
        # the cone lattice's closed form (exp/log) rounds differently inside
        # XLA's fusion: an ulp in t, never a different sample (layout above)
        np.testing.assert_allclose(tb.pos.numpy(), np.asarray(jb.pos), rtol=0, atol=3e-7)
    else:
        np.testing.assert_array_equal(tb.pos.numpy(), np.asarray(jb.pos))
    np.testing.assert_array_equal(tb.dirs.numpy(), np.asarray(jb.dirs))
    if cone:
        np.testing.assert_allclose(tb.dt_pad.numpy(), np.asarray(jb.dt_pad), rtol=1e-6)
    assert int(tb.layout.counts.sum()) <= capacity
    if capacity < int(jb.n_samples):  # whole rays dropped at the budget
        assert int(tb.layout.flat_valid.sum()) < int(jb.n_samples)
