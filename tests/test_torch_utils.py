"""Port parity: config, qmc (bit-exact), aabb, color and camera vs ngp_tpu."""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_tpu.utils import aabb as j_aabb
from ngp_tpu.utils import camera as j_camera
from ngp_tpu.utils import color as j_color
from ngp_tpu.utils import config as j_config
from ngp_tpu.utils import qmc as j_qmc
from ngp_tpu_torch.utils import aabb as t_aabb
from ngp_tpu_torch.utils import camera as t_camera
from ngp_tpu_torch.utils import color as t_color
from ngp_tpu_torch.utils import config as t_config
from ngp_tpu_torch.utils import qmc as t_qmc

torch.set_num_threads(2)

BASE_JSON = Path(__file__).resolve().parent.parent / "experiment" / "nerf_synthetic" / "config" / "base.json"


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.compare}


@pytest.mark.parametrize("source", ["empty", "base_json", "samlper_override"])
def test_config_parses_equal(source):
    if source == "empty":
        doc = {}
    elif source == "base_json":
        doc = j_config.load_commented_json(BASE_JSON)
        assert doc == t_config.load_commented_json(BASE_JSON)
    else:
        doc = {"samlper": {"aabb_scale": 4, "grid_size": 64}, "render": {"transmittance_threshold": 1e-3}}
    a, b = j_config.NGPConfig.from_json(doc), t_config.NGPConfig.from_json(doc)
    # same values, section by section (the classes are distinct types)
    for name in ("sampler", "network", "render", "optimizer", "envmap"):
        assert dataclasses.asdict(getattr(a, name)) == dataclasses.asdict(getattr(b, name)), name
    assert a.loss == b.loss
    assert a.sampler.n_cascades == b.sampler.n_cascades
    assert a.sampler.min_cone_stepsize == b.sampler.min_cone_stepsize
    assert a.network.encoding.scale == b.network.encoding.scale


def _u32(a):
    return np.asarray(a, np.uint32)


@pytest.mark.parametrize("dim", [0, 1])
def test_qmc_bit_exact(dim):
    rng = np.random.default_rng(0)
    idx = np.concatenate([np.arange(64), rng.integers(0, 2**32, 192, dtype=np.uint64)]).astype(np.uint32)
    seeds = np.concatenate([[0, 1, 0xDEADBEEF, 0xFFFFFFFF], rng.integers(0, 2**32, 252, dtype=np.uint64)]).astype(
        np.uint32
    )
    j = np.asarray(j_qmc.sobol(jnp.asarray(idx), dim))
    t = t_qmc.sobol(t_qmc._u32(idx), dim).numpy()
    np.testing.assert_array_equal(t, j.astype(np.int64))
    j = np.asarray(j_qmc.nested_uniform_scramble(jnp.asarray(idx), jnp.asarray(seeds)))
    t = t_qmc.nested_uniform_scramble(t_qmc._u32(idx), t_qmc._u32(seeds)).numpy()
    np.testing.assert_array_equal(t, j.astype(np.int64))
    for spp in (0, 1, 7, 1000):
        j = np.asarray(j_qmc.ld_random_val(jnp.uint32(spp), jnp.asarray(seeds), dim))
        t = t_qmc.ld_random_val(spp, seeds, dim).numpy()
        np.testing.assert_array_equal(t.view(np.uint32), j.view(np.uint32))
    j = np.asarray(j_qmc.ld_random_val_2d(jnp.asarray(idx), jnp.asarray(seeds)))
    t = t_qmc.ld_random_val_2d(idx, seeds).numpy()
    np.testing.assert_array_equal(t.view(np.uint32), j.view(np.uint32))


def test_qmc_pixel_offset_and_top_value_bit_exact():
    for spp in (0, 1, 2, 3, 8, 255):
        j = np.asarray(j_qmc.ld_random_pixel_offset(spp))
        t = t_qmc.ld_random_pixel_offset(spp).numpy()
        np.testing.assert_array_equal(t.view(np.uint32), j.view(np.uint32))
    np.testing.assert_array_equal(t_qmc.ld_random_pixel_offset(0).numpy(), [0.5, 0.5])
    # uint32 -> float32 rounds to nearest: 0xFFFFFFFF becomes exactly 1.0
    top = t_qmc._to_unit(torch.tensor([0xFFFFFFFF, 0xFFFFFF7F, 0x80000000], dtype=torch.int64)).numpy()
    ref = (jnp.asarray(_u32([0xFFFFFFFF, 0xFFFFFF7F, 0x80000000])).astype(jnp.float32) * j_qmc._U32_SCALE)
    np.testing.assert_array_equal(top.view(np.uint32), np.asarray(ref).view(np.uint32))
    assert top[0] == 1.0


def test_aabb_matches():
    rng = np.random.default_rng(1)
    o = rng.uniform(-1.5, 2.5, (512, 3)).astype(np.float32)
    d = rng.normal(size=(512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pos = np.concatenate([o, [[0, 0, 0], [1, 1, 1], [1, 1.0000001, 0.5], [-1e-9, 0.5, 0.5]]]).astype(np.float32)
    for scale in (1, 4):
        a, b = j_aabb.AABB.scene(scale), t_aabb.AABB.scene(scale)
        assert a.lo == b.lo and a.hi == b.hi
        np.testing.assert_array_equal(b.contains(torch.from_numpy(pos)).numpy(), np.asarray(a.contains(pos)))
        np.testing.assert_allclose(
            b.relative_pos(torch.from_numpy(pos)).numpy(), np.asarray(a.relative_pos(pos)), rtol=0, atol=1e-7
        )
        for x, y in zip(b.ray_intersect(torch.from_numpy(o), torch.from_numpy(d)), a.ray_intersect(o, d)):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=2e-7, atol=1e-7)


def test_color_matches():
    x = np.linspace(-0.1, 1.5, 4001, dtype=np.float32)
    for tf, jf in [(t_color.srgb_to_linear, j_color.srgb_to_linear), (t_color.linear_to_srgb, j_color.linear_to_srgb)]:
        np.testing.assert_allclose(tf(torch.from_numpy(x)).numpy(), np.asarray(jf(x)), rtol=3e-7, atol=1e-8)


def test_camera_matches():
    rng = np.random.default_rng(2)
    pose = rng.normal(size=(5, 3, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        t_camera.opengl_to_opencv(pose, 0.33, [0.5, 0.5, 0.5]).numpy(),
        np.asarray(j_camera.opengl_to_opencv(pose, 0.33, [0.5, 0.5, 0.5])),
    )
    rad = np.linspace(0.2, 2.5, 17).astype(np.float32)
    np.testing.assert_allclose(
        t_camera.fov_to_focal_length(800, rad).numpy(), np.asarray(j_camera.fov_to_focal_length(800, rad)), rtol=3e-7
    )
    f = np.linspace(100, 2000, 17).astype(np.float32)
    np.testing.assert_allclose(
        t_camera.focal_length_to_fov(800, f).numpy(), np.asarray(j_camera.focal_length_to_fov(800, f)), rtol=3e-7
    )
