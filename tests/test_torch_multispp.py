"""Port parity for the protocol's spp-8 frame: the frame geometry (k0, span,
hit), the packed 3^3 words, the jitter-cover march and whole render(W, H, 8)
frames, Shade through the shared evaluations and Depth through the per-pass
points, against ngp_tpu on the same snapshot."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_tpu.grid.occupancy import packed_neighborhood as j_packed_neighborhood
from ngp_tpu.models.ngp import NGPModel as JModel
from ngp_tpu.render.renderer import Renderer as JRenderer
from ngp_tpu.render.renderer import _rays_slab_pass as j_rays_slab_pass
from ngp_tpu.sampling.lattice import count_samples as j_count_samples
from ngp_tpu.testbed import Testbed as JTestbed
from ngp_tpu.utils.aabb import AABB as JAABB
from ngp_tpu.utils.camera import opengl_to_opencv as j_opengl_to_opencv
from ngp_tpu.utils.config import NGPConfig as JCfg
from ngp_tpu_torch import Testbed as TTestbed
from ngp_tpu_torch.grid.occupancy import packed_neighborhood as t_packed_neighborhood
from ngp_tpu_torch.models.interop import params_from_numpy
from ngp_tpu_torch.models.ngp import NGPModel as TModel
from ngp_tpu_torch.render import renderer as t_renderer
from ngp_tpu_torch.render.march import SHARE_ROUND
from ngp_tpu_torch.sampling import lattice as t_lattice
from ngp_tpu_torch.utils.aabb import AABB as TAABB
from ngp_tpu_torch.utils.config import NGPConfig as TCfg

torch.set_num_threads(2)

W, H = 32, 24
SPP = 8
# the serving scene of tests/test_torch_render.py
CONFIG = {
    "samlper": {"grid_size": 32},
    "network": {
        "encoding": {"n_levels": 4, "log2_hashmap_size": 12, "base_resolution": 8, "desired_resolution": 64},
        "network": {"n_neurons": 32, "n_hidden_layers": 1},
        "rgb_network": {"n_neurons": 32, "n_hidden_layers": 2},
    },
}


def ring_pose(theta, radius=1.2, height=0.4):
    """OpenGL camera-to-world (3, 4) on a ring around the origin, looking at it."""
    pos = np.array([radius * np.cos(theta), radius * np.sin(theta), height])
    back = pos / np.linalg.norm(pos)
    right = np.cross([0.0, 0.0, 1.0], back)
    right /= np.linalg.norm(right)
    up = np.cross(back, right)
    return np.stack([right, up, back, pos], axis=1).astype(np.float32)


def _march_setup():
    """A seeded cascaded occupancy grid (blocks and sparse cells) and 256 rays,
    a quarter of them starting outside the box."""
    scfg = JCfg.from_json({}).sampler
    rng = np.random.default_rng(7)
    g = scfg.grid_size
    occ0 = rng.random((g, g, g)) < 0.01
    for _ in range(4):
        c = rng.integers(8, g - 8, 3)
        occ0[c[0] - 4 : c[0] + 4, c[1] - 4 : c[1] + 4, c[2] - 4 : c[2] + 4] = True
    occ = np.stack([occ0, rng.random((g, g, g)) < 0.002])
    R = 256
    o = np.full((R, 3), 0.5, np.float32) + rng.uniform(-0.45, 0.45, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o[: R // 4] = o[: R // 4] - d[: R // 4] * 1.5
    startt = rng.uniform(0.0, scfg.min_cone_stepsize, R).astype(np.float32)
    return occ, o, d, startt


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """A JAX-written snapshot: seeded init with the density channel pushed up
    (rays terminate early) and three Gaussian blobs in the density grid."""
    tb = JTestbed()
    tb.load_model_config_dict(CONFIG)
    st = tb._state
    p = st.params
    w_last = p["density_mlp"][-1]
    p = dict(p, density_mlp=[*p["density_mlp"][:-1], w_last.at[:, 0].set(jnp.abs(w_last[:, 0]) * 4.0 + 0.5)])
    g = tb.config.sampler.grid_size
    rng = np.random.default_rng(5)
    ax = (np.arange(g) + 0.5) / g
    z, y, x = np.meshgrid(ax, ax, ax, indexing="ij")
    dens = np.zeros((tb.config.sampler.n_cascades, g, g, g), np.float32)
    for _ in range(3):
        c = rng.uniform(0.3, 0.7, 3)
        dens[0] += np.exp(-((x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2) / 0.01).astype(np.float32)
    tb._state = st._replace(params=p, ema_params=p, grid=st.grid._replace(density=jnp.asarray(dens.reshape(-1))))
    path = tmp_path_factory.mktemp("snap") / "blob.msgpack"
    tb.save_snapshot(str(path))
    return str(path)


@pytest.mark.parametrize("w,h,theta,radius", [(32, 24, 2.1, 1.2), (61, 47, 4.4, 0.9), (80, 80, 0.7, 1.6)])
def test_frame_geometry_equals_jax(w, h, theta, radius):
    """k0, span and hit of every ray equal _rays_slab_pass's exactly."""
    cfg = JCfg.from_json({}).sampler
    cam = np.array(j_opengl_to_opencv(ring_pose(theta, radius=radius), 0.33, [0.5, 0.5, 0.5]))
    g = cfg.grid_size
    rng = np.random.default_rng(int(theta * 10))
    lo = rng.uniform(0.2, 0.45, 3)
    box = (np.floor(np.stack([lo, lo + rng.uniform(0.1, 0.4, 3)]) * g) / g).astype(np.float32)
    f, pp, off = (h * 1.1, h * 1.1), (0.5, 0.5), (0.5, 0.5)
    n_lat = t_lattice.n_lattice_points(TCfg.from_json({}).sampler)
    *_, pack = j_rays_slab_pass(
        jnp.asarray(cam), jnp.asarray(np.float32(f)), jnp.asarray(np.float32(pp)), jnp.asarray(np.float32(off)),
        jnp.asarray(box), w=w, h=h, aabb_scale=1, dt=cfg.min_cone_stepsize, n_lat=n_lat, grid_size=g,
    )
    pack = np.asarray(pack)
    o, d = t_renderer.camera_rays(torch.from_numpy(cam), w, h, f, pp, off)
    hit, k0, span = t_renderer.frame_geometry(TCfg.from_json({}).sampler, o, d, torch.from_numpy(box))
    np.testing.assert_array_equal(hit.numpy(), pack[0] > 0.5)
    np.testing.assert_array_equal(k0.numpy(), pack[1].astype(np.int64))
    np.testing.assert_array_equal(span.numpy(), pack[2])
    assert 0 < hit.sum() < w * h and k0.max() > 0


@pytest.mark.parametrize("density", [0.01, 0.3])
def test_packed_neighborhood_equals_jax(density):
    cfg = JCfg.from_json({}).sampler
    rng = np.random.default_rng(5)
    occ = rng.random((cfg.n_cascades,) + (cfg.grid_size,) * 3) < density
    ref = np.asarray(j_packed_neighborhood(cfg, jnp.asarray(occ))).astype(np.int64)
    got = t_packed_neighborhood(TCfg.from_json({}).sampler, torch.from_numpy(occ)).numpy().astype(np.int64)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("jitter_cover", [False, True])
def test_cover_mask_equals_jax(jitter_cover):
    """The march at ordinals k0 + j through the packed words, exact and in
    jitter-cover mode: counts and masks equal ngp_tpu's count_samples."""
    occ, o, d, startt = _march_setup()
    jc, tc = JCfg.from_json({}).sampler, TCfg.from_json({}).sampler
    k0 = np.random.default_rng(1).integers(0, 300, o.shape[0]).astype(np.int32)
    n_window = t_lattice.n_lattice_points(tc)
    j_packed = j_packed_neighborhood(jc, jnp.asarray(occ))
    ref_counts, ref_masks = j_count_samples(
        jc, JAABB.scene(1.0), jnp.asarray(occ), jnp.asarray(o), jnp.asarray(d), jnp.asarray(startt), n_window,
        return_masks=True, k0=jnp.asarray(k0), packed=j_packed, jitter_cover=jitter_cover,
    )
    counts, masks = t_lattice.count_samples(
        tc, TAABB.scene(1.0), torch.from_numpy(occ), torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(startt),
        return_masks=True, k0=torch.from_numpy(k0), n_window=n_window,
        packed=t_packed_neighborhood(tc, torch.from_numpy(occ)), jitter_cover=jitter_cover,
    )
    np.testing.assert_array_equal(counts.numpy(), np.asarray(ref_counts))
    np.testing.assert_array_equal(masks.numpy(), np.asarray(ref_masks))
    assert np.asarray(ref_counts).sum() > 100


def test_can_batch_spp_equals_jax():
    for doc in ({}, {"samlper": {"snap_to_pixel_centers_in_rendering": False}}, {"samlper": {"grid_size": 256}},
                {"samlper": {"cone_angle_constant": 0.004}}, {"samlper": {"grid_size": 32}}):
        j = JRenderer(model=None, config=JCfg.from_json(doc)).can_batch_spp()
        t = t_renderer.Renderer(model=None, config=TCfg.from_json(doc)).can_batch_spp()
        assert j == t, doc


# Tolerances on linear RGBA (the accumulated buffer) and on the tonemapped
# image, as the spp-1 rows of tests/test_torch_render.py: both packages take
# the same cover points, lerp partners and per-pass samples, so only fp32
# summation order differs (the composite's cumsum, the shared lerp's colour
# sum taken as two (P, CHUNK) x (CHUNK, 3) products). Measured max 3.9e-7
# (Shade) and 5.4e-7 (Depth), allowed 1e-5 max and 1e-6 mean.
@pytest.mark.parametrize("mode,color_space", [("Shade", "Linear"), ("Shade", "SRGB"), ("Depth", "Linear"), ("Depth", "SRGB")])
def test_spp8_render_matches_jax(snapshot, mode, color_space):
    out = []
    for tb in (JTestbed(), TTestbed(device="cpu")):
        tb.load_snapshot(snapshot)
        tb.rendering_buffer.render_mode = mode
        tb.color_space = color_space
        tb.set_nerf_camera_matrix(ring_pose(2.1))
        img = tb.render(W, H, spp=SPP, to_srgb=False)
        out.append((np.asarray(img), np.asarray(tb._accum), tb))
    (j_img, j_acc, _), (t_img, t_acc, tt) = out
    assert tt._spp == SPP
    hit = j_acc[..., 3] > 0.001
    assert 0.1 < hit.mean() < 0.95
    for a, b in ((t_acc, j_acc), (t_img, j_img)):
        err = np.abs(a - b)
        assert err.max() <= 1e-5, f"max abs {err.max()}"
        assert err.mean() <= 1e-6, f"mean abs {err.mean()}"
    # Shade evaluates the network once per cover point (a superset of one
    # pass's samples), Depth once a pass
    samples = tt._renderer.last_frame_samples
    tt.render(W, H, spp=1, to_srgb=False)
    one_pass = tt._renderer.last_frame_samples
    assert (one_pass <= samples < 1.5 * one_pass) if mode == "Shade" else (samples > 6 * one_pass)


@pytest.fixture(scope="module")
def rough():
    """tests/test_spp_share.py:25-53: a small model with rough sigma and rgb
    fields (hash features scaled up) on a seeded occupancy grid, in both
    packages."""
    doc = {
        "samlper": {"aabb_scale": 1, "grid_size": 64, "maximum_marching_steps": 512},
        "network": {
            "encoding": {"n_levels": 4, "log2_hashmap_size": 12, "base_resolution": 8, "desired_resolution": 64},
            "network": {"n_neurons": 16, "n_hidden_layers": 1},
            "dir_encoding": {"degree": 2},
            "rgb_network": {"n_neurons": 16, "n_hidden_layers": 1},
        },
    }
    config = JCfg.from_json(doc)
    model = JModel.create(config.network)
    params = model.init(jax.random.PRNGKey(0))
    params["hash_table"] = params["hash_table"] * 600.0
    w_last = params["density_mlp"][-1]
    g = config.sampler.grid_size
    rng = np.random.default_rng(11)
    occ0 = rng.random((g, g, g)) < 0.05
    occ0[10:20, 10:20, 10:20] = True
    occ = np.stack([occ0] * config.sampler.n_cascades)
    return doc, config, model, params, w_last, occ


def _rough_frames(rough, share, dense=False):
    doc, config, model, params, w_last, occ = rough
    params = dict(params)
    if dense:
        # faint density everywhere: rays run past 256 samples, across the
        # lerp's round boundaries
        occ = np.ones_like(occ)
        params["density_mlp"] = [*params["density_mlp"][:-1], w_last.at[:, 0].set(jnp.abs(w_last[:, 0]) * 0.05 - 0.5)]
    else:
        params["density_mlp"] = [*params["density_mlp"][:-1], w_last.at[:, 0].set(jnp.abs(w_last[:, 0]) + 0.3)]
    cam = np.zeros((3, 4), np.float32)
    cam[:, 0], cam[:, 1], cam[:, 2], cam[:, 3] = [1, 0, 0], [0, 1, 0], [0, 0, 1], [0.5, 0.5, -0.6]
    res, fl = (32, 32), (40.0, 40.0)
    ref = JRenderer(model=model, config=config, share_spp_evals=share).render_frame(
        params, jnp.asarray(occ), cam, res, fl, (0.5, 0.5), 0, n_spp=4
    )
    tcfg = TCfg.from_json(doc)
    spec = TModel(tcfg.network, device="cpu").grid_spec
    tmodel = TModel(tcfg.network, device="cpu").load_params(params_from_numpy(jax.tree_util.tree_map(np.asarray, params), spec))
    r = t_renderer.Renderer(model=tmodel, config=tcfg, share_spp_evals=share)
    got = r.render_frame(torch.from_numpy(occ), cam, res, fl, (0.5, 0.5), 0, n_spp=4)
    return np.asarray(ref), got.numpy(), r


@pytest.mark.parametrize("share", [True, False])
def test_rough_field_matches_jax(rough, share):
    """The stress of tests/test_spp_share.py: the shared lerp and the per-pass
    evaluations on rough fields equal ngp_tpu's within fp32 summation order
    (measured 3.0e-7 and 2.2e-7; allowed 1e-5 max, 1e-7 mean)."""
    ref, got, r = _rough_frames(rough, share)
    err = np.abs(got - ref)
    assert np.isfinite(got).all() and ref[..., 3].max() > 0.05
    assert err.max() <= 1e-5 and err.mean() <= 1e-7, (err.max(), err.mean())


def test_shared_lerp_round_boundary_matches_jax(rough):
    """Rays longer than SHARE_ROUND samples: the lerp takes the point itself
    at each ngp_tpu round's last sample. Measured 4.2e-7 max against ngp_tpu
    (1.3e-5 without the boundary); allowed 2e-6."""
    ref, got, r = _rough_frames(rough, True, dense=True)
    err = np.abs(got - ref)
    assert r.last_frame_samples > SHARE_ROUND * 32 * 32 // 2
    assert err.max() <= 2e-6, err.max()
