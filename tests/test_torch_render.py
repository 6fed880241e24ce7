"""Port parity for the serving path: the lattice march (exact sample counts)
and whole frames rendered from one ngp_tpu snapshot by both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_tpu.render.renderer import _rays_slab_pass as j_rays_slab_pass
from ngp_tpu.sampling.lattice import count_samples as j_count_samples
from ngp_tpu.sampling.lattice import n_lattice_points as j_n_lattice_points
from ngp_tpu.testbed import Testbed as JTestbed
from ngp_tpu.utils.aabb import AABB as JAABB
from ngp_tpu.utils.config import NGPConfig as JCfg
from ngp_tpu_torch import Testbed as TTestbed
from ngp_tpu_torch.render.buffer import accumulate
from ngp_tpu_torch.render.renderer import camera_rays as t_camera_rays
from ngp_tpu_torch.render.renderer import ray_start as t_ray_start_alive
from ngp_tpu_torch.sampling import lattice as t_lattice
from ngp_tpu_torch.utils.aabb import AABB as TAABB
from ngp_tpu_torch.utils.config import NGPConfig as TCfg

torch.set_num_threads(2)


def _march_setup():
    """The seeded occupancy and rays of tests/test_render_segments.py:26-56."""
    scfg = JCfg.from_json({}).sampler
    rng = np.random.default_rng(7)
    g = scfg.grid_size
    occ0 = rng.random((g, g, g)) < 0.01
    for _ in range(4):
        c = rng.integers(8, g - 8, 3)
        occ0[c[0] - 4 : c[0] + 4, c[1] - 4 : c[1] + 4, c[2] - 4 : c[2] + 4] = True
    levels = [occ0]
    for _ in range(1, scfg.n_cascades):
        fine = levels[-1]
        pooled2 = fine.reshape(g // 2, 2, g // 2, 2, g // 2, 2).any(axis=(1, 3, 5))
        nxt = rng.random((g, g, g)) < 0.002
        q = g // 4
        nxt[q : 3 * q, q : 3 * q, q : 3 * q] |= pooled2
        levels.append(nxt)
    occ = np.stack(levels)
    R = 256
    o = np.full((R, 3), 0.5, np.float32) + rng.uniform(-0.45, 0.45, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o[: R // 4] = o[: R // 4] - d[: R // 4] * 1.5  # some rays start outside the box
    startt = rng.uniform(0.0, scfg.min_cone_stepsize, R).astype(np.float32)
    return occ, o, d, startt


@pytest.mark.parametrize(
    "case,doc",
    [
        ("seeded", {}),
        ("dense", {}),
        ("cone_stepping", {"samlper": {"cone_angle_constant": 0.004}}),
        ("aabb_scale_2", {"samlper": {"cone_angle_constant": 0.004, "aabb_scale": 2}}),
    ],
)
def test_march_counts_equal(case, doc):
    """Per-ray occupied-sample counts equal JAX count_samples(k0=0) exactly;
    the dense grid makes rays cross several chunks and the whole box, the
    cone-stepping cases take the geometric lattice and per-point mips."""
    occ, o, d, startt = _march_setup()
    if case == "dense":
        occ = np.ones_like(occ)
    jc, tc = JCfg.from_json(doc).sampler, TCfg.from_json(doc).sampler
    n_lat = j_n_lattice_points(jc)
    assert t_lattice.n_lattice_points(tc) == n_lat
    ref = j_count_samples(
        jc, JAABB.scene(jc.aabb_scale), jnp.asarray(occ), jnp.asarray(o), jnp.asarray(d), jnp.asarray(startt),
        n_lat, k0=jnp.zeros((o.shape[0],), jnp.int32),
    )
    got = t_lattice.count_samples(
        tc, TAABB.scene(tc.aabb_scale), torch.from_numpy(occ), torch.from_numpy(o), torch.from_numpy(d),
        torch.from_numpy(startt),
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    ref = np.asarray(ref)
    assert ref.max() > (t_lattice.CHUNK if case == "dense" else 0) and (ref == 0).any()


# ----------------------------------------------------------------- serving

CONFIG = {
    "samlper": {"grid_size": 32},
    "network": {
        "encoding": {"n_levels": 4, "log2_hashmap_size": 12, "base_resolution": 8, "desired_resolution": 64},
        "network": {"n_neurons": 32, "n_hidden_layers": 1},
        "rgb_network": {"n_neurons": 32, "n_hidden_layers": 2},
    },
}
W, H = 32, 24


def _blob_grid(cfg, seed):
    g = cfg.grid_size
    rng = np.random.default_rng(seed)
    ax = (np.arange(g) + 0.5) / g
    z, y, x = np.meshgrid(ax, ax, ax, indexing="ij")
    dens = np.zeros((cfg.n_cascades, g, g, g), np.float32)
    for _ in range(3):
        c = rng.uniform(0.3, 0.7, 3)
        dens[0] += np.exp(-((x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2) / 0.01).astype(np.float32)
    return dens.reshape(-1)


def ring_pose(theta, radius=1.2, height=0.4):
    """OpenGL camera-to-world (3, 4) on a ring around the origin, looking at it."""
    pos = np.array([radius * np.cos(theta), radius * np.sin(theta), height])
    back = pos / np.linalg.norm(pos)
    right = np.cross([0.0, 0.0, 1.0], back)
    right /= np.linalg.norm(right)
    up = np.cross(back, right)
    return np.stack([right, up, back, pos], axis=1).astype(np.float32)


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """A JAX-written snapshot: seeded init with the density channel pushed up
    (so rays terminate early) and a seeded blob density grid."""
    tb = JTestbed()
    tb.load_model_config_dict(CONFIG)
    st = tb._state
    p = st.params
    w_last = p["density_mlp"][-1]
    p = dict(p, density_mlp=[*p["density_mlp"][:-1], w_last.at[:, 0].set(jnp.abs(w_last[:, 0]) * 4.0 + 0.5)])
    grid = st.grid._replace(density=jnp.asarray(_blob_grid(tb.config.sampler, 5)))
    tb._state = st._replace(params=p, ema_params=p, grid=grid)
    path = tmp_path_factory.mktemp("snap") / "blob.msgpack"
    tb.save_snapshot(str(path))
    return str(path)


def _render_both(path, mode, spp, theta):
    jt = JTestbed()
    jt.load_snapshot(path)
    jt._renderer.share_spp_evals = False  # exact per-pass network evaluations
    tt = TTestbed(device="cpu")
    tt.load_snapshot(path)
    out = []
    for tb in (jt, tt):
        tb.rendering_buffer.render_mode = mode
        tb.set_nerf_camera_matrix(ring_pose(theta))
        img = tb.render(W, H, spp=spp, to_srgb=False)
        out.append((np.asarray(img), np.asarray(tb._accum)))
    return out, tt


# Tolerances on linear RGBA, set from the errors measured on this scene. At
# spp 1 both packages take the same samples on the same rays (the port
# computes lattice points with XLA's fused multiply-adds), so only fp32
# summation order differs (camera-ray matmul, composite cumsum, MLP dots):
# measured max 6.6e-7, allowed 1e-5. At spp 2 ngp_tpu marches once with a
# conservative jitter-cover mask and composites a few extra lattice points in
# cells next to occupied ones, where the port tests each pass's points
# exactly: measured max 5.9e-3 and mean 1.0e-4, allowed 2e-2 and 1e-3.
# AO, Distance, Stepsize and Cost take the same samples as Shade (Cost's
# counts are equal, so its frame is too). Normals differentiates the
# density head through the bf16 MLP and the hash encoding's trilinear
# derivative in both packages, in another order of fp32 sums: measured max
# 5.1e-6 and mean 5.7e-8, allowed 5e-5 and 1e-6. Theta 3.5 holds a pixel
# whose ray direction once differed from ngp_tpu's by an ulp (camera_rays).
@pytest.mark.parametrize(
    "mode,spp,theta,max_abs,mean_abs",
    [
        ("Shade", 1, 0.3, 1e-5, 1e-6),
        ("Shade", 1, 3.5, 1e-5, 1e-6),
        ("Shade", 2, 2.1, 2e-2, 1e-3),
        ("Depth", 1, 4.0, 1e-5, 1e-6),
        ("AO", 1, 0.7, 1e-5, 1e-6),
        ("Normals", 1, 1.3, 5e-5, 1e-6),
        ("Distance", 1, 2.8, 1e-5, 1e-6),
        ("Stepsize", 1, 3.2, 1e-5, 1e-6),
        ("Cost", 1, 5.0, 1e-5, 1e-6),
    ],
)
def test_snapshot_renders_match(snapshot, mode, spp, theta, max_abs, mean_abs):
    ((j_img, j_acc), (t_img, t_acc)), _ = _render_both(snapshot, mode, spp, theta)
    assert t_img.shape == j_img.shape == (H, W, 4)
    assert np.isfinite(t_acc).all()
    hit = j_acc[..., 3] > 0.001
    assert 0.1 < hit.mean() < 0.95, "the blobs should cover part of the frame"
    for a, b in ((t_acc, j_acc), (t_img, j_img)):
        err = np.abs(a - b)
        assert err.max() <= max_abs, f"max abs {err.max()}"
        assert err.mean() <= mean_abs, f"mean abs {err.mean()}"


@pytest.mark.parametrize("w,h,theta", [(32, 24, 3.5), (37, 53, 0.3), (100, 75, 5.0)])
def test_camera_rays_equal_jax_bitwise(w, h, theta):
    """The port's pixel-grid rays are ngp_tpu's (_rays_slab_pass) to the bit:
    XLA divides by the constant width as a product with its float32
    reciprocal, contracted with the principal-point subtraction."""
    cam = ring_pose(theta)
    f, pp, off = (h * 0.9, h * 1.1), (0.5, 0.47), (0.5, 0.5)
    o_j, d_j, *_ = j_rays_slab_pass(
        jnp.asarray(cam), jnp.asarray(np.float32(f)), jnp.asarray(np.float32(pp)), jnp.asarray(np.float32(off)),
        jnp.asarray(np.float32([[0, 0, 0], [1, 1, 1]])), w=w, h=h, aabb_scale=1, dt=0.01, n_lat=1024, grid_size=128,
    )
    o, d = t_camera_rays(torch.from_numpy(cam), w, h, f, pp, off)
    np.testing.assert_array_equal(o.numpy(), np.asarray(o_j))
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_j))


def test_ray_start_alive_equals_jax_on_grazing_rays():
    """The march-start test aabb.contains(o + d * t0) of ngp_tpu's
    _render_tile_impl, compiled by XLA with a fused multiply-add, on rays aimed
    at the box's edges: the port's alive mask is the same."""
    rng = np.random.default_rng(3)
    n = 4096
    tgt = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    a = rng.integers(0, 3, n)
    rows = np.arange(n)
    tgt[rows, a] = rng.choice([0.0, 1.0], n)
    tgt[rows, (a + 1) % 3] = rng.choice([0.0, 1.0], n)
    o = (tgt + rng.normal(size=(n, 3)) * 1.5).astype(np.float32)
    d = tgt - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    box = JAABB.scene(1.0)

    @jax.jit
    def j_alive(o, d):  # ngp_tpu/render/renderer.py:131-133
        tmin, _ = box.ray_intersect(o, d)
        t0 = jnp.maximum(tmin, 0.05) + 1e-6
        return box.contains(o + d * t0[:, None])

    ref = np.asarray(j_alive(jnp.asarray(o), jnp.asarray(d)))
    got = t_ray_start_alive(TAABB.scene(1.0), torch.from_numpy(o), torch.from_numpy(d))[1]
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0 < ref.sum() < n


def test_multi_pass_is_accumulate_of_passes(snapshot):
    """render(spp=2) in the port is exactly two render_frame passes averaged."""
    tt = TTestbed(device="cpu")
    tt.load_snapshot(snapshot)
    tt.set_nerf_camera_matrix(ring_pose(1.0))
    tt.render(W, H, spp=2, to_srgb=False)
    acc2 = tt._accum.clone()
    r = tt._renderer
    rb = tt.rendering_buffer
    frames = [
        r.render_frame(tt.grid.occupancy, rb.camera_matrix, (W, H), (H * 1.0, H * 1.0), rb.principal_point, s)
        for s in range(2)
    ]
    expect = accumulate(accumulate(torch.zeros_like(frames[0]), frames[0], 0), frames[1], 1)
    torch.testing.assert_close(acc2, expect, rtol=0, atol=0)
    assert not torch.equal(frames[0], frames[1])  # the passes jitter
