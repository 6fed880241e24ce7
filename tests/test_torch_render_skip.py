"""The renderer's empty-space skipping in the port: the spp-1 march over each
ray's kept coarse segments takes exactly the samples of the full march from
t0 (march_chunk from ordinal 0, kept here as the reference), the spp-8 cover
march with the coarse premask exactly the cover points of the march without
it, and batched frames in all seven modes equal ngp_tpu's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_tpu.testbed import Testbed as JTestbed
from ngp_tpu_torch import Testbed as TTestbed
from ngp_tpu_torch.grid.occupancy import occupied_aabb, packed_neighborhood
from ngp_tpu_torch.render import march as t_march
from ngp_tpu_torch.render import renderer as t_renderer
from ngp_tpu_torch.sampling import lattice as t_lattice
from ngp_tpu_torch.utils.aabb import AABB
from ngp_tpu_torch.utils.camera import opengl_to_opencv
from ngp_tpu_torch.utils.config import NGPConfig
from ngp_tpu_torch.utils.fma import fma
from ngp_tpu_torch.utils.qmc import ld_random_val

torch.set_num_threads(2)

W, H = 48, 40
FOCAL = (44.0, 44.0)


def ring_pose(theta, radius=1.2, height=0.4):
    """OpenGL camera-to-world (3, 4) on a ring around the origin, looking at it."""
    pos = np.array([radius * np.cos(theta), radius * np.sin(theta), height])
    back = pos / np.linalg.norm(pos)
    right = np.cross([0.0, 0.0, 1.0], back)
    right /= np.linalg.norm(right)
    up = np.cross(back, right)
    return np.stack([right, up, back, pos], axis=1).astype(np.float32)


def _grid(scfg, kind: str, seed: int = 7) -> torch.Tensor:
    """(n_cascades, G, G, G) bool: a few blocks and single cells in cascade
    0, some below 0.25 (where (pos - 0.5) + 0.5 rounds), each coarser
    cascade the pooled finer one in its central octant ("sparse"), or every
    cell occupied ("dense")."""
    g = scfg.grid_size
    if kind == "dense":
        return torch.ones((scfg.n_cascades, g, g, g), dtype=torch.bool)
    rng = np.random.default_rng(seed)
    occ0 = np.zeros((g, g, g), bool)
    for c in ((g // 8, g // 4, g // 2), *rng.integers(g // 4, 3 * g // 4 - 8, (2, 3))):
        occ0[c[0] : c[0] + 8, c[1] : c[1] + 8, c[2] : c[2] + 8] = True
    for c in rng.integers(g // 8, 3 * g // 4, (6, 3)):
        occ0[c[0], c[1], c[2]] = True
    levels = [occ0]
    for _ in range(1, scfg.n_cascades):
        pooled = levels[-1].reshape(g // 2, 2, g // 2, 2, g // 2, 2).any(axis=(1, 3, 5))
        nxt = np.zeros((g, g, g), bool)
        q = g // 4
        nxt[q : 3 * q, q : 3 * q, q : 3 * q] |= pooled
        levels.append(nxt)
    return torch.from_numpy(np.stack(levels))


def _camera(theta, radius=1.2):
    return opengl_to_opencv(ring_pose(theta, radius), 0.33, [0.5, 0.5, 0.5])


class _Recorder:
    """Wraps the marches and keeps (d, t, pos) of every point they mark as
    sampled (the lookahead segment aside), with the ordinal where the march
    reports it: the spp-8 frame's march_round, and the spp-1 pass's rounds
    in render/march.py, a launch of render_march_plain (its samples' rows,
    their t from the launch's segment_points) or a march_chunk round."""

    def __init__(self, monkeypatch):
        self.rows = []
        self.mp = monkeypatch
        for mod, name in ((t_renderer, "march_round"), (t_march, "march_chunk")):
            monkeypatch.setattr(mod, name, self._wrap(getattr(mod, name)))
        monkeypatch.setattr(t_march, "render_march_plain", self._launch(t_march.render_march_plain))

    def _wrap(self, fn):
        def run(cfg, aabb, occupancy, *args, **kw):
            out = fn(cfg, aabb, occupancy, *args, **kw)
            mask, t, pos = out[0][:, : t_lattice.CHUNK], out[1], out[2]
            d = args[5] if fn.__name__ == "march_round" else args[1]
            r, c = torch.nonzero(mask, as_tuple=True)
            idx = out[3][r, c] if fn.__name__ == "march_round" else None
            self.rows.append((d[r], t[r, c], pos[r, c], idx))
            return out

        run.__name__ = fn.__name__
        return run

    def _launch(self, fn):
        points = t_march.segment_points

        def run(cfg, occupancy, pooled, a, n_in, first, thresh):
            seen = []

            def tested(*args, **kw):
                seen.append(points(*args, **kw))
                return seen[-1]

            self.mp.setattr(t_march, "segment_points", tested)
            fn(cfg, occupancy, pooled, a, n_in, first, thresh)
            self.mp.setattr(t_march, "segment_points", points)
            n_rows = int(a.counts[1])
            if n_rows:
                flat = a.flat[:n_rows]
                row, col = flat // t_lattice.CHUNK, flat % t_lattice.CHUNK
                self.rows.append((a.d[a.list_out[row]], seen[0][2][row, col], a.pos[:n_rows].clone(), None))

        return run

    def table(self):
        d, t, pos = (torch.cat([r[k] for r in self.rows]) for k in range(3))
        return _sorted(torch.cat([d, t[:, None], pos], dim=1).numpy())


def _sorted(a: np.ndarray) -> np.ndarray:
    return a[np.lexsort(a.T[::-1])]


def _full_march(cfg, occ, o, d, startt, alive) -> np.ndarray:
    """The full march from t0 (the spp-1 frame before the premask): every
    alive ray from ordinal 0, CHUNK points a round, until it leaves the box
    or reaches the sample cap (no transmittance stop: the density is zero).
    Rows (d, t, pos) of its samples, sorted, and the lattice points it
    tested. It reads the grid as the renderer does: from packed words
    where packed_march_supported holds (ngp_tpu's spp-1 tile), else point
    by point."""
    scfg = cfg.sampler
    aabb = AABB.scene(scfg.aabb_scale)
    packed = packed_neighborhood(scfg, occ) if t_lattice.packed_march_supported(scfg) else None
    taken = torch.zeros(o.shape[0], dtype=torch.int64)
    ids = torch.nonzero(alive).squeeze(1)
    rows, points = [], 0
    for i0 in range(0, t_lattice.n_lattice_points(scfg), t_lattice.CHUNK):
        if ids.numel() == 0:
            break
        mask, t, pos, inside_end = t_lattice.march_chunk(
            scfg, aabb, occ, o[ids], d[ids], startt[ids], taken[ids], i0, packed=packed
        )
        points += mask.numel()
        r, c = torch.nonzero(mask, as_tuple=True)
        rows.append(torch.cat([d[ids][r], t[r, c][:, None], pos[r, c]], dim=1))
        tk = taken[ids] + mask.sum(dim=1)
        taken[ids] = tk
        ids = ids[inside_end & (tk < scfg.maximum_marching_steps)]
    return _sorted(torch.cat(rows).numpy()), points


def _zero_density_renderer(cfg):
    """A renderer whose network returns zero density everywhere: every ray
    marches its whole sample set (no transmittance stop)."""
    r = t_renderer.Renderer(model=None, config=cfg)
    r.model = type("Model", (), {"prepare_inference": lambda self: None})()
    r._evaluate = lambda pos_w, dir_w, normals=False: (torch.zeros(pos_w.shape[0]), torch.zeros(pos_w.shape[0], 3))
    return r


@pytest.mark.parametrize(
    "case,doc,grid",
    [
        ("sparse", {}, "sparse"),
        ("dense", {}, "dense"),
        ("cone", {"samlper": {"cone_angle_constant": 0.004}}, "sparse"),
        ("aabb_scale_2", {"samlper": {"aabb_scale": 2}}, "sparse"),
    ],
)
def test_spp1_kept_segments_take_the_full_march_samples(monkeypatch, case, doc, grid):
    """The spp-1 frame's samples (ray, t, pos), bit for bit, and so each
    ray's count, equal the full march's from ordinal 0: on a sparse grid
    (rays culled by the window and the premask), a dense one (rays cross
    whole rounds to the box or the sample cap), the cone lattice (whole
    lattice, rays missing the occupied box culled) and aabb_scale 2 (no
    packed words, per-point mips)."""
    cfg = NGPConfig.from_json(doc)
    scfg = cfg.sampler
    occ = _grid(scfg, grid)
    cam = _camera(0.9, radius=0.9 if case == "aabb_scale_2" else 1.2)
    o, d = t_renderer.camera_rays(cam, W, H, FOCAL, (0.5, 0.5), (0.5, 0.5))
    aabb = AABB.scene(scfg.aabb_scale)
    t0, alive = t_renderer.ray_start(aabb, o, d)
    seed = (torch.arange(W * H, dtype=torch.int64) * 786433) & 0xFFFFFFFF
    spp = 3
    startt = fma(ld_random_val(spp, seed), scfg.min_cone_stepsize, t0)
    want, full_points = _full_march(cfg, occ, o, d, startt, alive)

    rec = _Recorder(monkeypatch)
    r = _zero_density_renderer(cfg)
    r.render_frame(occ, cam, (W, H), FOCAL, (0.5, 0.5), spp)
    got = rec.table()
    assert got.shape == want.shape and want.shape[0] > 1000, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)
    assert r.last_frame_samples == want.shape[0]
    # per-ray counts: the rows group by the ray's direction
    _, n_got = np.unique(got[:, :3], axis=0, return_counts=True)
    _, n_want = np.unique(want[:, :3], axis=0, return_counts=True)
    np.testing.assert_array_equal(n_got, n_want)
    if case == "sparse":
        # the window and the premask: far fewer lattice points tested, the
        # coarse pass's midpoints included
        assert r.last_frame_points < full_points / 2, (r.last_frame_points, full_points)


@pytest.mark.parametrize("grid,theta", [("sparse", 0.9), ("sparse", 4.1), ("dense", 2.0)])
def test_spp8_cover_march_with_the_premask_equals_it_without(monkeypatch, grid, theta):
    """The spp-8 frame's cover march over the kept segments marks exactly
    the cover points, (ray, lattice ordinal), of the cover march without
    the premask (count_samples from k0, jitter_cover) over each ray's
    window, rounded up to whole rounds as the march without it went."""
    cfg = NGPConfig.from_json({})
    scfg = cfg.sampler
    occ = _grid(scfg, grid)
    cam = _camera(theta)
    o, d = t_renderer.camera_rays(cam, W, H, FOCAL, (0.5, 0.5), (0.5, 0.5))
    aabb = AABB.scene(1.0)
    box = occupied_aabb(scfg, occ)
    hit, k0, span = t_renderer.frame_geometry(scfg, o, d, box)
    t0, alive = t_renderer.ray_start(aabb, o, d)
    ids = torch.nonzero(hit & alive).squeeze(1)
    n_lat = t_lattice.n_lattice_points(scfg)
    _, masks = t_lattice.count_samples(
        scfg, aabb, occ, o[ids], d[ids], t0[ids], return_masks=True, k0=k0[ids], n_window=n_lat,
        packed=packed_neighborhood(scfg, occ), jitter_cover=True,
    )
    reach = torch.ceil(span[ids] / t_lattice.CHUNK)[:, None] * t_lattice.CHUNK > torch.arange(n_lat)[None, :]
    r_, c_ = torch.nonzero(masks & reach, as_tuple=True)
    want = _sorted(torch.cat([d[ids][r_], (k0[ids][r_] + c_).to(torch.float32)[:, None]], dim=1).numpy())

    rec = _Recorder(monkeypatch)
    r = _zero_density_renderer(cfg)
    r.share_spp_evals = False  # every pass at its own points: Depth
    r.render_frame(occ, cam, (W, H), FOCAL, (0.5, 0.5), 0, render_mode="Depth", n_spp=8, occ_aabb=box)
    got = _sorted(torch.cat([torch.cat([row[0], row[3].to(torch.float32)[:, None]], dim=1) for row in rec.rows]).numpy())
    assert want.shape[0] > 1000
    np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------------- frames

CONFIG = {
    "samlper": {"grid_size": 32},
    "network": {
        "encoding": {"n_levels": 4, "log2_hashmap_size": 12, "base_resolution": 8, "desired_resolution": 64},
        "network": {"n_neurons": 32, "n_hidden_layers": 1},
        "rgb_network": {"n_neurons": 32, "n_hidden_layers": 2},
    },
}
FW, FH = 32, 24


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """A JAX-written snapshot: seeded init with the density channel pushed
    up and two small Gaussian blobs (so most rays miss the occupied box or
    hold no kept segment)."""
    tb = JTestbed()
    tb.load_model_config_dict(CONFIG)
    st = tb._state
    p = st.params
    w_last = p["density_mlp"][-1]
    p = dict(p, density_mlp=[*p["density_mlp"][:-1], w_last.at[:, 0].set(jnp.abs(w_last[:, 0]) * 4.0 + 0.5)])
    g = tb.config.sampler.grid_size
    ax = (np.arange(g) + 0.5) / g
    z, y, x = np.meshgrid(ax, ax, ax, indexing="ij")
    dens = np.zeros((tb.config.sampler.n_cascades, g, g, g), np.float32)
    for c in ((0.35, 0.4, 0.45), (0.62, 0.6, 0.55)):
        dens[0] += np.exp(-((x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2) / 0.006).astype(np.float32)
    tb._state = st._replace(params=p, ema_params=p, grid=st.grid._replace(density=jnp.asarray(dens.reshape(-1))))
    path = tmp_path_factory.mktemp("snap") / "blobs.msgpack"
    tb.save_snapshot(str(path))
    return str(path)


# Tolerances of tests/test_torch_render.py on linear RGBA: both packages
# take the same samples on the same rays, so only fp32 summation order
# differs (Normals differentiates through the bf16 MLP: 5e-5 max).
@pytest.mark.parametrize(
    "mode,max_abs",
    [("Shade", 1e-5), ("Depth", 1e-5), ("AO", 1e-5), ("Normals", 5e-5), ("Distance", 1e-5), ("Stepsize", 1e-5), ("Cost", 1e-5)],
)
def test_spp2_frames_in_every_mode_match_jax(snapshot, mode, max_abs):
    """The batched spp-2 frame (the cover march over the kept segments; Shade
    shares one evaluation per cover point, the other modes evaluate each
    pass) equals ngp_tpu's in every mode."""
    out = []
    for tb in (JTestbed(), TTestbed(device="cpu")):
        tb.load_snapshot(snapshot)
        tb.rendering_buffer.render_mode = mode
        tb.set_nerf_camera_matrix(ring_pose(1.7))
        img = tb.render(FW, FH, spp=2, to_srgb=False)
        out.append((np.asarray(img), np.asarray(tb._accum)))
    (j_img, j_acc), (t_img, t_acc) = out
    assert np.isfinite(t_acc).all() and 0.02 < (j_acc[..., 3] > 0.001).mean() < 0.9
    for a, b in ((t_acc, j_acc), (t_img, j_img)):
        err = np.abs(a - b)
        assert err.max() <= max_abs, f"max abs {err.max()}"
        assert err.mean() <= 1e-6, f"mean abs {err.mean()}"


@pytest.mark.parametrize("grid", ["sparse", "dense"])
def test_count_samples_segments_cover_branch_equals_count_samples(grid):
    """count_samples_segments(jitter_cover=True) over every segment of the
    window marks count_samples(jitter_cover=True)'s cover points: the box
    tests take pos + d*dt at every point and at the window's first."""
    cfg = NGPConfig.from_json({})
    scfg = cfg.sampler
    occ = _grid(scfg, grid)
    o, d = t_renderer.camera_rays(_camera(2.7), W, H, FOCAL, (0.5, 0.5), (0.5, 0.5))
    aabb = AABB.scene(1.0)
    t0, _ = t_renderer.ray_start(aabb, o, d)
    _, k0, _ = t_renderer.frame_geometry(scfg, o, d, occupied_aabb(scfg, occ))
    packed = packed_neighborhood(scfg, occ)
    n_window = 2 * t_lattice.CHUNK * 3
    want_counts, want = t_lattice.count_samples(
        scfg, aabb, occ, o, d, t0, return_masks=True, k0=k0, n_window=n_window, packed=packed, jitter_cover=True
    )
    seg_idx = torch.arange(n_window // t_lattice.SEG).expand(o.shape[0], -1)
    counts, masks, lat = t_lattice.count_samples_segments(scfg, aabb, occ, o, d, t0, k0, seg_idx, packed=packed,
                                                          jitter_cover=True)
    assert torch.equal(lat[0], torch.arange(n_window))
    assert torch.equal(masks, want) and torch.equal(counts, want_counts) and int(want_counts.sum()) > 1000
