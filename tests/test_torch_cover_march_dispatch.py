"""The spp-n Shade frame's cover march (render/march.py's CoverMarch) off the
card: which frames cover_march_takes gives the kernel
(csrc/render_cover_march.cu), and the CPU frame, which marches each block of
its hit rays through CoverMarch over render_cover_march_plain (the kernel's
plain version, with its interface), against the tests' planned cover march
(tests/planned_march.py: planned_shared, the renderer's round loop before
CoverMarch took its march): spp-2 and spp-8 frames bit for bit with the same
sample and point counts on six lattices (base.json's grid and two coarser
ones, a finer lattice whose rays pass SHARE_ROUND samples, a sample cap that
cuts rounds, densities that stop rays early), the ranks' shares of a sharded
frame, frames cut into many blocks of hit rays, some of which the cull
drops, against the planned march cut the same way, and the rows of every
launch against the round that the planned march evaluates. A CPU frame launches no kernel and counts no plain round; its
syncs sit at site `cover_march`. torch only."""

import dataclasses

import numpy as np
import pytest
import torch

from ngp_tpu_torch import Testbed
from ngp_tpu_torch.models.ngp import NGPModel
from ngp_tpu_torch.render import march as t_march
from ngp_tpu_torch.render import renderer as t_renderer
from ngp_tpu_torch.render.renderer import camera_rays
from ngp_tpu_torch.sampling.lattice import CHUNK
from ngp_tpu_torch.utils import profiling
from ngp_tpu_torch.utils.config import SQRT3, NGPConfig, SamplerConfig
from planned_march import planned_shared

torch.set_num_threads(2)

NETWORK = {
    "encoding": {"n_levels": 8, "log2_hashmap_size": 14, "base_resolution": 16, "desired_resolution": 256},
    "network": {"n_neurons": 64, "n_hidden_layers": 1},
    "dir_encoding": {"degree": 4},
    "rgb_network": {"n_neurons": 64, "n_hidden_layers": 2},
}
W, H = 40, 32


def _sampler(**kw):
    return NGPConfig.from_json({"samlper": kw}).sampler  # base.json's sampler with kw


@pytest.mark.parametrize("sampler, device, takes", [
    ({}, "cpu", False),
    ({}, "cuda", True),
    ({}, torch.device("cuda", 0), True),
    ({"grid_size": 32}, "cuda", True),
    ({"maximum_marching_steps": 2048}, "cuda", True),
    ({"aabb_scale": 16}, "cuda", False),
    ({"cone_angle_constant": 0.00390625}, "cuda", False),
    ({"maximum_marching_steps": 800}, "cuda", False),  # 3.5 dt G <= 1 < 4.5 dt G: packed words, no cover test
    ({"maximum_marching_steps": 256}, "cuda", False),  # 3.5 dt G > 1: no packed word a segment
    ({"maximum_marching_steps": 1 << 31}, "cuda", False),  # ordinals past the kernels' int32 indices
], ids=["cpu", "cuda", "cuda0", "grid32", "steps2048", "aabb16", "cone", "spp1_only", "coarse_dt", "int32"])
def test_cover_march_takes(sampler, device, takes):
    cfg = _sampler(**sampler)
    assert t_march.cover_march_takes(cfg, device) is takes
    if device != "cpu" and sampler.get("maximum_marching_steps") == 800:
        assert t_march.render_march_takes(cfg, device)  # the spp-1 kernel takes what the cover march cannot


def _blobs(cfg, centres, scale=2.0):
    g = cfg.sampler.grid_size
    ax = (np.arange(g) + 0.5) / g
    z, y, x = np.meshgrid(ax, ax, ax, indexing="ij")
    dens = np.zeros((cfg.sampler.n_cascades, g, g, g), np.float32)
    for c in centres:
        dens[0] += scale * np.exp(-(((x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2) / 0.01))
    return dens.reshape(-1)


def _pose(theta, radius=1.4, height=0.5):
    pos = np.array([radius * np.cos(theta), radius * np.sin(theta), height])
    back = pos / np.linalg.norm(pos)
    right = np.cross([0.0, 0.0, 1.0], back)
    right /= np.linalg.norm(right)
    return np.stack([right, np.cross(back, right), back, pos], axis=1).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class _CappedSampler(SamplerConfig):
    """A sampler whose step size is the 1024-step lattice's while
    maximum_marching_steps caps the samples lower."""

    @property
    def min_cone_stepsize(self) -> float:
        return SQRT3 / 1024


# lattice: (sampler keys, step cap or None, blob centres, network). "model" a
# seeded network, "opaque" a density growing along x (rays stop at the
# transmittance threshold in the middle of their rounds), "thin" density 0.05
# (rays run to the box exit, past SHARE_ROUND samples on the 2048-step
# lattice, or to a cap of 83 samples, which cuts rounds)
LATTICES = {
    "grid32": ({"grid_size": 32}, None, ((0.4, 0.5, 0.45), (0.6, 0.45, 0.55)), "model"),
    "grid64_opaque": ({"grid_size": 64}, None, ((0.35, 0.5, 0.5), (0.65, 0.5, 0.5), (0.5, 0.3, 0.6)), "opaque"),
    "grid128": ({}, None, ((0.45, 0.5, 0.5), (0.6, 0.4, 0.55)), "model"),
    "grid32_thin": ({"grid_size": 32}, None, ((0.2, 0.5, 0.5), (0.8, 0.45, 0.5), (0.5, 0.8, 0.6)), "thin"),
    "steps2048_thin": ({"grid_size": 64, "maximum_marching_steps": 2048}, None,
                       ((0.5, 0.5, 0.5), (0.35, 0.6, 0.45)), "thin"),
    "capped": ({"grid_size": 32}, 83, ((0.5, 0.5, 0.5), (0.3, 0.7, 0.4)), "thin"),
}


@pytest.fixture(scope="module", params=sorted(LATTICES))
def scene(request):
    sampler, cap, centres, net = LATTICES[request.param]
    tb = Testbed(device="cpu")
    tb.load_model_config_dict({"samlper": {"aabb_scale": 1, **sampler}, "network": NETWORK})
    model = NGPModel(tb.config.network, device="cpu").init(torch.Generator().manual_seed(4))
    params = {k: (v * 50.0 if k == "hash_table" else v) for k, v in model.params().items()}
    tb.set_state(params, _blobs(tb.config, centres))
    r = tb._renderer
    if cap is not None:
        capped = _CappedSampler(**{**dataclasses.asdict(r.config.sampler), "maximum_marching_steps": cap})
        r.config = dataclasses.replace(r.config, sampler=capped)
    if net != "model":
        def evaluate(pos_w, dir_w, normals=False):
            x = pos_w[:, 0]
            sigma = torch.full_like(x, 0.05) if net == "thin" else 400.0 * x * x
            return sigma, torch.stack([x, pos_w[:, 1], dir_w[:, 2]], dim=-1)

        r._evaluate = evaluate
    assert r.can_batch_spp()
    tb.set_nerf_camera_matrix(_pose(0.7))
    cam = torch.as_tensor(tb.rendering_buffer.camera_matrix, dtype=torch.float32)
    o, d = camera_rays(cam, W, H, (float(W), float(W)), (0.5, 0.5), (0.5, 0.5))
    return request.param, tb, cam, o, d


def _render(tb, cam, o, d, n_spp, planned: bool = False, share=slice(None), spp: int = 0):
    """An spp-n Shade frame of the rays: the renderer's (CoverMarch over
    render_cover_march_plain), or with `planned` the tests' planned cover
    march of the share. -> (out, samples, points)."""
    r = tb._renderer
    assert not t_march.cover_march_takes(r.config.sampler, o.device)
    if planned:
        return planned_shared(r, tb.grid.occupancy, tb.grid.occ_aabb, o, d, spp, n_spp, share)
    out = r.render_rays(tb.grid.occupancy, cam, o, d, spp, "Shade", occ_aabb=tb.grid.occ_aabb, n_spp=n_spp)
    return out, r.last_frame_samples, r.last_frame_points


@pytest.mark.parametrize("n_spp", [2, 8])
def test_cover_march_frames_equal_the_planned_march(scene, n_spp):
    name, tb, cam, o, d = scene
    want, samples, points = _render(tb, cam, o, d, n_spp, planned=True)
    got, k_samples, k_points = _render(tb, cam, o, d, n_spp)
    assert torch.equal(got, want), (name, n_spp, float((got - want).abs().max()))
    assert (k_samples, k_points) == (samples, points), name
    assert samples > 0 and want[:, 3].max() > 0.0, name


def test_long_rays_pass_share_round(scene):
    """The 2048-step lattice's thin scene has rays of more than SHARE_ROUND
    samples, so its frames hold the lerp's break at each compositing round's
    last sample; the capped lattice's rays stop at the cap."""
    name, tb, cam, o, d = scene
    r = tb._renderer
    taken = []
    real = t_march.render_cover_march_plain

    def record(cfg, occupancy, pooled, packed, a, n_in, first, n_rounds, thresh):
        real(cfg, occupancy, pooled, packed, a, n_in, first, n_rounds, thresh)
        taken.append(int(a.taken.max()))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_march, "render_cover_march_plain", record)
        _render(tb, cam, o, d, 2)
    if name == "steps2048_thin":
        assert max(taken) > t_march.SHARE_ROUND, taken
    if name == "capped":
        assert max(taken) == r.config.sampler.maximum_marching_steps == 83, taken


class _Rank:
    """A mesh of `size` ranks seen from `rank`, whose all-reduce keeps this
    rank's rows: the frame of one rank's share."""

    def __init__(self, rank, size):
        self.rank, self.size = rank, size

    def all_reduce_(self, tensors, op):
        pass


def test_cover_march_shares_equal_the_planned_march(scene):
    """Each of 3 ranks' spp-8 frames against the planned march of the same
    share of the hit rays: bit-equal, and the shares' samples add up to the
    whole frame's."""
    name, tb, cam, o, d = scene
    r = tb._renderer
    _, samples, _ = _render(tb, cam, o, d, 8, planned=True)
    shares = []
    for rank in range(3):
        want, s_want, p_want = _render(tb, cam, o, d, 8, planned=True, share=slice(rank, None, 3))
        try:
            r.mesh = _Rank(rank, 3)
            out, s, p = _render(tb, cam, o, d, 8)
        finally:
            r.mesh = None
        assert torch.equal(out, want), (name, rank, float((out - want).abs().max()))
        assert (s, p) == (s_want, p_want) and s > 0, (name, rank)
        shares.append(s)
    assert sum(shares) == samples, (name, shares)


@pytest.mark.parametrize("n_spp", [2, 8])
def test_cover_march_blocks_of_hit_rays_equal_the_planned_march(scene, n_spp, monkeypatch):
    """With blocks of 37 rays, a frame of several blocks whose cull drops
    rays in some: the renderer cuts each block from the hit rays, and its
    frame equals the planned march's cut the same way, bit for bit with the
    same samples and points."""
    name, tb, cam, o, d = scene
    monkeypatch.setattr(t_renderer, "SPP_BLOCK_SLOTS", 37 * n_spp * CHUNK)
    stats = {}
    want, samples, points = planned_shared(tb._renderer, tb.grid.occupancy, tb.grid.occ_aabb, o, d, 0, n_spp,
                                           block=37, stats=stats)
    got, k_samples, k_points = _render(tb, cam, o, d, n_spp)
    assert stats["block"] == 37 and stats["hit"] > 2 * 37 and stats["kept"] < stats["hit"], (name, stats)
    assert torch.equal(got, want), (name, n_spp, float((got - want).abs().max()))
    assert (k_samples, k_points) == (samples, points) and samples > 0, name


def test_cover_launch_rows_equal_the_planned_round(scene, monkeypatch):
    """Every launch's output, read as the composite reads it, against the
    planned march's round on the same rays (both lists in ray order on the
    CPU): the mask and t, the rows to evaluate (every sample but a carried-in
    column 0, and column 128 where the ray carries out), their positions to
    the bit, and the counters."""
    import planned_march

    name, tb, cam, o, d = scene
    seen = {True: [], False: []}
    real_launch, real_round = t_march.render_cover_march_plain, planned_march.march_round

    def launch(cfg, occupancy, pooled, packed, a, n_in, first, n_rounds, thresh):
        real_launch(cfg, occupancy, pooled, packed, a, n_in, first, n_rounds, thresh)
        n_live, n_rows = a.counts.tolist()
        if n_live:
            grid = torch.zeros((n_live, CHUNK + 1), dtype=torch.bool)
            grid.view(-1)[a.flat[:n_rows]] = True
            pos = torch.zeros((n_live, CHUNK + 1, 3))
            pos.view(-1, 3)[a.flat[:n_rows]] = a.pos[:n_rows]
            carry = a.carry[:n_live].clone()
            assert torch.equal(grid[:, CHUNK], carry[:, 1]), name
            seen[False].append((a.mask[:n_live].clone(), a.t[:n_live].clone(), grid, pos, carry))

    def planned_round(*args, **kw):
        out = real_round(*args, **kw)
        seen[True].append((out[0][:, :CHUNK], out[1][:, :CHUNK], out[2][:, : CHUNK + 1]))
        return out

    monkeypatch.setattr(t_march, "render_cover_march_plain", launch)
    _render(tb, cam, o, d, 8)
    monkeypatch.setattr(planned_march, "march_round", planned_round)
    _render(tb, cam, o, d, 8, planned=True)
    assert len(seen[True]) == len(seen[False]) > 1, name
    for k, ((mask, t, pos), (k_mask, k_t, grid, k_pos, carry)) in enumerate(zip(seen[True], seen[False])):
        assert torch.equal(k_mask, mask) and torch.equal(k_t, t), (name, k)
        assert torch.equal(grid[:, 1:CHUNK], mask[:, 1:]) and torch.equal(grid[:, 0], mask[:, 0] & ~carry[:, 0]), (name, k)
        assert torch.equal(k_pos[grid], pos[grid]), (name, k)


def test_cpu_frame_takes_the_plain_path(scene):
    """A CPU spp-8 frame marches through CoverMarch, one plain launch and one
    readback a round: no kernel launch, no plain round counted (the card
    only), its syncs at site `cover_march`, none at the planned march's
    `cull`, `plan_rows`, `samples` or `live_rays`."""
    name, tb, cam, o, d = scene
    before = profiling.counters()
    out, samples, _ = _render(tb, cam, o, d, 8)
    after = profiling.counters()
    delta = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    assert samples > 0 and out[:, 3].max() > 0.0
    assert delta.get("launches.render_cover_march", 0) == delta.get("render.march.plain", 0) == 0
    assert delta.get("render.host_syncs.cover_march", 0) > 0
    for site in ("cull", "plan_rows", "samples", "live_rays"):
        assert delta.get(f"render.host_syncs.{site}", 0) == 0, site
