"""The spp-1 renderer's march (render/march.py) off the card: which frames
render_march_takes gives the kernel (csrc/render_march.cu), and the CPU
frame, which marches through FrameMarch over render_march_plain (the
kernel's plain version, with its interface), against the tests' planned
march (tests/planned_march.py: segment_plan, march_round): every round's
samples, whole frames in all seven modes bit for bit with the same sample
and point counts, at a sample cap that cuts rounds and with densities that
stop rays early, and the ranks' shares of a sharded frame. A CPU frame
launches no kernel and counts no plain round. On the cone lattice the pass
marches through ConeMarch, whose rounds take only rays still above the
transmittance threshold. torch only."""

import dataclasses

import numpy as np
import pytest
import torch

from ngp_tpu_torch import Testbed
from ngp_tpu_torch.models.ngp import NGPModel
from ngp_tpu_torch.render import march as t_march
from ngp_tpu_torch.render.renderer import RENDER_MODES, camera_rays
from ngp_tpu_torch.sampling.lattice import CHUNK
from ngp_tpu_torch.utils import profiling
from ngp_tpu_torch.utils.config import SQRT3, NGPConfig, SamplerConfig
from planned_march import planned_pass

torch.set_num_threads(2)

TINY = {
    "samlper": {"aabb_scale": 1, "grid_size": 32},  # base.json's dt: rounds of 0.22 scene units
    "network": {
        "encoding": {"n_levels": 8, "log2_hashmap_size": 14, "base_resolution": 16, "desired_resolution": 256},
        "network": {"n_neurons": 64, "n_hidden_layers": 1},
        "dir_encoding": {"degree": 4},
        "rgb_network": {"n_neurons": 64, "n_hidden_layers": 2},
    },
}
W, H = 40, 32


def _sampler(**kw):
    return NGPConfig.from_json({"samlper": kw}).sampler  # base.json's sampler with kw


@pytest.mark.parametrize("sampler, device, takes", [
    ({}, "cpu", False),
    ({}, "cuda", True),
    ({}, torch.device("cuda", 0), True),
    ({"grid_size": 32}, "cuda", True),
    ({"aabb_scale": 16}, "cuda", False),
    ({"cone_angle_constant": 0.00390625}, "cuda", False),
    ({"aabb_scale": 16, "cone_angle_constant": 0.00390625}, "cuda", False),
    ({"maximum_marching_steps": 256}, "cuda", False),  # dt = sqrt(3)/256: 3.5 dt G > 1, no packed word a segment
], ids=["cpu", "cuda", "cuda0", "grid32", "aabb16", "cone", "aabb16_cone", "coarse_dt"])
def test_render_march_takes(sampler, device, takes):
    assert t_march.render_march_takes(_sampler(**sampler), device) is takes



def test_render_march_launches_inside_a_recorded_op():
    """The kernel's ctypes launch runs inside RenderMarchOp, which
    torch.profiler records as an op under the enclosing spp_march span, so
    the span's device time takes in the kernel's; the op returns its tensor
    as it is."""
    from torch.profiler import ProfilerActivity, profile

    out = torch.arange(3, dtype=torch.int64)
    calls = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("spp_march"):
            got = t_march.RenderMarchOp.apply(out, lambda: calls.append(1))
    assert calls == [1] and torch.equal(got, out)
    ops = [e for e in prof.events() if e.name == "RenderMarchOp"]
    assert len(ops) == 1 and ops[0].cpu_parent is not None and ops[0].cpu_parent.name == "spp_march"

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
    maximum_marching_steps caps the samples lower (dt = sqrt(3) / steps, so
    no configuration's cap cuts a ray that enters from outside the box)."""

    @property
    def min_cone_stepsize(self) -> float:
        return SQRT3 / 1024


# (step cap, blob centres, network): "model" a seeded TINY network, "opaque"
# one whose density grows along x (rays stop at the transmittance threshold
# in the middle of the frame's rounds), "thin" density 0.05 (rays run to the
# box exit, or to a cap of 83 samples, which cuts rounds)
CASES = {
    "model": (None, ((0.4, 0.5, 0.45), (0.6, 0.45, 0.55)), "model"),
    "opaque": (None, ((0.35, 0.5, 0.5), (0.65, 0.5, 0.5), (0.5, 0.3, 0.6)), "opaque"),
    "thin": (None, ((0.2, 0.5, 0.5), (0.8, 0.45, 0.5), (0.5, 0.8, 0.6)), "thin"),
    "thin_cap": (83, ((0.5, 0.5, 0.5), (0.3, 0.7, 0.4)), "thin"),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def scene(request):
    cap, centres, net = CASES[request.param]
    tb = Testbed(device="cpu")
    tb.load_model_config_dict(TINY)
    model = NGPModel(tb.config.network, device="cpu").init(torch.Generator().manual_seed(4))
    params = {k: (v * 50.0 if k == "hash_table" else v) for k, v in model.params().items()}
    tb.set_state(params, _blobs(tb.config, centres))
    r = tb._renderer
    if cap is not None:
        sampler = _CappedSampler(**{**dataclasses.asdict(r.config.sampler), "maximum_marching_steps": cap})
        r.config = dataclasses.replace(r.config, sampler=sampler)
    if net != "model":
        def evaluate(pos_w, dir_w, normals=False):
            x = pos_w[:, 0]
            sigma = torch.full_like(x, 0.05) if net == "thin" else 400.0 * x * x
            return sigma, torch.stack([x, pos_w[:, 1], dir_w[:, 2]], dim=-1)

        r._evaluate = evaluate
    tb.set_nerf_camera_matrix(_pose(0.7))
    cam = torch.as_tensor(tb.rendering_buffer.camera_matrix, dtype=torch.float32)
    o, d = camera_rays(cam, W, H, (float(W), float(W)), (0.5, 0.5), (0.5, 0.5))
    return request.param, tb, cam, o, d


def _render(tb, cam, o, d, mode, planned: bool = False, share=slice(None), spp: int = 0):
    """A spp-1 pass of the rays: the renderer's (FrameMarch over
    render_march_plain), or with `planned` the tests' planned march of the
    share. -> (out, samples, points, syncs)."""
    r = tb._renderer
    assert not t_march.render_march_takes(r.config.sampler, o.device)
    syncs = profiling.get("render.host_syncs")
    if planned:
        out, samples, points = planned_pass(r, tb.grid.occupancy, tb.grid.occ_aabb, o, d, cam, spp, mode, share)
        return out, samples, points, 0
    out = r.render_rays(tb.grid.occupancy, cam, o, d, spp, mode, occ_aabb=tb.grid.occ_aabb)
    return out, r.last_frame_samples, r.last_frame_points, profiling.get("render.host_syncs") - syncs


@pytest.mark.parametrize("mode", RENDER_MODES)
def test_frame_march_frames_equal_the_plain_path(scene, mode):
    name, tb, cam, o, d = scene
    want, samples, points, _ = _render(tb, cam, o, d, mode, planned=True)
    got, k_samples, k_points, syncs = _render(tb, cam, o, d, mode)
    assert torch.equal(got, want), (name, mode, float((got - want).abs().max()))
    assert (k_samples, k_points) == (samples, points)
    assert samples > 0 and want[:, 3].max() > 0.0
    assert syncs > 0


class _Rounds:
    """Records every round the pass composites: its rays' mask rows and its
    samples as rows (ray id, column, position, warped direction), sorted."""

    def __init__(self, mp, renderer):
        self.rounds = []
        real = renderer._composite_round

        def record(acc, r, *args):
            ray = r.ids[r.flat // CHUNK]
            rows = torch.cat([ray[:, None].double(), (r.flat % CHUNK)[:, None].double(), r.pos.double(), r.dirs.double()], 1)
            order = torch.argsort(r.ids)
            self.rounds.append((r.ids[order], r.mask[order], rows[np.lexsort(rows.numpy().T[::-1])]))
            return real(acc, r, *args)

        mp.setattr(renderer, "_composite_round", record)


def test_frame_march_rounds_equal_march_round(scene):
    name, tb, cam, o, d = scene
    seen = {}
    for planned in (True, False):
        with pytest.MonkeyPatch.context() as mp:
            rec = _Rounds(mp, tb._renderer)
            _render(tb, cam, o, d, "Shade", planned)
        seen[planned] = rec.rounds
    assert len(seen[False]) == len(seen[True]) > 0, name
    for k, ((ids, mask, rows), (k_ids, k_mask, k_rows)) in enumerate(zip(seen[True], seen[False])):
        assert torch.equal(k_ids, ids), (name, k)
        assert torch.equal(k_mask, mask), (name, k)
        assert torch.equal(k_rows, rows), (name, k)  # positions and directions to the bit


class _Rank:
    """A mesh of `size` ranks seen from `rank`, whose all-reduce keeps this
    rank's rows: the frame of one rank's share."""

    def __init__(self, rank, size):
        self.rank, self.size = rank, size

    def all_reduce_(self, tensors, op):
        pass


def test_frame_march_shares_equal_the_plain_path(scene):
    """Each of 3 ranks' frames against the planned march of the same share:
    the renderer shares the hit rays (every size-th from the rank on), and
    the planned march here marches the rank's share of the hit rays. The
    frames are bit-equal, and the shares' samples add up to the whole
    frame's."""
    name, tb, cam, o, d = scene
    r = tb._renderer
    _, samples, _, _ = _render(tb, cam, o, d, "Shade", planned=True)
    shares = []
    for rank in range(3):
        want, s_want, _, _ = _render(tb, cam, o, d, "Shade", planned=True, share=slice(rank, None, 3))
        try:
            r.mesh = _Rank(rank, 3)
            out, s, _, _ = _render(tb, cam, o, d, "Shade")
        finally:
            r.mesh = None
        assert torch.equal(out, want), (name, rank, float((out - want).abs().max()))
        assert s == s_want > 0, (name, rank)
        shares.append(s)
    assert sum(shares) == samples, (name, shares)


def test_cpu_frame_takes_the_plain_path(scene):
    """A CPU frame marches through FrameMarch, one plain launch and one
    readback a round: no kernel launch, and the plain rounds are counted on
    the card only."""
    name, tb, cam, o, d = scene
    before = profiling.counters()
    out, samples, _, _ = _render(tb, cam, o, d, "Shade")
    after = profiling.counters()
    delta = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    assert samples > 0 and out[:, 3].max() > 0.0
    assert delta.get("launches.render_march", 0) == delta.get("render.march.plain", 0) == 0
    assert delta.get("render.host_syncs.march", 0) > 0
    assert delta.get("render.host_syncs.samples", 0) == delta.get("render.host_syncs.live_rays", 0) == 0


def test_cone_rounds_take_only_rays_above_the_threshold(scene):
    """The scene on the cone lattice: every round ConeMarch hands the
    composite holds only rays whose transmittance, before it, is at or above
    the threshold (the rounds before stopped the others), and the opaque
    scene stops rays that way."""
    name, tb, cam, o, d = scene
    r = tb._renderer
    cfg = r.config
    thresh = cfg.render.transmittance_threshold
    r.config = dataclasses.replace(cfg, sampler=dataclasses.replace(cfg.sampler, cone_angle_constant=0.004))
    seen = []
    real = r._composite_round

    def record(acc, rd, *args):
        seen.append(acc[2][rd.ids].clone())
        return real(acc, rd, *args)

    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(r, "_composite_round", record)
            out = r.render_rays(tb.grid.occupancy, cam, o, d, 0, "Shade", occ_aabb=tb.grid.occ_aabb)
    finally:
        r.config = cfg
    assert len(seen) > 1 and out[:, 3].max() > 0.0, name
    assert all(bool((tr >= thresh).all()) for tr in seen), name
    if name == "opaque":
        assert float(out[:, 3].max()) > 1.0 - thresh, name  # some ray turned opaque, so the stop ended it
