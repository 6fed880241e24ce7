"""Card tests of the spp-n Shade frame's cover march kernel
(csrc/render_cover_march.cu via render/march.py's CoverMarch): base.json
frames on the card, at the protocol's 800x800 shape and at 64x64, over five
grids (empty, the procedural scene's, a random half-occupied one, a full
one under a step cap of 200 samples with a low density, as early in
training, so that the cap cuts a ray's second round and ends it, and two
occupied corners, so that the 800x800 spp-8 frame holds several blocks of
hit rays and the cull drops rays between the corners), with the
kernel launch by launch against its plain version on copies of the same
inputs and state (the live list, every mask, lerp-partner and t row, the
carried flags, every row to evaluate, all in the same order, the rays'
taken, round and carried state, the counters), whole spp-2 and spp-8 frames
against the plain path (CoverMarch over render_cover_march_plain, and the
tests' planned cover march, tests/planned_march.py: planned_shared) to the
byte with the same sample and point counts, and against the kernel's own
frame again (its compaction is ordered, not set by atomics), the gap to the
planned march whose blocks are cut from the rays the cull keeps, the ranks'
shares of a sharded frame,
Testbed.render's spp-8 frame through the kernel (launches, no plain round,
one sync a round), the kernel's device time under the spp_march span, and a
timing case (the kernel's device ms a launch and a frame, its bytes bound,
the plain version's ms a round; printed and written to
build/cover_march_timing.json). Each test skips without a card. The
file imports torch, numpy and ngp_tpu_torch only, so on a machine with a
card (where jax is not installed) it runs from the repository root as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cover_march_cuda.py -q -s
"""

import dataclasses
import gc
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from ngp_tpu_torch import Testbed
from ngp_tpu_torch.data.synthetic import field_sigma_rgb
from ngp_tpu_torch.models.ngp import NGPModel
from ngp_tpu_torch.render import march as t_march
from ngp_tpu_torch.render.renderer import camera_rays
from ngp_tpu_torch.sampling.lattice import CHUNK
from ngp_tpu_torch.utils import profiling
from ngp_tpu_torch.utils.config import SQRT3, SamplerConfig
from ngp_tpu_torch.utils.qmc import ld_random_pixel_offset
from planned_march import planned_shared

pytestmark = pytest.mark.cuda

BASE_JSON = "experiment/nerf_synthetic/config/base.json"
SHAPES = {"protocol": (800, 800), "small": (64, 64)}
GRIDS = ("empty", "scene", "half", "capped", "corners")
CAP = 200  # the capped grid's maximum_marching_steps: within a ray's second round of 128 points
# the procedural scene's placement in the unit box (data/synthetic.py's
# datasets: scale 0.33, offset 0.5)
SCENE_SCALE, SCENE_OFFSET = 0.33, 0.5
H100_BYTES_S = 3.35e12  # HBM3 bandwidth of the H100 SXM (NVIDIA's data sheet)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: render_cover_march has no CPU mode")
    gc.collect()
    return torch.device("cuda")


def _density(cfg, kind: str) -> np.ndarray:
    """The density grid (n_cascades * G^3,), index x + G y + G^2 z."""
    g, nc = cfg.grid_size, cfg.n_cascades
    if kind == "empty":
        return np.zeros(nc * g**3, np.float32)
    if kind == "half":
        return (np.random.default_rng(5).random(nc * g**3) < 0.5).astype(np.float32)
    if kind == "capped":
        return np.ones(nc * g**3, np.float32)
    if kind == "corners":  # two opposite corner cubes of a quarter of the box's side
        lo = np.arange(g) < g // 4
        hi = np.arange(g) >= g - g // 4
        dens = np.zeros((nc, g, g, g), np.float32)
        dens[0] = (lo[:, None, None] & lo[None, :, None] & lo[None, None, :]) | (
            hi[:, None, None] & hi[None, :, None] & hi[None, None, :])
        return dens.reshape(-1)
    ax = (np.arange(g) + 0.5) / g
    z, y, x = np.meshgrid(ax, ax, ax, indexing="ij")
    pos = (torch.from_numpy(np.stack([x, y, z], axis=-1).astype(np.float32)) - SCENE_OFFSET) / SCENE_SCALE
    dens = np.zeros((nc, g, g, g), np.float32)
    dens[0] = field_sigma_rgb(pos)[0].numpy()
    return dens.reshape(-1)


def _pose(theta, radius=1.4, height=0.6):
    pos = np.array([0.5 + radius * np.cos(theta), 0.5 + radius * np.sin(theta), height])
    back = (pos - 0.5) / np.linalg.norm(pos - 0.5)
    right = np.cross([0.0, 0.0, 1.0], back)
    right /= np.linalg.norm(right)
    return np.stack([right, np.cross(back, right), back, pos], axis=1).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class _CappedSampler(SamplerConfig):
    """base.json's sampler, its step size the 1024-step lattice's, while
    maximum_marching_steps caps the samples lower."""

    @property
    def min_cone_stepsize(self) -> float:
        return SQRT3 / 1024


@pytest.fixture(scope="module", params=GRIDS)
def testbed(card, request):
    """base.json on the card with seeded weights (the density pushed up so
    rays turn opaque, as a trained scene's do) and the grid; the capped grid
    with the density pushed down (rays stay clear, so the step cap ends
    them) and maximum_marching_steps CAP."""
    tb = Testbed(device="cuda")
    tb.load_model_config(BASE_JSON)
    params = NGPModel(tb.config.network, device="cpu").init(torch.Generator().manual_seed(0)).params()
    if request.param == "capped":
        params["density_mlp"][-1][:, 0] = params["density_mlp"][-1][:, 0] * 0.1
    else:
        params["density_mlp"][-1][:, 0] = params["density_mlp"][-1][:, 0].abs() * 4.0 + 0.5
    tb.set_state(params, _density(tb.config.sampler, request.param))
    if request.param == "capped":
        r = tb._renderer
        r.config = dataclasses.replace(
            r.config, sampler=_CappedSampler(**{**dataclasses.asdict(r.config.sampler), "maximum_marching_steps": CAP})
        )
    tb.set_nerf_camera_matrix(_pose(0.9))
    yield request.param, tb
    del tb
    gc.collect()


def _rays(tb, shape):
    w, h = SHAPES[shape]
    cam = torch.as_tensor(tb.rendering_buffer.camera_matrix, dtype=torch.float32).to("cuda")
    o, d = camera_rays(cam, w, h, (float(w), float(w)), (0.5, 0.5), ld_random_pixel_offset(0).tolist())
    return cam, o, d


def _render(tb, shape, n_spp, path: str = "kernel", share=slice(None), cull_first=False, stats=None):
    """An spp-n Shade frame of the shape's pixel rays: the renderer's through
    the kernel ("kernel"), through CoverMarch over the plain version
    ("plain"), or the tests' planned cover march of the share ("planned",
    its blocks cut from the hit rays as the renderer's, or with `cull_first`
    from the rays the cull keeps; `stats` as planned_shared's).
    -> (out, samples, points, launches, plain rounds)."""
    r = tb._renderer
    cam, o, d = _rays(tb, shape)
    launches, plain = profiling.get("launches.render_cover_march"), profiling.get("render.march.plain")
    if path == "planned":
        out, samples, points = planned_shared(r, tb.grid.occupancy, tb.grid.occ_aabb, o, d, 0, n_spp, share,
                                              cull_first, stats=stats)
    else:
        assert t_march.cover_march_takes(r.config.sampler, o.device)
        with pytest.MonkeyPatch.context() as mp:
            if path == "plain":
                mp.setattr(t_march, "cover_march_takes", lambda cfg, device: False)
            out = r.render_rays(tb.grid.occupancy, cam, o, d, 0, "Shade", occ_aabb=tb.grid.occ_aabb, n_spp=n_spp)
        samples, points = r.last_frame_samples, r.last_frame_points
    torch.cuda.synchronize()
    return (out, samples, points, profiling.get("launches.render_cover_march") - launches,
            profiling.get("render.march.plain") - plain)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_kernel_launches_equal_their_plain_version(testbed, shape):
    """Every launch of an spp-8 frame against render_cover_march_plain on
    copies of its inputs and state: every output in the same order."""
    grid, tb = testbed
    real = t_march.render_cover_march
    checked = []

    def both(cfg, occupancy, pooled, packed, a, n_in, first, n_rounds, thresh):
        b = t_march.CoverLaunch(*(t.clone() for t in a))
        t_march.render_cover_march_plain(cfg, occupancy, pooled, packed, b, n_in, first, n_rounds, thresh)
        real(cfg, occupancy, pooled, packed, a, n_in, first, n_rounds, thresh)
        torch.cuda.synchronize()
        n_live, n_rows = a.counts.tolist()
        assert b.counts.tolist() == [n_live, n_rows], (grid, shape, len(checked))
        # the live list, each ray's rows of the composite and its rows to evaluate, in the same order
        for name, n in (("list_out", n_live), ("mask", n_live), ("adj", n_live), ("carry", n_live), ("t", n_live),
                        ("flat", n_rows), ("pos", n_rows), ("dirs", n_rows)):
            assert torch.equal(getattr(a, name)[:n], getattr(b, name)[:n]), (grid, shape, len(checked), name)
        listed = a.list_in[:n_in]
        for name in ("taken", "rnd", "carried"):
            assert torch.equal(getattr(a, name)[listed], getattr(b, name)[listed]), (grid, shape, len(checked), name)
        n_carried = int(a.carry[:n_live, 0].sum())  # rays whose column 0 the last round evaluated
        checked.append((n_in, n_live, n_rows, n_carried, int((a.taken[listed] == cfg.maximum_marching_steps).sum())))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_march, "render_cover_march", both)
        _, samples, _, _, _ = _render(tb, shape, 8)
    if grid != "empty":
        assert len(checked) >= 2 and samples == sum(c[2] for c in checked), checked
        assert sum(c[3] for c in checked) > 0, checked  # rows the carry saved
    if grid == "capped":
        assert tb._renderer.config.sampler.maximum_marching_steps == CAP
        assert sum(c[4] for c in checked) > 0, checked  # the cap ended rays


@pytest.mark.parametrize("n_spp", [2, 8])
def test_kernel_frames_equal_the_plain_path(testbed, n_spp):
    """Whole frames at both shapes: the kernel's against itself, against
    CoverMarch over the plain version and against the planned cover march,
    to the byte, with the same samples and points; the kernel's with no
    plain round."""
    grid, tb = testbed
    for shape in sorted(SHAPES):
        want, samples, points, _, _ = _render(tb, shape, n_spp, "planned")
        plain, p_samples, p_points, _, plain_rounds = _render(tb, shape, n_spp, "plain")
        got, k_samples, k_points, launches, k_plain = _render(tb, shape, n_spp)
        assert torch.equal(_render(tb, shape, n_spp)[0], got), (grid, n_spp, shape)
        assert torch.equal(plain, want), (grid, n_spp, shape, float((plain - want).abs().max()))
        assert torch.equal(got, want), (grid, n_spp, shape, float((got - want).abs().max()))
        assert (k_samples, k_points) == (p_samples, p_points) == (samples, points), (grid, n_spp, shape)
        assert k_plain == 0 and (plain_rounds > 0 or grid == "empty")
        if grid != "empty":
            assert samples > 0 and launches > 1 and want[..., 3].max() > 0.0


def test_kernel_frame_against_blocks_of_culled_rays(testbed):
    """The protocol shape's spp-8 frame against the planned march whose
    blocks are cut from the rays the cull keeps. Where the frame holds one
    block of hit rays, or the cull drops none, the blocks are the same and
    the frames equal to the byte. Where it holds several and the cull drops
    rays (the corners grid), a block's live lists differ, and with them the
    composite's batched products' and reductions' rounding and, for a pass
    whose transmittance lies at the threshold, whether its ray stops a round
    earlier: each pixel within 2.5 (srgb_to_linear's largest slope, 2.27,
    rounded up) times the threshold (the light a pass leaves past it) plus
    128 ulp of 1 (a 128-term sum's reordering). The gap is printed and
    written to build/cover_march_timing.json."""
    grid, tb = testbed
    stats = {}
    got = _render(tb, "protocol", 8)[0]
    hit_cut = _render(tb, "protocol", 8, "planned", stats=stats)[0]
    culled_cut, samples, _, _, _ = _render(tb, "protocol", 8, "planned", cull_first=True)
    assert torch.equal(got, hit_cut), (grid, float((got - hit_cut).abs().max()))
    gap = (got - culled_cut).abs()
    blocks_differ = stats.get("hit", 0) > stats.get("block", 0) and stats.get("kept", 0) < stats.get("hit", 0)
    if grid == "corners":
        assert blocks_differ and samples > 0, stats
    if not blocks_differ:
        assert torch.equal(got, culled_cut), (grid, stats, float(gap.max()))
        return
    thresh = tb._renderer.config.render.transmittance_threshold
    bound = 2.5 * (thresh + CHUNK * 2.0**-24)
    out = {"grid": grid, **stats, "max": float(gap.max()), "mean": float(gap.mean()),
           "pixels_differing": int((gap > 0).any(dim=-1).sum()), "bound": bound}
    print(json.dumps({"culled_blocks_gap": out}))
    path = Path("build") / "cover_march_timing.json"
    path.parent.mkdir(exist_ok=True)
    seen = json.loads(path.read_text()) if path.exists() else {}
    seen[f"{grid}_culled_blocks_gap"] = out
    path.write_text(json.dumps(seen, indent=1))
    assert float(gap.max()) <= bound, out


class _Rank:
    """A mesh of `size` ranks seen from `rank`, whose all-reduce keeps this
    rank's rows: the frame of one rank's share."""

    def __init__(self, rank, size):
        self.rank, self.size = rank, size

    def all_reduce_(self, tensors, op):
        pass


def test_kernel_ray_subsets_equal_the_plain_path(testbed):
    """Each of 3 ranks' spp-8 frames against the planned cover march of the
    same share of the hit rays: bit-equal, and the shares' samples add up
    to the whole frame's."""
    grid, tb = testbed
    r = tb._renderer
    _, samples, _, _, _ = _render(tb, "protocol", 8, "planned")
    shares = []
    for rank in range(3):
        want, s_want, _, _, _ = _render(tb, "protocol", 8, "planned", share=slice(rank, None, 3))
        try:
            r.mesh = _Rank(rank, 3)
            out, s, _, _, plain = _render(tb, "protocol", 8)
            assert plain == 0
        finally:
            r.mesh = None
        assert torch.equal(out, want), (grid, rank, float((out - want).abs().max()))
        assert s == s_want and (s > 0 or grid == "empty"), (grid, rank)
        shares.append(s)
    assert sum(shares) == samples, (grid, shares)


def test_testbed_frame_takes_the_kernel(testbed):
    """Testbed.render's spp-8 frame at the protocol shape: launches, no plain
    round, one sync a launch at site cover_march, none at the planned
    march's sites."""
    grid, tb = testbed
    tb.rendering_buffer.render_mode = "Shade"
    before = profiling.counters()
    tb.render(*SHAPES["protocol"], spp=8, to_srgb=True)
    after = profiling.counters()
    delta = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    assert delta.get("render.march.plain", 0) == 0
    for site in ("cull", "plan_rows", "samples", "live_rays"):
        assert delta.get(f"render.host_syncs.{site}", 0) == 0, site
    assert delta.get("render.host_syncs.cover_march", 0) == delta.get("launches.render_cover_march", 0)
    if grid != "empty":
        assert delta["launches.render_cover_march"] >= 2


def test_cover_march_kernel_counts_under_the_march_span(testbed):
    """Under torch.profiler, the kernel's device time counts in the device
    time that the profiler gives the spp_march spans, as the benchmark's
    march_ms.serve reads it (the span's device_time_total)."""
    grid, tb = testbed
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, _, launches, _ = _render(tb, "small", 8)
        torch.cuda.synchronize()
    events = prof.events()
    kernel_us = sum(e.time_range.elapsed_us() for e in events
                    if e.device_type == DeviceType.CUDA and "render_cover_march_kernel" in e.name)
    span_us = sum(e.device_time_total for e in events if e.device_type == DeviceType.CPU and e.name == "spp_march")
    if grid != "empty":
        assert launches > 1 and kernel_us > 0
    assert span_us >= kernel_us, (grid, launches, span_us, kernel_us)


def _profiled_frame(tb, path: str):
    """The protocol shape's spp-8 frame under torch.profiler: (device ms of
    each render_cover_march_kernel launch, the spp_march spans' device ms,
    the launches' counters)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    counts = []
    real = t_march.render_cover_march if path == "kernel" else t_march.render_cover_march_plain

    def spy(cfg, occupancy, pooled, packed, a, n_in, first, n_rounds, thresh):
        real(cfg, occupancy, pooled, packed, a, n_in, first, n_rounds, thresh)
        counts.append((n_in, a.counts, a.trans.shape[-1]))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_march, "render_cover_march" if path == "kernel" else "render_cover_march_plain", spy)
        _render(tb, "protocol", 8, path)  # warm
        counts.clear()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _render(tb, "protocol", 8, path)
            torch.cuda.synchronize()
    events = prof.events()
    kernel = [e.time_range.elapsed_us() / 1e3 for e in events
              if e.device_type == DeviceType.CUDA and "render_cover_march_kernel" in e.name]
    march_ms = sum(e.device_time_total for e in events if e.device_type == DeviceType.CPU and e.name == "spp_march") / 1e3
    return kernel, march_ms, [(n_in, *c.tolist(), p) for n_in, c, p in counts]  # (listed, live, rows, passes)


def test_cover_march_timing(testbed):
    """The kernel's device ms a launch and a frame on the protocol shape's
    spp-8 frame, its bytes bound a launch (a listed ray's id, state and P
    transmittances; a marched ray's rays, state, slot, its mask, adj, flags
    and t rows; 32 B a row; the packed words and the pooled grid once), and
    the plain version's spp_march device ms a round in the same frame."""
    grid, tb = testbed
    if grid == "empty":
        pytest.skip("no round to time")
    kernel, march_ms, counts = _profiled_frame(tb, "kernel")
    _, plain_march_ms, plain_counts = _profiled_frame(tb, "plain")
    g = tb.config.sampler.grid_size
    grids = 4 * g**3 + tb.config.sampler.n_cascades * (g // 8) ** 3
    launch_bytes = [n_in * (8 + 9 + 4 * p) + live * (40 + 9 + 8 + 2 * CHUNK + 2 + 4 * CHUNK) + 32 * rows + grids
                    for n_in, live, rows, p in counts]
    rounds = sum(1 for c in plain_counts if c[1] > 0)
    out = {
        "card": torch.cuda.get_device_name(0), "grid": grid, "launches": len(kernel),
        "kernel_ms": kernel, "kernel_ms_median": float(np.median(kernel)), "kernel_ms_frame": float(sum(kernel)),
        "bound_ms": [b / H100_BYTES_S * 1e3 for b in launch_bytes],
        "bound_ms_frame": sum(launch_bytes) / H100_BYTES_S * 1e3, "bytes_frame": sum(launch_bytes),
        "spp_march_ms_kernel": march_ms, "spp_march_ms_plain": plain_march_ms,
        "plain_ms_round": plain_march_ms / max(rounds, 1), "rounds_plain": rounds,
        "counts": counts,
    }
    print(json.dumps(out))
    path = Path("build") / "cover_march_timing.json"
    path.parent.mkdir(exist_ok=True)
    seen = json.loads(path.read_text()) if path.exists() else {}
    seen[grid] = out
    path.write_text(json.dumps(seen, indent=1))
    assert len(kernel) == len(counts) > 1 and sum(kernel) > 0.0
    assert march_ms >= sum(kernel)
