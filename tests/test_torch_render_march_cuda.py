"""Card tests of the spp-1 renderer's march kernel (csrc/render_march.cu via
render/march.py): base.json frames on the card, at the orbit cell's 800x800
shape and at 64x64, over four grids (empty, the procedural scene's, a random
half-occupied one, and a full one under a step cap of 200 samples with a low
density, as early in training, so that the cap cuts a ray's second round, with
its first round's samples carried, and ends it), with the kernel launch by
launch against its plain version on copies of the same inputs (the live list,
every mask row and sample row, the rays' taken and next round, the counters),
every round the frame composites against the tests' planned march
(tests/planned_march.py: segment_plan, march_round) to the bit, and whole
frames in all seven modes against the planned march's, with the same sample
and point counts; the ranks' shares of a sharded frame; one launch a round, no plain
round; the kernel's device time under the spp_march span in a profiled frame.
Each test skips without a card. The file imports torch, numpy and
ngp_tpu_torch only, so on a machine with a card (where jax is not installed)
it runs from the repository root as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_render_march_cuda.py -q
"""

import dataclasses
import gc

import numpy as np
import pytest
import torch

from ngp_tpu_torch import Testbed
from ngp_tpu_torch.data.synthetic import field_sigma_rgb
from ngp_tpu_torch.models.ngp import NGPModel
from ngp_tpu_torch.render import march as t_march
from ngp_tpu_torch.render.renderer import RENDER_MODES, camera_rays
from ngp_tpu_torch.sampling.lattice import CHUNK
from ngp_tpu_torch.utils import profiling
from ngp_tpu_torch.utils.config import SQRT3, SamplerConfig
from ngp_tpu_torch.utils.qmc import ld_random_pixel_offset
from planned_march import planned_pass

pytestmark = pytest.mark.cuda

BASE_JSON = "experiment/nerf_synthetic/config/base.json"
SHAPES = {"orbit": (800, 800), "small": (64, 64)}
GRIDS = ("empty", "scene", "half", "capped")
CAP = 200  # the capped grid's maximum_marching_steps: within a ray's second round of 128 points
# the procedural scene's placement in the unit box (data/synthetic.py's
# datasets: scale 0.33, offset 0.5)
SCENE_SCALE, SCENE_OFFSET = 0.33, 0.5


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: render_march has no CPU mode")
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


def _render(tb, shape, mode, planned: bool = False, share=slice(None)):
    """A spp-1 frame of the shape's pixel rays (render_frame's at spp 0):
    the renderer's, its march the kernel, or with `planned` the tests'
    planned march of the share -> (out, samples, points, launches, plain
    rounds)."""
    r = tb._renderer
    w, h = SHAPES[shape]
    cam = torch.as_tensor(tb.rendering_buffer.camera_matrix, dtype=torch.float32).to("cuda")
    o, d = camera_rays(cam, w, h, (float(w), float(w)), (0.5, 0.5), ld_random_pixel_offset(0).tolist())
    launches, plain = profiling.get("launches.render_march"), profiling.get("render.march.plain")
    if planned:
        out, samples, points = planned_pass(r, tb.grid.occupancy, tb.grid.occ_aabb, o, d, cam, 0, mode, share)
    else:
        assert t_march.render_march_takes(r.config.sampler, o.device)
        out = r.render_rays(tb.grid.occupancy, cam, o, d, 0, mode, occ_aabb=tb.grid.occ_aabb)
        samples, points = r.last_frame_samples, r.last_frame_points
    torch.cuda.synchronize()
    return (out, samples, points, profiling.get("launches.render_march") - launches,
            profiling.get("render.march.plain") - plain)


def _sorted_rows(rows: torch.Tensor) -> np.ndarray:
    a = rows.cpu().numpy()
    return a[np.lexsort(a.T[::-1])]


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_kernel_launches_equal_their_plain_version(testbed, shape):
    """Every launch of a Shade frame against render_march_plain on copies of
    its inputs and state."""
    grid, tb = testbed
    real = t_march.render_march
    checked = []

    def both(cfg, occupancy, pooled, a, n_in, first, thresh):
        b = t_march.Launch(*(t.clone() for t in a))
        t_march.render_march_plain(cfg, occupancy, pooled, b, n_in, first, thresh)
        real(cfg, occupancy, pooled, a, n_in, first, thresh)
        torch.cuda.synchronize()
        n_live, n_rows, n_seg = a.counts.tolist()
        assert b.counts.tolist() == [n_live, n_rows, n_seg], (grid, shape, len(checked))
        # the live list as a set, each ray's mask row, its rows and state
        k_order, p_order = torch.argsort(a.list_out[:n_live]), torch.argsort(b.list_out[:n_live])
        assert torch.equal(a.list_out[:n_live][k_order], b.list_out[:n_live][p_order])
        assert torch.equal(a.mask[:n_live][k_order], b.mask[:n_live][p_order])
        rows = []
        for x in (a, b):
            flat = x.flat[:n_rows]
            ray = x.list_out[flat // CHUNK].double()
            rows.append(_sorted_rows(torch.cat([ray[:, None], (flat % CHUNK)[:, None].double(), x.pos[:n_rows].double(),
                                                x.dirs[:n_rows].double()], dim=1)))
        np.testing.assert_array_equal(rows[0], rows[1])
        listed = a.list_in[:n_in]
        assert torch.equal(a.taken[listed], b.taken[listed]) and torch.equal(a.rnd[listed], b.rnd[listed])
        checked.append((n_in, n_live, n_rows, int((a.taken[listed] == cfg.maximum_marching_steps).sum())))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_march, "render_march", both)
        _, samples, _, _, _ = _render(tb, shape, "Shade")
    if grid != "empty":
        assert len(checked) >= 2 and samples == sum(c[2] for c in checked), checked
    if grid == "capped":
        # the cap cut rounds: rays ended at it, with no sample past it
        assert tb._renderer.config.sampler.maximum_marching_steps == CAP
        assert sum(c[3] for c in checked) > 0, checked


class _Rounds:
    """Records every round the pass composites: its rays' mask rows and its
    samples as rows (ray id, column, position, warped direction), sorted."""

    def __init__(self, mp, renderer):
        self.rounds = []
        real = renderer._composite_round

        def record(acc, r, *args):
            ray = r.ids[r.flat // CHUNK].double()
            rows = torch.cat([ray[:, None], (r.flat % CHUNK)[:, None].double(), r.pos.double(), r.dirs.double()], dim=1)
            order = torch.argsort(r.ids)
            self.rounds.append((r.ids[order].cpu(), r.mask[order].cpu(), _sorted_rows(rows)))
            return real(acc, r, *args)

        mp.setattr(renderer, "_composite_round", record)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_kernel_rounds_equal_march_round(testbed, shape):
    grid, tb = testbed
    seen = {}
    for kernel in (False, True):
        with pytest.MonkeyPatch.context() as mp:
            rec = _Rounds(mp, tb._renderer)
            _, _, _, launches, plain = _render(tb, shape, "Shade", planned=not kernel)
        seen[kernel] = rec.rounds
        if kernel:
            # one launch a round and the one that finds every ray ended
            assert plain == 0, plain
            assert launches == len(rec.rounds) + 1 or (grid == "empty" and launches == 0), (launches, len(rec.rounds))
    assert len(seen[True]) == len(seen[False]), grid
    if grid != "empty":
        assert len(seen[True]) > 1
    for k, ((ids, mask, rows), (k_ids, k_mask, k_rows)) in enumerate(zip(seen[False], seen[True])):
        assert torch.equal(k_ids, ids), (grid, shape, k)
        assert torch.equal(k_mask, mask), (grid, shape, k)
        np.testing.assert_array_equal(k_rows, rows, err_msg=f"{grid} {shape} round {k}")


@pytest.mark.parametrize("mode", RENDER_MODES)
def test_kernel_frames_equal_the_plain_path(testbed, mode):
    grid, tb = testbed
    for shape in sorted(SHAPES):
        want, samples, points, _, _ = _render(tb, shape, mode, planned=True)
        got, k_samples, k_points, launches, plain = _render(tb, shape, mode)
        assert torch.equal(got, want), (grid, mode, shape, float((got - want).abs().max()))
        assert (k_samples, k_points) == (samples, points), (grid, mode, shape)
        assert plain == 0
        if grid != "empty":
            assert samples > 0 and launches > 1 and want[..., 3].max() > 0.0


class _Rank:
    """A mesh of `size` ranks seen from `rank`, whose all-reduce keeps this
    rank's rows: the frame of one rank's share."""

    def __init__(self, rank, size):
        self.rank, self.size = rank, size

    def all_reduce_(self, tensors, op):
        pass


def test_kernel_ray_subsets_equal_the_plain_path(testbed):
    """Each of 3 ranks' frames against the planned march of the same share:
    the kernel path shares the hit rays (every size-th from the rank on),
    and the planned march here marches the rank's share of the hit rays.
    The frames are bit-equal, and the shares' samples add up to the whole
    frame's."""
    grid, tb = testbed
    r = tb._renderer
    _, samples, _, _, _ = _render(tb, "orbit", "Shade", planned=True)
    shares = []
    for rank in range(3):
        want, s_want, _, _, _ = _render(tb, "orbit", "Shade", planned=True, share=slice(rank, None, 3))
        try:
            r.mesh = _Rank(rank, 3)
            out, s, _, _, plain = _render(tb, "orbit", "Shade")
            assert plain == 0
        finally:
            r.mesh = None
        assert torch.equal(out, want), (grid, rank, float((out - want).abs().max()))
        assert s == s_want and (s > 0 or grid == "empty"), (grid, rank)
        shares.append(s)
    assert sum(shares) == samples, (grid, shares)


def test_testbed_frame_takes_the_kernel(testbed):
    """Testbed.render's spp-1 frame at the orbit shape: launches, no plain
    round, and its host syncs a round."""
    grid, tb = testbed
    tb.rendering_buffer.render_mode = "Shade"
    before = profiling.counters()
    tb.render(*SHAPES["orbit"], spp=1, to_srgb=True)
    after = profiling.counters()
    delta = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    assert delta.get("render.march.plain", 0) == 0
    assert delta.get("render.host_syncs.samples", 0) == delta.get("render.host_syncs.live_rays", 0) == 0
    assert delta.get("render.host_syncs.march", 0) == delta.get("launches.render_march", 0)
    if grid != "empty":
        assert delta["launches.render_march"] >= 2


def test_march_kernel_counts_under_the_march_span(testbed):
    """Under torch.profiler, the kernel's device time counts in the device
    time that the profiler gives the spp_march spans, as the benchmark's
    march_ms.serve reads it (the span's device_time_total)."""
    grid, tb = testbed
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, _, launches, _ = _render(tb, "small", "Shade")
        torch.cuda.synchronize()
    events = prof.events()
    kernel_us = sum(e.time_range.elapsed_us() for e in events
                    if e.device_type == DeviceType.CUDA and "render_march_kernel" in e.name)
    span_us = sum(e.device_time_total for e in events if e.device_type == DeviceType.CPU and e.name == "spp_march")
    if grid != "empty":
        assert launches > 1 and kernel_us > 0
    assert span_us >= kernel_us, (grid, launches, span_us, kernel_us)
