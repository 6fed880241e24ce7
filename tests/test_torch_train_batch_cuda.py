"""Card tests of the training batch kernels (csrc/train_batch.cu: train_march
and train_emit): on the card, generate_training_batch through the kernels
against its plain path on the same tensors, every field bit for bit, at the
training cells' shape, with the two-level march off, at the probe's shape and
for a data-parallel shard, on a blob grid, a dense grid and a grid of
one-cell slabs; the march alone on rays one float32 ulp under cell faces; a
batch replayed from a CUDA graph; and a captured training call's launches.
The same for the large-scene configuration (aabb_scale 16: five cascades;
the cone lattice dt = t/256, and the arithmetic lattice over the cascades):
the batch on the blob, dense and slab grids and on one with occupied boxes in
every cascade, rays crossing every cascade and one ulp under the faces of
each, a graph replay, and a captured call's launches and cascade counters.
Each test skips without a card. The file imports torch, numpy and
ngp_tpu_torch only, so on a machine with a card (where jax is not installed)
it runs from the repository root as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_train_batch_cuda.py -q
"""

import gc

import numpy as np
import pytest
import torch

from ngp_tpu_torch.grid import occupancy as occ_mod
from ngp_tpu_torch.grid.occupancy import packed_neighborhood, pooled_occupancy
from ngp_tpu_torch.sampling import training
from ngp_tpu_torch.sampling.lattice import (
    SEG,
    coarse_segment_mask,
    count_samples,
    count_samples_segments,
    n_lattice_points,
    occupied_window_start,
)
from ngp_tpu_torch.utils import profiling
from ngp_tpu_torch.utils.aabb import AABB
from ngp_tpu_torch.utils.config import NGPConfig

pytestmark = pytest.mark.cuda

# the training cells' shape: (n_rays, capacity, s_pad, n_window, s_short, n_long, n_seg_cap)
CELL = (10240, 1 << 18, 512, 1152, 32, 2560, 96)
SHAPES = {
    "cell": dict(shape=CELL),
    "single_level": dict(shape=CELL[:6] + (0,)),
    "probe": dict(shape=(1024, 1024, 32, 1152, 0, 0, 0), want_seg_stat=True),
    "shard": dict(shape=CELL, index_offset=CELL[0], stride_denom=2 * CELL[0]),
}
GRIDS = ("blob", "dense", "slabs")
FIELDS = ("rays_o", "rays_d", "rgba", "ray_valid", "sel_long", "valid_long", "valid_short", "pos", "dirs", "dt_pad",
          "dt_pad_long", "n_samples", "max_ray_count", "count_at_split", "seg_count_hi", "image_index", "xy")


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the batch kernels have no CPU mode")
    return torch.device("cuda")


# ngp-aabb16-oadd's sampler (portbench/configs/ngp-aabb16-oadd.json) and its
# arithmetic-lattice twin
AABB16 = {"aabb_scale": 16, "cone_angle_constant": 0.00390625}
AABB16_ARITH = {"aabb_scale": 16}
# the large-scene cell's shapes: the loop's window is ignored on the cone
# lattice, which marches whole (1,664 points). "cell" is aabb16-oadd-train-800's
# checked step shape on an H100 (n_rays, capacity, s_pad, n_window, s_short,
# n_long, n_seg_cap)
AABB16_CELL_SHAPE = (24576, 1 << 18, 256, 1664, 32, 6144, 0)
CONE_SHAPES = {
    "cell": dict(shape=AABB16_CELL_SHAPE, scale=1.0),
    "rays_8192": dict(shape=(8192, 1 << 18, 256, 1664, 64, 2048, 0), scale=1.0),
    "single_bucket": dict(shape=(4096, 1 << 18, 512, 512, 0, 0, 0), scale=1.0),
    "probe": dict(shape=(1024, 1024, 32, 1664, 0, 0, 0), want_seg_stat=True, scale=1.0),
    "near_cameras": dict(shape=(8192, 1 << 18, 256, 1664, 64, 2048, 0), scale=0.33),
}
ARITH_SHAPES = {
    "cell": dict(shape=(4096, 1 << 18, 512, 4096, 64, 1024, 96), scale=1.0),
    "single_level": dict(shape=(4096, 1 << 18, 512, 4096, 64, 1024, 0), scale=1.0),
}


def _cfg(**sampler):
    return NGPConfig.from_json({"samlper": sampler}).sampler  # base.json's sampler: grid 128, 1024 steps


def _scene(card, n_images=16, size=100, seed=0, scale=0.33):
    """Cameras on a ring of radius 4 (times `scale` in the scene's units) around the scene, random fp16 images."""
    from ngp_tpu_torch.data.synthetic import look_at_pose
    from ngp_tpu_torch.utils.camera import opengl_to_opencv

    rng = np.random.default_rng(seed)
    poses = []
    for k in range(n_images):
        phi = 2.4 * k
        eye = 4.0 * np.array([np.cos(phi) * 0.8, np.sin(phi) * 0.8, 0.3 + 0.5 * np.sin(1.3 * k)])
        poses.append(look_at_pose(eye))
    xforms = opengl_to_opencv(np.stack(poses), scale, [0.5, 0.5, 0.5]).to(card)
    images = torch.from_numpy(rng.uniform(0, 1, (n_images, size, size, 4)).astype(np.float16)).to(card)
    focal = 0.5 * size / np.tan(0.5 * 0.6911112070083618)
    return images, xforms, (focal, focal)


def _grid(cfg, kind: str, card):
    """The occupancy grid and its occupied box after update_occupancy of a
    density: three soft blobs, everything, or cascade-0 slabs one cell thick
    at every even x (y in [16, 112)), so many lattice points lie within a
    cell of a face between an occupied and an empty cell; "cascades": the
    blobs and, in every outer cascade, random boxes and such slabs on half
    of its x range."""
    g = cfg.grid_size
    ax = (np.arange(g) + 0.5) / g
    z, y, x = np.meshgrid(ax, ax, ax, indexing="ij")
    dens = np.zeros((cfg.n_cascades, g, g, g), np.float32)
    if kind == "blob":
        rng = np.random.default_rng(3)
        for _ in range(3):
            c = rng.uniform(0.35, 0.65, 3)
            dens[0] += np.exp(-(((x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2) / 0.01)).astype(np.float32)
    elif kind == "dense":
        dens[:] = 1.0
    elif kind == "cascades":
        rng = np.random.default_rng(7)
        for _ in range(3):
            c = rng.uniform(0.35, 0.65, 3)
            dens[0] += np.exp(-(((x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2) / 0.01)).astype(np.float32)
        yi, xi = np.meshgrid(np.arange(g), np.arange(g), indexing="ij")
        for k in range(1, cfg.n_cascades):
            for _ in range(6):
                lo, w = rng.integers(0, g - 24, 3), rng.integers(2, 24, 3)
                dens[k, lo[2] : lo[2] + w[2], lo[1] : lo[1] + w[1], lo[0] : lo[0] + w[0]] = 1.0  # axes (z, y, x)
            dens[k][: g // 2, (yi >= 8) & (yi < g - 8) & (xi % 2 == 0) & (xi < g // 2)] = 1.0
    else:
        yi, xi = np.meshgrid(np.arange(g), np.arange(g), indexing="ij")
        dens[0][:, (yi >= 16) & (yi < 112) & (xi % 2 == 0)] = 1.0  # axes (z, y, x)
    state = occ_mod.create_grid_state(cfg, device=card)._replace(density=torch.from_numpy(dens.reshape(-1)).to(card))
    state = occ_mod.update_occupancy(cfg, state)
    return state.occupancy, state.occ_aabb


def _args(cfg, card, grid, spec, seed=5):
    images, xforms, focal = _scene(card, seed=seed, scale=spec.get("scale", 0.33))
    occ, box = _grid(cfg, grid, card)
    n_rays, capacity, s_pad, n_window, s_short, n_long, n_seg_cap = spec["shape"]
    salts = torch.tensor([0x9E3779B9 ^ seed, 12345 + seed], dtype=torch.int64, device=card)
    shift = torch.tensor(2**32 - 77 + seed, dtype=torch.int64, device=card)
    pos = (cfg, AABB.scene(cfg.aabb_scale), images, xforms, focal, (0.5, 0.5), occ, salts, n_rays, shift, capacity, s_pad)
    kw = dict(stride_denom=spec.get("stride_denom", 0), index_offset=spec.get("index_offset", 0), occ_aabb=box,
              n_window=n_window, s_short=s_short, n_long=n_long, n_seg_cap=n_seg_cap,
              want_seg_stat=spec.get("want_seg_stat", False))
    return pos, kw


def _plain(pos, kw):
    """The plain path on the same (card) tensors."""
    return training._batch(*pos, kw["stride_denom"], kw["index_offset"], kw["occ_aabb"], kw["n_window"], kw["s_short"],
                           kw["n_long"], kw["n_seg_cap"], kw["want_seg_stat"], False)


def _assert_same(got, want):
    for name in FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert torch.equal(a, b), f"{name}: {int((a != b).sum())} of {a.numel()} differ"
    for lay in ("layout", "layout_long"):
        a, b = getattr(got, lay), getattr(want, lay)
        assert (a is None) == (b is None), lay
        if a is not None:
            for name in a._fields:
                assert torch.equal(getattr(a, name), getattr(b, name)), f"{lay}.{name}"


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_batch_kernels_equal_plain(card, shape, grid):
    """Every field of the kernels' batch equals the plain path's, bit for bit;
    one train_march and one train_emit launch, no plain count."""
    cfg = _cfg()
    pos, kw = _args(cfg, card, grid, SHAPES[shape])
    assert training.batch_kernels_take(cfg, kw["occ_aabb"], kw["n_window"], card)
    before = {k: profiling.get(k) for k in ("launches.train_march", "launches.train_emit", "train.batch.plain")}
    got = training.generate_training_batch(*pos, **kw)
    torch.cuda.synchronize()
    after = {k: profiling.get(k) for k in before}
    assert after["launches.train_march"] - before["launches.train_march"] == 1
    assert after["launches.train_emit"] - before["launches.train_emit"] == 1
    assert after["train.batch.plain"] == before["train.batch.plain"]
    want = _plain(pos, kw)
    assert int(want.n_samples) > 0
    if shape != "single_level":
        assert int(want.seg_count_hi) > 0
    _assert_same(got, want)


def _face_rays(cfg, card):
    """Rays along +y and +z at x one float32 ulp under the cell faces k/G,
    every third k, through a few cell centres of the other axis, then random
    rays through the scene: (o, d) on the card and the number of face rays."""
    g = cfg.grid_size
    o, d = [], []
    for k in range(1, g, 3):
        x0 = np.nextafter(np.float32(k / g), np.float32(0.0))
        for c in (20, 47, 64, 90):
            z0 = (c + 0.5) / g
            o += [(x0, -0.3, z0), (x0, z0, -0.3)]
            d += [(0.0, 1.0, 0.0), (0.0, 0.0, 1.0)]
    rng = np.random.default_rng(11)
    src = rng.normal(size=(512, 3))
    src = 0.5 + 2.5 * src / np.linalg.norm(src, axis=1, keepdims=True)
    dst = rng.uniform(0.3, 0.7, (512, 3))
    dirs = (dst - src) / np.linalg.norm(dst - src, axis=1, keepdims=True)
    o = np.concatenate([np.asarray(o, np.float32), src.astype(np.float32)])
    d = np.concatenate([np.asarray(d, np.float32), dirs.astype(np.float32)])
    return torch.from_numpy(o).to(card), torch.from_numpy(d).to(card), o.shape[0] - src.shape[0]


@pytest.mark.parametrize("seg_cap", [0, 96, 200])
def test_march_on_cell_faces(card, seg_cap):
    """train_march alone against the plain march on rays one ulp under cell
    faces of the slab grid: the same counts, coarse counts and left-justified
    lattice ordinals (the plain path's row sort of its masks)."""
    cfg = _cfg()
    aabb = AABB.scene(1)
    occ, box = _grid(cfg, "slabs", card)
    o, d, n_face = _face_rays(cfg, card)
    tmin, tmax = aabb.ray_intersect(o, d)
    tmin = torch.clamp(tmin, min=cfg.near_distance)
    jitter = torch.linspace(0.0, 0.999, o.shape[0], device=card)
    startt = tmin + cfg.min_cone_stepsize * jitter
    hits = tmin < tmax
    n_window = n_lattice_points(cfg)
    n_seg = n_window // SEG
    k0 = occupied_window_start(box, o, d, startt, cfg.min_cone_stepsize, n_window)
    s_pad = 256
    counts, lat_pad, seg_counts = training.train_march(cfg, aabb, occ, o, d, startt, k0, hits, n_window, seg_cap, s_pad,
                                                       True)
    packed = packed_neighborhood(cfg, occ)
    cmask = coarse_segment_mask(cfg, pooled_occupancy(cfg, occ), o, d, startt, n_seg, k0) & hits[:, None]
    if seg_cap:
        seg_idx = torch.sort(torch.where(cmask, torch.arange(n_seg, device=card)[None, :], n_seg), dim=1).values
        want_counts, masks, lat = count_samples_segments(cfg, aabb, occ, o, d, startt, k0, seg_idx[:, :seg_cap], packed=packed)
        sentinel = (n_seg + 1) * SEG
    else:
        want_counts, masks = count_samples(cfg, aabb, occ, o, d, startt, return_masks=True, k0=k0, n_window=n_window,
                                           packed=packed)
        lat, sentinel = torch.arange(n_window, device=card)[None, :], n_window
    masks = masks & hits[:, None]
    want_counts = torch.where(hits, want_counts, 0)
    want_lat = torch.sort(torch.where(masks, lat, sentinel), dim=1).values[:, :s_pad]
    assert int(want_counts[:n_face].sum()) > 1000  # the face rays sample the slabs
    assert torch.equal(counts, want_counts)
    assert torch.equal(seg_counts, cmask.sum(dim=1))
    assert torch.equal(lat_pad.to(torch.int64), want_lat)


def test_batch_replayed_from_graph(card):
    """A batch captured in a CUDA graph and replayed with new salts and ray
    shift equals the plain path's eager batch for those draws."""
    cfg = _cfg()
    pos, kw = _args(cfg, card, "blob", SHAPES["cell"])
    salts, shift = pos[7].clone(), pos[9].clone()
    captured = pos[:7] + (salts,) + pos[8:9] + (shift,) + pos[10:]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        training.generate_training_batch(*captured, **kw)  # warm: the library loads outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = training.generate_training_batch(*captured, **kw)
    for k in range(3):
        new_salts = torch.tensor([1000 + 17 * k, 0xDEADBEEF - k], dtype=torch.int64, device=card)
        new_shift = torch.tensor(999 * k, dtype=torch.int64, device=card)
        salts.copy_(new_salts)
        shift.copy_(new_shift)
        graph.replay()
        torch.cuda.synchronize()
        want = _plain(pos[:7] + (new_salts,) + pos[8:9] + (new_shift,) + pos[10:], kw)
        _assert_same(got, want)


def test_train_call_launches_and_batch(card, tmp_path):
    """A base.json training call captured and replayed launches train_march
    and train_emit once a step each and never takes the plain path; its
    steps' batch statistics equal the same steps run eagerly."""
    from ngp_tpu_torch import Testbed
    from ngp_tpu_torch.data.synthetic import write_synthetic_dataset
    from ngp_tpu_torch.train.trainer import STAT_KEYS

    # a Testbed an earlier test dropped lives on in a reference cycle, its
    # captured graphs with it, until the cyclic collector runs; run inside a
    # capture here, that destroys graphs mid-capture and invalidates it
    # (torch.cuda.graph no longer collects before a capture)
    gc.collect()
    train_json, _ = write_synthetic_dataset(tmp_path, n_train=8, n_test=1, width=64, height=64, device="cuda")
    tb = Testbed()
    tb.load_model_config_dict({})
    tb.load_training_data(train_json)
    for _ in range(4):
        tb.train(16, 1 << 16)
    tr, loop = tb._trainer, tb._loop
    ds = loop.dataset
    n_rays, capacity, s_pad, n_window, s_short, n_long, n_seg_cap, _ = loop._last_shape
    n = 8
    table = torch.from_numpy(tr.draw_table(torch.Generator().manual_seed(7), n, 4321, n_rays)).to(card)
    graphed = torch.zeros((n, len(STAT_KEYS)), dtype=torch.float64, device=card)
    eager = torch.zeros_like(graphed)
    call = tr.train_call(n_rays, capacity, s_pad, n, n_window, s_short, n_long, n_seg_cap)
    plain0 = profiling.get("train.batch.plain")
    call(ds, table, graphed)  # the capture, then the first replay
    assert call.graph is not None
    assert call.launches["train_march"] == n and call.launches["train_emit"] == n
    march0, emit0 = profiling.get("launches.train_march"), profiling.get("launches.train_emit")
    call(ds, table, graphed)
    torch.cuda.synchronize()
    assert profiling.get("launches.train_march") - march0 == n
    assert profiling.get("launches.train_emit") - emit0 == n
    step = tr.train_step(n_rays, capacity, s_pad, n_window, s_short, n_long, n_seg_cap)
    for k in range(n):
        step(ds, table[k], eager[k])
    torch.cuda.synchronize()
    assert profiling.get("train.batch.plain") == plain0
    # the batch's statistics depend on the grid and the draws only
    cols = [STAT_KEYS.index(k) for k in ("measured_batch_size_before_compaction", "max_ray_count", "count_at_split",
                                         "seg_count_hi")]
    assert torch.equal(graphed[:, cols], eager[:, cols])
    assert bool((graphed[:, cols[0]] > 0).all())


def _launch_and_compare(card, cfg, pos, kw, counters=None):
    """The kernels' batch (one launch of each kernel, no plain count) against
    the plain path's on the same tensors: (kernels' batch, plain batch)."""
    assert training.batch_kernels_take(cfg, kw["occ_aabb"], kw["n_window"], card)
    before = {k: profiling.get(k) for k in ("launches.train_march", "launches.train_emit", "train.batch.plain")}
    got = training.generate_training_batch(*pos, **kw, counters=counters)
    torch.cuda.synchronize()
    after = {k: profiling.get(k) for k in before}
    assert after["launches.train_march"] - before["launches.train_march"] == 1
    assert after["launches.train_emit"] - before["launches.train_emit"] == 1
    assert after["train.batch.plain"] == before["train.batch.plain"]
    want = _plain(pos, kw)
    _assert_same(got, want)
    return got, want


@pytest.mark.parametrize("grid", GRIDS + ("cascades",))
@pytest.mark.parametrize("shape", list(CONE_SHAPES))
def test_cone_batch_kernels_equal_plain(card, shape, grid):
    """ngp-aabb16-oadd's batch (the cone lattice over five cascades): every
    field of the kernels' batch equals the plain path's, bit for bit (dt_pad
    and dt_pad_long included); the march's counters add up to the batch's
    samples and its rays."""
    cfg = _cfg(**AABB16)
    assert cfg.n_cascades == 5 and training.march_mode(cfg) == training.CONE
    pos, kw = _args(cfg, card, grid, CONE_SHAPES[shape])
    counters = training.MarchCounters(card)
    got, want = _launch_and_compare(card, cfg, pos, kw, counters)
    assert int(want.n_samples) > 0 and want.dt_pad is not None
    totals = counters.totals.tolist()
    assert totals[0] == CONE_SHAPES[shape]["shape"][0]
    assert sum(totals[3:]) == int(want.n_samples)
    assert totals[2] >= sum(totals[3:])
    if grid in ("dense", "cascades") and CONE_SHAPES[shape]["scale"] == 1.0:
        # rays from outside cascade 2 cross the outer cascades' occupied cells
        assert sum(v > 0 for v in totals[3:8]) >= 3, totals


@pytest.mark.parametrize("grid", ("blob", "cascades", "slabs"))
@pytest.mark.parametrize("shape", list(ARITH_SHAPES))
def test_cascade_batch_kernels_equal_plain(card, shape, grid):
    """aabb_scale 16 on the arithmetic lattice (per-point cascades, the coarse
    pass at each segment's own mip): the kernels' batch equals the plain one."""
    cfg = _cfg(**AABB16_ARITH)
    assert training.march_mode(cfg) == training.CASCADE
    pos, kw = _args(cfg, card, grid, ARITH_SHAPES[shape])
    _, want = _launch_and_compare(card, cfg, pos, kw)
    assert int(want.n_samples) > 0
    if ARITH_SHAPES[shape]["shape"][6]:
        assert int(want.seg_count_hi) > 0


def _cascade_face_rays(cfg, card):
    """Rays along +y and +z, from inside the scene box, at x one float32 ulp
    under faces of every cascade's cells (x = 0.5 + (k / G - 0.5) 2^c), the
    other coordinate through a few cell centres, then random rays: (o, d) on
    the card and the number of face rays."""
    g = cfg.grid_size
    lo = 0.5 - 0.5 * cfg.aabb_scale + 0.05
    o, d = [], []
    for c in range(cfg.n_cascades):
        w = float(1 << c)
        for k in range(1, g, 9):
            x0 = np.nextafter(np.float32(0.5 + (k / g - 0.5) * w), np.float32(-np.inf))
            for cc in (20, 47, 90):
                z0 = np.float32(0.5 + ((cc + 0.5) / g - 0.5) * w)
                o += [(x0, lo, z0), (x0, z0, lo)]
                d += [(0.0, 1.0, 0.0), (0.0, 0.0, 1.0)]
    rng = np.random.default_rng(12)
    src = rng.normal(size=(512, 3))
    src = 0.5 + rng.uniform(0.3, 7.0, (512, 1)) * src / np.linalg.norm(src, axis=1, keepdims=True)
    dst = rng.uniform(-1.0, 2.0, (512, 3))
    dirs = (dst - src) / np.linalg.norm(dst - src, axis=1, keepdims=True)
    o = np.concatenate([np.asarray(o, np.float32), src.astype(np.float32)])
    d = np.concatenate([np.asarray(d, np.float32), dirs.astype(np.float32)])
    return torch.from_numpy(o).to(card), torch.from_numpy(d).to(card), o.shape[0] - src.shape[0]


@pytest.mark.parametrize("grid", ("slabs", "cascades"))
def test_cone_march_on_cell_faces(card, grid):
    """train_march alone on the cone lattice against the plain march on rays
    one ulp under cell faces of every cascade: the same counts and
    left-justified lattice ordinals."""
    from ngp_tpu_torch.sampling.lattice import cone_anchors, lattice_dt

    cfg = _cfg(**AABB16)
    aabb = AABB.scene(cfg.aabb_scale)
    occ, box = _grid(cfg, grid, card)
    o, d, n_face = _cascade_face_rays(cfg, card)
    tmin, tmax = aabb.ray_intersect(o, d)
    tmin = torch.clamp(tmin, min=cfg.near_distance)
    jitter = torch.linspace(0.0, 0.999, o.shape[0], device=card)
    startt = tmin + lattice_dt(cfg, tmin) * jitter
    hits = tmin < tmax
    n_window = n_lattice_points(cfg)
    k0 = torch.zeros_like(hits, dtype=torch.int64)
    anchors = torch.stack(cone_anchors(cfg, startt), dim=-1).contiguous()
    s_pad = 512
    counters = training.MarchCounters(card)
    counts, lat_pad, seg_counts = training.train_march(cfg, aabb, occ, o, d, startt, k0, hits, n_window, 0, s_pad,
                                                       False, box, anchors, counters)
    want_counts, masks = count_samples(cfg, aabb, occ, o, d, startt, return_masks=True, k0=k0, n_window=n_window)
    masks = masks & hits[:, None]
    want_counts = torch.where(hits, want_counts, 0)
    want_lat = torch.sort(torch.where(masks, torch.arange(n_window, device=card)[None, :], n_window), dim=1).values
    assert int(want_counts[:n_face].sum()) > 1000  # the face rays sample the cascades' slabs
    assert seg_counts is None
    assert torch.equal(counts, want_counts)
    assert torch.equal(lat_pad.to(torch.int64), want_lat[:, :s_pad])
    totals = counters.totals.tolist()
    assert sum(totals[3:]) == int(want_counts.sum()) and totals[0] == o.shape[0]
    # samples in every cascade where every cascade holds occupied cells of its own
    assert sum(v > 0 for v in totals[3:8]) >= (5 if grid == "cascades" else 2), totals


def test_cone_batch_replayed_from_graph(card):
    """A cone-lattice batch captured in a CUDA graph and replayed with new
    salts and ray shift equals the plain path's eager batch for those draws;
    each replay adds its march's counts."""
    cfg = _cfg(**AABB16)
    pos, kw = _args(cfg, card, "cascades", CONE_SHAPES["cell"])
    salts, shift = pos[7].clone(), pos[9].clone()
    captured = pos[:7] + (salts,) + pos[8:9] + (shift,) + pos[10:]
    counters = training.MarchCounters(card)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        training.generate_training_batch(*captured, **kw, counters=counters)  # warm, outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = training.generate_training_batch(*captured, **kw, counters=counters)
    for k in range(3):
        new_salts = torch.tensor([2000 + 31 * k, 0xCAFEF00D - k], dtype=torch.int64, device=card)
        new_shift = torch.tensor(777 * k + 5, dtype=torch.int64, device=card)
        salts.copy_(new_salts)
        shift.copy_(new_shift)
        before = counters.totals.clone()
        graph.replay()
        torch.cuda.synchronize()
        want = _plain(pos[:7] + (new_salts,) + pos[8:9] + (new_shift,) + pos[10:], kw)
        _assert_same(got, want)
        added = (counters.totals - before).tolist()
        assert added[0] == CONE_SHAPES["cell"]["shape"][0] and sum(added[3:]) == int(want.n_samples)


def test_cone_train_call_launches_and_counters(card, tmp_path):
    """A large-scene (ngp-aabb16-oadd's sampler) training call captured and
    replayed launches train_march and train_emit once a step each, never
    takes the plain path, and reads the march's counters with its stats: the
    samples by cascade add up to the steps' generated samples."""
    from ngp_tpu_torch import Testbed
    from ngp_tpu_torch.data.synthetic import write_synthetic_dataset
    from ngp_tpu_torch.sampling.training import MARCH_COUNTERS
    from ngp_tpu_torch.train.trainer import STAT_KEYS

    gc.collect()  # see test_train_call_launches_and_batch
    train_json, _ = write_synthetic_dataset(tmp_path, n_train=8, n_test=1, width=64, height=64, device="cuda")
    tb = Testbed()
    tb.load_model_config_dict({"samlper": AABB16, "network": {"encoding": {"per_level_scale": 1.66248}}})
    tb.load_training_data(train_json)
    plain0 = profiling.get("train.batch.plain")
    for _ in range(4):
        tb.train(16, 1 << 16)
    assert profiling.get("train.batch.plain") == plain0
    tr, loop = tb._trainer, tb._loop
    n_rays, capacity, s_pad, n_window, s_short, n_long, n_seg_cap, _ = loop._last_shape
    n = 8
    table = torch.from_numpy(tr.draw_table(torch.Generator().manual_seed(9), n, 1234, n_rays)).to(card)
    out = torch.zeros((n, len(STAT_KEYS)), dtype=torch.float64, device=card)
    call = tr.train_call(n_rays, capacity, s_pad, n, n_window, s_short, n_long, n_seg_cap)
    call(ds := loop.dataset, table, out)  # the capture, then the first replay
    assert call.graph is not None
    assert call.launches["train_march"] == n and call.launches["train_emit"] == n
    tr.march_counters.stage()
    torch.cuda.synchronize()
    tr.march_counters.count()
    before = {k: profiling.get(k) for k in MARCH_COUNTERS + ("launches.train_march",)}
    call(ds, table, out)
    tr.march_counters.stage()
    torch.cuda.synchronize()
    tr.march_counters.count()
    delta = {k: profiling.get(k) - before[k] for k in before}
    assert delta["launches.train_march"] == n
    samples = sum(delta[f"train.batch.samples.mip{k}"] for k in range(training.MAX_CASCADES))
    assert samples == int(out[:, STAT_KEYS.index("measured_batch_size_before_compaction")].sum())
    assert delta["train.batch.rays"] == n * n_rays and delta["train.batch.lat_slots"] == n * n_rays * s_pad
    assert delta["train.batch.points"] > samples > 0
    assert profiling.get("train.batch.plain") == plain0
    # a train() call reads the counters at its stats' sync
    pts = profiling.get("train.batch.points")
    tb.train(16, 1 << 16)
    assert profiling.get("train.batch.points") > pts


def test_a_shape_the_controllers_return_to_replays_at_once(card, tmp_path, monkeypatch):
    """On the cone lattice's model, a call whose shape is not the last
    call's but whose captured call is cached replays that graph at once (no
    eager call, no new capture); a shape with no cached call runs eagerly."""
    from ngp_tpu_torch import Testbed
    from ngp_tpu_torch.data.synthetic import write_synthetic_dataset

    gc.collect()  # see test_train_call_launches_and_batch
    train_json, _ = write_synthetic_dataset(tmp_path, n_train=8, n_test=1, width=64, height=64, device="cuda")
    tb = Testbed()
    tb.load_model_config_dict({"samlper": AABB16, "network": {"encoding": {"per_level_scale": 1.66248}}})
    tb.load_training_data(train_json)
    for _ in range(3):
        tb.train(16, 1 << 16)
    loop = tb._loop
    a = loop._last_shape
    b = a._replace(s_pad=a.s_pad // 2 if a.s_pad > 64 else 2 * a.s_pad, s_short=0)
    shapes = [a, a, b, b, a, b]
    monkeypatch.setattr(loop, "_choose_shape", lambda n, commit: shapes.pop(0) if commit else shapes[0])
    seen = []
    for _ in range(6):
        captures = profiling.get("train.captures")
        tb.train(16, 1 << 16)
        seen.append((bool(tb.training_buffer.graphed), profiling.get("train.captures") - captures))
    # a replays; b runs eagerly, then is captured; back at a and at b, each replays at once
    assert seen[0][0] and seen[1:] == [(True, 0), (False, 0), (True, 1), (True, 0), (True, 0)], seen
