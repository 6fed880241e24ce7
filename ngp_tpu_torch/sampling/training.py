"""Training ray and sample generation at static shapes.

Counterpart: ngp_tpu/sampling/training.py:47-81 (TrainingBatch) and
:83-329 (generate_training_batch): per ray an image (the reference's uint32
stride pick, with wraparound), a pixel and a march-start jitter from the
pcg4d counter hash over the ray index and two u32 salts, snapped to pixel
centers; the ray is clipped to the scene box behind the near distance and
marched over the t-lattice from its occupied-window start k0 (exact
empty-space skip) for n_window points, or, with n_seg_cap, through the
two-level march (a coarse premask of 8-point segments over the halo-pooled
grid, then the fine march on the first n_seg_cap kept segments); each ray's
occupied samples are truncated to `s_pad`; with s_short and n_long the
n_long longest rays composite in a (n_long, s_pad) bucket and the rest in
(R, s_short); rays longer than their bucket or overflowing the flat sample
budget are dropped whole, and the survivors fill the flat network batch
through the flat <-> padded layout (ops/layout.py). Per-ray compaction is a
row sort of where(mask, lattice ordinal, sentinel), cut to s_pad. On the
card, where batch_kernels_take holds (every configuration given the occupied
box: the arithmetic lattice at cascade 0 or over the cascades, and the cone
lattice), two kernels of csrc/train_batch.cu take the march with its
compaction (train_march, one warp a ray, writing each ray's samples
left-justified) and the flat network inputs with the cone lattice's step
sizes (train_emit, one thread a slot or a padded sample), bit-equal to this
plain path, which runs everywhere else. train_march adds its rays, lat_pad
slots, tested points and samples by cascade into a MarchCounters buffer on
the card when it is given one.

Every shape depends only on the arguments, never on the data, and nothing
syncs with the host or copies to the card: the salts (2,) and n_rays_shift
() may be device tensors, so a training step can be captured in a CUDA
graph. `stride_denom` and `index_offset` let a data-parallel shard draw
its slice [index_offset, index_offset + n_rays) of a stride_denom-ray
global batch: the image pick divides by the global count and every per-ray
draw (image, pixel, march jitter) hashes the global ray index, so the
shards' rays are exactly the global batch's (parallel/mesh.py). Differs:
the salts are an argument (ngp_tpu draws them from a threefry key, :152);
n_lattice is computed, not passed.
"""

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ngp_tpu_torch.data.nerf_synthetic import read_rgba
from ngp_tpu_torch.grid.occupancy import packed_neighborhood, pcg4d, pooled_occupancy, static_dt_mip
from ngp_tpu_torch.ops import kernels
from ngp_tpu_torch.ops.layout import SampleLayout, build_layout
from ngp_tpu_torch.sampling.lattice import (
    SEG,
    coarse_segment_mask,
    cone_anchors,
    count_samples,
    count_samples_segments,
    lattice_dt,
    lattice_t,
    n_lattice_points,
    occupied_window_start,
    packed_march_supported,
)
from ngp_tpu_torch.utils import profiling
from ngp_tpu_torch.utils.aabb import AABB
from ngp_tpu_torch.utils.config import SamplerConfig
from ngp_tpu_torch.utils.fma import dot_fma, sqrt_rn
from ngp_tpu_torch.utils.qmc import mul32

_MASK = 0xFFFFFFFF


class TrainingBatch(NamedTuple):
    rays_o: torch.Tensor  # (R, 3)
    rays_d: torch.Tensor  # (R, 3)
    rgba: torch.Tensor  # (R, 4) premultiplied-linear target
    ray_valid: torch.Tensor  # (R,) bool, kept rays (either bucket)
    layout: SampleLayout  # short bucket: all R rays at width s_short
    layout_long: SampleLayout | None  # the n_long longest rays at width s_pad (None unbucketed)
    sel_long: torch.Tensor | None  # (n_long,) ascending ray indices of the long rows
    valid_long: torch.Tensor | None  # (n_long,) bool
    valid_short: torch.Tensor  # (R,) bool, kept rays composited in the short bucket
    pos: torch.Tensor  # (C, 3) warped network positions
    dirs: torch.Tensor  # (C, 3) warped directions
    dt_pad: torch.Tensor | None  # (R, s_short) step sizes; None when constant (c == 0)
    dt_pad_long: torch.Tensor | None  # (n_long, s_pad)
    n_samples: torch.Tensor  # () generated samples before drops
    max_ray_count: torch.Tensor  # () longest ray (the s_pad controller's signal)
    count_at_split: torch.Tensor  # () longest count outside the top n_long (the s_short controller's)
    seg_count_hi: torch.Tensor  # () p99.5 of the rays' coarse-kept segment counts (0 without the coarse pass)
    image_index: torch.Tensor  # (R,) picked image per ray
    xy: torch.Tensor  # (R, 2) normalized pixel coordinate


MAX_CASCADES = 8  # csrc/train_batch.cu's MAX_CASCADES
# train_march's counters, in the order of csrc/train_batch.cu's buffer: rays
# marched, their lat_pad slots, lattice points whose occupancy the fine march
# read, and the samples the rays take by cascade
MARCH_COUNTERS = ("train.batch.rays", "train.batch.lat_slots", "train.batch.points",
                  *(f"train.batch.samples.mip{k}" for k in range(MAX_CASCADES)))
PACKED, CASCADE, CONE = 0, 1, 2  # train_march's lattices (csrc/train_batch.cu)


class MarchCounters:
    """train_march's totals on a device (`totals`, int64, MARCH_COUNTERS'
    order), kept for the process and added to by every launch given them,
    CUDA-graph replays included, and their host copy: stage() queues the copy
    without a sync; count(), after a sync that followed it, adds each total's
    change since the last count to profiling's counters of the same name."""

    def __init__(self, device):
        device = torch.device(device)
        self.totals = torch.zeros((len(MARCH_COUNTERS),), dtype=torch.int64, device=device)
        self._host = torch.zeros((len(MARCH_COUNTERS),), dtype=torch.int64)
        if device.type == "cuda":
            self._host = self._host.pin_memory()
        self._seen = [0] * len(MARCH_COUNTERS)

    def stage(self):
        self._host.copy_(self.totals, non_blocking=True)

    def count(self):
        now = self._host.tolist()
        for name, v, seen in zip(MARCH_COUNTERS, now, self._seen, strict=True):
            if v != seen:
                profiling.count(name, v - seen)
        self._seen = now


def march_mode(cfg: SamplerConfig) -> int:
    """train_march's lattice: CONE for cone_angle_constant > 0, PACKED where
    one packed word answers a segment (packed_march_supported), else CASCADE
    (per-point cascades on the arithmetic lattice)."""
    if cfg.cone_angle_constant != 0.0:
        return CONE
    return PACKED if packed_march_supported(cfg) else CASCADE


def batch_kernels_take(cfg: SamplerConfig, occ_aabb, n_window: int, device) -> bool:
    """Whether train_march and train_emit (csrc/train_batch.cu) generate the
    batch: tensors on the card, the occupied box given (the window start k0;
    on the cone lattice, which marches whole, the span a ray walks), a window
    of whole segments whose ordinals fit lat_pad's int16, and at most
    MAX_CASCADES cascades. No occupied box and CPU tensors take the plain
    path."""
    n_lattice = n_lattice_points(cfg)
    n_window = n_lattice if cfg.cone_angle_constant != 0.0 else min(n_window or n_lattice, n_lattice)
    return (torch.device(device).type == "cuda" and occ_aabb is not None and n_window % SEG == 0
            and n_window + SEG < 1 << 15 and cfg.n_cascades <= MAX_CASCADES)


def generate_training_batch(
    cfg: SamplerConfig,
    aabb: AABB,
    images: torch.Tensor,  # (N, H, W, 4) fp16
    xforms: torch.Tensor,  # (N, 3, 4)
    focal_length,
    principal_point,
    occupancy: torch.Tensor,  # (n_cascades, G, G, G) bool
    salts,  # (2,) u32 draws
    n_rays: int,
    n_rays_shift,  # () u32
    capacity: int,
    s_pad: int,
    stride_denom: int = 0,  # the global batch's ray count (0: n_rays)
    index_offset: int = 0,  # this shard's first global ray index
    occ_aabb=None,  # (2, 3) occupied-cell box: enables the window start k0
    n_window: int = 0,
    s_short: int = 0,
    n_long: int = 0,
    n_seg_cap: int = 0,
    want_seg_stat: bool = False,
    counters: MarchCounters | None = None,
) -> TrainingBatch:
    """`occ_aabb` with `n_window` clips each ray's march to the window of
    n_window lattice points from its entry into the occupied box (the
    TrainingLoop sizes n_window from the box's diagonal). `s_short` /
    `n_long` enable the two buckets; `n_seg_cap` > 0 the two-level march
    (arithmetic lattice with the window on), which truncates a ray to its
    first n_seg_cap coarse-kept segments; `want_seg_stat` computes
    seg_count_hi without the two-level march. The march and the flat inputs
    are the two kernels where batch_kernels_take holds, else the plain path
    (counted as train.batch.plain on the card); both give the same batch.
    The kernels' march adds its counts into `counters` where given."""
    use_kernels = batch_kernels_take(cfg, occ_aabb, n_window, occupancy.device)
    if occupancy.device.type == "cuda" and not use_kernels:
        profiling.count("train.batch.plain")
    return _batch(cfg, aabb, images, xforms, focal_length, principal_point, occupancy, salts, n_rays, n_rays_shift,
                  capacity, s_pad, stride_denom, index_offset, occ_aabb, n_window, s_short, n_long, n_seg_cap,
                  want_seg_stat, use_kernels, counters)


def _batch(cfg: SamplerConfig, aabb: AABB, images, xforms, focal_length, principal_point, occupancy, salts, n_rays: int,
           n_rays_shift, capacity: int, s_pad: int, stride_denom: int, index_offset: int, occ_aabb, n_window: int,
           s_short: int, n_long: int, n_seg_cap: int, want_seg_stat: bool, use_kernels: bool,
           counters: MarchCounters | None = None) -> TrainingBatch:
    """generate_training_batch through the kernels (use_kernels) or the plain path."""
    dev = occupancy.device
    n_images, h, w = images.shape[0], images.shape[1], images.shape[2]
    n_lattice = n_lattice_points(cfg)
    n_window = min(n_window or n_lattice, n_lattice)
    s_pad = min(s_pad, n_window)  # counts never exceed the window
    salts = torch.as_tensor(salts, dtype=torch.int64, device=dev) & _MASK
    shift = torch.as_tensor(n_rays_shift, dtype=torch.int64, device=dev) & _MASK

    # image pick: uint32 stride arithmetic with wraparound (cu:348), over the
    # global ray index and the global count
    i = (torch.arange(n_rays, dtype=torch.int64, device=dev) + (int(index_offset) & _MASK)) & _MASK
    img = (mul32((i + shift) & _MASK, n_images) // (stride_denom or n_rays)) % n_images

    h0, h1, h2, _ = pcg4d(i, salts[0].expand(n_rays), salts[1].expand(n_rays), torch.full_like(i, 0x9E3779B9))
    inv24 = 1.0 / (1 << 24)
    xy = torch.stack([h0 >> 8, h1 >> 8], dim=-1).to(torch.float32) * inv24
    jitter_u = (h2 >> 8).to(torch.float32) * inv24
    if cfg.snap_to_pixel_centers_in_training:
        res = torch.cat([torch.full_like(xy[:, :1], w), torch.full_like(xy[:, :1], h)], dim=1)
        xy = (torch.minimum(torch.clamp(torch.floor(xy * res), min=0), res - 1) + 0.5) / res

    xf = xforms[img]  # (R, 3, 4)
    # float32 scalars, as JAX takes them (a Python float multiplies in float64)
    fx, fy, wf, hf = (torch.tensor(float(v), dtype=torch.float32) for v in (*focal_length, w, h))
    d_cam = torch.stack(
        [
            (xy[:, 0] - principal_point[0]) * wf / fx,
            (xy[:, 1] - principal_point[1]) * hf / fy,
            torch.ones((n_rays,), dtype=torch.float32, device=dev),
        ],
        dim=-1,
    )
    d = dot_fma(xf[:, :, :3], d_cam[:, None, :])
    d = d / sqrt_rn(dot_fma(d, d))[:, None]
    o = xf[:, :, 3]

    tmin, tmax = aabb.ray_intersect(o, d)
    tmin = torch.clamp(tmin, min=cfg.near_distance)
    dt = cfg.min_cone_stepsize
    startt = tmin + lattice_dt(cfg, tmin) * jitter_u  # march-start jitter (cu:385)
    hits = tmin < tmax

    if occ_aabb is not None and cfg.cone_angle_constant == 0.0:
        k0 = occupied_window_start(occ_aabb, o, d, startt, dt, n_lattice)
    else:
        # the window start assumes the arithmetic lattice; the cone lattice
        # marches whole
        n_window = n_lattice
        k0 = torch.zeros((n_rays,), dtype=torch.int64, device=dev)
    # the coarse premask, and/or its controller stat: one halo-pooled lookup
    # per 8-point segment, conservative for the jittered march
    coarse_ok = cfg.cone_angle_constant == 0.0 and occ_aabb is not None and n_window % SEG == 0
    seg_on = n_seg_cap > 0 and coarse_ok
    seg_count_hi = torch.zeros((), dtype=torch.int64, device=dev)
    n_seg = n_window // SEG
    k_hi = min(int(0.995 * n_rays), n_rays - 1)
    if seg_on:
        s_pad = min(s_pad, n_seg_cap * SEG)  # counts never exceed the kept width
    cone = cfg.cone_angle_constant != 0.0
    # the row sort's sentinel: the ordinal past the window (the two-level
    # march's columns past its segment past the window)
    sentinel = (n_seg + 1) * SEG if seg_on else n_window
    anchors = None
    if use_kernels:
        # the march writes each ray's samples already left-justified (lat_pad)
        coarse = coarse_ok and (seg_on or want_seg_stat)
        if cone:
            anchors = torch.stack(cone_anchors(cfg, startt), dim=-1).contiguous()  # (R, 4) iA, tA, iC, tC
        counts, lat_pad, seg_counts = train_march(cfg, aabb, occupancy, o, d, startt, k0, hits, n_window,
                                                  n_seg_cap if seg_on else 0, s_pad, coarse, occ_aabb, anchors,
                                                  counters)
        if coarse:
            seg_count_hi = torch.sort(seg_counts).values[k_hi]
    else:
        if seg_on or (want_seg_stat and coarse_ok):
            cmask = coarse_segment_mask(cfg, pooled_occupancy(cfg, occupancy), o, d, startt, n_seg, k0) & hits[:, None]
            seg_count_hi = torch.sort(cmask.sum(dim=1)).values[k_hi]

        # one packed 3^3 word answers an 8-point group's occupancy (built in-step)
        packed = packed_neighborhood(cfg, occupancy) if packed_march_supported(cfg) else None

        if seg_on:
            j_seg = torch.arange(n_seg, dtype=torch.int64, device=dev)[None, :]
            seg_idx = torch.sort(torch.where(cmask, j_seg, n_seg), dim=1).values[:, :n_seg_cap]
            counts, masks, lat_all = count_samples_segments(cfg, aabb, occupancy, o, d, startt, k0, seg_idx, packed=packed)
        else:
            counts, masks = count_samples(cfg, aabb, occupancy, o, d, startt, return_masks=True, k0=k0, n_window=n_window,
                                          packed=packed)
        masks = masks & hits[:, None]
        counts = torch.where(hits, counts, 0)
    n_samples = counts.sum()
    max_ray_count = counts.max()  # before truncation: the s_pad controller sees the tail
    counts = torch.clamp(counts, max=s_pad)  # truncate long rays (cu:408)

    bucketed = 0 < s_short < s_pad and 0 < n_long < n_rays
    if not bucketed:
        s_short = s_pad

    # whole-ray drops: zero samples, longer than the bucket, or overflowing
    # the flat budget (cu:408, cu:414-416; dropped rays keep their holes)
    if bucketed:
        # stable, as jnp.argsort: ties keep the lower ray first
        order = torch.argsort(-counts, stable=True)
        # ascending, as build_layout's rank inversion needs
        sel_long = torch.sort(order[:n_long]).values
        is_long = torch.zeros((n_rays,), dtype=torch.bool, device=dev).index_fill_(0, sel_long, True)
        count_at_split = counts[order[n_long : n_long + 1]][0]  # a 0-dim tensor index would sync
        ray_valid = (counts > 0) & torch.where(is_long, counts <= s_pad, counts <= s_short)
    else:
        sel_long = None
        is_long = torch.zeros((n_rays,), dtype=torch.bool, device=dev)
        # the longest count outside the would-be top bucket, so s_short can re-engage
        if 0 < n_long < n_rays:
            count_at_split = torch.topk(counts, n_long + 1).values[n_long]
        else:
            count_at_split = max_ray_count
        ray_valid = (counts > 0) & (counts <= s_pad)
    counts_res = torch.where(ray_valid, counts, 0)
    base = torch.cumsum(counts_res, 0) - counts_res
    ray_valid = ray_valid & (base + counts_res <= capacity)
    valid_short = ray_valid & ~is_long
    layout = build_layout(base, counts, valid_short, capacity, s_short)
    layout_long = valid_long = None
    if bucketed:
        valid_long = (ray_valid & is_long)[sel_long]
        layout_long = build_layout(base[sel_long], counts[sel_long], valid_long, capacity, s_pad)

    # flat network inputs, closed-form from the lattice ordinal k0 + j; a
    # full-width layout maps each flat slot to (ray, j)
    lay_all = build_layout(base, counts, ray_valid, capacity, s_pad) if bucketed else layout
    dt_pad = dt_pad_long = None
    if use_kernels:
        pos, flat_dirs, dt_pad, dt_pad_long = train_emit(cfg, aabb, lay_all, k0, startt, o, d, lat_pad, ray_valid,
                                                         sel_long, s_short, sentinel, anchors)
    else:
        # per-ray compaction: the occupied window ordinals ascend, so a row sort
        # of where(mask, ordinal, sentinel) left-justifies them in march order;
        # on the two-level march the columns carry their own ordinals (lat_all)
        lat_vals = lat_all if seg_on else torch.arange(n_window, dtype=torch.int64, device=dev)[None, :]
        keys = torch.where(masks & ray_valid[:, None], lat_vals, sentinel)
        lat_pad = torch.sort(keys, dim=1).values[:, :s_pad]  # (R, s_pad), k0-relative

        rid = lay_all.ray_ids
        flat_lat = torch.where(lay_all.flat_valid, k0[rid] + lat_pad[rid, lay_all.pos_in_ray], 0)
        # here XLA keeps the multiply and the add apart (no fused multiply-add)
        if cfg.cone_angle_constant == 0.0:
            flat_t = startt[rid] + flat_lat.to(torch.float32) * torch.tensor(dt, dtype=torch.float32)
        else:
            flat_t = lattice_t(cfg, startt[rid], flat_lat)
        pos = aabb.relative_pos(o[rid] + flat_t[:, None] * d[rid])
        flat_dirs = (d[rid] + 1.0) * 0.5
        if cone:
            dts = lattice_dt(cfg, lattice_t(cfg, startt[:, None], k0[:, None] + lat_pad))  # (R, s_pad)
            dt_pad = dts[:, :s_short]
            if bucketed:
                dt_pad_long = dts[sel_long]

    return TrainingBatch(
        rays_o=o,
        rays_d=d,
        rgba=read_rgba(images, xy, img),
        ray_valid=ray_valid,
        layout=layout,
        layout_long=layout_long,
        sel_long=sel_long,
        valid_long=valid_long,
        valid_short=valid_short,
        pos=pos,
        dirs=flat_dirs,
        dt_pad=dt_pad,
        dt_pad_long=dt_pad_long,
        n_samples=n_samples,
        max_ray_count=max_ray_count,
        count_at_split=count_at_split,
        seg_count_hi=seg_count_hi,
        image_index=img,
        xy=xy,
    )


# ------------------------------------------------------------------ kernels
def _library():
    lib = kernels.library("train_batch")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.train_march.argtypes = [p] * 13 + [i] * 15 + [f] * 13 + [p]
    lib.train_march.restype = ctypes.c_int
    lib.train_emit.argtypes = [p] * 15 + [ctypes.c_longlong] + [i] * 6 + [f] * 10 + [p]
    lib.train_emit.restype = ctypes.c_int
    return lib


def _require(name: str, t: torch.Tensor, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous() or t.device != device:
        raise ValueError(f"{name} must be contiguous {dtype} of shape {tuple(shape)} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _f32(v) -> float:
    """A python float as the float32 value torch takes it as."""
    return float(np.float32(v))


def _cone_constants(cfg: SamplerConfig) -> list:
    """(c, M, log1p(c)) as float32, as lattice_t and lattice_dt take them."""
    c = cfg.cone_angle_constant
    return [_f32(c), _f32(cfg.max_cone_stepsize), _f32(np.log1p(c)) if c else 0.0]


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def train_march(cfg: SamplerConfig, aabb: AABB, occupancy, o, d, startt, k0, hits, n_window: int, seg_cap: int, s_pad: int,
                coarse: bool, occ_aabb=None, anchors=None, counters: MarchCounters | None = None):
    """The march kernel (csrc/train_batch.cu) over rays (R,) from their window
    start k0, on the card: (counts (R,) int64, the samples each ray takes
    (capped at maximum_marching_steps, not at s_pad; 0 where `hits` is
    false); lat_pad (R, s_pad) int16, the k0-relative lattice ordinals of its
    first s_pad samples in march order, then the sentinel (the plain path's
    row sort); seg_counts (R,) int64, its coarse-kept segments, or None
    without the coarse pass). seg_cap > 0 marches the first seg_cap kept
    segments (count_samples_segments), 0 every segment of the window
    (count_samples); the coarse pass runs with seg_cap > 0 or `coarse`
    (constant dt only). On the cone lattice (k0 zero, the window the whole
    lattice) it takes the rays' cone_anchors (R, 4) and the occupied box
    occ_aabb (2, 3), and walks each ray only where it can reach that box.
    With `counters` it adds its counts there."""
    mode = march_mode(cfg)
    n_lattice = n_lattice_points(cfg)
    if (o.device.type != "cuda" or n_window % SEG or n_window > n_lattice or cfg.n_cascades > MAX_CASCADES
            or (mode == CONE and (n_window != n_lattice or seg_cap or coarse or occ_aabb is None or anchors is None))):
        raise ValueError("train_march takes CUDA tensors, a window of whole segments and at most "
                         f"{MAX_CASCADES} cascades; on the cone lattice the whole lattice with its anchors and "
                         "the occupied box, and no coarse pass")
    R, dev = o.shape[0], o.device
    g, nc = cfg.grid_size, cfg.n_cascades
    n_seg = n_window // SEG
    cap = min(seg_cap, n_seg)
    coarse = coarse or cap > 0
    sentinel = (n_seg + 1) * SEG if cap > 0 else n_window
    if sentinel >= 1 << 15:
        raise ValueError(f"a window of {n_window} points overflows the int16 ordinals of lat_pad")
    o = o.contiguous()
    _require("o", o, torch.float32, (R, 3), dev)
    _require("d", d, torch.float32, (R, 3), dev)
    _require("startt", startt, torch.float32, (R,), dev)
    _require("k0", k0, torch.int64, (R,), dev)
    _require("hits", hits, torch.bool, (R,), dev)
    _require("occupancy", occupancy, torch.bool, (nc, g, g, g), dev)
    if mode == CONE:
        _require("anchors", anchors, torch.float32, (R, 4), dev)
        _require("occ_aabb", occ_aabb, torch.float32, (2, 3), dev)
    if counters is not None:
        _require("counters", counters.totals, torch.int64, (len(MARCH_COUNTERS),), dev)
    counts = torch.empty((R,), dtype=torch.int64, device=dev)
    lat_pad = torch.empty((R, s_pad), dtype=torch.int16, device=dev)
    seg_counts = torch.empty((R,), dtype=torch.int64, device=dev) if coarse else None
    pooled = pooled_occupancy(cfg, occupancy) if coarse else occupancy
    # the coarse pass's constants as coarse_segment_mask's float32 tensors see
    # them: the march's static mip (0 on base.json's lattice) and the next
    # one, the mip edge's band (bound - 16 dt) and the scene cube's cut, a
    # python float compared in float32
    dt = float(cfg.min_cone_stepsize)
    mip_lo = max(static_dt_mip(dt, g, nc), 0)
    bound = np.array([(126 + mip_lo) << 23], np.int32).view(np.float32)[0]
    near = np.float32(bound - np.float32(16.0 * dt))
    cut = np.float32(0.5 * float(cfg.aabb_scale) + 8.0 * dt)
    lo, hi = [_f32(v) for v in aabb.lo], [_f32(v) for v in aabb.hi]
    err = _library().train_march(
        o.data_ptr(), d.data_ptr(), startt.data_ptr(), k0.data_ptr(), hits.data_ptr(), _ptr(anchors),
        occupancy.data_ptr(), pooled.data_ptr(), _ptr(occ_aabb if mode == CONE else None), counts.data_ptr(),
        (seg_counts if coarse else counts).data_ptr(), lat_pad.data_ptr(),
        _ptr(counters.totals if counters is not None else None),
        mode, R, g, pooled.shape[-1], nc, n_seg, cap, int(coarse), mip_lo, min(mip_lo + 1, nc - 1),
        int(cfg.aabb_scale != 1), cfg.maximum_marching_steps, s_pad, sentinel, n_lattice, _f32(dt), float(near),
        float(cut), _f32(16.0 * dt), *_cone_constants(cfg), *lo, *hi,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"train_march launch failed: CUDA error {err}")
    profiling.count("launches.train_march")
    return counts, lat_pad, seg_counts


def train_emit(cfg: SamplerConfig, aabb: AABB, layout: SampleLayout, k0, startt, o, d, lat_pad, ray_valid, sel_long,
               s_short: int, sentinel: int, anchors=None):
    """The emission kernel (csrc/train_batch.cu) of the flat network inputs
    over the layout's slots, on the card: (pos (C, 3) relative to the scene
    box, dirs (C, 3) warped, dt_pad, dt_pad_long), slot i from its ray's
    ordinal k0 + lat_pad[ray, j] (0 on an invalid slot) as the plain path
    computes it. On the cone lattice (`anchors` (R, 4) given) also the step
    sizes lattice_dt of the (R, s_short) padded samples and of the long
    bucket's rows `sel_long` (n_long,) at width s_pad, an invalid ray's
    (not `ray_valid`) at the sentinel; else dt_pad and dt_pad_long are None."""
    C, (R, s_pad), dev = layout.ray_ids.shape[0], lat_pad.shape, lat_pad.device
    cone = anchors is not None
    o = o.contiguous()
    _require("ray_ids", layout.ray_ids, torch.int64, (C,), dev)
    _require("pos_in_ray", layout.pos_in_ray, torch.int64, (C,), dev)
    _require("flat_valid", layout.flat_valid, torch.bool, (C,), dev)
    _require("k0", k0, torch.int64, (R,), dev)
    _require("startt", startt, torch.float32, (R,), dev)
    _require("o", o, torch.float32, (R, 3), dev)
    _require("d", d, torch.float32, (R, 3), dev)
    _require("lat_pad", lat_pad, torch.int16, (R, s_pad), dev)
    pos = torch.empty((C, 3), dtype=torch.float32, device=dev)
    dirs = torch.empty((C, 3), dtype=torch.float32, device=dev)
    dt_pad = dt_pad_long = None
    n_long = 0
    if cone:
        _require("anchors", anchors, torch.float32, (R, 4), dev)
        _require("ray_valid", ray_valid, torch.bool, (R,), dev)
        dt_pad = torch.empty((R, s_short), dtype=torch.float32, device=dev)
        if sel_long is not None:
            n_long = sel_long.shape[0]
            _require("sel_long", sel_long, torch.int64, (n_long,), dev)
            dt_pad_long = torch.empty((n_long, s_pad), dtype=torch.float32, device=dev)
    lo = [_f32(v) for v in aabb.lo]
    diag = [_f32(h - l) for h, l in zip(aabb.hi, aabb.lo)]  # AABB.diag_t's float32(hi - lo)
    err = _library().train_emit(
        layout.ray_ids.data_ptr(), layout.pos_in_ray.data_ptr(), layout.flat_valid.data_ptr(), k0.data_ptr(),
        startt.data_ptr(), o.data_ptr(), d.data_ptr(), lat_pad.data_ptr(), _ptr(anchors),
        _ptr(ray_valid if cone else None), _ptr(sel_long if cone else None), pos.data_ptr(), dirs.data_ptr(),
        _ptr(dt_pad), _ptr(dt_pad_long), C, R, s_pad, s_short, n_long, sentinel, int(cone),
        _f32(cfg.min_cone_stepsize), *_cone_constants(cfg), *lo, *diag, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"train_emit launch failed: CUDA error {err}")
    profiling.count("launches.train_emit")
    return pos, dirs, dt_pad, dt_pad_long
