"""The spp-1 pass's march: every round of a pass, on every device and lattice.

Counterpart: ngp_tpu's spp-1 tile marches as XLA code
(ngp_tpu/render/renderer.py's _coarse_pass and the packed
count_samples_segments; the cone lattice's whole-lattice march,
:921-932). pass_march builds the march of one spp-1 pass for the config and
the rays' device, and Renderer._render_pass composites the rounds it hands
out (Round), whatever the lattice.

On a constant-dt lattice, FrameMarch: the frame's window against the
occupied box (frame_geometry), then one launch a round, each launch taking
the live rays of the last one, dropping those that ended (the composite's
transmittance under transmittance_threshold, the step cap, the box exit, no
further round with a kept coarse segment), marching every other one to its
next round that keeps a segment, and writing the round's samples as flat
rows, the dense (L, 128) mask and the compacted live list. The host reads
one counter triple a round (live rays, rows, the frame's window in
segments), which sizes the network's evaluation. A launch is
csrc/render_march.cu's render_march where render_march_takes holds (a card
frame on the PACKED lattice), else render_march_plain, its plain version in
PyTorch with the same interface: the CPU's march, and a card's on the other
constant-dt lattices (aabb_scale > 1, or dt too coarse for one packed word
a segment), counted in render.march.plain. The kernel's live list comes in
block order, the plain version's in list order; nothing after the march
depends on it.

On the cone lattice (dt grows with t), ConeMarch: every ray that meets the
occupied box marches the whole lattice from ordinal 0, CHUNK points a round
(march_chunk, point by point), its samples compacted on the host; a card's
rounds count in render.march.plain.

The spp-n Shade frame with one shared evaluation a cover point
(Renderer._composite_shared) marches each block of its hit rays through
CoverMarch: one launch a round, each launch taking the live rays of the last
one, dropping those that ended (every pass's transmittance under
transmittance_threshold, the step cap, the box exit, no further round below
the ray's limit with a kept coarse segment), marching every other one to its
next round that keeps a segment (rounds aligned at the ray's k0), with the
cover test of each point's segment and a lookahead segment, and writing the
rows the shared evaluation takes (the samples, the lerp partner at a round's
end, less the point the last round carried in) with the dense (L, 128) mask,
lerp partners and t and the compacted live list. The host reads one counter
pair a round (live rays, rows) at sync site `cover_march`. A launch is csrc/render_cover_march.cu's render_cover_march
where cover_march_takes holds (a card frame on a jitter-cover lattice), else
render_cover_march_plain, its plain version in PyTorch with the same
interface (the CPU's march; a card's counted in render.march.plain). The
other spp-n frames (Renderer._composite_passes) march the segment plan's
rounds (segment_plan, march_round) themselves.
"""

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ngp_tpu_torch.grid.occupancy import packed_neighborhood, pooled_occupancy, static_dt_mip
from ngp_tpu_torch.ops import kernels
from ngp_tpu_torch.sampling.lattice import (
    CHUNK,
    SEG,
    coarse_segment_mask,
    jitter_cover_supported,
    march_chunk,
    n_lattice_points,
    packed_march_supported,
    ray_box_span,
    segment_points,
    window_start_inside,
)
from ngp_tpu_torch.utils import profiling
from ngp_tpu_torch.utils.aabb import AABB
from ngp_tpu_torch.utils.config import SamplerConfig

RANGE_SEGS = CHUNK // SEG  # segments of one round of the fine march (128 lattice points)
INT32_MAX = (1 << 31) - 1
# ngp_tpu composites a shared frame in rounds of D occupied samples a ray and
# lerps to the point itself at each round's last sample; on tiles of at most
# 1024 rays (small frames) every round is its last stage's D = min(256, W)
SHARE_ROUND = 256


def frame_geometry(cfg, o: torch.Tensor, d: torch.Tensor, occ_aabb: torch.Tensor):
    """Each ray's lattice window against the occupied box, as ngp_tpu's
    _rays_slab_pass: (hit (N,) bool, k0 (N,) int64, span (N,) float32).
    The box is inflated by dt + 1/G; k0 = floor((occ_lo - s_lo)/dt) - 2 and
    span = ceil((occ_hi - max(occ_lo, s_lo))/dt) + 4 lattice steps from the
    scene-box entry s_lo (>= 0.05), clipped to the lattice; XLA divides by
    the constant dt as a product with float32(1/dt)."""
    dt = cfg.min_cone_stepsize
    n_lat = n_lattice_points(cfg)
    dd = torch.where(d.abs() < 1e-12, 1e-12, d)

    def slab(lo, hi):
        t1, t2 = (lo - o) / dd, (hi - o) / dd
        return torch.amax(torch.minimum(t1, t2), dim=-1), torch.amin(torch.maximum(t1, t2), dim=-1)

    box = occ_aabb.to(device=o.device, dtype=torch.float32)
    with profiling.host_sync("render", "frame_geometry"):  # copied to the card
        margin = torch.tensor(dt + 1.0 / cfg.grid_size, dtype=torch.float32, device=o.device)
    occ_lo, occ_hi = slab(box[0] - margin, box[1] + margin)
    scene = AABB.scene(cfg.aabb_scale)
    s_lo = torch.clamp(slab(scene.lo_t(o), scene.hi_t(o))[0], min=0.05)
    with profiling.host_sync("render", "frame_geometry"):
        inv_dt = torch.tensor(1.0 / dt, dtype=torch.float32, device=o.device)
    k0 = torch.clamp(torch.floor((occ_lo - s_lo) * inv_dt) - 2.0, 0.0, float(n_lat))
    start = torch.maximum(occ_lo, s_lo)
    span = torch.minimum(torch.clamp(torch.ceil((occ_hi - start) * inv_dt) + 4.0, min=0.0), n_lat - k0)
    return (occ_hi >= start) & (span > 0), k0.to(torch.int64), span


def render_march_takes(cfg: SamplerConfig, device) -> bool:
    """Whether a spp-1 pass marches through render_march: tensors on the
    card, the PACKED lattice (packed_march_supported: constant dt,
    aabb_scale 1 and one packed word a segment), and ordinals, rounds and
    sample counts within the kernel's int32 indices."""
    return torch.device(device).type == "cuda" and packed_march_supported(cfg) and _int32_ranges(cfg)


def _int32_ranges(cfg: SamplerConfig) -> bool:
    """Ordinals, rounds and sample counts within the march kernels' int32 indices."""
    return n_lattice_points(cfg) + CHUNK <= INT32_MAX and cfg.maximum_marching_steps <= INT32_MAX


class Launch(NamedTuple):
    """One launch's tensors. The frame's rays by ray id: o, d (N, 3), t0 and
    startt (N,) the unjittered and jittered march starts, k0 (N,) int64 window
    starts, trans (N,) the transmittance after each ray's last composited
    round, taken and rnd (N,) int32, the state the launch reads (after the
    first) and writes. n_seg () int64, the frame's window in segments. The
    launch reads list_in[:n_in] and writes list_out, mask (n_in, 128) bool,
    flat (n_in * 128,) int64, pos and dirs (n_in * 128, 3) float32 from row 0
    on, and counts (3,) int64: live rays, rows, n_seg; counts must be zero."""

    o: torch.Tensor
    d: torch.Tensor
    t0: torch.Tensor
    startt: torch.Tensor
    k0: torch.Tensor
    trans: torch.Tensor
    taken: torch.Tensor
    rnd: torch.Tensor
    n_seg: torch.Tensor
    list_in: torch.Tensor
    list_out: torch.Tensor
    mask: torch.Tensor
    flat: torch.Tensor
    pos: torch.Tensor
    dirs: torch.Tensor
    counts: torch.Tensor


def _library():
    lib = kernels.library("render_march")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.render_march.argtypes = [p] * 18 + [i] * 9 + [f] * 10 + [p]
    lib.render_march.restype = ctypes.c_int
    return lib


def _f32(v) -> float:
    """A python float as the float32 value torch takes it as."""
    return float(np.float32(v))


def _check(dev, specs, n_in: int, R: int):
    """Raise unless every (name, tensor, dtype, shape or None) of `specs` is
    contiguous on `dev` with that dtype and shape, and 0 < n_in <= R."""
    for name, t, dtype, shape in specs:
        if t.dtype != dtype or (shape is not None and tuple(t.shape) != shape) or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{name} must be contiguous {dtype} of shape {shape} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if not 0 < n_in <= R:
        raise ValueError(f"n_in {n_in} outside the list's 1..{R}")


def _coarse_constants(cfg: SamplerConfig, pooled) -> tuple:
    """The march kernels' grid and coarse-pass arguments: grid, pooled_res,
    the static mip and the next, dt, and the mip edge's band and the scene
    cube's cut as coarse_segment_mask's float32 tensors see them (train_march's)."""
    dt = float(cfg.min_cone_stepsize)
    g, nc = cfg.grid_size, cfg.n_cascades
    mip_lo = max(static_dt_mip(dt, g, nc), 0)
    bound = np.array([(126 + mip_lo) << 23], np.int32).view(np.float32)[0]
    near = np.float32(bound - np.float32(16.0 * dt))
    cut = np.float32(0.5 * float(cfg.aabb_scale) + 8.0 * dt)
    return g, pooled.shape[-1], mip_lo, min(mip_lo + 1, nc - 1), _f32(dt), float(near), float(cut)


def _box(cfg: SamplerConfig) -> list:
    """The scene box's lo and hi corners as float32 values."""
    aabb = AABB.scene(cfg.aabb_scale)
    return [_f32(v) for v in (*aabb.lo, *aabb.hi)]


def render_march(cfg: SamplerConfig, occupancy, pooled, a: Launch, n_in: int, first: bool, thresh: float):
    """The kernel (csrc/render_march.cu) on a's tensors, on the card: one
    round of the rays a.list_in[:n_in]; `first` for the frame's first launch.
    `pooled` is pooled_occupancy(cfg, occupancy)."""
    dev = a.o.device
    N, R = a.o.shape[0], a.list_in.shape[0]
    if dev.type != "cuda" or not render_march_takes(cfg, dev):
        raise ValueError("render_march takes CUDA tensors on the PACKED lattice")
    g = cfg.grid_size
    _check(dev, (
        ("occupancy", occupancy, torch.bool, (cfg.n_cascades, g, g, g)), ("pooled", pooled, torch.bool, None),
        ("o", a.o, torch.float32, (N, 3)), ("d", a.d, torch.float32, (N, 3)), ("t0", a.t0, torch.float32, (N,)),
        ("startt", a.startt, torch.float32, (N,)), ("k0", a.k0, torch.int64, (N,)),
        ("trans", a.trans, torch.float32, (N,)), ("taken", a.taken, torch.int32, (N,)),
        ("rnd", a.rnd, torch.int32, (N,)), ("n_seg", a.n_seg, torch.int64, ()), ("list_in", a.list_in, torch.int64, None),
        ("list_out", a.list_out, torch.int64, (R,)), ("mask", a.mask, torch.bool, (R, CHUNK)),
        ("flat", a.flat, torch.int64, (R * CHUNK,)), ("pos", a.pos, torch.float32, (R * CHUNK, 3)),
        ("dirs", a.dirs, torch.float32, (R * CHUNK, 3)), ("counts", a.counts, torch.int64, (3,)),
    ), n_in, R)
    n_lat = n_lattice_points(cfg)

    def launch():
        err = _library().render_march(
            occupancy.data_ptr(), pooled.data_ptr(), a.o.data_ptr(), a.d.data_ptr(), a.t0.data_ptr(),
            a.startt.data_ptr(), a.k0.data_ptr(), a.trans.data_ptr(), a.taken.data_ptr(), a.rnd.data_ptr(),
            a.n_seg.data_ptr(), a.list_in.data_ptr(), a.list_out.data_ptr(), a.mask.data_ptr(), a.flat.data_ptr(),
            a.pos.data_ptr(), a.dirs.data_ptr(), a.counts.data_ptr(), n_in, int(first), n_lat // CHUNK, n_lat,
            cfg.maximum_marching_steps, *_coarse_constants(cfg, pooled), _f32(thresh), *_box(cfg),
            torch.cuda.current_stream(dev).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"render_march launch failed: CUDA error {err}")

    RenderMarchOp.apply(a.counts, launch)
    profiling.count("launches.render_march")


class RenderMarchOp(torch.autograd.Function):
    """The ctypes launch as a recorded torch op. torch.profiler gives a
    kernel's device time to the op that was open when the kernel was
    launched, and a span's record_function range is no such op, so a bare
    ctypes launch would fall outside the spp_march span. The hash and MLP
    kernels launch inside their autograd Functions and count under their
    spans; this gives the march kernel the same. Nothing differentiates
    through it: it returns `out` as it is."""

    @staticmethod
    def forward(ctx, out, launch):
        launch()
        return out

    @staticmethod
    def backward(ctx, grad):
        return None, None


def render_march_plain(cfg: SamplerConfig, occupancy, pooled, a: Launch, n_in: int, first: bool, thresh: float):
    """render_march in PyTorch, on any device and constant-dt lattice: the
    same rays, state, rows and counts, the live list in list order (the
    kernel's is in block order). The kernel's plain version, which its card
    tests hold it against, and the launch of every frame the kernel does not
    take. It reads the grid from one packed word a segment where
    packed_march_supported holds, as the kernel does, else point by point
    (occupancy_lookup). Its host syncs (n_seg, two nonzeros, the counts'
    copy) count at site `march`."""
    dev = a.o.device
    n_lat = n_lattice_points(cfg)
    n_rounds = n_lat // CHUNK
    with profiling.host_sync("render", "march"):
        n_seg = int(a.n_seg)
    rays = a.list_in[:n_in]
    k0 = a.k0[rays]
    w0 = k0 - k0 % SEG
    s0 = w0 // SEG
    if first:
        taken = torch.zeros_like(rays)
        go = torch.ones_like(rays, dtype=torch.bool)
        start = torch.zeros_like(rays)
    else:
        last, taken = a.rnd[rays].to(torch.int64), a.taken[rays].to(torch.int64)
        go, start = (last >= 0) & (a.trans[rays] >= thresh), last + 1
    # the first round from `start` that keeps a segment of the window
    keep = coarse_segment_mask(cfg, pooled, a.o[rays], a.d[rays], a.t0[rays], n_seg, w0)
    seg_rnd = (s0[:, None] + torch.arange(n_seg, device=dev)[None, :]) // RANGE_SEGS
    ok = keep & (seg_rnd >= start[:, None]) & (seg_rnd < n_rounds)
    rnd = torch.where(ok, seg_rnd, n_rounds).amin(dim=1)
    with profiling.host_sync("render", "march"):
        sel = torch.nonzero(go & (rnd < n_rounds)).squeeze(1)
    L = sel.numel()
    ray, rnd, taken, w0 = rays[sel], rnd[sel], taken[sel], w0[sel]
    # that round's points: the kept segments' valid ordinals
    j = (RANGE_SEGS * rnd - w0 // SEG)[:, None] + torch.arange(RANGE_SEGS, device=dev)[None, :]
    kept = (j >= 0) & (j < n_seg) & keep[sel[:, None], j.clamp(0, n_seg - 1)]
    idx = CHUNK * rnd[:, None] + torch.arange(CHUNK, device=dev)[None, :]
    valid = kept.repeat_interleave(SEG, dim=1) & (idx < n_lat)
    packed = packed_neighborhood(cfg, occupancy) if packed_march_supported(cfg) else None
    inside, occ, _, pos = segment_points(cfg, AABB.scene(cfg.aabb_scale), occupancy, a.o[ray], a.d[ray], a.startt[ray],
                                         idx, packed)
    mask = valid & inside & occ
    m = mask.to(torch.int64)
    mask = mask & (taken[:, None] + torch.cumsum(m, dim=1) - m < cfg.maximum_marching_steps)
    exited = (valid & ~inside).any(dim=1)
    taken = taken + mask.sum(dim=1)
    a.taken[ray] = taken.to(torch.int32)
    a.rnd[ray] = torch.where(exited | (taken >= cfg.maximum_marching_steps), -1, rnd).to(torch.int32)
    with profiling.host_sync("render", "march"):
        rows, cols = torch.nonzero(mask, as_tuple=True)
    M = rows.numel()
    a.list_out[:L] = ray
    a.mask[:L] = mask
    a.flat[:M] = rows * CHUNK + cols
    a.pos[:M] = pos[rows, cols]
    a.dirs[:M] = (a.d[ray[rows]] + 1.0) * 0.5
    with profiling.host_sync("render", "march"):  # copied to the counts' device
        a.counts.copy_(torch.tensor([L, M, n_seg], dtype=torch.int64))


class Round(NamedTuple):
    """A marched round: the live rays' ids (L,), their (L, W) sample mask,
    and its rows: flat (M,) indices row * W + column, positions and warped
    directions (M, 3); t (L, W) the points' t where the lattice's dt varies
    (None on constant dt, where the composite reads only the step size)."""

    ids: torch.Tensor
    mask: torch.Tensor
    flat: torch.Tensor
    pos: torch.Tensor
    dirs: torch.Tensor
    t: torch.Tensor | None = None


class SegmentPlan(NamedTuple):
    """The kept coarse segments of a frame's rays: segment j of ray i holds
    the lattice ordinals w0[i] + 8j .. w0[i] + 8j + 7 and lies in round
    (s0[i] + j) // RANGE_SEGS; nxt[i, r] is the first round >= r that holds a
    kept segment of ray i (n_rounds, the last column, where none does)."""

    w0: torch.Tensor  # (R,) int64
    s0: torch.Tensor  # (R,) int64
    keep: torch.Tensor  # (R, n_seg) bool
    nxt: torch.Tensor  # (R, n_rounds + 1) int64

    def rows(self, sel) -> "SegmentPlan":
        """The plan of the rows `sel`; a boolean mask indexes each of the
        four tensors, a host sync each."""
        mask = isinstance(sel, torch.Tensor) and sel.dtype == torch.bool
        with profiling.host_sync("render", "plan_rows", 4 if mask else 0):
            return SegmentPlan(self.w0[sel], self.s0[sel], self.keep[sel], self.nxt[sel])


def segment_plan(keep, w0, s0, n_rounds: int, limit=None) -> SegmentPlan:
    """The plan of kept segments `keep` (R, n_seg); rounds >= `limit` (R,)
    (or n_rounds) hold nothing."""
    R, n_seg = keep.shape
    dev = keep.device
    rnd = (s0[:, None] + torch.arange(n_seg, device=dev)[None, :]) // RANGE_SEGS
    ok = keep & (rnd < (n_rounds if limit is None else limit[:, None]))
    has = torch.zeros((R, n_rounds + 1), dtype=torch.bool, device=dev)
    has.scatter_(1, torch.where(ok, rnd, n_rounds), ok)
    has[:, n_rounds] = True
    first = torch.where(has, torch.arange(n_rounds + 1, device=dev), n_rounds)
    nxt = torch.flip(torch.cummin(torch.flip(first, [1]), dim=1).values, [1])
    return SegmentPlan(w0, s0, keep, nxt)


def march_round(cfg, aabb: AABB, occupancy, packed, plan: SegmentPlan, sel, rnd, o, d, startt, taken, lookahead: int = 0,
                jitter_cover: bool = False):
    """Round rnd (L,) of the plan's rays sel (L,): the lattice points of each
    ray's segments in that round (RANGE_SEGS of them, then `lookahead`
    segments of the next round), a segment that is not kept testing nothing.
    o, d, startt and taken (the samples taken before) are the L rays'.
    Returns (mask (L, W) of the points the ray samples, t (L, W), pos
    (L, W, 3), idx (L, W) their lattice ordinals, exited (L,) whether a
    tested point of the round, the lookahead aside, lay outside the box)."""
    n_seg = plan.keep.shape[1]
    dev = o.device
    j = (RANGE_SEGS * rnd - plan.s0[sel])[:, None] + torch.arange(RANGE_SEGS + lookahead, device=dev)[None, :]
    kept = (j >= 0) & (j < n_seg) & plan.keep.reshape(-1)[sel[:, None] * n_seg + j.clamp(0, n_seg - 1)]
    idx = plan.w0[sel][:, None] + (j[:, :, None] * SEG + torch.arange(SEG, device=dev)).reshape(j.shape[0], -1)
    valid = kept.repeat_interleave(SEG, dim=1)
    inside, occ, t, pos = segment_points(cfg, aabb, occupancy, o, d, startt, idx, packed, jitter_cover)
    mask = valid & inside & occ
    m = mask.to(torch.int64)
    mask = mask & (taken[:, None] + torch.cumsum(m, dim=1) - m < cfg.maximum_marching_steps)
    exited = (valid & ~inside)[:, : RANGE_SEGS * SEG].any(dim=1)
    return mask, t, pos, idx, exited


def pass_march(cfg: SamplerConfig, occupancy, occ_aabb, o, d, t0, startt, alive, trans, thresh: float,
               share=slice(None)):
    """The march of one spp-1 pass over the rays o, d (N, 3), starting at t0
    (N,) unjittered and startt jittered, those `alive` whose start lies in
    the box; trans (N,) is the pass's transmittance, which the composite
    updates in place between rounds. `share` picks this rank's share of the
    rays that meet the occupied box. FrameMarch on a constant-dt lattice
    (culling the rays whose window misses the occupied box or whose march
    starts outside the box), ConeMarch on the cone lattice; None where no
    ray meets the occupied box."""
    aabb = AABB.scene(cfg.aabb_scale)
    if cfg.cone_angle_constant != 0.0:
        lo, hi = ray_box_span(occ_aabb.to(device=o.device, dtype=torch.float32), o, d)
        with profiling.host_sync("render", "hit_rays"):
            ids = torch.nonzero(alive & (hi >= torch.clamp(lo, min=0.05))).squeeze(1)
        return ConeMarch(cfg, occupancy, o, d, startt, ids[share], trans, thresh) if ids.numel() else None
    hit, k0, span = frame_geometry(cfg, o, d, occ_aabb)
    start_in = window_start_inside(cfg, aabb, o, d, startt, torch.zeros_like(k0))
    with profiling.host_sync("render", "hit_rays"):
        ids = torch.nonzero(hit & alive & start_in).squeeze(1)
    if not ids.numel():
        return None
    # rounds aligned at ordinal 0, as the full march's chunks: the window
    # starts at k0 rounded down to a whole segment; its length in segments
    # stays on the device
    w0 = k0[ids] - k0[ids] % SEG
    n_seg = torch.clamp(torch.ceil((k0[ids] - w0 + span[ids]).max() / SEG), min=1)
    return FrameMarch(cfg, occupancy, o, d, t0, startt, k0, ids[share], n_seg, trans, ids.numel(), thresh)


class FrameMarch:
    """The march of one spp-1 pass on a constant-dt lattice, one launch a
    round: render_march where render_march_takes holds, else
    render_march_plain (counted in render.march.plain on the card).

    `ids` (R,) are the rays to march (the hit rays, or a rank's share of
    them), n_seg () the frame's window in segments on the device, n_hit the
    frame's hit rays (the coarse pass's rows). `trans` (N,) is the pass's
    transmittance, which the composite updates in place between rounds.
    `tested` and `sampled` count the lattice points the march tested
    (n_hit * n_seg coarse midpoints, 128 a marched ray a round) and the rows
    it wrote."""

    def __init__(self, cfg: SamplerConfig, occupancy, o, d, t0, startt, k0, ids, n_seg, trans, n_hit: int, thresh: float):
        dev = o.device
        N, R = o.shape[0], ids.numel()
        self.cfg, self.occupancy, self.thresh, self.n_hit = cfg, occupancy, thresh, n_hit
        self.kernel = render_march_takes(cfg, dev)
        self.pooled = pooled_occupancy(cfg, occupancy)
        self.n_rounds = n_lattice_points(cfg) // CHUNK
        i32 = dict(dtype=torch.int32, device=dev)
        f32 = dict(dtype=torch.float32, device=dev)
        self.lists = (ids.contiguous(), torch.empty((R,), dtype=torch.int64, device=dev),
                      torch.empty((R,), dtype=torch.int64, device=dev))
        self.state = (torch.empty((N,), **i32), torch.empty((N,), **i32))
        self.rays = (o.contiguous(), d.contiguous(), t0, startt, k0, trans)
        self.n_seg = n_seg.to(torch.int64).reshape(())
        self.out = (torch.empty((R, CHUNK), dtype=torch.bool, device=dev),
                    torch.empty((R * CHUNK,), dtype=torch.int64, device=dev),
                    torch.empty((R * CHUNK, 3), **f32), torch.empty((R * CHUNK, 3), **f32))
        # one counter row a launch: a frame launches at most n_rounds + 1 times
        self.counts = torch.zeros((self.n_rounds + 1, 3), dtype=torch.int64, device=dev)
        self.host = torch.zeros((3,), dtype=torch.int64, pin_memory=dev.type == "cuda")
        self.n_in, self.launches, self.tested, self.sampled = R, 0, 0, 0

    def next(self) -> Round | None:
        """March the next round of the rays still live: None once none is."""
        k = self.launches
        if self.n_in == 0:
            if k == 0:  # a share with no ray: the frame's coarse pass counts all the same
                with profiling.host_sync("render", "march"):
                    self.tested += self.n_hit * int(self.n_seg)
                self.launches = 1
            return None
        if k > self.n_rounds:
            raise RuntimeError(f"a frame marches at most {self.n_rounds} rounds")
        list_in = self.lists[0] if k == 0 else self.lists[1 + (k - 1) % 2]
        list_out = self.lists[1 + k % 2]
        a = Launch(*self.rays, *self.state, self.n_seg, list_in, list_out, *self.out, self.counts[k])
        if not self.kernel and list_in.device.type == "cuda":
            profiling.count("render.march.plain")
        launch = render_march if self.kernel else render_march_plain
        launch(self.cfg, self.occupancy, self.pooled, a, self.n_in, k == 0, self.thresh)
        self.launches += 1
        with profiling.host_sync("render", "march"):
            self.host.copy_(self.counts[k], non_blocking=True)
            if self.host.is_pinned():
                torch.cuda.current_stream(list_in.device).synchronize()
        n_live, n_rows, n_seg = self.host.tolist()
        if k == 0:
            self.tested += self.n_hit * n_seg
        self.tested += n_live * CHUNK
        self.sampled += n_rows
        self.n_in = n_live
        if n_live == 0:
            return None
        mask, flat, pos, dirs = self.out
        return Round(list_out[:n_live], mask[:n_live], flat[:n_rows], pos[:n_rows], dirs[:n_rows])


class ConeMarch:
    """The march of one spp-1 pass on the cone lattice: the rays `ids` march
    the whole lattice from ordinal 0, CHUNK points a round (march_chunk),
    until the composite's transmittance falls under `thresh`, the step cap
    or the box exit ends them. trans, tested and sampled as FrameMarch's."""

    def __init__(self, cfg: SamplerConfig, occupancy, o, d, startt, ids, trans, thresh: float):
        self.cfg, self.occupancy, self.o, self.d, self.startt, self.trans, self.thresh = (
            cfg, occupancy, o, d, startt, trans, thresh)
        self.aabb = AABB.scene(cfg.aabb_scale)
        self.dirs = (d + 1.0) * 0.5
        self.taken = torch.zeros((o.shape[0],), dtype=torch.int64, device=o.device)
        self.n_lat = n_lattice_points(cfg)
        self.ids, self.i0, self.last, self.tested, self.sampled = ids, 0, None, 0, 0

    def next(self) -> Round | None:
        """Drop the rays the last round ended, march the next round of the
        rest: None once none is left or the lattice is done."""
        cfg, ids = self.cfg, self.ids
        if self.last is not None:
            (mask, inside_end), self.last = self.last, None
            tk = self.taken[ids] + mask.sum(dim=1)
            self.taken[ids] = tk
            more = (self.trans[ids] >= self.thresh) & (tk < cfg.maximum_marching_steps)
            with profiling.host_sync("render", "live_rays"):
                ids = self.ids = ids[more & inside_end]
        if self.i0 >= self.n_lat or ids.numel() == 0:
            return None
        if ids.device.type == "cuda":
            profiling.count("render.march.plain")
        mask, t, pos, inside_end = march_chunk(cfg, self.aabb, self.occupancy, self.o[ids], self.d[ids],
                                               self.startt[ids], self.taken[ids], self.i0)
        self.i0 += CHUNK
        self.last = (mask, inside_end)
        self.tested += mask.numel()
        with profiling.host_sync("render", "samples"):
            rows, cols = torch.nonzero(mask, as_tuple=True)
        self.sampled += rows.numel()
        return Round(ids, mask, rows * CHUNK + cols, pos[rows, cols], self.dirs[ids[rows]], t)


def cover_march_takes(cfg: SamplerConfig, device) -> bool:
    """Whether a cover-march round launches render_cover_march: tensors on
    the card, a jitter-cover lattice (jitter_cover_supported: the PACKED
    lattice with each point's segment within one cell of its packed word's),
    and the kernels' int32 ranges."""
    return torch.device(device).type == "cuda" and jitter_cover_supported(cfg) and _int32_ranges(cfg)


class CoverLaunch(NamedTuple):
    """One cover-march launch's tensors. A block's R rays by index in the
    block: o, d (R, 3), t0 (R,) the unjittered march start, k0 (R,) int64
    window starts, limit (R,) int32 the window's rounds, trans (R, P) each
    pass's transmittance after the ray's last composited round, taken and rnd
    (R,) int32 and carried (R,) bool, the state the launch reads (after the
    first) and writes. The launch reads list_in[:n_in] and writes list_out,
    mask and adj (n_in, 128) bool, carry (n_in, 2) bool (carried in, carried
    out), t (n_in, 128) float32, flat (n_in * 129,) int64, pos and dirs
    (n_in * 129, 3) float32 from row 0 on, and counts (2,) int64: live rays,
    rows; in list order (the marched rays' order in
    list_in, a ray's rows by column). counts and scan, the kernel's scratch
    (1 + ceil(n_in / 8),) int64, must be zero."""

    o: torch.Tensor
    d: torch.Tensor
    t0: torch.Tensor
    k0: torch.Tensor
    limit: torch.Tensor
    trans: torch.Tensor
    taken: torch.Tensor
    rnd: torch.Tensor
    carried: torch.Tensor
    list_in: torch.Tensor
    list_out: torch.Tensor
    mask: torch.Tensor
    adj: torch.Tensor
    carry: torch.Tensor
    t: torch.Tensor
    flat: torch.Tensor
    pos: torch.Tensor
    dirs: torch.Tensor
    counts: torch.Tensor
    scan: torch.Tensor


def _cover_library():
    lib = kernels.library("render_cover_march")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.render_cover_march.argtypes = [p] * 22 + [i] * 10 + [f] * 10 + [p]
    lib.render_cover_march.restype = ctypes.c_int
    return lib


def _cover_blocks(n: int) -> int:
    """The kernel's thread blocks for n listed rays: 8 rays (warps) a block."""
    return -(-n // 8)


def render_cover_march(cfg: SamplerConfig, occupancy, pooled, packed, a: CoverLaunch, n_in: int, first: bool,
                       n_rounds: int, thresh: float):
    """The kernel (csrc/render_cover_march.cu) on a's tensors, on the card:
    one round of the rays a.list_in[:n_in]; `first` for the block's first
    launch. `pooled` is pooled_occupancy(cfg, occupancy), `packed`
    packed_neighborhood(cfg, occupancy) (the kernel reads no other grid);
    n_rounds bounds every ray's limit."""
    dev = a.o.device
    R, L, P = a.o.shape[0], a.list_in.shape[0], a.trans.shape[-1]
    if dev.type != "cuda" or not cover_march_takes(cfg, dev):
        raise ValueError("render_cover_march takes CUDA tensors on a jitter-cover lattice")
    g = cfg.grid_size
    _check(dev, (
        ("pooled", pooled, torch.bool, None), ("packed", packed, torch.int32, (g**3,)),
        ("o", a.o, torch.float32, (R, 3)), ("d", a.d, torch.float32, (R, 3)), ("t0", a.t0, torch.float32, (R,)),
        ("k0", a.k0, torch.int64, (R,)), ("limit", a.limit, torch.int32, (R,)),
        ("trans", a.trans, torch.float32, (R, P)), ("taken", a.taken, torch.int32, (R,)),
        ("rnd", a.rnd, torch.int32, (R,)), ("carried", a.carried, torch.bool, (R,)),
        ("list_in", a.list_in, torch.int64, None), ("list_out", a.list_out, torch.int64, (L,)),
        ("mask", a.mask, torch.bool, (L, CHUNK)), ("adj", a.adj, torch.bool, (L, CHUNK)),
        ("carry", a.carry, torch.bool, (L, 2)), ("t", a.t, torch.float32, (L, CHUNK)),
        ("flat", a.flat, torch.int64, (L * (CHUNK + 1),)), ("pos", a.pos, torch.float32, (L * (CHUNK + 1), 3)),
        ("dirs", a.dirs, torch.float32, (L * (CHUNK + 1), 3)), ("counts", a.counts, torch.int64, (2,)),
        ("scan", a.scan, torch.int64, (1 + _cover_blocks(L),)),
    ), n_in, L)

    def launch():
        err = _cover_library().render_cover_march(
            pooled.data_ptr(), packed.data_ptr(), a.o.data_ptr(), a.d.data_ptr(), a.t0.data_ptr(), a.k0.data_ptr(),
            a.limit.data_ptr(), a.trans.data_ptr(), a.taken.data_ptr(), a.rnd.data_ptr(), a.carried.data_ptr(),
            a.list_in.data_ptr(), a.list_out.data_ptr(), a.mask.data_ptr(), a.adj.data_ptr(), a.carry.data_ptr(),
            a.t.data_ptr(), a.flat.data_ptr(), a.pos.data_ptr(), a.dirs.data_ptr(), a.counts.data_ptr(),
            a.scan.data_ptr(), n_in,
            int(first), n_rounds, cfg.maximum_marching_steps, P, SHARE_ROUND, *_coarse_constants(cfg, pooled),
            _f32(thresh), *_box(cfg), torch.cuda.current_stream(dev).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"render_cover_march launch failed: CUDA error {err}")

    RenderMarchOp.apply(a.counts, launch)
    profiling.count("launches.render_cover_march")


def render_cover_march_plain(cfg: SamplerConfig, occupancy, pooled, packed, a: CoverLaunch, n_in: int, first: bool,
                             n_rounds: int, thresh: float):
    """render_cover_march in PyTorch, on any device and jitter-cover lattice:
    the same rays, state, rows and counts, in the same order. The kernel's
    plain version, which its card tests hold it against, and the launch of
    every round the kernel does not take. The listed rays' coarse pass over
    the rounds from each ray's start to its limit and the lookahead segment
    (segment_plan; the window as wide as the widest such span), then
    march_round(lookahead=1, jitter_cover=True) at the first round from each
    ray's start that keeps a segment. Its host syncs (the window's width, two
    nonzeros, the counts' copy) count at site `cover_march`."""
    rays = a.list_in[:n_in]
    limit = a.limit[rays].to(torch.int64)
    if first:
        taken = torch.zeros_like(rays)
        c_in = torch.zeros_like(rays, dtype=torch.bool)
        go = torch.ones_like(rays, dtype=torch.bool)
        start = torch.zeros_like(rays)
    else:
        last, taken, c_in = a.rnd[rays].to(torch.int64), a.taken[rays].to(torch.int64), a.carried[rays]
        go, start = (last >= 0) & (a.trans[rays] >= thresh).any(dim=1), last + 1
    with profiling.host_sync("render", "cover_march"):
        width = int(torch.where(go, limit - start, 0).max())
    if width <= 0:  # no listed ray has a round left: the counts stay zero
        return
    # each ray's window from its start round on: segment j holds ordinals
    # w0 + 8j, the same float32 sums as from k0 (lattice ordinals < 2^24)
    w0, s0 = a.k0[rays] + CHUNK * start, RANGE_SEGS * start
    keep = coarse_segment_mask(cfg, pooled, a.o[rays], a.d[rays], a.t0[rays], RANGE_SEGS * width + 1, w0)
    plan = segment_plan(keep, w0, s0, n_rounds, limit)
    rnd = plan.nxt.gather(1, start.clamp(max=n_rounds)[:, None]).squeeze(1)
    with profiling.host_sync("render", "cover_march"):
        sel = torch.nonzero(go & (rnd < n_rounds)).squeeze(1)
    L = sel.numel()
    if L == 0:  # every listed ray ended: the counts stay zero
        return
    ray, rnd, taken, c_in = rays[sel], rnd[sel], taken[sel], c_in[sel]
    mask, t, pos, _, exited = march_round(cfg, AABB.scene(cfg.aabb_scale), occupancy, packed, plan, sel, rnd, a.o[ray],
                                          a.d[ray], a.t0[ray], taken, lookahead=1, jitter_cover=True)
    m, m_next = mask[:, :CHUNK], mask[:, CHUNK]
    mi = m.to(torch.int64)
    q = taken[:, None] + torch.cumsum(mi, dim=1) - mi  # the point's sample ordinal on its ray
    # lerp partner: the next lattice point's evaluation when that point is a
    # sample too, except at the last sample of a compositing round
    adj = torch.cat([m[:, 1:], m_next[:, None]], dim=1) & ((q + 1) % SHARE_ROUND != 0)
    ev = torch.cat([m, m[:, -1:] & adj[:, -1:]], dim=1)  # (L, CHUNK + 1) points to evaluate
    ev[:, 0] &= ~c_in
    with profiling.host_sync("render", "cover_march"):
        rows, cols = torch.nonzero(ev, as_tuple=True)
    M = rows.numel()
    taken = taken + mi.sum(dim=1)
    a.taken[ray] = taken.to(torch.int32)
    a.rnd[ray] = torch.where(exited | (taken >= cfg.maximum_marching_steps), -1, rnd).to(torch.int32)
    a.carried[ray] = ev[:, CHUNK]
    a.list_out[:L] = ray
    a.mask[:L] = m
    a.adj[:L] = adj
    a.carry[:L] = torch.stack([c_in, ev[:, CHUNK]], dim=1)
    a.t[:L] = t[:, :CHUNK]
    a.flat[:M] = rows * (CHUNK + 1) + cols
    a.pos[:M] = pos[rows, cols]
    a.dirs[:M] = (a.d[ray[rows]] + 1.0) * 0.5
    with profiling.host_sync("render", "cover_march"):  # copied to the counts' device
        a.counts.copy_(torch.tensor([L, M], dtype=torch.int64))


class CoverRound(NamedTuple):
    """A marched cover round of a block: the live rays' indices in the block
    (L,), their (L, 128) sample mask and lerp partners `adj` (column j lerps
    towards column j + 1's evaluation, column 127 towards the lookahead
    point's), carry (L, 2) whether the ray carried its column 0's evaluation
    in from the last round and whether it carries its column 128's out, t
    (L, 128) the points' t; and the rows to evaluate: flat (M,) indices
    row * 129 + column, positions and warped directions (M, 3)."""

    ids: torch.Tensor
    mask: torch.Tensor
    adj: torch.Tensor
    carry: torch.Tensor
    t: torch.Tensor
    flat: torch.Tensor
    pos: torch.Tensor
    dirs: torch.Tensor


class CoverMarch:
    """The cover march of a block of an spp-n Shade frame's hit rays, one
    launch a round: render_cover_march where cover_march_takes holds, else
    render_cover_march_plain (counted in render.march.plain on the card).

    o, d (R, 3), t0, k0 and limit (R,) are the block's rays; `trans` (R, P)
    each pass's transmittance, which the composite updates in place between
    rounds; n_rounds the frame's most rounds (the max of every hit ray's
    limit). `tested` and `sampled` count the lattice points the fine march
    tested (136 a marched ray a round: its 16 segments and the lookahead) and
    the rows it wrote."""

    def __init__(self, cfg: SamplerConfig, occupancy, pooled, packed, o, d, t0, k0, limit, n_rounds: int, trans,
                 thresh: float):
        dev = o.device
        R = o.shape[0]
        self.cfg, self.grids, self.thresh, self.n_rounds = cfg, (occupancy, pooled, packed), thresh, n_rounds
        self.kernel = cover_march_takes(cfg, dev)
        i64 = dict(dtype=torch.int64, device=dev)
        f32 = dict(dtype=torch.float32, device=dev)
        self.lists = (torch.arange(R, **i64), torch.empty((R,), **i64), torch.empty((R,), **i64))
        self.rays = (o.contiguous(), d.contiguous(), t0.contiguous(), k0.contiguous(),
                     limit.to(torch.int32).contiguous(), trans)
        self.state = (torch.zeros((R,), dtype=torch.int32, device=dev), torch.zeros((R,), dtype=torch.int32, device=dev),
                      torch.zeros((R,), dtype=torch.bool, device=dev))
        rows = R * (CHUNK + 1)
        self.out = (torch.empty((R, CHUNK), dtype=torch.bool, device=dev),
                    torch.empty((R, CHUNK), dtype=torch.bool, device=dev),
                    torch.empty((R, 2), dtype=torch.bool, device=dev), torch.empty((R, CHUNK), **f32),
                    torch.empty((rows,), **i64), torch.empty((rows, 3), **f32), torch.empty((rows, 3), **f32))
        # one counter row and one kernel scratch row a launch: a block launches at most n_rounds + 1 times
        self.counts = torch.zeros((n_rounds + 1, 2), **i64)
        self.scan = torch.zeros((n_rounds + 1, 1 + _cover_blocks(R)), **i64)
        self.host = torch.zeros((2,), dtype=torch.int64, pin_memory=dev.type == "cuda")
        self.n_in, self.launches, self.tested, self.sampled = R, 0, 0, 0

    def next(self) -> CoverRound | None:
        """March the next round of the rays still live: None once none is."""
        k = self.launches
        if self.n_in == 0:
            return None
        if k > self.n_rounds:
            raise RuntimeError(f"a block marches at most {self.n_rounds} rounds")
        list_in = self.lists[0] if k == 0 else self.lists[1 + (k - 1) % 2]
        list_out = self.lists[1 + k % 2]
        a = CoverLaunch(*self.rays, *self.state, list_in, list_out, *self.out, self.counts[k], self.scan[k])
        if not self.kernel and list_in.device.type == "cuda":
            profiling.count("render.march.plain")
        launch = render_cover_march if self.kernel else render_cover_march_plain
        launch(self.cfg, *self.grids, a, self.n_in, k == 0, self.n_rounds, self.thresh)
        self.launches += 1
        with profiling.host_sync("render", "cover_march"):
            self.host.copy_(self.counts[k], non_blocking=True)
            if self.host.is_pinned():
                torch.cuda.current_stream(list_in.device).synchronize()
        n_live, n_rows = self.host.tolist()
        self.tested += n_live * (CHUNK + SEG)
        self.sampled += n_rows
        self.n_in = n_live
        if n_live == 0:
            return None
        mask, adj, carry, t, flat, pos, dirs = self.out
        return CoverRound(list_out[:n_live], mask[:n_live], adj[:n_live], carry[:n_live], t[:n_live], flat[:n_rows],
                          pos[:n_rows], dirs[:n_rows])
