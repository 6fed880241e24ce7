"""Closed-form t-lattice ray marching on torch tensors.

Counterpart: ngp_tpu/sampling/lattice.py:47-63 (_march_mip), :66-111
(packed_march_supported, _packed_group_occ, jitter_cover_supported),
:121-160 (coarse_segment_mask), :162-214 (count_samples_segments, with its
jitter_cover branch), :221-277
(n_lattice_points, lattice_t, lattice_dt), :280-303 (ray_box_span,
occupied_window_start) and :306-400 (_chunk_mask, count_samples, with its
per-ray masks). Same semantics: a ray visits t_i = startt + i*dt (closed
form for cone stepping), stops at the first lattice point outside the scene
box, and takes at most maximum_marching_steps occupied points. With a
per-ray window start k0 the lattice ordinals are k0 + j, and the
jitter-cover march (one march for all spp passes of a frame) tests each
point's segment [pos, pos + d*dt] through the packed 3^3 words of its
8-point group, so its mask is a superset of every jittered pass's.
count_samples and the two-level march (coarse_segment_mask, then
count_samples_segments on the kept segments) have static shapes, as
ngp_tpu's: every ray marches every chunk of its window, carrying whether it
is still inside the box, so a training step never syncs with the host. The
renderer keeps its own compacting march, which drops finished rays between
rounds (the reference's alive-ray compaction): over the kept segments
(segment_points) where the lattice is arithmetic, over march_chunk on the
cone lattice. Lattice t and positions are fused multiply-adds
(utils/fma.py) where XLA contracts them.
"""

import math

import numpy as np
import torch

from ngp_tpu_torch.grid.occupancy import (
    mip_from_dt,
    mip_from_pos,
    occupancy_lookup,
    packed_chunk_lookup,
    packed_cover_lookup,
    pooled_lookup,
    static_dt_mip,
)
from ngp_tpu_torch.utils.aabb import AABB
from ngp_tpu_torch.utils.config import SamplerConfig
from ngp_tpu_torch.utils.fma import fma

CHUNK = 128  # lattice points marched per ray per round
SEG = 8  # lattice points of one packed-word group


def march_mip(cfg: SamplerConfig, pos: torch.Tensor, dt: float) -> torch.Tensor:
    """Cascade for occupancy tests along a constant-dt march: the static dt
    floor for aabb_scale 1 (every in-box point is at mip 0), else per point."""
    fl = max(static_dt_mip(dt, cfg.grid_size, cfg.n_cascades), 0)
    if cfg.aabb_scale == 1:
        return torch.full(pos.shape[:-1], fl, dtype=torch.int32, device=pos.device)
    mip = mip_from_pos(pos, cfg.n_cascades)
    return torch.clamp(mip, min=fl) if fl > 0 else mip


def packed_march_supported(cfg: SamplerConfig) -> bool:
    """One packed word per 8-point group answers all 8 occupancy tests
    exactly: constant dt, aabb_scale 1 (every march mip is 0) and the
    group's half-extent 3.5*dt within one cell."""
    return cfg.cone_angle_constant == 0.0 and cfg.aabb_scale == 1 and 3.5 * cfg.min_cone_stepsize * cfg.grid_size <= 1.0


def jitter_cover_supported(cfg: SamplerConfig) -> bool:
    """The cover test reaches one step further (point 7's segment ends 4.5*dt
    from the group midpoint), so it needs 4.5*dt*G <= 1 as well."""
    return packed_march_supported(cfg) and 4.5 * cfg.min_cone_stepsize * cfg.grid_size <= 1.0


def packed_group_occ(cfg: SamplerConfig, packed, pos: torch.Tensor, pos_end=None) -> torch.Tensor:
    """Occupancy of lattice positions pos (R, W, 3), W a multiple of SEG, whose
    columns are consecutive ordinals in aligned groups of SEG: one packed word
    at each group's midpoint (the mean of its points 3 and 4). With pos_end
    (R, W, 3), the points one step on (pos + d*dt), point i reports whether
    any cell that the segment [pos_i, pos_end_i] touches is occupied."""
    R, W, _ = pos.shape
    pg = pos.reshape(R, W // SEG, SEG, 3)
    pos_mid = 0.5 * (pg[:, :, 3, :] + pg[:, :, 4, :])
    if pos_end is None:
        return packed_chunk_lookup(cfg, packed, pos_mid, pg).reshape(R, W)
    return packed_cover_lookup(cfg, packed, pos_mid, pg, pos_end.reshape(pg.shape)).reshape(R, W)


def n_lattice_points(cfg: SamplerConfig) -> int:
    """Lattice length that crosses the scene box diagonal from any start,
    rounded up to whole chunks."""
    diag = math.sqrt(3.0) * cfg.aabb_scale
    m = cfg.min_cone_stepsize
    c = cfg.cone_angle_constant
    if c == 0.0:
        n = int(math.ceil(diag / m)) + 1
    else:
        M = cfg.max_cone_stepsize
        n_a = int(math.ceil(1.0 / c)) + 1
        n_b = int(math.ceil(math.log(max(M / m, 1.0)) / math.log1p(c))) + 1
        n_c = int(math.ceil(diag / M)) + 1
        n = n_a + n_b + n_c
    return -(-n // CHUNK) * CHUNK


def cone_anchors(cfg: SamplerConfig, t0: torch.Tensor) -> tuple:
    """The cone lattice's anchors for march starts t0 (elementwise): (iA, tA,
    iC, tC), where the arithmetic stretch (step m) ends at ordinal iA, t = tA,
    and the exponential one (t' = t * (1 + c)) at iC, t = tC; past iC the step
    is M. lattice_t's closed form; the batch kernels take them as computed
    here, so their t is the same float32 arithmetic."""
    m = cfg.min_cone_stepsize
    c = cfg.cone_angle_constant
    M = cfg.max_cone_stepsize
    iA = torch.ceil(torch.clamp(m / c - t0, min=0.0) / m)
    tA = t0 + iA * m
    log1pc = float(np.log1p(c))
    nB = torch.ceil(torch.log(torch.clamp(M / (c * torch.clamp(tA, min=1e-30)), min=1.0)) / log1pc)
    tC = tA * torch.exp(nB * log1pc)
    iC = iA + nB
    return iA, tA, iC, tC


def lattice_t(cfg: SamplerConfig, startt: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t of lattice index `idx` for a march starting at `startt` (broadcast).
    c = 0: startt + idx*m; c > 0: the closed form of t' = t + clamp(c*t, m, M)."""
    m = cfg.min_cone_stepsize
    c = cfg.cone_angle_constant
    i = idx.to(torch.float32)
    if c == 0.0:
        return fma(i, m, startt)
    M = cfg.max_cone_stepsize
    t0 = startt
    iA, tA, iC, tC = cone_anchors(cfg, t0)
    log1pc = float(np.log1p(c))
    t_a = t0 + i * m
    t_b = tA * torch.exp((i - iA) * log1pc)
    t_c = tC + (i - iC) * M
    return torch.where(i <= iA, t_a, torch.where(i <= iC, t_b, t_c))


def lattice_dt(cfg: SamplerConfig, t: torch.Tensor) -> torch.Tensor:
    """Step size at t: clamp(c*t, m, M) for c > 0, else the constant m."""
    c = cfg.cone_angle_constant
    if c == 0.0:
        return torch.full_like(t, cfg.min_cone_stepsize)
    return torch.clamp(c * t, cfg.min_cone_stepsize, cfg.max_cone_stepsize)


def march_chunk(
    cfg: SamplerConfig, aabb: AABB, occupancy, o, d, startt, taken, i0: int, width: int = CHUNK, k0=None, packed=None,
    jitter_cover: bool = False, lookahead: int = 0, still=None,
):
    """Lattice points [i0, i0 + width + lookahead) of rays that were inside the
    box up to i0 (ordinals k0 + i with a per-ray window start k0 (R,)).

    Returns (mask (R, W) of the points the ray samples, t (R, W),
    pos (R, W, 3), inside_end (R,) whether the ray is still inside the box
    at the chunk's last point i0 + width - 1); W = width + lookahead, the
    lookahead points being the next chunk's first. `taken` (R,) counts the
    samples each ray took before; `still` (R,), where given, whether each ray
    was still inside the box at point i0 - 1 (count_samples' carry).
    With `packed` (packed_march_supported) the occupancy comes from the
    packed words of aligned 8-point groups; with jitter_cover (needs packed
    and jitter_cover_supported; startt unjittered) the mask is the cover
    mask: a point counts if it or pos + d*dt lies in the box and its segment
    touches an occupied cell."""
    n_lat = n_lattice_points(cfg)
    j = torch.arange(i0, i0 + width + lookahead, dtype=torch.float32, device=o.device)
    i = j[None, :] if k0 is None else k0.to(torch.float32)[:, None] + j[None, :]
    t = lattice_t(cfg, startt[:, None], i)
    pos = fma(t[..., None], d[:, None, :], o[:, None, :])
    inside = aabb.contains(pos)
    if jitter_cover:
        # XLA recomputes the positions in three fusions of ngp_tpu's cover
        # march and contracts them into fused multiply-adds in most lanes,
        # not all: about one cover point in 450,000 lands on the other side
        # of a cell face there (ROADMAP queue 3)
        pos_end = fma(d[:, None, :], cfg.min_cone_stepsize, pos)
        inside = inside | aabb.contains(pos_end)
    if k0 is None:
        inside = inside & (j < n_lat)[None, :]
    # the march breaks at the first point outside the box
    reach = torch.cumprod(inside.to(torch.int32), dim=1) > 0
    if still is not None:
        reach = still[:, None] & reach
    if jitter_cover:
        occ = packed_group_occ(cfg, packed, pos, pos_end)
    elif packed is not None:
        occ = packed_group_occ(cfg, packed, pos)
    elif cfg.cone_angle_constant == 0.0:
        occ = occupancy_lookup(cfg, occupancy, pos, march_mip(cfg, pos, cfg.min_cone_stepsize))
    else:
        occ = occupancy_lookup(cfg, occupancy, pos, mip_from_dt(lattice_dt(cfg, t), pos, cfg.grid_size, cfg.n_cascades))
    mask = reach & occ
    m = mask.to(torch.int64)
    ordinal = taken[:, None] + torch.cumsum(m, dim=1) - m
    mask = mask & (ordinal < cfg.maximum_marching_steps)
    return mask, t, pos, reach[:, width - 1]


def count_samples(
    cfg: SamplerConfig, aabb: AABB, occupancy, o, d, startt, return_masks: bool = False, k0=None, n_window: int | None = None,
    packed=None, jitter_cover: bool = False,
):
    """Occupied samples each ray takes over its lattice window, (R,) int64;
    with return_masks also the (R, n_window) bool mask of the points each ray
    samples (ngp_tpu's count_samples(return_masks=True)). The window is
    ordinals k0 + [0, n_window), a whole number of chunks (default: the whole
    lattice from 0); packed and jitter_cover as march_chunk. Every ray
    marches every chunk (static shapes, no host sync)."""
    R = o.shape[0]
    taken = torch.zeros((R,), dtype=torch.int64, device=o.device)
    still = torch.ones((R,), dtype=torch.bool, device=o.device)
    n_window = n_lattice_points(cfg) if n_window is None else n_window
    masks = []
    for i0 in range(0, n_window, CHUNK):
        mask, _, _, still = march_chunk(
            cfg, aabb, occupancy, o, d, startt, taken, i0, k0=k0, packed=packed, jitter_cover=jitter_cover, still=still
        )
        taken = taken + mask.sum(dim=1)
        if return_masks:
            masks.append(mask)
    return (taken, torch.cat(masks, dim=1)) if return_masks else taken


def coarse_segment_mask(cfg: SamplerConfig, pooled, o, d, startt, n_seg: int, k0) -> torch.Tensor:
    """(R, n_seg) bool: segment j (ordinals k0 + 8j .. 8j + 7) may hold an
    occupied sample, a conservative superset through the halo-pooled grid
    (grid/occupancy.pooled_occupancy): one lookup at the segment's midpoint
    (ordinal offset + 4) at its mip, or-ed with the next mip's where the
    midpoint lies within 16*dt of its mip cube's edge, and false where the
    segment's whole extent lies outside the scene cube. False positives cost
    only fine-march work. Arithmetic lattice only."""
    dt = cfg.min_cone_stepsize
    j = torch.arange(n_seg, dtype=torch.float32, device=o.device)
    tm = fma(k0.to(torch.float32)[:, None] + SEG * j[None, :] + 4.0, dt, startt[:, None])
    pos = fma(tm[..., None], d[:, None, :], o[:, None, :])
    mip = march_mip(cfg, pos, dt)
    occ = pooled_lookup(cfg, pooled, pos, mip)
    maxval = torch.amax(torch.abs(pos - 0.5), dim=-1)
    if cfg.n_cascades > 1:
        # mip m's range ends at maxval = 2^(m - 1) (mip_from_pos)
        bound = ((126 + mip) << 23).view(torch.float32)
        near = maxval >= bound - 16.0 * dt
        mip_hi = torch.clamp(mip + 1, max=cfg.n_cascades - 1)
        occ = occ | (near & pooled_lookup(cfg, pooled, pos, mip_hi))
    scene_half = 0.5 * float(cfg.aabb_scale)
    return occ & (maxval <= scene_half + 8.0 * dt)


def segment_points(cfg: SamplerConfig, aabb: AABB, occupancy, o, d, startt, idx, packed=None, jitter_cover: bool = False):
    """The tests of lattice ordinals idx (R, W), W a multiple of SEG whose
    columns are aligned groups of SEG consecutive ordinals (segments), from
    the march start startt (R,): (inside (R, W), occ (R, W), t, pos). The t
    of ordinal i is lattice_t(startt, i) and the position fma(t, d, o), as
    march_chunk computes them, so a point is the same to the bit. With
    `packed` the occupancy comes from one packed word a segment; with
    jitter_cover (startt unjittered) `inside` and `occ` are march_chunk's
    cover tests (pos or pos + d*dt in the box; any cell the segment
    [pos, pos + d*dt] touches occupied)."""
    t = lattice_t(cfg, startt[:, None], idx)
    pos = fma(t[..., None], d[:, None, :], o[:, None, :])
    inside = aabb.contains(pos)
    if jitter_cover:
        pos_end = fma(d[:, None, :], cfg.min_cone_stepsize, pos)
        return inside | aabb.contains(pos_end), packed_group_occ(cfg, packed, pos, pos_end), t, pos
    if packed is not None:
        return inside, packed_group_occ(cfg, packed, pos), t, pos
    return inside, occupancy_lookup(cfg, occupancy, pos, march_mip(cfg, pos, cfg.min_cone_stepsize)), t, pos


def window_start_inside(cfg: SamplerConfig, aabb: AABB, o, d, startt, k0, jitter_cover: bool = False):
    """(R,) bool: the window's first point (ordinal k0) passes march_chunk's
    box test, the point itself or, with jitter_cover, pos + d*dt."""
    pos = fma(lattice_t(cfg, startt, k0)[:, None], d, o)
    inside = aabb.contains(pos)
    if jitter_cover:
        inside = inside | aabb.contains(fma(d, cfg.min_cone_stepsize, pos))
    return inside


def count_samples_segments(
    cfg: SamplerConfig, aabb: AABB, occupancy, o, d, startt, k0, seg_idx, packed=None, jitter_cover: bool = False
):
    """The fine march on the kept coarse segments seg_idx (R, C), ascending
    segment ordinals padded with a sentinel past the window: (counts (R,),
    masks (R, 8C), lat (R, 8C)) with `lat` the k0-relative lattice ordinals
    in march order. Equals count_samples' sample set when seg_idx holds every
    coarse-occupied segment: in the convex scene box the break-on-exit prefix
    is the pointwise contains() test and the window's first point inside.
    With jitter_cover (needs packed; startt unjittered) the mask is
    count_samples(jitter_cover=True)'s cover mask: the box tests take
    pos + d*dt too, at every point and at the window's first."""
    R, C = seg_idx.shape
    j8 = torch.arange(SEG, dtype=torch.int64, device=o.device)
    lat = (seg_idx[:, :, None] * SEG + j8[None, None, :]).reshape(R, C * SEG)
    inside, occ, _, _ = segment_points(cfg, aabb, occupancy, o, d, startt, k0[:, None] + lat, packed, jitter_cover)
    inside0 = window_start_inside(cfg, aabb, o, d, startt, k0, jitter_cover)
    mask = inside & inside0[:, None] & occ
    m = mask.to(torch.int64)
    mask = mask & (torch.cumsum(m, dim=1) - m < cfg.maximum_marching_steps)
    return mask.sum(dim=1), mask, lat


def ray_box_span(box: torch.Tensor, o: torch.Tensor, d: torch.Tensor):
    """Slab test of rays against a box tensor (2, 3): (tmin, tmax) per ray;
    a miss has tmax < tmin. Zero direction components are nudged to 1e-12."""
    dd = torch.where(torch.abs(d) < 1e-12, 1e-12, d)
    t1 = (box[0] - o) / dd
    t2 = (box[1] - o) / dd
    return torch.amax(torch.minimum(t1, t2), dim=-1), torch.amin(torch.maximum(t1, t2), dim=-1)


def occupied_window_start(occ_aabb: torch.Tensor, o, d, startt, dt: float, n_lattice: int) -> torch.Tensor:
    """Each ray's first lattice ordinal whose t can be occupied, (R,) int64:
    floor((t_lo - startt) / dt) against the occupied box, n_lattice for a
    miss, clamped to [0, n_lattice]. Skipping to it is exact. A division by
    dt, as ngp_tpu's (the renderer's frame_geometry multiplies by
    float32(1/dt) instead, as _rays_slab_pass does)."""
    t_lo, t_hi = ray_box_span(occ_aabb, o, d)
    k0 = torch.floor((t_lo - startt) / torch.full_like(startt, dt)).to(torch.int64)
    miss = t_hi < torch.maximum(t_lo, startt)
    return torch.clamp(torch.where(miss, n_lattice, k0), 0, n_lattice)
