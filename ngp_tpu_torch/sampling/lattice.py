"""Closed-form t-lattice ray marching on torch tensors.

Counterpart: ngp_tpu/sampling/lattice.py:47-63 (_march_mip), :221-277
(n_lattice_points, lattice_t, lattice_dt) and :306-373 (_chunk_mask,
count_samples). Same semantics: a ray visits t_i = startt + i*dt (closed
form for cone stepping), stops at the first lattice point outside the scene
box, and takes at most maximum_marching_steps occupied points. Differs in
structure: the port marches only the rays still alive, one chunk of lattice
points at a time, and drops finished rays between chunks (the reference's
alive-ray compaction) instead of the coarse premask, packed 3^3 words and
occupied-box window start, which exist to keep XLA's shapes static.
Lattice t and positions are fused multiply-adds (utils/fma.py), as XLA
compiles them.
"""

import math

import numpy as np
import torch

from ngp_tpu_torch.grid.occupancy import mip_from_dt, mip_from_pos, occupancy_lookup, static_dt_mip
from ngp_tpu_torch.utils.aabb import AABB
from ngp_tpu_torch.utils.config import SamplerConfig
from ngp_tpu_torch.utils.fma import fma

CHUNK = 128  # lattice points marched per ray per round


def march_mip(cfg: SamplerConfig, pos: torch.Tensor, dt: float) -> torch.Tensor:
    """Cascade for occupancy tests along a constant-dt march: the static dt
    floor for aabb_scale 1 (every in-box point is at mip 0), else per point."""
    fl = max(static_dt_mip(dt, cfg.grid_size, cfg.n_cascades), 0)
    if cfg.aabb_scale == 1:
        return torch.full(pos.shape[:-1], fl, dtype=torch.int32, device=pos.device)
    mip = mip_from_pos(pos, cfg.n_cascades)
    return torch.clamp(mip, min=fl) if fl > 0 else mip


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
    iA = torch.ceil(torch.clamp(m / c - t0, min=0.0) / m)
    tA = t0 + iA * m
    log1pc = float(np.log1p(c))
    nB = torch.ceil(torch.log(torch.clamp(M / (c * torch.clamp(tA, min=1e-30)), min=1.0)) / log1pc)
    tC = tA * torch.exp(nB * log1pc)
    iC = iA + nB
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


def march_chunk(cfg: SamplerConfig, aabb: AABB, occupancy, o, d, startt, taken, i0: int, width: int = CHUNK):
    """Lattice points [i0, i0 + width) of rays that were inside the box up to i0.

    Returns (mask (R, W) of the points the ray samples, t (R, W),
    pos (R, W, 3), inside_end (R,) whether the ray is still inside the box
    after the chunk). `taken` (R,) counts the samples each ray took before."""
    n_lat = n_lattice_points(cfg)
    i = torch.arange(i0, i0 + width, dtype=torch.float32, device=o.device)
    t = lattice_t(cfg, startt[:, None], i[None, :])
    pos = fma(t[..., None], d[:, None, :], o[:, None, :])
    inside = aabb.contains(pos) & (i < n_lat)[None, :]
    # the march breaks at the first point outside the box
    reach = torch.cumprod(inside.to(torch.int32), dim=1) > 0
    if cfg.cone_angle_constant == 0.0:
        mip = march_mip(cfg, pos, cfg.min_cone_stepsize)
    else:
        mip = mip_from_dt(lattice_dt(cfg, t), pos, cfg.grid_size, cfg.n_cascades)
    mask = reach & occupancy_lookup(cfg, occupancy, pos, mip)
    m = mask.to(torch.int64)
    ordinal = taken[:, None] + torch.cumsum(m, dim=1) - m
    mask = mask & (ordinal < cfg.maximum_marching_steps)
    return mask, t, pos, reach[:, -1]


def count_samples(cfg: SamplerConfig, aabb: AABB, occupancy, o, d, startt) -> torch.Tensor:
    """Occupied samples each ray takes over the whole lattice, (R,) int64."""
    R = o.shape[0]
    taken = torch.zeros((R,), dtype=torch.int64, device=o.device)
    ids = torch.arange(R, device=o.device)
    for i0 in range(0, n_lattice_points(cfg), CHUNK):
        if ids.numel() == 0:
            break
        mask, _, _, inside_end = march_chunk(cfg, aabb, occupancy, o[ids], d[ids], startt[ids], taken[ids], i0)
        t_new = taken[ids] + mask.sum(dim=1)
        taken[ids] = t_new
        ids = ids[inside_end & (t_new < cfg.maximum_marching_steps)]
    return taken
