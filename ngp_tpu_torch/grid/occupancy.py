"""Cascaded occupancy grid: state, bitfield update and lookups, on torch.

Counterpart: ngp_tpu/grid/occupancy.py:37-59 (GridState, create_grid_state),
:62-92 (occupied_aabb), :274-300 (update_occupancy), :448-462
(occupancy_lookup) and :465-504 (mip_from_pos, static_dt_mip). Same linear
layout (x + G*y + G^2*z) and the same (c, x, y, z) occupancy axes. The grid
sampling/splat half (training) and the pooled/packed march accelerators are
not ported: the port's march tests every lattice point directly.
"""

import math
from typing import NamedTuple

import torch

from ngp_tpu_torch.utils.config import SamplerConfig


class GridState(NamedTuple):
    density: torch.Tensor  # (n_cascades * G^3,) fp32
    occupancy: torch.Tensor  # (n_cascades, G, G, G) bool, axes (c, x, y, z)
    mean_density: torch.Tensor  # () fp32
    step: int  # grid-update counter
    occ_aabb: torch.Tensor  # (2, 3) world box of every occupied cell


def create_grid_state(cfg: SamplerConfig, device="cpu") -> GridState:
    g = cfg.grid_size
    r = 0.5 * cfg.aabb_scale
    return GridState(
        density=torch.zeros((cfg.n_total_elements,), dtype=torch.float32, device=device),
        occupancy=torch.zeros((cfg.n_cascades, g, g, g), dtype=torch.bool, device=device),
        mean_density=torch.zeros((), dtype=torch.float32, device=device),
        step=0,
        occ_aabb=torch.tensor([[0.5 - r] * 3, [0.5 + r] * 3], dtype=torch.float32, device=device),
    )


def _first_true(v: torch.Tensor) -> torch.Tensor:
    """Index of the first True of a 1-D bool tensor (0 when none: argmax)."""
    return torch.argmax(v.to(torch.uint8))


def occupied_aabb(cfg: SamplerConfig, occupancy: torch.Tensor) -> torch.Tensor:
    """World AABB of every occupied cell, (2, 3) f32 [lo; hi], intersected
    with the scene box; an empty grid gives a point box at the center."""
    g = cfg.grid_size
    dev = occupancy.device
    los, his = [], []
    for c in range(cfg.n_cascades):
        occ = occupancy[c]
        nonempty = torch.any(occ)
        lo_i, hi_i = [], []
        for ax in range(3):
            v = torch.any(occ.permute(ax, *[i for i in range(3) if i != ax]).reshape(g, -1), dim=1)
            lo_i.append(_first_true(v))
            hi_i.append(g - 1 - _first_true(torch.flip(v, (0,))))
        lo_u = torch.stack(lo_i).to(torch.float32) / g
        hi_u = (torch.stack(hi_i).to(torch.float32) + 1.0) / g
        scale = float(1 << c)
        inf = torch.full((3,), math.inf, dtype=torch.float32, device=dev)
        los.append(torch.where(nonempty, (lo_u - 0.5) * scale + 0.5, inf))
        his.append(torch.where(nonempty, (hi_u - 0.5) * scale + 0.5, -inf))
    r = 0.5 * cfg.aabb_scale
    lo = torch.clamp(torch.amin(torch.stack(los), dim=0), min=0.5 - r)
    hi = torch.clamp(torch.amax(torch.stack(his), dim=0), max=0.5 + r)
    empty = lo[0] > hi[0]
    half = torch.full((3,), 0.5, dtype=torch.float32, device=dev)
    return torch.stack([torch.where(empty, half, lo), torch.where(empty, half, hi)])


def update_occupancy(cfg: SamplerConfig, state: GridState) -> GridState:
    """Threshold the grid into occupancy and max-pool up the cascades
    (mean = mean(relu(cascade 0)); occupied = density > min(0.01-ish, mean))."""
    g = cfg.grid_size
    mean = torch.mean(torch.clamp(state.density[: cfg.n_grid_elements], min=0.0))
    thresh = torch.clamp(mean, max=cfg.min_optical_thickness)
    occ_flat = state.density > thresh
    # linear index x + G*y + G^2*z -> (z, y, x) then transpose to (x, y, z)
    occ = occ_flat.reshape(cfg.n_cascades, g, g, g).permute(0, 3, 2, 1)

    levels = [occ[0]]
    q = g // 4
    for c in range(1, cfg.n_cascades):
        fine = levels[-1]
        pooled = fine.reshape(g // 2, 2, g // 2, 2, g // 2, 2).any(dim=5).any(dim=3).any(dim=1)
        merged = occ[c].clone()
        merged[q : 3 * q, q : 3 * q, q : 3 * q] |= pooled
        levels.append(merged)
    occupancy = torch.stack(levels).contiguous()
    return state._replace(occupancy=occupancy, mean_density=mean, occ_aabb=occupied_aabb(cfg, occupancy))


def _exp2_neg(mip: torch.Tensor) -> torch.Tensor:
    """2^-mip for small integer mip, built from its exponent bits (exact)."""
    return ((127 - mip.to(torch.int32)) << 23).view(torch.float32)


def occupancy_lookup(cfg: SamplerConfig, occupancy: torch.Tensor, pos: torch.Tensor, mip: torch.Tensor) -> torch.Tensor:
    """Occupancy at world positions for given mips; pos (..., 3), mip (...,)."""
    g = cfg.grid_size
    p = (pos - 0.5) * _exp2_neg(mip)[..., None] + 0.5
    cell = torch.clamp(torch.floor(p * g).to(torch.int64), 0, g - 1)
    flat = ((mip.to(torch.int64) * g + cell[..., 0]) * g + cell[..., 1]) * g + cell[..., 2]
    return occupancy.reshape(-1)[flat]


def _frexp_exponent(x: torch.Tensor) -> torch.Tensor:
    """frexpf exponent from the float32 exponent bits (exact for normals)."""
    bits = x.to(torch.float32).view(torch.int32)
    return ((bits >> 23) & 0xFF) - 126


def mip_from_pos(pos: torch.Tensor, n_cascades: int) -> torch.Tensor:
    """Smallest cascade whose cube contains pos (occupancy_sampler.cu:216-221)."""
    maxval = torch.amax(torch.abs(pos - 0.5), dim=-1)
    mip = torch.clamp(_frexp_exponent(maxval) + 1, 0, n_cascades - 1)
    return torch.where(maxval == 0.0, torch.full_like(mip, min(1, n_cascades - 1)), mip)


def mip_from_dt(dt: torch.Tensor, pos: torch.Tensor, grid_size: int, n_cascades: int) -> torch.Tensor:
    """Cascade from position, bumped up if dt spans more than half a cell."""
    mip = mip_from_pos(pos, n_cascades)
    d = dt * 2.0 * grid_size
    dt_mip = torch.clamp(_frexp_exponent(d), 0, n_cascades - 1)
    return torch.where(d < 1.0, mip, torch.maximum(mip, dt_mip))


def static_dt_mip(dt: float, grid_size: int, n_cascades: int) -> int:
    """Mip floor of a constant step size: -1 when dt spans under half a cell."""
    d = dt * 2.0 * grid_size
    if d < 1.0:
        return -1
    _, e = math.frexp(d)
    return int(min(max(e, 0), n_cascades - 1))
