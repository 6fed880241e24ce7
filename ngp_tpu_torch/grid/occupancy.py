"""Cascaded occupancy grid: state, upkeep, bitfield update and lookups, on torch.

Counterpart: ngp_tpu/grid/occupancy.py:37-59 (GridState, create_grid_state),
:62-92 (occupied_aabb), :95-147 (cell_centers, mark_untrained_grid),
:150-172 (_pcg4d), :175-256 (sample_grid_positions), :259-271
(splat_density_ema), :274-300 (update_occupancy), :448-462
(occupancy_lookup) and :465-504 (mip_from_pos, static_dt_mip). Same linear
layout (x + G*y + G^2*z) and the same (c, x, y, z) occupancy axes. Differs:
the two u32 salts that JAX draws from a threefry key are an explicit `salts`
argument (the caller draws them from a torch.Generator; tests inject JAX's),
and uint32 arithmetic runs in int64 masked to 32 bits (utils/qmc.py). The
pooled/packed march accelerators are not ported: the port's march tests
every lattice point directly.
"""

import math
from typing import NamedTuple

import torch

from ngp_tpu_torch.utils.config import SamplerConfig
from ngp_tpu_torch.utils.qmc import mul32

_MASK = 0xFFFFFFFF


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


# ---------------------------------------------------------------- grid upkeep
def cell_centers(cfg: SamplerConfig, cascade: int, device="cpu") -> torch.Tensor:
    """World-space centers of one cascade's cells, (G^3, 3), linear order."""
    g = cfg.grid_size
    ax = (torch.arange(g, dtype=torch.float32, device=device) + 0.5) / g - 0.5
    z, y, x = torch.meshgrid(ax, ax, ax, indexing="ij")
    pos = torch.stack([x.reshape(-1), y.reshape(-1), z.reshape(-1)], dim=-1)
    return pos * float(1 << cascade) + 0.5


def mark_untrained_grid(cfg: SamplerConfig, resolution, focal_length, xforms: torch.Tensor) -> torch.Tensor:
    """Initial density grid (n_cascades * G^3,): 0 where any camera sees the
    cell, else -1. A cell (center p, radius r) is visible from camera j if
    z = (p - t_j)·fwd_j > 0 and |x|-r < z * w/(2 fx), |y|-r < z * h/(2 fy)."""
    dev = xforms.device
    half_resx = torch.tensor(0.5 * float(resolution[0]), dtype=torch.float32)
    half_resy = torch.tensor(0.5 * float(resolution[1]), dtype=torch.float32)
    fx, fy = float(focal_length[0]), float(focal_length[1])
    xf = xforms.to(torch.float32)
    chunk = min(1 << 16, cfg.n_grid_elements)
    grids = []
    for c in range(cfg.n_cascades):
        pos = cell_centers(cfg, c, dev)
        radius = 0.5 * math.sqrt(3.0) * (1 << c) / cfg.grid_size
        vis = []
        for s in range(0, pos.shape[0], chunk):
            ploc = pos[s : s + chunk, None, :] - xf[None, :, :, 3]  # (chunk, n_images, 3)
            cam = [torch.einsum("pnc,nc->pn", ploc, xf[:, :, k]) for k in range(3)]
            v = (
                (cam[2] > 0)
                & (torch.abs(cam[0]) - radius < cam[2] / fx * half_resx)
                & (torch.abs(cam[1]) - radius < cam[2] / fy * half_resy)
            )
            vis.append(v.any(dim=1))
        grids.append(torch.where(torch.cat(vis), 0.0, -1.0))
    return torch.cat(grids)


def pcg4d(x, y, z, w):
    """Counter-based u32x4 hash (pcg4d, Jarzynski & Olano) on uint32-in-int64
    tensors; bit-exact with ngp_tpu's _pcg4d."""
    x, y, z, w = ((mul32(v, 1664525) + 1013904223) & _MASK for v in (x, y, z, w))
    for i in range(2):
        x = (x + mul32(y, w)) & _MASK
        y = (y + mul32(z, x)) & _MASK
        z = (z + mul32(x, y)) & _MASK
        w = (w + mul32(y, z)) & _MASK
        if i == 0:
            x, y, z, w = x ^ (x >> 16), y ^ (y >> 16), z ^ (z >> 16), w ^ (w >> 16)
    return x, y, z, w


def _u24_unit(h: torch.Tensor) -> torch.Tensor:
    """Top 24 bits of a u32 as a float32 in [0, 1) (exact)."""
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def sample_grid_positions(cfg: SamplerConfig, density: torch.Tensor, salts, n_uniform: int, n_nonuniform: int, step: int):
    """Pick grid cells and a random position inside each: ((N, 3) world pos,
    (N,) int64 cell index). `salts` are the two u32 draws ngp_tpu takes from
    its key. The uniform half keeps its first candidate cell; the
    nonuniform half keeps the first of 10 above min_optical_thickness (else
    the last)."""
    dev = density.device
    g, n_cells = cfg.grid_size, cfg.n_grid_elements
    tot = n_uniform + n_nonuniform
    s0, s1 = (int(s) & _MASK for s in salts)
    i = torch.cat([torch.arange(n_uniform, device=dev), torch.arange(n_nonuniform, device=dev) + n_uniform])
    step = int(step) & _MASK
    h0, h1, h2, h3 = pcg4d(i, torch.full_like(i, s0), torch.full_like(i, s1), torch.full_like(i, step))
    u = torch.stack([_u24_unit(h0), _u24_unit(h1), _u24_unit(h2)], dim=-1)
    levels = (_u24_unit(h3) * cfg.n_cascades).to(torch.int64).clamp(max=cfg.n_cascades - 1)

    shifted = (i + ((step * tot) & _MASK)) & _MASK
    cand0 = ((mul32(shifted, 56924617) + 96925573) & _MASK) % n_cells + levels * n_cells
    idx = cand0
    if n_nonuniform > 0:
        j = torch.arange(1, 10, device=dev)
        lin = (mul32(shifted[n_uniform:, None], 56924617) + mul32(j[None, :], 19349663) + 96925573) & _MASK
        cand_n = torch.cat([cand0[n_uniform:, None], lin % n_cells + levels[n_uniform:, None] * n_cells], dim=1)
        ok = density[cand_n] > cfg.min_optical_thickness
        first = torch.argmax(ok.to(torch.uint8), dim=1)
        pick = torch.where(ok.any(dim=1), first, 9)
        idx = torch.cat([cand0[:n_uniform], torch.gather(cand_n, 1, pick[:, None])[:, 0]])

    local = idx % n_cells
    cell = torch.stack([local % g, (local // g) % g, local // (g * g)], dim=-1).to(torch.float32)
    mip_scale = ((127 + idx // n_cells).to(torch.int32) << 23).view(torch.float32)[:, None]
    pos = ((cell + u) / g - 0.5) * mip_scale + 0.5
    return pos, idx


def splat_density_ema(cfg: SamplerConfig, state: GridState, indices: torch.Tensor, densities: torch.Tensor) -> GridState:
    """Scatter-max the samples' optical thickness (density * min step), then
    EMA-max decay: new = prev < 0 ? prev : max(prev * decay, splat)."""
    optical = densities * cfg.min_cone_stepsize
    current = torch.zeros_like(state.density).scatter_reduce(0, indices, optical, "amax", include_self=True)
    prev = state.density
    new = torch.where(prev < 0.0, prev, torch.maximum(prev * cfg.ema_decay, current))
    return state._replace(density=new, step=state.step + 1)
