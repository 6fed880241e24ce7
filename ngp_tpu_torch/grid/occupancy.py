"""Cascaded occupancy grid: state, upkeep, bitfield update and lookups, on torch.

Counterpart: ngp_tpu/grid/occupancy.py:37-59 (GridState, create_grid_state),
:62-92 (occupied_aabb), :95-147 (cell_centers, mark_untrained_grid), :150-172
(_pcg4d), :175-256 (sample_grid_positions, with the data-parallel offsets),
:259-271 (splat_density_ema, split into splat_density and ema_density as
ngp_tpu/parallel/mesh.py's update_fn splits it), :274-300 (update_occupancy),
:303-348 (pooled_occupancy, pooled_lookup: the coarse premask's halo-pooled
super-grid), :351-445 (packed_neighborhood, packed_chunk_lookup,
packed_cover_lookup), :448-462 (occupancy_lookup) and :465-504 (mip_from_pos,
static_dt_mip). Same linear layout (x + G*y + G^2*z) and the same (c, x, y, z)
occupancy axes. Differs: the two u32 salts that JAX draws from a threefry key
are an explicit `salts` argument (the caller draws them from a
torch.Generator; tests inject JAX's), uint32 arithmetic runs in int64 masked
to 32 bits (utils/qmc.py), and the packed words are int32 (27 bits used).
splat_density_ema and update_occupancy write into the state's own tensors
(copy_) and return it with the new step: a training step captured in a CUDA
graph reads the occupancy, occ_aabb and mean_density at fixed addresses (JAX
returns new arrays).
"""

import math
from typing import NamedTuple

import torch

from ngp_tpu_torch.utils.config import SamplerConfig
from ngp_tpu_torch.utils.device import resolve_device
from ngp_tpu_torch.utils.qmc import mul32

_MASK = 0xFFFFFFFF


class GridState(NamedTuple):
    density: torch.Tensor  # (n_cascades * G^3,) fp32
    occupancy: torch.Tensor  # (n_cascades, G, G, G) bool, axes (c, x, y, z)
    mean_density: torch.Tensor  # () fp32
    step: int  # grid-update counter
    occ_aabb: torch.Tensor  # (2, 3) world box of every occupied cell


def create_grid_state(cfg: SamplerConfig, device=None) -> GridState:
    """A zero grid on `device` (the card unless the caller passes another one)."""
    device = resolve_device(device)
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
    (mean = mean(relu(cascade 0)); occupied = density > min(0.01-ish, mean)),
    in place into the state's occupancy, mean_density and occ_aabb."""
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
    occupancy = torch.stack(levels)
    state.occupancy.copy_(occupancy)
    state.mean_density.copy_(mean)
    state.occ_aabb.copy_(occupied_aabb(cfg, occupancy))
    return state


POOL = 8  # fine cells per superblock edge (128^3 grid -> 16^3 super-grid)
HALO = 3  # fine-cell halo each superblock absorbs beyond its own 8^3 block


def pooled_occupancy(cfg: SamplerConfig, occupancy: torch.Tensor) -> torch.Tensor:
    """Halo-pooled super-occupancy, (n_cascades, G/8, G/8, G/8) bool:
    superblock b is True iff any fine cell of b's 8^3 block grown by a
    HALO-cell shell is occupied (a (8 + 2*HALO)^3 any-pool at stride 8). A
    lattice segment of 8 steps whose midpoint's superblock reads False holds
    no occupied sample: the halo absorbs the segment's (4 + 1)*dt half-extent
    (march-start jitter included), about 1.1 cells at base.json's dt. The
    pool runs one axis at a time (a max is separable, and the padding takes
    no part in it): one 3-D window of 14^3 cells an output took 0.17 ms a
    call at G = 128 on an H100."""
    w = POOL + 2 * HALO
    pooled = occupancy.to(torch.float32)[:, None]
    for axis in range(3):
        size, stride, pad = ([1, 1, 1], [1, 1, 1], [0, 0, 0])
        size[axis], stride[axis], pad[axis] = w, POOL, HALO
        pooled = torch.nn.functional.max_pool3d(pooled, size, stride=stride, padding=pad)
    return pooled[:, 0] > 0


def pooled_lookup(cfg: SamplerConfig, pooled: torch.Tensor, pos: torch.Tensor, mip: torch.Tensor) -> torch.Tensor:
    """pooled_occupancy at world positions; occupancy_lookup's addressing on
    the G/8 super-grid."""
    s = cfg.grid_size // POOL
    p = (pos - 0.5) * _exp2_neg(mip)[..., None] + 0.5
    cell = torch.clamp(torch.floor(p * s).to(torch.int64), 0, s - 1)
    flat = ((mip.to(torch.int64) * s + cell[..., 0]) * s + cell[..., 1]) * s + cell[..., 2]
    return pooled.reshape(-1)[flat]


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


def packed_neighborhood(cfg: SamplerConfig, occupancy: torch.Tensor) -> torch.Tensor:
    """Cascade-0 occupancy of each cell's 3^3 neighbourhood as one (G^3,)
    int32 word: bit (dx+1)*9 + (dy+1)*3 + (dz+1) is cell (x+dx, y+dy, z+dz),
    0 outside the grid; word index (x*G + y)*G + z."""
    g = cfg.grid_size
    occ0 = torch.nn.functional.pad(occupancy[0].to(torch.int32), (1, 1, 1, 1, 1, 1))
    word = torch.zeros((g, g, g), dtype=torch.int32, device=occupancy.device)
    bit = 0
    for dx in range(3):
        for dy in range(3):
            for dz in range(3):
                word |= occ0[dx : dx + g, dy : dy + g, dz : dz + g] << bit
                bit += 1
    return word.reshape(-1)


def _packed_word(cfg: SamplerConfig, packed: torch.Tensor, pos_mid: torch.Tensor):
    """(word of the midpoint's cell, the cell (..., 3)) for midpoints pos_mid."""
    g = cfg.grid_size
    cm = torch.clamp(torch.floor(pos_mid * g).to(torch.int64), 0, g - 1)
    return packed[(cm[..., 0] * g + cm[..., 1]) * g + cm[..., 2]], cm


def packed_chunk_lookup(cfg: SamplerConfig, packed: torch.Tensor, pos_mid: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Occupancy of the K points pos (..., K, 3) of a group from one packed
    word at the group midpoint pos_mid (..., 3): exactly occupancy_lookup at
    mip 0 for points within one cell of the midpoint's cell per axis."""
    g = cfg.grid_size
    word, cm = _packed_word(cfg, packed, pos_mid)
    cp = torch.clamp(torch.floor(pos * g).to(torch.int64), 0, g - 1)
    off = torch.clamp(cp - cm[..., None, :], -1, 1) + 1
    bit = off[..., 0] * 9 + off[..., 1] * 3 + off[..., 2]
    return ((word[..., None] >> bit) & 1).to(torch.bool)


def packed_cover_lookup(cfg: SamplerConfig, packed, pos_mid, pos, pos2) -> torch.Tensor:
    """Whether any cell of the box between cell(pos) and cell(pos2) (the cells
    a straight segment [pos, pos2] touches) is occupied, from one packed word
    per group: (..., K) bool, a superset of occupancy along the segment while
    both end cells lie within one cell of the midpoint's per axis."""
    g = cfg.grid_size
    word, cm = _packed_word(cfg, packed, pos_mid)
    cp = torch.clamp(torch.floor(pos * g).to(torch.int64), 0, g - 1)
    cq = torch.clamp(torch.floor(pos2 * g).to(torch.int64), 0, g - 1)
    lo = torch.clamp(torch.minimum(cp, cq) - cm[..., None, :], -1, 1) + 1
    hi = torch.clamp(torch.maximum(cp, cq) - cm[..., None, :], -1, 1) + 1
    rng = ((1 << (hi + 1)) - 1) & ~((1 << lo) - 1)  # per axis, bits lo..hi of {0, 1, 2}
    mx, my, mz = rng[..., 0], rng[..., 1], rng[..., 2]
    myz = sum(torch.where((my >> k) & 1 != 0, mz << (3 * k), 0) for k in range(3))
    box = sum(torch.where((mx >> k) & 1 != 0, myz << (9 * k), 0) for k in range(3))
    return (word[..., None] & box) != 0


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
def cell_centers(cfg: SamplerConfig, cascade: int, device=None) -> torch.Tensor:
    """World-space centers of one cascade's cells, (G^3, 3), linear order, on
    `device` (the card unless the caller passes another one)."""
    device = resolve_device(device)
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


def sample_grid_positions(cfg: SamplerConfig, density: torch.Tensor, salts, n_uniform: int, n_nonuniform: int, step: int,
                          uniform_offset: int = 0, nonuniform_offset: int | None = None, n_total_global: int | None = None):
    """Pick grid cells and a random position inside each: ((N, 3) world pos,
    (N,) int64 cell index). `salts` are the two u32 draws ngp_tpu takes from
    its key. The uniform half keeps its first candidate cell; the
    nonuniform half keeps the first of 10 above min_optical_thickness (else
    the last). uniform_offset, nonuniform_offset and n_total_global let a
    data-parallel shard draw its slice of a global [uniform; nonuniform]
    candidate set with the counter hashes of one device drawing all of it;
    the defaults are the single-device indexing."""
    dev = density.device
    g, n_cells = cfg.grid_size, cfg.n_grid_elements
    tot = n_total_global if n_total_global is not None else n_uniform + n_nonuniform
    if nonuniform_offset is None:
        nonuniform_offset = n_uniform
    s0, s1 = (int(s) & _MASK for s in salts)
    i = torch.cat([torch.arange(n_uniform, device=dev) + uniform_offset, torch.arange(n_nonuniform, device=dev) + nonuniform_offset])
    i = i & _MASK
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


def splat_density(cfg: SamplerConfig, state: GridState, indices: torch.Tensor, densities: torch.Tensor) -> torch.Tensor:
    """The scatter-max splat of the samples' optical thickness (density * min
    step) into a zero grid shaped like the state's density. Data-parallel
    upkeep merges the shards' splats with a MAX all-reduce before
    ema_density (the reference's global atomicMax)."""
    optical = densities * cfg.min_cone_stepsize
    return torch.zeros_like(state.density).scatter_reduce(0, indices, optical, "amax", include_self=True)


def ema_density(cfg: SamplerConfig, state: GridState, current: torch.Tensor) -> GridState:
    """EMA-max decay by a splat: new = prev < 0 ? prev : max(prev * decay,
    current), in place into the state's density; returns the state with the
    step advanced."""
    prev = state.density
    state.density.copy_(torch.where(prev < 0.0, prev, torch.maximum(prev * cfg.ema_decay, current)))
    return state._replace(step=state.step + 1)


def splat_density_ema(cfg: SamplerConfig, state: GridState, indices: torch.Tensor, densities: torch.Tensor) -> GridState:
    """Scatter-max splat, then EMA-max decay (splat_density, ema_density)."""
    return ema_density(cfg, state, splat_density(cfg, state, indices, densities))
