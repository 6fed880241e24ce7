"""Multiresolution hash-grid encoding, all three variants: CUDA kernels for Hopper + plain versions.

Counterpart: ngp_tpu/ops/hash_encoding.py:90-151 (HashGridSpec.create),
:200-291 (the "tcnn" variant: _corner_indices_weights, _encode_tcnn,
_bwd_tcnn, _weight_grads), :297-419 (the "xadd" variant:
_pair_indices_weights, _encode_xadd_packed, _bwd_xadd), :425-436
(_oct_offsets), :459-486 (_oct_base_w0), :498-513 (_encode_oadd_packed),
:520-650 (_bwd_oadd_stochastic, _bwd_oadd with its analytic d/dpos),
:695-720 (hash_encode's custom_vjp) and :723-755 (hash_encode_const_pos,
the training encode, which takes the stochastic deposit only for
variant "oadd").
Differs deliberately in the gather: ngp_tpu gathers one row of a packed
view per (sample, level), "oct" for oadd (8*F floats per row, ~0.5 GB at
full size) and "pair" for xadd (2*F), because TPU gathers cost per row; the
port gathers the 8 corners directly from the (L, T_pad, F) table. An oadd
corner k is row idx0 + offs[k], taken mod T_pad; an xadd pair row [t[r],
t[r+1 mod T]] is the two corner rows r and (r + 1) mod size; tcnn's 8 rows
are independent. That is exact: every hash level's size equals
padded_size, and on dense levels the clamps keep every row inside the
level. All levels are evaluated in one batched pass instead of a per-level
scan. The backward scatters into the (L, T_pad, F) table in fp32 (ngp_tpu
accumulates in bf16, and xadd and tcnn have no fp32 switch; on the card the
fp32 sums have no fixed order).

The gather (`hash_encode`) and both table scatters (`hash_bwd_exact`, every
variant, and `hash_bwd_oadd_stochastic`, oadd only) launch hand-written
kernels on CUDA tensors (csrc/hash_encode_fwd.cu, csrc/hash_encode_bwd.cu,
built by ops/kernels.py, bound through ctypes) and run their plain versions
(the `*_plain` functions) on CPU tensors; any other device raises. The
analytic d/dpos (`hash_dpos`, for input_gradient and the Normals mode) is
plain torch on every device.

Index math in the plain versions runs in int64 with uint32 wraparound
(masked to 32 bits), as the JAX code computes it in uint32; the grid
coordinate pos*scale + 0.5 is a fused multiply-add (utils/fma.py), as XLA
compiles it (the kernels use __fmaf_rn).
"""

import ctypes
import functools
import math
from dataclasses import dataclass

import torch

from ngp_tpu_torch.ops import kernels
from ngp_tpu_torch.utils import profiling
from ngp_tpu_torch.utils.config import HashEncodingConfig
from ngp_tpu_torch.utils.fma import fma
from ngp_tpu_torch.utils.qmc import mul32

_MASK = 0xFFFFFFFF

# "oadd" linear-hash strides (ngp_tpu/ops/hash_encoding.py:80-81)
_OCT_SY = 258583
_OCT_SZ = 253757
# tiny-cuda-nn's primes for y and z (x's is 1), of the "xadd" and "tcnn"
# hashes (ngp_tpu/ops/hash_encoding.py:73)
_PRIME_Y = 2654435761
_PRIME_Z = 805459861

VARIANTS = ("oadd", "xadd", "tcnn")  # csrc/hash_grid.cuh Variant, in this order

MAX_LEVELS = 32  # csrc/hash_grid.cuh kMaxLevels
KERNEL_FEATURES = (1, 2, 4, 8)  # feature widths the kernels are built for


@dataclass(frozen=True)
class HashGridSpec:
    """Static per-level layout, precomputed on the host from the config."""

    n_levels: int
    n_features: int
    scales: tuple  # float per level
    resolutions: tuple  # int per level
    dense: tuple  # bool per level
    sizes: tuple  # logical table entries per level
    offsets: tuple  # exclusive prefix of sizes (for flat export)
    variant: str = "xadd"
    stochastic_bwd: bool = False
    stochastic_level_rate: int = 1

    @property
    def padded_size(self) -> int:
        return max(self.sizes)

    @property
    def n_output_dims(self) -> int:
        return self.n_levels * self.n_features

    @staticmethod
    def create(cfg: HashEncodingConfig) -> "HashGridSpec":
        scales, resolutions, dense, sizes, offsets = [], [], [], [], []
        off = 0
        for l in range(cfg.n_levels):
            scale = cfg.base_resolution * (cfg.scale**l) - 1.0
            res = int(math.ceil(scale)) + 1
            # a level is dense only if its 8-aligned size fits, so every hash
            # level's size equals padded_size (exact mod-T_pad corner rows)
            aligned = -(-(res**3) // 8) * 8
            is_dense = aligned <= cfg.hashmap_size
            size = aligned if is_dense else cfg.hashmap_size
            scales.append(scale)
            resolutions.append(res)
            dense.append(is_dense)
            sizes.append(size)
            offsets.append(off)
            off += size
        return HashGridSpec(
            n_levels=cfg.n_levels,
            n_features=cfg.n_features_per_level,
            scales=tuple(scales),
            resolutions=tuple(resolutions),
            dense=tuple(dense),
            sizes=tuple(sizes),
            offsets=tuple(offsets),
            variant=cfg.hash_variant,
            stochastic_bwd=getattr(cfg, "stochastic_corner_backward", False),
            stochastic_level_rate=getattr(cfg, "stochastic_level_rate", 1),
        )


def check_variant(spec: HashGridSpec):
    """Raise ValueError unless spec.variant is one of VARIANTS."""
    if spec.variant not in VARIANTS:
        raise ValueError(f"unknown hash variant {spec.variant!r}: expected one of {VARIANTS}")


def oct_offsets(spec: HashGridSpec, l: int):
    """(sy, sz, offsets[8]) for level l; offsets[k] is the table offset of
    corner k (bit0=x, bit1=y, bit2=z) from the cell's base row."""
    size = spec.sizes[l]
    if spec.dense[l]:
        sy, sz = spec.resolutions[l], spec.resolutions[l] ** 2
    else:
        sy, sz = _OCT_SY % size, _OCT_SZ % size
    offs = [((k & 1) + ((k >> 1) & 1) * sy + ((k >> 2) & 1) * sz) % size for k in range(8)]
    return sy, sz, offs


def hash_table_init(generator: torch.Generator, spec: HashGridSpec, scale: float = 1e-4) -> torch.Tensor:
    """Uniform(-1e-4, 1e-4) table in the port's (L, T_pad, F) layout."""
    u = torch.rand(
        (spec.n_levels, spec.padded_size, spec.n_features), generator=generator, device=generator.device
    )
    return u * (2.0 * scale) - scale


def _level_constants(spec: HashGridSpec, device):
    per = [oct_offsets(spec, l) for l in range(spec.n_levels)]
    i64 = dict(dtype=torch.int64, device=device)
    return {
        "scale": torch.tensor(spec.scales, dtype=torch.float32, device=device),
        "res": torch.tensor(spec.resolutions, **i64),
        "dense": torch.tensor(spec.dense, dtype=torch.bool, device=device),
        "size": torch.tensor(spec.sizes, **i64),
        "sy": torch.tensor([p[0] for p in per], **i64),
        "sz": torch.tensor([p[1] for p in per], **i64),
        "offs": torch.tensor([p[2] for p in per], **i64),  # (L, 8)
    }


def _grid_coords(pos: torch.Tensor, lc: dict):
    """pos (N, 3) -> each level's cell (N, L, 3) int64 and fraction (N, L, 3)
    f32: scaled = pos * scale + 0.5 (one fma), base = floor, frac = scaled - base."""
    scaled = fma(pos[:, None, :], lc["scale"][None, :, None], 0.5)  # (N, L, 3)
    base_f = torch.floor(scaled)
    return base_f.to(torch.int64), scaled - base_f


def oct_base_w0(pos: torch.Tensor, lc: dict, with_dlive: bool = False):
    """oadd: base row and corner-0 per-dim weights for every level.

    pos (N, 3) -> (idx0 (N, L) int64, w0 (N, L, 3) f32), and with
    `with_dlive` also dlive (N, L, 3) f32. Dense levels clamp each dim's
    corner pair into [0, res-2] with the weight shifted onto the surviving
    entry (exactly clip-to-[0, res-1] semantics); dlive is 0 in a clamped
    dim, whose weight no longer moves with pos."""
    base, frac = _grid_coords(pos, lc)

    res = lc["res"][None, :, None]
    top = torch.clamp(res - 2, min=0)
    bc = torch.minimum(torch.clamp(base, min=0), top)
    hi = base > res - 2
    lo = base < 0
    w0_dense = torch.where(hi, 0.0, torch.where(lo, 1.0, 1.0 - frac))
    dense = lc["dense"][None, :, None]
    b = torch.where(dense, bc, base)
    w0 = torch.where(dense, w0_dense, 1.0 - frac)

    u = b & _MASK  # uint32 view of the (possibly negative) cell coordinate
    idx0 = (u[..., 0] + ((u[..., 1] * lc["sy"]) & _MASK)) & _MASK
    idx0 = (idx0 + ((u[..., 2] * lc["sz"]) & _MASK)) & _MASK
    if with_dlive:
        dlive = torch.where(dense & (hi | lo), 0.0, 1.0)
        return idx0 % lc["size"], w0, dlive
    return idx0 % lc["size"], w0


def _corner_bits(device) -> torch.Tensor:
    """(8, 3) bool: bit d of corner k (bit0 = x, bit1 = y, bit2 = z)."""
    return torch.tensor([[(k >> d) & 1 for d in range(3)] for k in range(8)], dtype=torch.bool, device=device)


def _corner_factors(w0: torch.Tensor) -> torch.Tensor:
    """(..., 3) corner-0 weights -> (..., 8, 3): corner k's weight factor in
    each dim, w0 where bit d of k is 0 and 1 - w0 where it is 1."""
    return torch.where(_corner_bits(w0.device), 1.0 - w0[..., None, :], w0[..., None, :])


def _rows(idx0: torch.Tensor, offs: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    """Table row of corner(s) `offs` from base row idx0, wrapped mod the level size."""
    row = idx0 + offs
    return torch.where(row >= size, row - size, row)


def _cells_oadd(pos: torch.Tensor, lc: dict):
    idx0, w0, dlive = oct_base_w0(pos, lc, with_dlive=True)
    rows = _rows(idx0[:, :, None], lc["offs"][None], lc["size"][None, :, None])
    return rows, _corner_factors(w0), dlive


def _cells_tcnn(pos: torch.Tensor, lc: dict):
    """tcnn (ngp_tpu's _corner_indices_weights): 8 independent corner rows.
    Dense levels clamp each corner's coordinate into [0, res-1] and leave
    the weights alone (two corners may share a row); hash levels take
    (x ^ y*2654435761 ^ z*805459861) mod size in uint32."""
    base, frac = _grid_coords(pos, lc)
    bits = _corner_bits(pos.device)
    c = base[:, :, None, :] + bits.to(torch.int64)  # (N, L, 8, 3)
    res = lc["res"][None, :, None]
    cd = torch.minimum(torch.clamp(c, min=0), res[..., None] - 1)
    rows_dense = cd[..., 0] + cd[..., 1] * res + cd[..., 2] * (res * res)
    u = c & _MASK
    rows_hash = (u[..., 0] ^ mul32(u[..., 1], _PRIME_Y) ^ mul32(u[..., 2], _PRIME_Z)) % lc["size"][None, :, None]
    rows = torch.where(lc["dense"][None, :, None], rows_dense, rows_hash)
    factors = torch.where(bits, frac[:, :, None, :], 1.0 - frac[:, :, None, :])
    return rows, factors, torch.ones_like(frac)


def _cells_xadd(pos: torch.Tensor, lc: dict):
    """xadd (ngp_tpu's _pair_indices_weights): corners k and k|1 are rows r
    and (r + 1) mod size of the pair row r = (x + (y*2654435761 ^
    z*805459861)) mod size on hash levels. Dense levels clamp the x-pair
    into [0, res-2] with the weight shifted onto the surviving entry (its
    d/dx is 0 there) and each y and z corner coordinate into [0, res-1]."""
    base, frac = _grid_coords(pos, lc)
    bits = _corner_bits(pos.device)
    bx, fx = base[..., 0], frac[..., 0]  # (N, L)
    cy = base[..., 1, None] + bits[:, 1].to(torch.int64)  # (N, L, 8)
    cz = base[..., 2, None] + bits[:, 2].to(torch.int64)
    res, size, dense = lc["res"][None, :], lc["size"][None, :, None], lc["dense"][None, :]

    xb = torch.minimum(torch.clamp(bx, min=0), torch.clamp(res - 2, min=0))
    hi, lo = bx > res - 2, bx < 0
    wx0 = torch.where(dense, torch.where(hi, 0.0, torch.where(lo, 1.0, 1.0 - fx)), 1.0 - fx)
    r = res[..., None]
    rows_dense = xb[..., None] + torch.clamp(cy, 0).minimum(r - 1) * r + torch.clamp(cz, 0).minimum(r - 1) * (r * r)
    h = mul32(cy & _MASK, _PRIME_Y) ^ mul32(cz & _MASK, _PRIME_Z)
    rows_hash = (((bx & _MASK)[..., None] + h) & _MASK) % size
    pair = torch.where(dense[..., None], rows_dense, rows_hash)
    rows = _rows(pair, bits[:, 0].to(torch.int64), size)

    wx = torch.where(bits[:, 0], 1.0 - wx0[..., None], wx0[..., None])  # (N, L, 8)
    wy = torch.where(bits[:, 1], frac[..., 1, None], 1.0 - frac[..., 1, None])
    wz = torch.where(bits[:, 2], frac[..., 2, None], 1.0 - frac[..., 2, None])
    dx_live = torch.where(dense & (hi | lo), 0.0, 1.0)
    dlive = torch.stack([dx_live, torch.ones_like(dx_live), torch.ones_like(dx_live)], dim=-1)
    return rows, torch.stack([wx, wy, wz], dim=-1), dlive


_CELLS = {"oadd": _cells_oadd, "xadd": _cells_xadd, "tcnn": _cells_tcnn}


def _corner_cells(pos: torch.Tensor, spec: HashGridSpec, lc: dict | None = None):
    """Every (sample, level)'s 8 corners under spec.variant: rows (N, L, 8)
    int64 of each level's own table, weight factors (N, L, 8, 3) (corner
    k's factor in each dim) and dlive (N, L, 3) (0 in a dim whose weights
    a dense clamp fixed, so d/dpos is 0 there)."""
    check_variant(spec)
    return _CELLS[spec.variant](pos, _level_constants(spec, pos.device) if lc is None else lc)


def _corner_weights(factors: torch.Tensor, variant: str) -> torch.Tensor:
    """(..., 8, 3) factors -> (..., 8) trilinear weights, multiplied in
    ngp_tpu's order: (wx * wy) * wz, and (wy * wz) * wx for xadd."""
    if variant == "xadd":
        return factors[..., 1] * factors[..., 2] * factors[..., 0]
    return factors[..., 0] * factors[..., 1] * factors[..., 2]


def _flat(rows: torch.Tensor, spec: HashGridSpec) -> torch.Tensor:
    """Level-local rows (N, L, 8) -> rows of the flattened (L * T_pad, F) table."""
    return rows + (torch.arange(spec.n_levels, device=rows.device) * spec.padded_size)[None, :, None]


def corner_rows(pos: torch.Tensor, spec: HashGridSpec) -> torch.Tensor:
    """(N, L, 8) int64 rows of the flattened (L * T_pad, F) table that the
    8 corners of each sample's cell read at each level, under spec.variant."""
    return _flat(_corner_cells(pos, spec)[0], spec)


def hash_encode_plain(table: torch.Tensor, pos: torch.Tensor, spec: HashGridSpec) -> torch.Tensor:
    """The gather kernel's function in plain torch, for spec.variant.
    table (L, T_pad, F) fp32; pos (N, 3) in [0,1] -> (N, L*F)."""
    n = pos.shape[0]
    L, T_pad, F = table.shape
    rows, factors, _ = _corner_cells(pos, spec)
    w8 = _corner_weights(factors, spec.variant)  # (N, L, 8)
    feats = table.reshape(L * T_pad, F)[_flat(rows, spec).reshape(-1)].reshape(n, L, 8, F)
    out = (w8[..., None] * feats).sum(dim=2)  # (N, L, F)
    return out.reshape(n, L * F)


# ------------------------------------------------------------------ backward
def exact_deposits(pos: torch.Tensor, spec: HashGridSpec, g: torch.Tensor):
    """The exact scatter's deposits under spec.variant: rows (N*L*8,) int64 of
    the flattened (L * T_pad, F) table and the values w8[k] * g (N*L*8, F)
    fp32 added there, in (sample, level, corner) order."""
    n, L, F = pos.shape[0], spec.n_levels, spec.n_features
    rows, factors, _ = _corner_cells(pos, spec)
    w8 = _corner_weights(factors, spec.variant)  # (N, L, 8)
    return _flat(rows, spec).reshape(-1), (w8[..., None] * g.reshape(n, L, 1, F)).reshape(-1, F)


def hash_bwd_exact_plain(pos: torch.Tensor, spec: HashGridSpec, g: torch.Tensor) -> torch.Tensor:
    """The exact scatter's function in plain torch: the table gradient of
    spec.variant (no d/dpos), every sample deposits w8[k] * g into all 8
    corner rows of its cell (ngp_tpu's _bwd_oadd, _bwd_xadd, _bwd_tcnn).
    pos (N, 3), g (N, L*F) -> (L, T_pad, F) fp32, accumulated in fp32."""
    L, F, T = spec.n_levels, spec.n_features, spec.padded_size
    d = torch.zeros((L * T, F), dtype=torch.float32, device=pos.device)
    d.index_add_(0, *exact_deposits(pos, spec, g))
    return d.reshape(L, T, F)


def level_rate(spec: HashGridSpec, n: int) -> int:
    """The stochastic deposit's level rate kr for N = n samples:
    spec.stochastic_level_rate where it is > 1 and divides n, else 1."""
    kr = spec.stochastic_level_rate
    return kr if kr > 1 and n % kr == 0 else 1


def _require_oadd_stochastic(spec: HashGridSpec):
    if spec.variant != "oadd":
        raise ValueError(f"the stochastic deposit is oadd's; hash variant {spec.variant!r} takes the exact one")


def hash_bwd_oadd_stochastic_plain(pos: torch.Tensor, spec: HashGridSpec, g: torch.Tensor) -> torch.Tensor:
    """The stochastic scatter's function in plain torch: the one-corner
    unbiased table gradient (ngp_tpu's _bwd_oadd_stochastic):
    per (sample, level) one corner drawn with probability equal to its
    trilinear weight, from a hash of pos's float32 bits, receives the
    unweighted g. With stochastic_level_rate kr > 1 (and N % kr == 0),
    sample slot i deposits only into levels l with l % kr == i % kr, scaled
    by kr. Accumulates in fp32 (ngp_tpu: bf16 by default). oadd only."""
    _require_oadd_stochastic(spec)
    n, L, F, T = pos.shape[0], spec.n_levels, spec.n_features, spec.padded_size
    dev = pos.device
    kr = level_rate(spec, n)
    lc = _level_constants(spec, dev)
    idx0, w0 = oct_base_w0(pos, lc)  # (N, L), (N, L, 3)
    pbits = pos.contiguous().view(torch.int32).to(torch.int64) & _MASK
    hb = mul32(pbits[:, 0], 0x9E3779B1) ^ mul32(pbits[:, 1], 0x85EBCA77) ^ mul32(pbits[:, 2], 0xC2B2AE3D)
    lsalt = mul32(torch.arange(1, L + 1, device=dev), 0x27D4EB2F)
    h = hb[:, None] ^ lsalt[None, :]  # (N, L)
    k = torch.zeros((n, L), dtype=torch.int64, device=dev)
    for d in range(3):  # one independent 24-bit uniform per dim
        h = mul32(h ^ (h >> 15), 0x2C1B3C6D)
        u = (h >> 8).to(torch.float32) * (2.0**-24)
        k = k | ((u >= w0[..., d]).to(torch.int64) << d)
    offs = torch.gather(lc["offs"][None].expand(n, L, 8), 2, k[..., None])[..., 0]
    rows = _rows(idx0, offs, lc["size"][None, :]) + (torch.arange(L, device=dev) * T)[None, :]
    gl = g.reshape(n, L, F)
    if kr > 1:
        # in each run of kr slots, level l is kept by slot l % kr: fixed
        # shapes, so no host sync
        lv = torch.arange(L, device=dev)
        rows = rows.reshape(n // kr, kr, L)[:, lv % kr, lv]
        gl = gl.reshape(n // kr, kr, L, F)[:, lv % kr, lv] * float(kr)
    d = torch.zeros((L * T, F), dtype=torch.float32, device=dev)
    d.index_add_(0, rows.reshape(-1), gl.reshape(-1, F))
    return d.reshape(L, T, F)


def hash_dpos(table: torch.Tensor, pos: torch.Tensor, spec: HashGridSpec, g: torch.Tensor) -> torch.Tensor:
    """d(sum(g * hash_encode(table, pos)))/d(pos), (N, 3) fp32: the analytic
    trilinear derivative of ngp_tpu's backward for spec.variant (_bwd_oadd's
    need_pos_grad branch, ops/hash_encoding.py:634-643; _bwd_xadd's,
    :395-413; _bwd_tcnn's _weight_grads, :279-291), summed over levels. Per
    level and dim d, scale * sum_k sign_d(k) * W_o1(k) * W_o2(k) * <feat_k, g>,
    zero in a dim whose weights a dense clamp fixed (dlive). Plain torch on
    every device."""
    n, L, F, T = pos.shape[0], spec.n_levels, spec.n_features, spec.padded_size
    lc = _level_constants(spec, pos.device)
    rows, W, dlive = _corner_cells(pos, spec, lc)  # (N, L, 8), (N, L, 8, 3), (N, L, 3)
    feats = table.reshape(L * T, F)[_flat(rows, spec).reshape(-1)].reshape(n, L, 8, F)
    s = (feats * g.reshape(n, L, 1, F)).sum(dim=-1)  # (N, L, 8)
    sign = _corner_bits(pos.device).to(torch.float32) * 2.0 - 1.0  # (8, 3)
    dims = []
    for d in range(3):
        o1, o2 = (d + 1) % 3, (d + 2) % 3
        prod_other = W[..., o1] * W[..., o2]  # (N, L, 8)
        dims.append(dlive[..., d] * (sign[:, d] * prod_other * s).sum(dim=-1) * lc["scale"])
    return torch.stack(dims, dim=-1).sum(dim=1)


# ---------------------------------------------------------------- kernels
class LevelConstants(ctypes.Structure):
    """csrc/hash_grid.cuh's LevelConstants: one spec's per-level constants,
    passed to each kernel by value."""

    _fields_ = [
        ("scale", ctypes.c_float * MAX_LEVELS),
        ("res", ctypes.c_int * MAX_LEVELS),
        ("dense", ctypes.c_int * MAX_LEVELS),
        ("size", ctypes.c_uint32 * MAX_LEVELS),
        ("sy", ctypes.c_uint32 * MAX_LEVELS),
        ("sz", ctypes.c_uint32 * MAX_LEVELS),
        ("offs", (ctypes.c_uint32 * 8) * MAX_LEVELS),
        ("n_levels", ctypes.c_int),
        ("variant", ctypes.c_int),  # index in VARIANTS
    ]


@functools.lru_cache(maxsize=None)
def level_constants(spec: HashGridSpec) -> LevelConstants:
    """The kernels' level constants of `spec`, built once per spec on the
    host (no launch copies anything to the card for them)."""
    if spec.n_levels > MAX_LEVELS:
        raise ValueError(f"the hash kernels take up to {MAX_LEVELS} levels, got {spec.n_levels}")
    check_variant(spec)
    lc = LevelConstants()
    lc.n_levels = spec.n_levels
    lc.variant = VARIANTS.index(spec.variant)
    for l in range(spec.n_levels):
        sy, sz, offs = oct_offsets(spec, l)
        lc.scale[l] = spec.scales[l]
        lc.res[l] = spec.resolutions[l]
        lc.dense[l] = int(spec.dense[l])
        lc.size[l], lc.sy[l], lc.sz[l] = spec.sizes[l], sy, sz
        for k in range(8):
            lc.offs[l][k] = offs[k]
    return lc


def _library(name: str, entry: str, *ints):
    lib = kernels.library(name)
    fn = getattr(lib, entry)
    p = ctypes.c_void_p
    fn.argtypes = [p] * 3 + list(ints) + [ctypes.POINTER(LevelConstants), p]
    fn.restype = ctypes.c_int
    return fn


def _check_kernel_inputs(spec: HashGridSpec, pos: torch.Tensor, **tensors):
    """Raise unless pos is (N, 3) and every other tensor matches the kernels'
    dtype, shape and device; all must be contiguous."""
    check_variant(spec)
    if spec.n_features not in KERNEL_FEATURES:
        raise ValueError(f"the hash kernels take {KERNEL_FEATURES} features per level, got {spec.n_features}")
    n = pos.shape[0] if pos.dim() == 2 else -1
    shapes = {"pos": (n, 3), "table": (spec.n_levels, spec.padded_size, spec.n_features), "g": (n, spec.n_output_dims)}
    for name, x in dict(tensors, pos=pos).items():
        if x.dtype != torch.float32 or tuple(x.shape) != shapes[name] or n < 0:
            raise ValueError(f"{name} must be {shapes[name]} float32, got {tuple(x.shape)} {x.dtype}")
        if x.device != pos.device:
            raise ValueError(f"{name} is on {x.device}, expected {pos.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def hash_encode_cuda(table: torch.Tensor, pos: torch.Tensor, spec: HashGridSpec) -> torch.Tensor:
    """Launch the gather kernel on the current stream: (N, L*F) fp32."""
    _check_kernel_inputs(spec, pos, table=table)
    n = pos.shape[0]
    out = torch.empty((n, spec.n_output_dims), dtype=torch.float32, device=pos.device)
    if n == 0:
        return out
    fn = _library("hash_encode_fwd", "hash_encode_fwd", ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int)
    err = fn(
        table.data_ptr(), pos.data_ptr(), out.data_ptr(), n, spec.padded_size, spec.n_features,
        ctypes.byref(level_constants(spec)), torch.cuda.current_stream(pos.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"hash_encode_fwd launch failed: CUDA error {err}")
    profiling.count("launches.hash_encode_fwd")
    return out


def hash_bwd_exact_cuda(pos: torch.Tensor, spec: HashGridSpec, g: torch.Tensor) -> torch.Tensor:
    """Launch the exact scatter of spec.variant on the current stream:
    (L, T_pad, F) fp32. The zero fill is a launch on the same stream, so a
    CUDA graph captures it with the scatter (from the graph's pool)."""
    _check_kernel_inputs(spec, pos, g=g)
    n = pos.shape[0]
    d = torch.zeros((spec.n_levels, spec.padded_size, spec.n_features), dtype=torch.float32, device=pos.device)
    if n == 0:
        return d
    fn = _library("hash_encode_bwd", "hash_encode_bwd_exact", ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int)
    err = fn(
        pos.data_ptr(), g.data_ptr(), d.data_ptr(), n, spec.padded_size, spec.n_features,
        ctypes.byref(level_constants(spec)), torch.cuda.current_stream(pos.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"hash_encode_bwd (exact) launch failed: CUDA error {err}")
    profiling.count("launches.hash_encode_bwd_exact")
    return d


def hash_bwd_oadd_stochastic_cuda(pos: torch.Tensor, spec: HashGridSpec, g: torch.Tensor) -> torch.Tensor:
    """Launch the stochastic scatter on the current stream: (L, T_pad, F) fp32.
    oadd only."""
    _require_oadd_stochastic(spec)
    _check_kernel_inputs(spec, pos, g=g)
    n = pos.shape[0]
    d = torch.zeros((spec.n_levels, spec.padded_size, spec.n_features), dtype=torch.float32, device=pos.device)
    if n == 0:
        return d
    fn = _library(
        "hash_encode_bwd", "hash_encode_bwd_stochastic", ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int
    )
    err = fn(
        pos.data_ptr(), g.data_ptr(), d.data_ptr(), n, level_rate(spec, n), spec.padded_size, spec.n_features,
        ctypes.byref(level_constants(spec)), torch.cuda.current_stream(pos.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"hash_encode_bwd (stochastic) launch failed: CUDA error {err}")
    profiling.count("launches.hash_encode_bwd_stochastic")
    return d


def _on_device(name: str, pos: torch.Tensor, cuda, plain, *args):
    """The kernel for a CUDA pos, the plain version for a CPU one; any other
    device raises."""
    if pos.device.type == "cuda":
        return cuda(*args)
    if pos.device.type == "cpu":
        return plain(*args)
    raise ValueError(f"{name} runs on cuda or cpu tensors, got {pos.device}")


def hash_encode(table: torch.Tensor, pos: torch.Tensor, spec: HashGridSpec) -> torch.Tensor:
    """Forward of spec.variant, not differentiable: table (L, T_pad, F) fp32,
    pos (N, 3) in [0,1] -> (N, L*F). The kernel on CUDA tensors, the plain
    version on CPU tensors; an unknown variant raises ValueError."""
    check_variant(spec)
    return _on_device("hash_encode", pos, hash_encode_cuda, hash_encode_plain, table, pos.contiguous(), spec)


def hash_bwd_exact(pos: torch.Tensor, spec: HashGridSpec, g: torch.Tensor) -> torch.Tensor:
    """Exact table gradient (L, T_pad, F) fp32 of g (N, L*F), for spec.variant."""
    check_variant(spec)
    return _on_device("hash_bwd_exact", pos, hash_bwd_exact_cuda, hash_bwd_exact_plain, pos.contiguous(), spec, g.contiguous())


def hash_bwd_oadd_stochastic(pos: torch.Tensor, spec: HashGridSpec, g: torch.Tensor) -> torch.Tensor:
    """One-corner oadd table gradient (L, T_pad, F) fp32 of g (N, L*F);
    any other variant raises ValueError (ngp_tpu never draws for them)."""
    _require_oadd_stochastic(spec)
    return _on_device(
        "hash_bwd_oadd_stochastic", pos, hash_bwd_oadd_stochastic_cuda, hash_bwd_oadd_stochastic_plain,
        pos.contiguous(), spec, g.contiguous(),
    )


# --------------------------------------------------------------- autograd
class _HashEncodeConstPos(torch.autograd.Function):
    """hash_encode with a table gradient and none for pos (ngp_tpu's
    hash_encode_const_pos, ops/hash_encoding.py:723-755): the stochastic
    deposit for an oadd spec with stochastic_bwd, as ngp_tpu picks it
    (:742), the exact scatter otherwise (HashGridSpec.create copies
    stochastic_corner_backward into every variant's spec)."""

    @staticmethod
    def forward(ctx, table, pos, spec):
        ctx.save_for_backward(pos)
        ctx.spec = spec
        return hash_encode(table, pos, spec)

    @staticmethod
    def backward(ctx, g):
        (pos,) = ctx.saved_tensors
        spec = ctx.spec
        bwd = hash_bwd_oadd_stochastic if spec.variant == "oadd" and spec.stochastic_bwd else hash_bwd_exact
        return bwd(pos, spec, g.contiguous()), None, None


def hash_encode_const_pos(table: torch.Tensor, pos: torch.Tensor, spec: HashGridSpec) -> torch.Tensor:
    """Differentiable in `table` (the stochastic backward for oadd with
    spec.stochastic_bwd, the exact one otherwise), constant in `pos`."""
    check_variant(spec)
    return _HashEncodeConstPos.apply(table, pos, spec)


class _HashEncode(torch.autograd.Function):
    """hash_encode differentiable in table and pos (ngp_tpu's hash_encode
    custom_vjp, ops/hash_encoding.py:695-720): d_table through the exact
    scatter, as _hash_encode_bwd uses each variant's exact backward, and
    d_pos through hash_dpos. Each is computed only when its input needs it."""

    @staticmethod
    def forward(ctx, table, pos, spec):
        ctx.save_for_backward(table, pos)
        ctx.spec = spec
        return hash_encode(table, pos, spec)

    @staticmethod
    def backward(ctx, g):
        table, pos = ctx.saved_tensors
        spec, g = ctx.spec, g.contiguous()
        d_table = hash_bwd_exact(pos, spec, g) if ctx.needs_input_grad[0] else None
        d_pos = hash_dpos(table, pos, spec, g) if ctx.needs_input_grad[1] else None
        return d_table, d_pos, None


def hash_encode_pos_grad(table: torch.Tensor, pos: torch.Tensor, spec: HashGridSpec) -> torch.Tensor:
    """hash_encode differentiable in `table` (exact backward) and in `pos`
    (analytic trilinear derivative), for input_gradient."""
    check_variant(spec)
    return _HashEncode.apply(table, pos, spec)
