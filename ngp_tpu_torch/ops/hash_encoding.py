"""Multiresolution hash-grid encoding (oadd variant) on torch.

Counterpart: ngp_tpu/ops/hash_encoding.py:90-151 (HashGridSpec.create),
:425-436 (_oct_offsets), :459-486 (_oct_base_w0), :498-513
(_encode_oadd_packed), :520-650 (_bwd_oadd_stochastic, _bwd_oadd without
d/dpos) and :723-755 (hash_encode_const_pos, the training encode).
Differs deliberately in the gather: ngp_tpu gathers one row of a packed
"oct" view (8*F floats per row, ~0.5 GB at full size) because TPU gathers
cost per row; the port gathers the 8 corners directly
from the (L, T_pad, F) table. Corner k of a sample is row idx0 + offs[k],
taken mod T_pad. That is exact: every hash level's size equals padded_size,
and on dense levels the corner clamp keeps idx0 + offs[k] inside the level.
All levels are evaluated in one batched pass instead of a per-level scan.
The backward scatters into the (L, T_pad, F) table with index_add_ in fp32
(ngp_tpu accumulates in bf16 by default; on the card the fp32 sums have no
fixed order). The analytic d/dpos (input_gradient) and the "xadd" and
"tcnn" variants are not ported yet.

Index math runs in int64 with uint32 wraparound (masked to 32 bits), as the
JAX code computes it in uint32; the grid coordinate pos*scale + 0.5 is a
fused multiply-add (utils/fma.py), as XLA compiles it.
"""

import math
from dataclasses import dataclass

import torch

from ngp_tpu_torch.utils.config import HashEncodingConfig
from ngp_tpu_torch.utils.fma import fma
from ngp_tpu_torch.utils.qmc import mul32

_MASK = 0xFFFFFFFF

# "oadd" linear-hash strides (ngp_tpu/ops/hash_encoding.py:80-81)
_OCT_SY = 258583
_OCT_SZ = 253757


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


def oct_base_w0(pos: torch.Tensor, lc: dict):
    """Base row and corner-0 per-dim weights for every level.

    pos (N, 3) -> (idx0 (N, L) int64, w0 (N, L, 3) f32). Dense levels clamp
    each dim's corner pair into [0, res-2] with the weight shifted onto the
    surviving entry (exactly clip-to-[0, res-1] semantics)."""
    scaled = fma(pos[:, None, :], lc["scale"][None, :, None], 0.5)  # (N, L, 3)
    base_f = torch.floor(scaled)
    frac = scaled - base_f
    base = base_f.to(torch.int64)

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
    return idx0 % lc["size"], w0


def hash_encode(table: torch.Tensor, pos: torch.Tensor, spec: HashGridSpec) -> torch.Tensor:
    """oadd forward. table (L, T_pad, F) fp32; pos (N, 3) in [0,1] -> (N, L*F)."""
    if spec.variant != "oadd":
        raise NotImplementedError(f"hash variant {spec.variant!r} is not ported (oadd only)")
    n = pos.shape[0]
    L, T_pad, F = table.shape
    lc = _level_constants(spec, pos.device)
    idx0, w0 = oct_base_w0(pos, lc)

    # trilinear weight of corner k: product over dims of w0 (bit 0) or 1 - w0
    bits = torch.tensor([[(k >> d) & 1 for d in range(3)] for k in range(8)], dtype=torch.bool, device=pos.device)
    W = torch.where(bits[None, None], 1.0 - w0[:, :, None, :], w0[:, :, None, :])  # (N, L, 8, 3)
    w8 = W[..., 0] * W[..., 1] * W[..., 2]  # (N, L, 8)

    rows = (idx0[:, :, None] + lc["offs"][None]) % T_pad  # (N, L, 8)
    rows = rows + (torch.arange(L, device=pos.device) * T_pad)[None, :, None]
    feats = table.reshape(L * T_pad, F)[rows.reshape(-1)].reshape(n, L, 8, F)
    out = (w8[..., None] * feats).sum(dim=2)  # (N, L, F)
    return out.reshape(n, L * F)


# ------------------------------------------------------------------ backward
def _rows(idx0: torch.Tensor, offs: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    """Table row of corner(s) `offs` from base row idx0, wrapped mod the level size."""
    row = idx0 + offs
    return torch.where(row >= size, row - size, row)


def hash_bwd_oadd(pos: torch.Tensor, spec: HashGridSpec, g: torch.Tensor) -> torch.Tensor:
    """Exact oadd table gradient (no d/dpos): every sample deposits w8[k] * g
    into all 8 corners of its cell. pos (N, 3), g (N, L*F) -> (L, T_pad, F)
    fp32, accumulated in fp32."""
    n, L, F, T = pos.shape[0], spec.n_levels, spec.n_features, spec.padded_size
    lc = _level_constants(spec, pos.device)
    idx0, w0 = oct_base_w0(pos, lc)
    bits = torch.tensor([[(k >> d) & 1 for d in range(3)] for k in range(8)], dtype=torch.bool, device=pos.device)
    W = torch.where(bits[None, None], 1.0 - w0[:, :, None, :], w0[:, :, None, :])
    w8 = W[..., 0] * W[..., 1] * W[..., 2]  # (N, L, 8)
    rows = _rows(idx0[:, :, None], lc["offs"][None], lc["size"][None, :, None])
    rows = rows + (torch.arange(L, device=pos.device) * T)[None, :, None]
    contrib = w8[..., None] * g.reshape(n, L, 1, F)
    d = torch.zeros((L * T, F), dtype=torch.float32, device=pos.device)
    d.index_add_(0, rows.reshape(-1), contrib.reshape(-1, F))
    return d.reshape(L, T, F)


def hash_bwd_oadd_stochastic(pos: torch.Tensor, spec: HashGridSpec, g: torch.Tensor) -> torch.Tensor:
    """One-corner unbiased table gradient (ngp_tpu's _bwd_oadd_stochastic):
    per (sample, level) one corner drawn with probability equal to its
    trilinear weight, from a hash of pos's float32 bits, receives the
    unweighted g. With stochastic_level_rate kr > 1 (and N % kr == 0),
    sample slot i deposits only into levels l with l % kr == i % kr, scaled
    by kr. Accumulates in fp32 (ngp_tpu: bf16 by default)."""
    n, L, F, T = pos.shape[0], spec.n_levels, spec.n_features, spec.padded_size
    dev = pos.device
    kr = spec.stochastic_level_rate
    if kr <= 1 or n % kr != 0:
        kr = 1
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


class _HashEncodeConstPos(torch.autograd.Function):
    """hash_encode with a table gradient and none for pos (ngp_tpu's
    hash_encode_const_pos, ops/hash_encoding.py:723-755)."""

    @staticmethod
    def forward(ctx, table, pos, spec):
        ctx.save_for_backward(pos)
        ctx.spec = spec
        return hash_encode(table, pos, spec)

    @staticmethod
    def backward(ctx, g):
        (pos,) = ctx.saved_tensors
        spec = ctx.spec
        bwd = hash_bwd_oadd_stochastic if spec.stochastic_bwd else hash_bwd_oadd
        return bwd(pos, spec, g.contiguous()), None, None


def hash_encode_const_pos(table: torch.Tensor, pos: torch.Tensor, spec: HashGridSpec) -> torch.Tensor:
    """Differentiable in `table` (stochastic or exact backward by
    spec.stochastic_bwd), constant in `pos`."""
    if spec.variant != "oadd":
        raise NotImplementedError(f"hash variant {spec.variant!r} is not ported (oadd only)")
    return _HashEncodeConstPos.apply(table, pos, spec)
