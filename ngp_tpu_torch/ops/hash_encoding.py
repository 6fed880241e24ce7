"""Multiresolution hash-grid encoding (oadd variant, forward only) on torch.

Counterpart: ngp_tpu/ops/hash_encoding.py:90-151 (HashGridSpec.create),
:425-436 (_oct_offsets), :459-486 (_oct_base_w0) and :498-513
(_encode_oadd_packed). Differs deliberately in the gather: ngp_tpu gathers
one row of a packed "oct" view (8*F floats per row, ~0.5 GB at full size)
because TPU gathers cost per row; the port gathers the 8 corners directly
from the (L, T_pad, F) table. Corner k of a sample is row idx0 + offs[k],
taken mod T_pad. That is exact: every hash level's size equals padded_size,
and on dense levels the corner clamp keeps idx0 + offs[k] inside the level.
All levels are evaluated in one batched pass instead of a per-level scan.
The "xadd" and "tcnn" variants and the backward are not ported yet.

Index math runs in int64 with uint32 wraparound (masked to 32 bits), as the
JAX code computes it in uint32; the grid coordinate pos*scale + 0.5 is a
fused multiply-add (utils/fma.py), as XLA compiles it.
"""

import math
from dataclasses import dataclass

import torch

from ngp_tpu_torch.utils.config import HashEncodingConfig
from ngp_tpu_torch.utils.fma import fma

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
