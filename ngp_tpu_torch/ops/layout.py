"""Flat <-> padded sample-layout bijection.

Counterpart: ngp_tpu/ops/layout.py:26-92 (SampleLayout, build_layout) and
:99-156 (pad_from_flat, flat_from_pad, pad_layout, flat_layout). Same
index structure: flat slot i of the network batch is padded slot
(ray_ids[i], pos_in_ray[i]) of the (R, S) composite layout. Differs: the
JAX custom_vjp gathers (which keep both autodiff directions off the TPU's
slow scatter) are plain indexing under torch autograd, whose backward is an
index-add of a bijection, hence the same values.
"""

from typing import NamedTuple

import torch


class SampleLayout(NamedTuple):
    base: torch.Tensor  # (R,) int64 flat start offset per ray
    counts: torch.Tensor  # (R,) int64 valid samples per ray (0 for dropped rays)
    ray_ids: torch.Tensor  # (C,) int64 owning ray per flat slot (clamped)
    pos_in_ray: torch.Tensor  # (C,) int64 j such that flat i == padded (rid, j)
    flat_valid: torch.Tensor  # (C,) bool
    pad_valid: torch.Tensor  # (R, S) bool, j < counts[r]


def build_layout(base, counts, ray_valid, capacity: int, s_pad: int) -> SampleLayout:
    """The bijection from per-ray (base, counts); `base` is the exclusive
    cumsum of counts over all rays (dropped rays keep their reservation as
    holes) and ascending over valid rays."""
    R = base.shape[0]
    dev = base.device
    counts_eff = torch.where(ray_valid, counts, 0)
    marks = torch.zeros((capacity,), dtype=torch.int64, device=dev)
    # valid rays have counts > 0 and base + counts <= capacity: distinct bases
    marks[base[ray_valid]] = 1
    rid = torch.cumsum(marks, 0) - 1  # rank among valid rays; -1 before the first
    valid_idx = torch.nonzero(ray_valid).squeeze(1)
    rank_to_ray = torch.zeros((R,), dtype=torch.int64, device=dev)
    rank_to_ray[: valid_idx.numel()] = valid_idx
    rid_c = rank_to_ray[torch.clamp(rid, 0, R - 1)]
    pos_in_ray = torch.arange(capacity, device=dev) - base[rid_c]
    flat_valid = (rid >= 0) & (pos_in_ray >= 0) & (pos_in_ray < counts_eff[rid_c])
    pad_valid = torch.arange(s_pad, device=dev)[None, :] < counts_eff[:, None]
    return SampleLayout(
        base=base,
        counts=counts_eff,
        ray_ids=rid_c,
        pos_in_ray=torch.clamp(pos_in_ray, 0, s_pad - 1),
        flat_valid=flat_valid,
        pad_valid=pad_valid,
    )


def pad_layout(layout: SampleLayout, flat: torch.Tensor) -> torch.Tensor:
    """flat (C, K) or (C,) -> padded (R, S, K) / (R, S); zero off the valid slots."""
    S = layout.pad_valid.shape[1]
    idx = torch.clamp(layout.base[:, None] + torch.arange(S, device=flat.device)[None, :], 0, flat.shape[0] - 1)
    valid = layout.pad_valid if flat.dim() == 1 else layout.pad_valid[..., None]
    return torch.where(valid, flat[idx], 0.0)


def flat_layout(layout: SampleLayout, padded: torch.Tensor) -> torch.Tensor:
    """padded (R, S, K) or (R, S) -> flat (C, K) / (C,); zero off the valid slots."""
    valid = layout.flat_valid if padded.dim() == 2 else layout.flat_valid[:, None]
    return torch.where(valid, padded[layout.ray_ids, layout.pos_in_ray], 0.0)
