# Frozen copy of ngp_tpu_torch/ops/layout.py at commit ef1215de9ec9, the plain path only: the benchmark's reference.
"""Flat <-> padded sample-layout bijection as gather-only differentiable ops.

Counterpart: ngp_tpu/ops/layout.py:26-92 (SampleLayout, build_layout) and
:99-156 (pad_from_flat, flat_from_pad, pad_layout, flat_layout). Same index
structure: flat slot i of the network batch is padded slot
(ray_ids[i], pos_in_ray[i]) of the (R, S) composite layout. Both directions
are gathers, and the backward of each is the other gather, as JAX's
custom_vjp pair computes it (`_pad_from_flat_bwd`, `_flat_from_pad_bwd`):
two torch.autograd.Functions, so autograd never emits the sort-based
index_put_ backward of a plain `flat[idx]`. build_layout places ranks by a
scatter-add into R + 1 slots (the last one takes the dropped rays, JAX's
mode="drop"), so it has no data-dependent shape and never syncs with the
host. Differs: the index fields are int64.
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
    """The bijection from per-ray (base, counts).

    `base` is the exclusive cumsum of counts over all rays (dropped rays keep
    their reservation as holes). PRECONDITION: `base` ascends over valid
    rays. Flat slots are ranked by offset (cumsum of marks) and rays by array
    order (cumsum of ray_valid), and the two ranks are equated; a bucket
    built from an unsorted row selection breaks that and silently zeroes the
    backward (the forward reads only base and pad_valid). Callers selecting
    a row subset sort it first (sampling/training.py, sel_long)."""
    R = base.shape[0]
    dev = base.device
    counts_eff = torch.where(ray_valid, counts, 0)
    # +1 at each valid ray's base; the dropped rays' marks land in slot C
    at = torch.where(ray_valid, base, capacity)
    marks = torch.zeros((capacity + 1,), dtype=torch.int64, device=dev).index_add_(0, at, torch.ones_like(at))[:capacity]
    rid = torch.cumsum(marks, 0) - 1  # rank among valid rays; -1 before the first
    rank = torch.cumsum(ray_valid.to(torch.int64), 0) - 1  # per ray: its rank
    # invert rank -> ray by a scatter of the ray indices at their rank
    at = torch.where(ray_valid, rank, R)
    rank_to_ray = torch.zeros((R + 1,), dtype=torch.int64, device=dev).index_add_(
        0, at, torch.arange(R, dtype=torch.int64, device=dev)
    )[:R]
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


def _gather_pad(flat, base, pad_valid):
    """(C, K) -> (R, S, K): padded[r, j] = flat[base[r] + j] on valid slots."""
    S = pad_valid.shape[1]
    idx = torch.clamp(base[:, None] + torch.arange(S, device=flat.device)[None, :], 0, flat.shape[0] - 1)
    return torch.where(pad_valid[..., None], flat[idx], 0.0)


def _gather_flat(padded, ray_ids, pos_in_ray, flat_valid):
    """(R, S, K) -> (C, K): flat[i] = padded[ray_ids[i], pos_in_ray[i]] on valid slots."""
    return torch.where(flat_valid[:, None], padded[ray_ids, pos_in_ray], 0.0)


class PadFromFlat(torch.autograd.Function):
    """(C, K) -> (R, S, K); its backward is the flat gather of the cotangent."""

    @staticmethod
    def forward(ctx, flat, base, ray_ids, pos_in_ray, flat_valid, pad_valid):
        ctx.save_for_backward(ray_ids, pos_in_ray, flat_valid)
        return _gather_pad(flat, base, pad_valid)

    @staticmethod
    def backward(ctx, g):
        ray_ids, pos_in_ray, flat_valid = ctx.saved_tensors
        return _gather_flat(g, ray_ids, pos_in_ray, flat_valid), None, None, None, None, None


class FlatFromPad(torch.autograd.Function):
    """(R, S, K) -> (C, K); its backward is the padded gather of the cotangent."""

    @staticmethod
    def forward(ctx, padded, base, ray_ids, pos_in_ray, flat_valid, pad_valid):
        ctx.save_for_backward(base, pad_valid)
        return _gather_flat(padded, ray_ids, pos_in_ray, flat_valid)

    @staticmethod
    def backward(ctx, g):
        base, pad_valid = ctx.saved_tensors
        return _gather_pad(g, base, pad_valid), None, None, None, None, None


def pad_from_flat(flat, base, ray_ids, pos_in_ray, flat_valid, pad_valid):
    return PadFromFlat.apply(flat, base, ray_ids, pos_in_ray, flat_valid, pad_valid)


def flat_from_pad(padded, base, ray_ids, pos_in_ray, flat_valid, pad_valid):
    return FlatFromPad.apply(padded, base, ray_ids, pos_in_ray, flat_valid, pad_valid)


def pad_layout(layout: SampleLayout, flat: torch.Tensor) -> torch.Tensor:
    """flat (C, K) or (C,) -> padded (R, S, K) / (R, S); zero off the valid slots."""
    squeeze = flat.dim() == 1
    out = pad_from_flat(
        flat[:, None] if squeeze else flat,
        layout.base, layout.ray_ids, layout.pos_in_ray, layout.flat_valid, layout.pad_valid,
    )
    return out[..., 0] if squeeze else out


def flat_layout(layout: SampleLayout, padded: torch.Tensor) -> torch.Tensor:
    """padded (R, S, K) or (R, S) -> flat (C, K) / (C,); zero off the valid slots."""
    squeeze = padded.dim() == 2
    out = flat_from_pad(
        padded[..., None] if squeeze else padded,
        layout.base, layout.ray_ids, layout.pos_in_ray, layout.flat_valid, layout.pad_valid,
    )
    return out[..., 0] if squeeze else out
