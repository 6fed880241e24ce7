# Frozen copy of ngp_tpu_torch/render/composite.py at commit ef1215de9ec9, the plain path only: the benchmark's reference.
"""Differentiable emission-absorption compositing in the padded ray layout.

Counterpart: ngp_tpu/render/composite.py:33-73 (CompositeResult,
composite_rays) and :76-166 (train_loss). Same objective: the flat network
outputs go through the flat -> padded layout (ops/layout.py), transmittance
is exp(-exclusive cumsum(sigma dt)) per ray, a sample counts iff the
transmittance before it is >= the threshold (under detach, as the
reference's early stop), exhausted rays add the background, and the
density-L1 term keeps its 1e-4 / LOSS_SCALE weight; `extra_buckets` split
the rays over further (rows, width) layouts of the same flat buffer (the
training batch's long bucket), each ray composited in exactly one, with
losses and stats summed over the buckets, and each bucket's
(rgb_ray, trans_end, exhausted), detached, in aux["bucket_rays"] for the
envmap's gradient. autograd derives the backward.
"""

from typing import NamedTuple

import torch

from portbench.reference.frozen.ops import losses
from portbench.reference.frozen.ops.layout import SampleLayout, pad_layout
from portbench.reference.frozen.utils.config import LOSS_SCALE


class CompositeResult(NamedTuple):
    rgb_ray: torch.Tensor  # (R, 3) composited color (incl. background term)
    trans_end: torch.Tensor  # (R,) transmittance after the included samples
    include: torch.Tensor  # (R, S) bool, samples contributing (T >= threshold)
    n_included: torch.Tensor  # (R,) int64 "compacted" sample counts
    exhausted: torch.Tensor  # (R,) bool, marched all samples without early stop


def composite_rays(rgb, sigma, dt, valid, counts, background, transmittance_threshold: float) -> CompositeResult:
    """rgb (R, S, 3) and sigma (R, S) post-activation, dt scalar or (R, S),
    valid (R, S), counts (R,), background (3,) or (R, 3)."""
    n_rays = sigma.shape[0]
    sdt = torch.where(valid, sigma * dt, 0.0)
    acc_before = torch.cumsum(sdt, dim=1) - sdt  # exclusive per-ray prefix
    trans = torch.exp(-acc_before)

    include = valid & (trans >= transmittance_threshold)
    alpha = 1.0 - torch.exp(-sdt)
    weight = torch.where(include, alpha * trans, 0.0)

    rgb_ray = torch.sum(weight[..., None] * rgb, dim=1)
    n_included = include.sum(dim=1)
    trans_end = torch.exp(-torch.sum(torch.where(include, sdt, 0.0), dim=1))

    exhausted = n_included == counts
    bg = torch.as_tensor(background, dtype=torch.float32, device=sigma.device).expand(n_rays, 3)
    rgb_ray = rgb_ray + torch.where(exhausted[:, None], trans_end[:, None] * bg, 0.0)
    return CompositeResult(rgb_ray, trans_end, include, n_included, exhausted)


def train_loss(
    rgb_raw,  # (C, 3) pre-activation network rgb, flat layout
    sigma_raw,  # (C,) pre-activation network density, flat layout
    layout: SampleLayout,
    dt,  # scalar or (R, S) step sizes
    ray_valid,  # (R,) bool, kept rays
    rgb_target,  # (R, 3)
    background,  # (3,) or (R, 3), linear training background
    *,
    n_rays_denom: int,
    loss_type: str,
    transmittance_threshold: float,
    rgb_activation: str,
    density_activation: str,
    mean_density,
    min_optical_thickness: float,
    apply_rgb_activation,
    apply_density_activation,
    extra_buckets=(),  # [(layout, dt, ray_valid_rows, rgb_target_rows, background_rows)]
):
    """Scalar training objective and an aux dict (per_ray_loss, rgb_ray,
    n_included of the first bucket; bucket_rays, one detached (rgb_ray,
    trans_end, exhausted) a bucket; loss_sum and measured_batch_size over
    all buckets):

      L = (1/n_rays) sum_rays mean_rgb loss(target, composited)
        + [rgb act == Exponential] (1e-4 / n_rays) * 0.5 * relu(rgb_raw)^2
        + [mean_density < min_opt] (1e-4 / LOSS_SCALE) * relu(-sigma_raw)
    """
    packed = torch.cat([rgb_raw, sigma_raw[:, None]], dim=-1)  # (C, 4)
    thin = torch.as_tensor(mean_density, device=packed.device) < min_optical_thickness
    l1_coeff = thin.to(torch.float32) * (1e-4 / LOSS_SCALE)

    loss = loss_sum = measured = 0.0
    aux = {}
    for b, (lay, dt_b, rv_b, tgt_b, bg_b) in enumerate(((layout, dt, ray_valid, rgb_target, background), *extra_buckets)):
        padded = pad_layout(lay, packed)  # (Rb, Sb, 4), one gather each way
        rgb_raw_p, sigma_raw_p = padded[..., :3], padded[..., 3]
        sigma = apply_density_activation(sigma_raw_p, density_activation)
        rgb = apply_rgb_activation(rgb_raw_p, rgb_activation)

        valid = lay.pad_valid & rv_b[:, None]
        res = composite_rays(rgb, sigma, dt_b, valid, lay.counts, bg_b, transmittance_threshold)
        per_ray_loss = torch.mean(losses.loss_value(tgt_b, res.rgb_ray, loss_type), dim=-1)
        per_ray_loss = torch.where(rv_b, per_ray_loss, 0.0)
        loss = loss + torch.sum(per_ray_loss) / n_rays_denom

        include = res.include.detach()
        if rgb_activation.lower() == "exponential":
            reg = 0.5 * 1e-4 * torch.sum(torch.where(include[..., None], torch.relu(rgb_raw_p) ** 2, 0.0))
            loss = loss + reg / n_rays_denom
        loss = loss + l1_coeff * torch.sum(torch.where(include, torch.relu(-sigma_raw_p), 0.0))

        loss_sum = loss_sum + torch.sum(per_ray_loss).detach()
        measured = measured + res.n_included.sum()
        if b == 0:
            aux["per_ray_loss"] = per_ray_loss.detach()
            aux["rgb_ray"] = res.rgb_ray.detach()
            aux["n_included"] = res.n_included
        aux.setdefault("bucket_rays", []).append((res.rgb_ray.detach(), res.trans_end.detach(), res.exhausted))
    aux["bucket_rays"] = tuple(aux["bucket_rays"])
    aux["loss_sum"] = loss_sum
    aux["measured_batch_size"] = measured
    return loss, aux
