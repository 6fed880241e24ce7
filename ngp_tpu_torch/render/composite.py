"""Differentiable emission-absorption compositing in the padded ray layout.

Counterpart: ngp_tpu/render/composite.py:33-73 (CompositeResult,
composite_rays) and :76-166 (train_loss). Same objective: the flat network
outputs go through the flat -> padded layout (ops/layout.py), transmittance
is exp(-exclusive cumsum(sigma dt)) per ray, a sample counts iff the
transmittance before it is >= the threshold (under detach, as the
reference's early stop), exhausted rays add the background, and the
density-L1 term keeps its 1e-4 / LOSS_SCALE weight. autograd derives the
backward. Differs: one bucket only (ngp_tpu's `extra_buckets` serve its
two-bucket layout, which the port leaves out), and no envmap outputs.
"""

from typing import NamedTuple

import torch

from ngp_tpu_torch.ops import losses
from ngp_tpu_torch.ops.layout import SampleLayout, pad_layout
from ngp_tpu_torch.utils.config import LOSS_SCALE


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
):
    """Scalar training objective and an aux dict (per_ray_loss, rgb_ray,
    n_included, loss_sum, measured_batch_size):

      L = (1/n_rays) sum_rays mean_rgb loss(target, composited)
        + [rgb act == Exponential] (1e-4 / n_rays) * 0.5 * relu(rgb_raw)^2
        + [mean_density < min_opt] (1e-4 / LOSS_SCALE) * relu(-sigma_raw)
    """
    packed = torch.cat([rgb_raw, sigma_raw[:, None]], dim=-1)  # (C, 4)
    thin = torch.as_tensor(mean_density, device=packed.device) < min_optical_thickness
    l1_coeff = thin.to(torch.float32) * (1e-4 / LOSS_SCALE)

    padded = pad_layout(layout, packed)  # (R, S, 4)
    rgb_raw_p, sigma_raw_p = padded[..., :3], padded[..., 3]
    sigma = apply_density_activation(sigma_raw_p, density_activation)
    rgb = apply_rgb_activation(rgb_raw_p, rgb_activation)

    valid = layout.pad_valid & ray_valid[:, None]
    res = composite_rays(rgb, sigma, dt, valid, layout.counts, background, transmittance_threshold)
    per_ray_loss = torch.mean(losses.loss_value(rgb_target, res.rgb_ray, loss_type), dim=-1)
    per_ray_loss = torch.where(ray_valid, per_ray_loss, 0.0)
    loss = torch.sum(per_ray_loss) / n_rays_denom

    include = res.include.detach()
    if rgb_activation.lower() == "exponential":
        reg = 0.5 * 1e-4 * torch.sum(torch.where(include[..., None], torch.relu(rgb_raw_p) ** 2, 0.0))
        loss = loss + reg / n_rays_denom
    loss = loss + l1_coeff * torch.sum(torch.where(include, torch.relu(-sigma_raw_p), 0.0))

    aux = {
        "per_ray_loss": per_ray_loss.detach(),
        "rgb_ray": res.rgb_ray.detach(),
        "n_included": res.n_included,
        "loss_sum": torch.sum(per_ray_loss).detach(),
        "measured_batch_size": res.n_included.sum(),
    }
    return loss, aux
