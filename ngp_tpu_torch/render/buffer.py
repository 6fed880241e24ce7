"""Render buffer post-processing: spp accumulation + tonemap, on torch.

Counterpart: ngp_tpu/render/buffer.py:25-87 (accumulate, tonemap_curve,
tonemap), the same formulas; plain functions instead of jitted ones.
"""

import torch

from ngp_tpu_torch.utils import profiling
from ngp_tpu_torch.utils.color import linear_to_srgb, srgb_to_linear


def accumulate(accum: torch.Tensor, frame: torch.Tensor, spp: int, color_space: str = "Linear") -> torch.Tensor:
    """Running average: accum_{n+1} = (accum*n + frame)/(n+1); spp = frames so far."""
    color_space = color_space.lower()
    rgb, a = frame[..., :3], frame[..., 3:4]
    if color_space == "visposneg":
        val = frame[..., 0:1] - frame[..., 1:2]
        tmp_val = accum[..., 0:1] - accum[..., 1:2]
        tmp_val = (tmp_val * spp + val) / (spp + 1)
        out_rgb = torch.cat([torch.clamp(tmp_val, min=0.0), torch.clamp(-tmp_val, min=0.0), accum[..., 2:3]], dim=-1)
    else:
        if color_space == "srgb":
            rgb = linear_to_srgb(rgb)
        out_rgb = (accum[..., :3] * spp + rgb) / (spp + 1)
    out_a = (accum[..., 3:4] * spp + a) / (spp + 1)
    return torch.cat([out_rgb, out_a], dim=-1)


def tonemap_curve(x: torch.Tensor, curve: str = "Identity") -> torch.Tensor:
    curve = curve.lower()
    if curve == "identity":
        return x
    x = torch.clamp(x, min=0.0)
    if curve == "reinhard":
        y = x[..., 0] * 0.2126 + x[..., 1] * 0.7152 + x[..., 2] * 0.0722
        return x / (y[..., None] + 1.0)
    if curve == "aces":
        k0, k1, k2 = 0.36 * 2.51, 0.6 * 0.03, 0.0
        k3, k4, k5 = 0.36 * 2.43, 0.6 * 0.59, 0.14
    elif curve == "hable":
        a, b, c, d, e, f = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
        k0, k1, k2 = a * f - a * e, c * b * f - b * e, 0.0
        k3, k4, k5 = a * f, b * f, d * f * f
        w = 11.2
        white_scale = (k3 * w * w + k4 * w + k5) / (k0 * w * w + k1 * w + k2)
        k0, k1, k2 = 4 * k0 * white_scale, 2 * k1 * white_scale, k2 * white_scale
        k3, k4 = 4 * k3, 2 * k4
    else:
        raise ValueError(f"Unknown tonemap curve {curve}")
    sq = x * x
    return (k0 * sq + k1 * x + k2) / (k3 * sq + k4 * x + k5)


def tonemap(accum, exposure: float, background_color, color_space: str, output_color_space: str, curve: str = "Identity"):
    """accum (H,W,4) -> final (H,W,4); background_color is a 4-vector in sRGB
    (one not yet a tensor is copied to the card: a frame's host sync
    render.sync.background)."""
    with profiling.host_sync("render", "background", int(not isinstance(background_color, torch.Tensor))):
        bg = torch.as_tensor(background_color, dtype=torch.float32, device=accum.device)
    rgb = accum[..., :3] * (2.0**exposure)
    a = accum[..., 3:4]

    bg_rgb = bg[:3]
    if color_space.lower() != "srgb":
        bg_rgb = srgb_to_linear(bg_rgb)
    weight = (1.0 - a) * bg[3]
    rgb = rgb + bg_rgb * weight
    a = a + weight

    if color_space.lower() == "srgb":
        rgb = srgb_to_linear(rgb)
    rgb = tonemap_curve(rgb, curve)
    if output_color_space.lower() == "srgb":
        rgb = linear_to_srgb(rgb)
    return torch.cat([rgb, a], dim=-1)
