# Frozen copy of ngp_tpu_torch/utils/color.py at commit ef1215de9ec9, the plain path only: the benchmark's reference.
"""Color-space transforms (sRGB <-> linear), elementwise on torch tensors.

Counterpart: ngp_tpu/utils/color.py:18-43 (srgb_to_linear, linear_to_srgb
and their closed-form derivatives; the envmap's gradient divides by
srgb_to_linear_derivative). Reference: internal/utils/common_device.h:71-101,
with its truncated exponent 0.41666.
"""

import torch

_SRGB_KNEE = 0.04045
_LIN_KNEE = 0.0031308
_INV_GAMMA = 0.41666


def srgb_to_linear(x: torch.Tensor) -> torch.Tensor:
    return torch.where(
        x <= _SRGB_KNEE, x / 12.92, torch.pow((torch.clamp(x, min=_SRGB_KNEE) + 0.055) / 1.055, 2.4)
    )


def srgb_to_linear_derivative(x: torch.Tensor) -> torch.Tensor:
    return torch.where(
        x <= _SRGB_KNEE, 1.0 / 12.92, 2.4 / 1.055 * torch.pow((torch.clamp(x, min=_SRGB_KNEE) + 0.055) / 1.055, 1.4)
    )


def linear_to_srgb(x: torch.Tensor) -> torch.Tensor:
    return torch.where(
        x < _LIN_KNEE, 12.92 * x, 1.055 * torch.pow(torch.clamp(x, min=_LIN_KNEE), _INV_GAMMA) - 0.055
    )


def linear_to_srgb_derivative(x: torch.Tensor) -> torch.Tensor:
    return torch.where(
        x < _LIN_KNEE, 12.92, 1.055 * _INV_GAMMA * torch.pow(torch.clamp(x, min=_LIN_KNEE), _INV_GAMMA - 1.0)
    )
