# Frozen copy of ngp_tpu_torch/ops/losses.py at commit ef1215de9ec9, the plain path only: the benchmark's reference.
"""Per-channel RGB losses, each returning (value, d/d_prediction) elementwise.

Counterpart: ngp_tpu/ops/losses.py:17-90 (L2, RelativeL2, L1, SmoothL1 with
alpha 0.1, LogL1, SMAPE, MAPE and the string dispatch). Same closed forms;
training differentiates the value with autograd, the closed-form gradient is
kept for the tests that hold it against autograd.
"""

import torch

LOSS_TYPES = ("L2", "RelativeL2", "L1", "Mape", "Smape", "SmoothL1", "LogL1")


def _copysign_pos(mag, sign_src):
    """copysignf with sign(+0) = +1."""
    return torch.where(sign_src >= 0, mag, -mag)


def l2(target, prediction):
    d = prediction - target
    return d * d, 2.0 * d


def relative_l2(target, prediction):
    d = prediction - target
    factor = 1.0 / (prediction * prediction + 1e-2)
    return d * d * factor, 2.0 * d * factor


def l1(target, prediction):
    d = prediction - target
    return torch.abs(d), _copysign_pos(torch.ones_like(d), d)


def smooth_l1(target, prediction, alpha=0.1):
    d = prediction - target
    ad = torch.abs(d)
    quad = 0.5 / alpha * d * d
    val = torch.where(ad > alpha, ad - 0.5 * alpha, quad)
    grad = torch.where(ad > alpha, torch.where(d > 0, 1.0, -1.0), d / alpha)
    return val, grad


def log_l1(target, prediction):
    d = prediction - target
    divisor = torch.abs(d) + 1.0
    return torch.log(divisor), _copysign_pos(1.0 / divisor, d)


def smape(target, prediction):
    d = prediction - target
    factor = 1.0 / (0.5 * (torch.abs(prediction) + torch.abs(target)) + 1e-2)
    return torch.abs(d) * factor, _copysign_pos(factor, d)


def mape(target, prediction):
    d = prediction - target
    factor = 1.0 / (torch.abs(prediction) + 1e-2)
    return torch.abs(d) * factor, _copysign_pos(factor, d)


_LOSSES = {
    "l2": l2,
    "relativel2": relative_l2,
    "l1": l1,
    "mape": mape,
    "smape": smape,
    "smoothl1": smooth_l1,
    "logl1": log_l1,
}


def loss_and_gradient(target, prediction, loss_type: str):
    """String-dispatched (value, gradient); an unknown name raises."""
    key = loss_type.lower()
    if key not in _LOSSES:
        raise ValueError(f"Unknown loss type: {loss_type!r} (expected one of {LOSS_TYPES})")
    return _LOSSES[key](target, prediction)


def loss_value(target, prediction, loss_type: str):
    return loss_and_gradient(target, prediction, loss_type)[0]
