"""Camera math: fov/focal conversions and the OpenGL -> scene pose convention.

Counterpart: ngp_tpu/utils/camera.py:14-37 (fov_to_focal_length,
focal_length_to_fov, opengl_to_opencv). The pose interpolation and the
generic pixel_to_rays are not ported; the renderer builds its pixel-grid rays
itself (render/renderer.py camera_rays), as ngp_tpu's renderer does.
"""

import math

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def fov_to_focal_length(resolution, rad) -> torch.Tensor:
    """0.5 * resolution / tan(0.5 * rad), in float32."""
    return 0.5 * _f32(resolution) / torch.tan(0.5 * _f32(rad))


def focal_length_to_fov(resolution, focal_length) -> torch.Tensor:
    """Field of view in *degrees* (matches the reference)."""
    return 2.0 * 180.0 / math.pi * torch.atan(_f32(resolution) / (_f32(focal_length) * 2.0))


def opengl_to_opencv(pose, scale, offset) -> torch.Tensor:
    """(..., 3, 4) OpenGL camera-to-world pose -> scene convention: negate the
    Y/Z basis columns, t = t*scale + offset, then cycle rows xyz <- yzx."""
    pose = _f32(pose)
    offset = _f32(offset)
    flip = torch.tensor([1.0, -1.0, -1.0], dtype=torch.float32)
    rot = pose[..., :3] * flip
    t = pose[..., 3] * scale + offset
    out = torch.cat([rot, t[..., None]], dim=-1)
    return out[..., [1, 2, 0], :]
