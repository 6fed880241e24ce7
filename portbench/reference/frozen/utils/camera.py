# Frozen copy of ngp_tpu_torch/utils/camera.py at commit ef1215de9ec9, the plain path only: the benchmark's reference.
"""Camera math: fov/focal conversions, the OpenGL -> scene pose convention,
pose interpolation and pixel -> ray.

Counterpart: ngp_tpu/utils/camera.py:14-37 (fov_to_focal_length,
focal_length_to_fov, opengl_to_opencv) and :40-134 (_so3_log, _so3_exp,
log_space_lerp in float64 numpy as there, and pixel_to_rays). The renderer
builds its pixel-grid rays itself (render/renderer.py camera_rays), as
ngp_tpu's renderer does; no path of either package calls pixel_to_rays or
log_space_lerp.
"""

import math

import numpy as np
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


def _hat(w) -> np.ndarray:
    return np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])


def _so3_log(rot) -> np.ndarray:
    """Rotation matrix (3, 3) -> axis-angle vector (float64 numpy)."""
    cos = np.clip((np.trace(rot) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(cos)
    if theta < 1e-8:
        return np.zeros(3)
    return np.array([rot[2, 1] - rot[1, 2], rot[0, 2] - rot[2, 0], rot[1, 0] - rot[0, 1]]) * theta / (2.0 * np.sin(theta))


def _so3_exp(w) -> np.ndarray:
    theta = np.linalg.norm(w)
    k = _hat(w)
    if theta < 1e-8:
        return np.eye(3) + k
    return np.eye(3) + np.sin(theta) / theta * k + (1 - np.cos(theta)) / theta**2 * (k @ k)


def log_space_lerp(begin, end, t: float) -> np.ndarray:
    """Rigid-pose interpolation in SE(3) log space (common_device.cu:32-41):
    begin and end (3, 4) camera-to-world; returns (3, 4) float32."""
    a = np.eye(4)
    a[:3, :4] = np.asarray(begin, np.float64)
    b = np.eye(4)
    b[:3, :4] = np.asarray(end, np.float64)
    m = b @ np.linalg.inv(a)
    w = _so3_log(m[:3, :3])
    theta = np.linalg.norm(w)
    k = _hat(w)
    if theta < 1e-8:
        v_inv = np.eye(3) - 0.5 * k
    else:
        v_inv = np.eye(3) - 0.5 * k + (1.0 / theta**2 - (1.0 + np.cos(theta)) / (2.0 * theta * np.sin(theta))) * (k @ k)
    u = v_inv @ m[:3, 3]
    wt, ut = w * t, u * t
    theta_t = np.linalg.norm(wt)
    kt = _hat(wt)
    if theta_t < 1e-8:
        v = np.eye(3) + 0.5 * kt
    else:
        v = np.eye(3) + (1 - np.cos(theta_t)) / theta_t**2 * kt + (theta_t - np.sin(theta_t)) / theta_t**3 * (kt @ kt)
    mt = np.eye(4)
    mt[:3, :3] = _so3_exp(wt)
    mt[:3, 3] = v @ ut
    return (mt @ a)[:3, :4].astype(np.float32)


def pixel_to_rays(xy, resolution, focal_length, principal_point, camera_matrix):
    """Rays for normalised pixel coordinates xy in [0,1]^2, (..., 2) ->
    (origins, unit directions), both (..., 3) float32; the origins broadcast
    from camera_matrix[:, 3] (common_device.h:130-152)."""
    xy = _f32(xy)
    res, f, pp = _f32(resolution), _f32(focal_length), _f32(principal_point)
    cam = _f32(camera_matrix)
    d_cam = torch.stack(
        [(xy[..., 0] - pp[0]) * res[0] / f[0], (xy[..., 1] - pp[1]) * res[1] / f[1], torch.ones_like(xy[..., 0])], dim=-1
    )
    d = d_cam @ cam[:, :3].T
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return cam[:, 3].expand_as(d), d
