"""nerf_synthetic dataset loader (transforms_*.json + PNG frames).

Counterpart: ngp_tpu/data/nerf_synthetic.py:28-37 (NeRFSyntheticDataset),
:48-108 (srgb_to_linear_np, load_nerf_synthetic) and :111-120 (read_rgba).
Same conversion: rgb = srgb_to_linear(rgb8 / 255) * a, a = a8 / 255, as
premultiplied-linear fp16 images resident on the device. Differs: PNGs are
decoded by data/png.py (standard library) instead of the native loader or
PIL, and the dataset lives on an explicit torch device.
"""

import json
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ngp_tpu_torch.data.png import read_png
from ngp_tpu_torch.utils.camera import fov_to_focal_length, opengl_to_opencv


@dataclass
class NeRFSyntheticDataset:
    images: torch.Tensor  # (N, H, W, 4) float16, premultiplied linear
    xforms: torch.Tensor  # (N, 3, 4) float32, scene convention
    focal_length: tuple  # (fx, fy)
    principal_point: tuple  # (0.5, 0.5)
    resolution: tuple  # (W, H)
    scale: float
    offset: tuple
    n_images: int


def srgb_to_linear_np(x):
    return np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def load_nerf_synthetic(json_path, scale: float = 0.33, offset=(0.5, 0.5, 0.5), device="cpu") -> NeRFSyntheticDataset:
    json_path = Path(json_path)
    base = json_path.parent
    doc = json.loads(json_path.read_text())
    frames = doc["frames"]

    def resolve(fp: str) -> Path:
        p = base / fp
        if p.suffix == "":
            p = p.with_suffix(".png")
        if p.suffix != ".png" or not p.exists():
            raise FileNotFoundError(f"Could not find PNG image file: {p}")
        return p

    paths = [resolve(f["file_path"]) for f in frames]
    with ThreadPoolExecutor(max_workers=8) as pool:
        raw = list(pool.map(read_png, paths))
    h, w = raw[0].shape[:2]
    if any(r.shape[:2] != (h, w) for r in raw):
        raise ValueError("training images are not all the same size")
    u8 = np.stack(raw).astype(np.float32) / 255.0
    alpha = u8[..., 3:4]
    lin = srgb_to_linear_np(u8[..., :3]) * alpha  # premultiply in linear space
    images = np.concatenate([lin, alpha], axis=-1).astype(np.float16)

    xforms_gl = np.stack([np.asarray(f["transform_matrix"], np.float32)[:3, :4] for f in frames])
    xforms = opengl_to_opencv(xforms_gl, scale, list(offset))
    fl = float(fov_to_focal_length(w, float(doc["camera_angle_x"])))
    return NeRFSyntheticDataset(
        images=torch.from_numpy(images).to(device),
        xforms=xforms.to(device),
        focal_length=(fl, fl),
        principal_point=(0.5, 0.5),
        resolution=(w, h),
        scale=scale,
        offset=tuple(offset),
        n_images=len(frames),
    )


def read_rgba(images: torch.Tensor, xy: torch.Tensor, img_idx: torch.Tensor) -> torch.Tensor:
    """Nearest-pixel premultiplied-linear rgba at normalized xy: floor to the
    pixel index, clamp to the image; (R, 4) float32."""
    _, h, w, _ = images.shape
    px = torch.clamp((xy[..., 0] * w).to(torch.int64), 0, w - 1)
    py = torch.clamp((xy[..., 1] * h).to(torch.int64), 0, h - 1)
    return images[img_idx, py, px].to(torch.float32)
