"""Procedural nerf_synthetic-format scene generator, on torch.

Counterpart: ngp_tpu/data/synthetic.py:27-207, the scene the tests, the
benches and chip_smoke.py train on: a few soft emissive blobs, dense-marched
into premultiplied-linear frames and written as transforms_*.json + PNGs.
Differs: the ground-truth march runs on a torch device (the card renders
its own training data), in the numpy original's dtypes (float64 where numpy
promotes to it, float32 elsewhere), so on the CPU it agrees with the
original to float32 rounding of exp; PNGs are written by data/png.py.
"""

import json
from pathlib import Path

import numpy as np
import torch

from ngp_tpu_torch.data.png import write_png

_BLOBS = np.array(
    [  # cx, cy, cz, radius, r, g, b
        [0.50, 0.50, 0.50, 0.12, 0.9, 0.2, 0.1],
        [0.62, 0.44, 0.55, 0.07, 0.1, 0.8, 0.2],
        [0.42, 0.58, 0.45, 0.08, 0.2, 0.3, 0.9],
        [0.50, 0.38, 0.58, 0.05, 0.9, 0.8, 0.1],
    ],
    dtype=np.float32,
)
_SIGMA_PEAK = 300.0


def scene_blobs(name: str | None) -> np.ndarray:
    """Per-scene blob sets seeded from the scene name; None gives the
    canonical 4-blob scene."""
    if not name or name == "default":
        return _BLOBS
    rng = np.random.default_rng(int.from_bytes(name.encode()[:8].ljust(8, b"\0"), "little"))
    n = int(rng.integers(3, 7))
    blobs = []
    for _ in range(n):
        c = 0.5 + rng.uniform(-0.14, 0.14, 3)
        r = float(rng.uniform(0.05, 0.13))
        col = rng.uniform(0.1, 1.0, 3)
        blobs.append([*c, r, *col])
    return np.asarray(blobs, np.float32)


def field_sigma_rgb(pos: torch.Tensor, blobs=None):
    """pos (..., 3) scene coords -> (sigma (...,), rgb (..., 3)) float32."""
    pos = pos.to(torch.float32)
    sigma = torch.zeros(pos.shape[:-1], dtype=torch.float32, device=pos.device)
    rgb_acc = torch.zeros(pos.shape[:-1] + (3,), dtype=torch.float32, device=pos.device)
    for row in _BLOBS if blobs is None else blobs:
        row = torch.as_tensor(row, dtype=torch.float32, device=pos.device)
        d2 = ((pos - row[:3]) ** 2).sum(-1)
        s = _SIGMA_PEAK * torch.exp(-0.5 * d2 / (row[3] * row[3]) * 4.0)
        rgb_acc += s[..., None] * row[4:]
        sigma += s
    rgb = rgb_acc / torch.clamp(sigma[..., None], min=1e-8)
    return sigma, torch.clamp(rgb, 0.0, 1.0)


def look_at_pose(eye) -> np.ndarray:
    """OpenGL camera-to-world (3, 4) looking from `eye` at the origin."""
    eye = np.asarray(eye, np.float32)
    fwd = -eye / np.linalg.norm(eye)
    up = np.array([0.0, 0.0, 1.0], np.float32)
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    cam_up = np.cross(right, fwd)
    return np.stack([right, cam_up, -fwd, eye], axis=1).astype(np.float32)


def _opengl_to_opencv_np(pose, scale, offset):
    pose = np.asarray(pose, np.float32)
    rot = pose[..., :3] * np.array([1.0, -1.0, -1.0], np.float32)
    t = pose[..., 3] * scale + np.asarray(offset, np.float32)
    out = np.concatenate([rot, t[..., None]], axis=-1)
    return out[..., [1, 2, 0], :]


def render_ground_truth(pose_gl, width, height, camera_angle_x, scale=0.33, offset=(0.5, 0.5, 0.5), n_steps=384, blobs=None, device="cpu") -> torch.Tensor:
    """Dense-march the analytic field -> (H, W, 4) premultiplied linear rgba
    (float32 on `device`), through the framework's camera pipeline."""
    f64 = dict(dtype=torch.float64, device=device)
    xform = torch.from_numpy(_opengl_to_opencv_np(pose_gl, scale, offset)).to(device)
    fl = 0.5 * width / np.tan(0.5 * camera_angle_x)
    xs = ((torch.arange(width, **f64) + 0.5) / width).to(torch.float32)
    ys = ((torch.arange(height, **f64) + 0.5) / height).to(torch.float32)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    d_cam = torch.stack(
        [((gx - 0.5) * width).double() / fl, ((gy - 0.5) * height).double() / fl, torch.ones_like(gx, dtype=torch.float64)],
        dim=-1,
    ).reshape(-1, 3)
    d = d_cam @ xform[:, :3].double().T
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    o = xform[:, 3].expand(d.shape[0], 3)

    inv_d = 1.0 / torch.where(torch.abs(d) < 1e-9, 1e-9, d)
    a, b = -o * inv_d, (1 - o) * inv_d
    t0 = torch.amax(torch.minimum(a, b), dim=-1).clamp(min=0)
    t1 = torch.amin(torch.maximum(a, b), dim=-1)
    hit = t1 > t0

    n_rays = o.shape[0]
    rgb_out = torch.zeros((n_rays, 3), dtype=torch.float32, device=device)
    trans = torch.ones((n_rays,), dtype=torch.float32, device=device)
    dt = (t1 - t0) / n_steps
    for i in range(n_steps):
        t = t0 + (i + 0.5) * dt
        sigma, rgb = field_sigma_rgb(o + t[:, None] * d, blobs)
        alpha = torch.where(hit, 1.0 - torch.exp(-sigma * dt), 0.0)
        w = alpha * trans
        # numpy's in-place float32 += float64: the sum in float64, one rounding
        rgb_out = (rgb_out.double() + w[:, None] * rgb).to(torch.float32)
        trans = (trans.double() * (1.0 - alpha)).to(torch.float32)
    img = torch.cat([rgb_out, (1.0 - trans)[:, None]], dim=-1)
    return img.reshape(height, width, 4)


def _linear_to_srgb_np(x):
    return np.where(x < 0.0031308, 12.92 * x, 1.055 * np.maximum(x, 0.0031308) ** 0.41666 - 0.055)


def to_rgba8(img: np.ndarray) -> np.ndarray:
    """Premultiplied linear (H, W, 4) -> straight sRGB 8-bit + alpha."""
    a = img[..., 3:4]
    straight = np.divide(img[..., :3], a, out=np.zeros_like(img[..., :3]), where=a > 1e-6)
    srgb = np.clip(_linear_to_srgb_np(np.clip(straight, 0, 1)), 0, 1)
    return (np.concatenate([srgb, a], axis=-1) * 255.0 + 0.5).astype(np.uint8)


def write_synthetic_dataset(out_dir, n_train=16, n_test=4, width=128, height=128, camera_angle_x=0.6911112070083618, scene=None, device="cpu"):
    """Write transforms_train.json / transforms_test.json + PNG frames, with
    cameras on a spiral over the upper sphere of radius 4."""
    out = Path(out_dir)
    (out / "train").mkdir(parents=True, exist_ok=True)
    (out / "test").mkdir(parents=True, exist_ok=True)
    blobs = scene_blobs(scene)

    def make_split(split, n):
        frames = []
        for i in range(n):
            u = (i + 0.5) / n
            theta = np.arccos(np.clip(0.15 + 0.8 * u, -1, 1))
            phi = i * 2.399963229728653 + (0.5 if split == "test" else 0.0)
            eye = 4.0 * np.array([np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta)])
            pose = look_at_pose(eye)
            img = render_ground_truth(pose, width, height, camera_angle_x, blobs=blobs, device=device)
            name = f"{split}/r_{i}"
            write_png(out / f"{name}.png", to_rgba8(img.cpu().numpy()))
            mat = np.eye(4, dtype=np.float32)
            mat[:3, :4] = pose
            frames.append({"file_path": f"./{name}", "transform_matrix": mat.tolist()})
        doc = {"camera_angle_x": camera_angle_x, "frames": frames}
        (out / f"transforms_{split}.json").write_text(json.dumps(doc, indent=1))

    make_split("train", n_train)
    make_split("test", n_test)
    return out / "transforms_train.json", out / "transforms_test.json"
