"""The cells' scene, poses and image metric.

- The scene: ngp_tpu_torch/data/synthetic.py's procedural blob scene
  (`write_synthetic_dataset`, commit ef1215de9ec9), written here from the
  frozen copy of that module (portbench/reference/frozen/data/), with the
  same spiral of cameras (`spiral_pose`, frozen from `make_split`). Only the
  train split's PNGs are written: the serving cells need the test poses,
  not the test images. The files depend only on the scene's parameters and
  are kept under build/portbench/scene/<hash of them>/, a fixed directory
  inside the checkout.
- `ring_pose`: frozen copy of chip_smoke.py:398 (commit ef1215de9ec9).
"""

import hashlib
import json
import math
import os
from pathlib import Path

import numpy as np

from portbench.harness.spec import ROOT

SCENE_CACHE = ROOT / "build" / "portbench" / "scene"


def ring_pose(theta, radius=1.3, height=0.4):
    """OpenGL camera-to-world (3, 4) on a ring around the origin, looking at it."""
    pos = np.array([radius * np.cos(theta), radius * np.sin(theta), height])
    back = pos / np.linalg.norm(pos)
    right = np.cross([0.0, 0.0, 1.0], back)
    right /= np.linalg.norm(right)
    up = np.cross(back, right)
    return np.stack([right, up, back, pos], axis=1).astype(np.float32)


def spiral_pose(split: str, i: int, n: int, radius: float) -> np.ndarray:
    """The generator's camera i of n on the spiral over the upper sphere."""
    from portbench.reference.frozen.data.synthetic import look_at_pose

    u = (i + 0.5) / n
    theta = np.arccos(np.clip(0.15 + 0.8 * u, -1, 1))
    phi = i * 2.399963229728653 + (0.5 if split == "test" else 0.0)
    eye = radius * np.array([np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta)])
    return look_at_pose(eye)


def view_poses(scene: dict) -> list:
    return [spiral_pose("test", i, scene["n_test"], scene["radius"]) for i in range(scene["n_test"])]


def orbit_pose(k: int, p: dict, radius: float) -> np.ndarray:
    """Frame k of the orbit: azimuth k * step, elevation swinging between its
    two limits over `elev_period_frames` frames."""
    az = math.radians(p["azimuth_step_deg"]) * k
    lo, hi = math.radians(p["elev_min_deg"]), math.radians(p["elev_max_deg"])
    elev = lo + (hi - lo) * 0.5 * (1.0 - math.cos(2.0 * math.pi * k / p["elev_period_frames"]))
    return ring_pose(az, radius * math.cos(elev), radius * math.sin(elev))


def scene_dir(scene: dict, cache: Path | None = None) -> Path:
    key = hashlib.sha1(json.dumps(scene, sort_keys=True).encode()).hexdigest()[:12]
    return (cache or SCENE_CACHE) / key


def ensure_scene(scene: dict, device, cache: Path | None = None) -> Path:
    """The train split's transforms_train.json (and PNGs), written once."""
    from portbench.reference.frozen.data.png import write_png
    from portbench.reference.frozen.data.synthetic import render_ground_truth, scene_blobs, to_rgba8

    out = scene_dir(scene, cache)
    path = out / "transforms_train.json"
    if path.exists():
        return path
    (out / "train").mkdir(parents=True, exist_ok=True)
    blobs = scene_blobs(None)
    frames = []
    for i in range(scene["n_train"]):
        pose = spiral_pose("train", i, scene["n_train"], scene["radius"])
        img = render_ground_truth(pose, scene["width"], scene["height"], scene["camera_angle_x"], blobs=blobs, device=device)
        write_png(out / f"train/r_{i}.png", to_rgba8(img.cpu().numpy()))
        mat = np.eye(4, dtype=np.float32)
        mat[:3, :4] = pose
        frames.append({"file_path": f"./train/r_{i}", "transform_matrix": mat.tolist()})
    doc = {"camera_angle_x": scene["camera_angle_x"], "frames": frames}
    tmp = out / f"transforms_train.json.{os.getpid()}"
    tmp.write_text(json.dumps(doc, indent=1))
    os.replace(tmp, path)  # written last: its presence means the scene is whole
    return path
