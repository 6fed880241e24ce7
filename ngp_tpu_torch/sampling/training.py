"""Training ray and sample generation.

Counterpart: ngp_tpu/sampling/training.py:47-81 (TrainingBatch) and
:83-329 (generate_training_batch): per ray an image (the reference's uint32
stride pick, with wraparound), a pixel and a march-start jitter from the
pcg4d counter hash over the global ray index and two u32 salts, snapped to
pixel centers; the ray is clipped to the scene box behind the near
distance and marched over the t-lattice; each ray's occupied samples are
truncated to `s_pad`, rays overflowing the flat sample budget are dropped
whole, and the survivors fill the flat network batch through the
flat <-> padded layout (ops/layout.py).

Differs: the salts are an argument (ngp_tpu draws them from a threefry
key, :152); the march covers the whole lattice (ngp_tpu's occupied-window
start is exact, so skipping to it changes no sample); and the two-bucket
composite split (s_short/n_long, :239-278) and the two-level segment march
(n_seg_cap, :198-226) are left out: they shape XLA's static work and only
add rare drops or truncations. The port equals ngp_tpu called with
occ_aabb=None, s_short=0, n_long=0, n_seg_cap=0.
"""

from typing import NamedTuple

import torch

from ngp_tpu_torch.data.nerf_synthetic import read_rgba
from ngp_tpu_torch.grid.occupancy import pcg4d
from ngp_tpu_torch.ops.layout import SampleLayout, build_layout
from ngp_tpu_torch.sampling.lattice import count_samples, lattice_dt, lattice_t, n_lattice_points
from ngp_tpu_torch.utils.aabb import AABB
from ngp_tpu_torch.utils.config import SamplerConfig
from ngp_tpu_torch.utils.fma import dot_fma, fma, sqrt_rn
from ngp_tpu_torch.utils.qmc import mul32

_MASK = 0xFFFFFFFF


class TrainingBatch(NamedTuple):
    rays_o: torch.Tensor  # (R, 3)
    rays_d: torch.Tensor  # (R, 3)
    rgba: torch.Tensor  # (R, 4) premultiplied-linear target
    ray_valid: torch.Tensor  # (R,) bool, kept rays
    layout: SampleLayout  # all R rays at width s_pad
    pos: torch.Tensor  # (C, 3) warped network positions
    dirs: torch.Tensor  # (C, 3) warped directions
    dt_pad: torch.Tensor | None  # (R, S) step sizes; None when constant (c == 0)
    n_samples: torch.Tensor  # () generated samples before drops
    max_ray_count: torch.Tensor  # () longest ray (the s_pad controller's signal)
    image_index: torch.Tensor  # (R,) picked image per ray
    xy: torch.Tensor  # (R, 2) normalized pixel coordinate


def generate_training_batch(
    cfg: SamplerConfig,
    aabb: AABB,
    images: torch.Tensor,  # (N, H, W, 4) fp16
    xforms: torch.Tensor,  # (N, 3, 4)
    focal_length,
    principal_point,
    occupancy: torch.Tensor,  # (n_cascades, G, G, G) bool
    salts,  # two u32 draws
    n_rays: int,
    n_rays_shift: int,
    capacity: int,
    s_pad: int,
) -> TrainingBatch:
    dev = occupancy.device
    n_images, h, w = images.shape[0], images.shape[1], images.shape[2]
    n_lattice = n_lattice_points(cfg)
    s_pad = min(s_pad, n_lattice)

    # image pick: uint32 stride arithmetic with wraparound (cu:348)
    i = torch.arange(n_rays, dtype=torch.int64, device=dev)
    img = (mul32((i + (int(n_rays_shift) & _MASK)) & _MASK, n_images) // n_rays) % n_images

    s0, s1 = (int(s) & _MASK for s in salts)
    h0, h1, h2, _ = pcg4d(i, torch.full_like(i, s0), torch.full_like(i, s1), torch.full_like(i, 0x9E3779B9))
    inv24 = 1.0 / (1 << 24)
    xy = torch.stack([h0 >> 8, h1 >> 8], dim=-1).to(torch.float32) * inv24
    jitter_u = (h2 >> 8).to(torch.float32) * inv24
    if cfg.snap_to_pixel_centers_in_training:
        res = torch.tensor([w, h], dtype=torch.float32, device=dev)
        xy = (torch.minimum(torch.clamp(torch.floor(xy * res), min=0), res - 1) + 0.5) / res

    xf = xforms[img]  # (R, 3, 4)
    # float32 scalars, as JAX takes them (a Python float multiplies in float64)
    fx, fy, wf, hf = (torch.tensor(float(v), dtype=torch.float32) for v in (*focal_length, w, h))
    d_cam = torch.stack(
        [
            (xy[:, 0] - principal_point[0]) * wf / fx,
            (xy[:, 1] - principal_point[1]) * hf / fy,
            torch.ones((n_rays,), dtype=torch.float32, device=dev),
        ],
        dim=-1,
    )
    d = dot_fma(xf[:, :, :3], d_cam[:, None, :])
    d = d / sqrt_rn(dot_fma(d, d))[:, None]
    o = xf[:, :, 3]

    tmin, tmax = aabb.ray_intersect(o, d)
    tmin = torch.clamp(tmin, min=cfg.near_distance)
    startt = tmin + lattice_dt(cfg, tmin) * jitter_u  # march-start jitter (cu:385)
    hits = tmin < tmax

    counts, masks = count_samples(cfg, aabb, occupancy, o, d, startt, return_masks=True)
    masks &= hits[:, None]
    counts = torch.where(hits, counts, 0)
    n_samples = counts.sum()
    max_ray_count = counts.max()
    counts = torch.clamp(counts, max=s_pad)  # truncate long rays (cu:408)

    # whole-ray drops: zero samples or overflowing the flat budget (cu:414-416)
    ray_valid = counts > 0
    counts_res = torch.where(ray_valid, counts, 0)
    base = torch.cumsum(counts_res, 0) - counts_res
    ray_valid &= base + counts_res <= capacity
    layout = build_layout(base, counts, ray_valid, capacity, s_pad)

    # left-justify each kept ray's first s_pad occupied lattice indices
    masks &= ray_valid[:, None]
    rows, cols = torch.nonzero(masks, as_tuple=True)
    ordinal = torch.arange(rows.numel(), device=dev) - (torch.cumsum(masks.sum(dim=1), 0) - masks.sum(dim=1))[rows]
    keep = ordinal < s_pad
    lat_pad = torch.full((n_rays, s_pad), n_lattice, dtype=torch.int64, device=dev)
    lat_pad[rows[keep], ordinal[keep]] = cols[keep]

    rid = layout.ray_ids
    flat_lat = torch.where(layout.flat_valid, lat_pad[rid, layout.pos_in_ray], 0)
    # here XLA keeps the multiply and the add apart (no fused multiply-add)
    if cfg.cone_angle_constant == 0.0:
        flat_t = startt[rid] + flat_lat.to(torch.float32) * torch.tensor(cfg.min_cone_stepsize, dtype=torch.float32)
    else:
        flat_t = lattice_t(cfg, startt[rid], flat_lat)
    flat_pos = o[rid] + flat_t[:, None] * d[rid]
    flat_dirs = (d[rid] + 1.0) * 0.5

    dt_pad = None
    if cfg.cone_angle_constant != 0.0:
        dt_pad = lattice_dt(cfg, lattice_t(cfg, startt[:, None], lat_pad))

    return TrainingBatch(
        rays_o=o,
        rays_d=d,
        rgba=read_rgba(images, xy, img),
        ray_valid=ray_valid,
        layout=layout,
        pos=aabb.relative_pos(flat_pos),
        dirs=flat_dirs,
        dt_pad=dt_pad,
        n_samples=n_samples,
        max_ray_count=max_ray_count,
        image_index=img,
        xy=xy,
    )
