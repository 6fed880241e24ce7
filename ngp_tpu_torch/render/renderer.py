"""Novel-view renderer: march alive rays chunk by chunk, evaluate, composite, compact.

Counterpart: ngp_tpu/render/renderer.py:67-433 (_render_tile_impl with all
seven modes, one spp pass per call) and :712-734 (_camera_rays). Ports the
semantics, not the structure: ngp_tpu's span tiles, shape buckets, jit
caches, coarse segment premask, packed march and ring queue exist to keep
XLA's shapes static. Here, as in the reference's render loop (testbed.cu:
479-606), all W*H rays stay on the device; each round marches the next
CHUNK lattice points of the rays still alive, evaluates the network only on
the occupied points as one flat batch, composites in the dense
(n_alive, CHUNK) layout and drops the rays that finished. The multi-spp
shared-evaluation path (share_evals) is not ported; render(spp > 1) runs
exact per-pass frames. The modes' sample colours and shading follow
ngp_tpu: Normals composites -grad(sigma)/|grad(sigma)| per sample
(NGPModel.input_gradient) and shades (0.5 n + 0.5) * opacity of the
normalised sum; Depth and Distance composite the camera-axis and Euclidean
distance over scene_scale; Stepsize the warped dt; AO the sample's alpha;
Cost shades the count of included samples / 128 with alpha 1.

Exactly as ngp_tpu: the pixel offset ld_random_pixel_offset(0 if snap else
spp); the march start t0 = max(tmin, 0.05) + 1e-6 (a ray is alive only if
that point is inside the box) plus ld_random_val(spp, ray_id*786433)*dt; the
break at the first lattice point outside the box and the per-ray sample cap;
network inputs relative_pos(pos) and (d + 1)/2; a sample counts iff the
transmittance before it is >= transmittance_threshold; Shade converts the
accumulated colour with srgb_to_linear unless train_in_linear_color, and the
output is zero where opacity <= 0.001.
"""

from dataclasses import dataclass

import torch

from ngp_tpu_torch.models.ngp import NGPModel, apply_density_activation, apply_rgb_activation
from ngp_tpu_torch.sampling.lattice import CHUNK, lattice_dt, march_chunk, n_lattice_points
from ngp_tpu_torch.utils.aabb import AABB, warp_dt
from ngp_tpu_torch.utils.color import srgb_to_linear
from ngp_tpu_torch.utils.config import NGPConfig
from ngp_tpu_torch.utils.fma import fma
from ngp_tpu_torch.utils.qmc import ld_random_pixel_offset, ld_random_val

RENDER_MODES = ("AO", "Shade", "Normals", "Depth", "Distance", "Stepsize", "Cost")
EVAL_BATCH = 1 << 18  # rows per network evaluation (the fused kernel's batch)


def camera_rays(cam: torch.Tensor, w: int, h: int, focal_length, principal_point, off):
    """Pixel-grid rays for subpixel offset `off`: origins and unit directions
    (W*H, 3), row-major over (y, x). cam (3, 4) float32 on the target device."""
    dev = cam.device
    f = torch.as_tensor(focal_length, dtype=torch.float32, device=dev)
    pp = torch.as_tensor(principal_point, dtype=torch.float32, device=dev)
    off = torch.as_tensor(off, dtype=torch.float32, device=dev)
    # (i + off) / w - pp as XLA compiles it: the division by the constant
    # becomes a product with float32(1 / w), contracted with the subtraction
    # into one fused multiply-add (so the rays are ngp_tpu's to the bit)
    xs = fma(torch.arange(w, dtype=torch.float32, device=dev) + off[0], 1.0 / w, -pp[0])
    ys = fma(torch.arange(h, dtype=torch.float32, device=dev) + off[1], 1.0 / h, -pp[1])
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    gx, gy = gx.reshape(-1), gy.reshape(-1)
    dcam = torch.stack([gx * w / f[0], gy * h / f[1], torch.ones_like(gx)], dim=-1)
    d = dcam @ cam[:, :3].T
    # degenerate cameras give zero-length directions; keep them finite
    d = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-12)
    o = cam[:, 3].expand_as(d)
    return o, d


def ray_start(aabb: AABB, o: torch.Tensor, d: torch.Tensor):
    """Ray init (init_rays_with_payload_kernel_nerf): the march start t0 past
    the near plane 0.05, and whether the ray is alive (that point lies in the
    box). o + d * t0 is one fused multiply-add, as XLA compiles ngp_tpu's, so
    rays that graze the box agree."""
    tmin, _ = aabb.ray_intersect(o, d)
    t0 = torch.clamp(tmin, min=0.05) + 1e-6
    return t0, aabb.contains(fma(d, t0[:, None], o))


@dataclass
class Renderer:
    """Renders one spp pass of a frame from a model and an occupancy grid."""

    model: NGPModel
    config: NGPConfig
    train_in_linear_color: bool = False
    rgb_activation: str = "Logistic"
    density_activation: str = "Exponential"
    last_frame_samples: int = 0  # network samples evaluated by the last frame

    def _evaluate(self, pos_w: torch.Tensor, dir_w: torch.Tensor, normals: bool = False):
        """Network on a flat batch of samples -> (sigma (M,), rgb (M, 3)); with
        `normals` the colour is the unit normal -grad(sigma)/|grad(sigma)|."""
        sig, col = [], []
        for s in range(0, pos_w.shape[0], EVAL_BATCH):
            p = pos_w[s : s + EVAL_BATCH]
            rgb_raw, sigma_raw = self.model.rgbsigma_raw(p, dir_w[s : s + EVAL_BATCH])
            sig.append(apply_density_activation(sigma_raw, self.density_activation))
            if normals:
                # volume_rendering_kernel (testbed.cu:260-265): the normal
                # points down the density gradient
                grad = self.model.input_gradient(p, self.density_activation)
                col.append(-grad / torch.clamp(torch.linalg.norm(grad, dim=-1, keepdim=True), min=1e-12))
            else:
                col.append(apply_rgb_activation(rgb_raw, self.rgb_activation))
        return torch.cat(sig), torch.cat(col)

    @torch.no_grad()
    def render_frame(
        self,
        occupancy: torch.Tensor,
        camera_matrix,
        resolution,
        focal_length,
        principal_point,
        spp: int,
        render_mode: str = "Shade",
        scene_scale: float = 1.0,
    ) -> torch.Tensor:
        """One frame at spp index `spp` -> (H, W, 4) premultiplied linear."""
        if render_mode not in RENDER_MODES:
            raise NotImplementedError(f"render mode {render_mode!r} is not ported (have {RENDER_MODES})")
        dev = occupancy.device
        scfg = self.config.sampler
        aabb = AABB.scene(scfg.aabb_scale)
        dt = scfg.min_cone_stepsize
        thresh = self.config.render.transmittance_threshold
        w, h = resolution
        n = w * h
        cam = torch.as_tensor(camera_matrix, dtype=torch.float32).to(dev)
        off = ld_random_pixel_offset(0 if scfg.snap_to_pixel_centers_in_rendering else int(spp))
        o, d = camera_rays(cam, w, h, focal_length, principal_point, off.tolist())

        t0, alive = ray_start(aabb, o, d)
        seed = (torch.arange(n, dtype=torch.int64, device=dev) * 786433) & 0xFFFFFFFF
        startt = fma(ld_random_val(int(spp), seed), dt, t0)
        dirs_w = (d + 1.0) * 0.5
        cam_fwd, cam_org = cam[:, 2], cam[:, 3]
        depth_scale = 1.0 / scene_scale

        self.model.prepare_inference()
        rgb_acc = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        opac = torch.zeros((n,), dtype=torch.float32, device=dev)
        trans = torch.ones((n,), dtype=torch.float32, device=dev)
        taken = torch.zeros((n,), dtype=torch.int64, device=dev)
        processed = torch.zeros((n,), dtype=torch.int64, device=dev)  # included samples (Cost)
        ids = torch.nonzero(alive).squeeze(1)
        n_samples = 0
        for i0 in range(0, n_lattice_points(scfg), CHUNK):
            if ids.numel() == 0:
                break
            mask, t, pos, inside_end = march_chunk(scfg, aabb, occupancy, o[ids], d[ids], startt[ids], taken[ids], i0)
            rows, cols = torch.nonzero(mask, as_tuple=True)
            n_samples += rows.numel()
            sigma = torch.zeros(mask.shape, dtype=torch.float32, device=dev)
            rgb = torch.zeros(mask.shape + (3,), dtype=torch.float32, device=dev)
            if rows.numel():
                sig_s, rgb_s = self._evaluate(
                    aabb.relative_pos(pos[rows, cols]), dirs_w[ids[rows]], normals=render_mode == "Normals"
                )
                sigma[rows, cols] = sig_s
                rgb[rows, cols] = rgb_s
            dts = lattice_dt(scfg, t)
            if render_mode == "Depth":
                z = ((pos - cam_org) * cam_fwd).sum(dim=-1) * depth_scale
                rgb = z[..., None].expand(-1, -1, 3)
            elif render_mode == "Distance":
                z = torch.linalg.norm(pos - cam_org, dim=-1) * depth_scale
                rgb = z[..., None].expand(-1, -1, 3)
            elif render_mode == "Stepsize":
                rgb = warp_dt(dts, dt, scfg.n_cascades)[..., None].expand(-1, -1, 3)

            # composite (early stop: a sample counts iff the transmittance
            # BEFORE it is >= the threshold)
            sdt = torch.where(mask, sigma * dts, 0.0)
            alpha = 1.0 - torch.exp(-sdt)
            if render_mode == "AO":
                rgb = alpha[..., None].expand(-1, -1, 3)
            acc_before = torch.cumsum(sdt, dim=1) - sdt
            tr = trans[ids]
            t_before = tr[:, None] * torch.exp(-acc_before)
            include = mask & (t_before >= thresh)
            wgt = torch.where(include, alpha * t_before, 0.0)
            rgb_acc[ids] += (wgt[..., None] * rgb).sum(dim=1)
            opac[ids] += wgt.sum(dim=1)
            tr = tr * torch.exp(-torch.where(include, sdt, 0.0).sum(dim=1))
            trans[ids] = tr
            processed[ids] += include.sum(dim=1)
            tk = taken[ids] + mask.sum(dim=1)
            taken[ids] = tk
            ids = ids[inside_end & (tr >= thresh) & (tk < scfg.maximum_marching_steps)]
        self.last_frame_samples = n_samples

        # shade_kernel (testbed.cu:448-477)
        if render_mode == "Cost":
            col = processed.to(torch.float32) / 128.0
            out = torch.stack([col, col, col, torch.ones_like(col)], dim=-1)
        elif render_mode == "Normals":
            # remap the mean normal to [0, 1] (testbed.cu:463-465)
            nrm = rgb_acc / torch.clamp(torch.linalg.norm(rgb_acc, dim=-1, keepdim=True), min=1e-12)
            out = torch.cat([(0.5 * nrm + 0.5) * opac[:, None], opac[:, None]], dim=-1)
        else:
            rgb_out = rgb_acc
            if render_mode == "Shade" and not self.train_in_linear_color:
                rgb_out = srgb_to_linear(rgb_acc)
            out = torch.cat([rgb_out, opac[:, None]], dim=-1)
        out = torch.where((opac > 0.001)[:, None], out, 0.0)
        return out.reshape(h, w, 4)
