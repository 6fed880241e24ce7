"""Novel-view renderer: march alive rays round by round, evaluate, composite, compact.

Counterpart: ngp_tpu/render/renderer.py:67-433 (_render_tile_impl with all
seven modes, one pass or n_spp passes per call, the envmap behind every
ray), :437-447 (_coarse_pass), :481-526 (_rays_slab_pass: the frame's k0 /
span / hit), :606-625 (share_spp_evals, can_batch_spp), :712-734
(_camera_rays), :763-872 (_frame_geometry: the coarse premask and the cull
of rays with no kept segment) and :885-1109 (render_frame, with the envmap
fill of culled and missed rays). Ports the semantics, not the structure:
ngp_tpu's span tiles, shape buckets, jit caches and ring queue exist to keep
XLA's shapes static. Here, as in the reference's render loop
(testbed.cu:479-606), all W*H rays stay on the device; each round marches
the rays still alive, evaluates the network only on the points that need it
as one flat batch (written into preallocated outputs), composites in the
dense (n_alive, round width) layout and drops the rays that finished. The
modes' sample colours and shading follow ngp_tpu: Normals composites
-grad(sigma)/|grad(sigma)| per sample (NGPModel.input_gradient) and shades
(0.5 n + 0.5) * opacity of the normalised sum; Depth and Distance composite
the camera-axis and Euclidean distance over scene_scale; Stepsize the warped
dt; AO the sample's alpha; Cost shades the count of included samples / 128
with alpha 1.

Empty-space skipping (the arithmetic lattice, cone_angle_constant = 0):
each ray's window comes from the occupied box as in _rays_slab_pass (hit,
k0, span: frame_geometry); a coarse pass over the hit rays, at the
unjittered t0, keeps the 8-point segments that the halo-pooled grid says
may hold an occupied point (coarse_segment_mask over enough segments to
cover the longest window: ceil(max span / 8), from the window start
rounded to a whole segment at spp 1, in whole rounds plus the lookahead
segment at spp 8), and rays with no kept segment are culled. The fine march then
walks each ray's kept segments in rounds of RANGE_SEGS = 16 segments (128
lattice points): a round is one 128-ordinal range of the lattice, as the
full march's chunk was, and a ray jumps from one range holding a kept
segment to the next, so the rounds a ray takes, the points that stop it
(the transmittance stop, the running sample cap, the box exit) and so the
network samples of the frame are the full march's. The break-on-exit is
count_samples_segments': the window's first point inside, then a pointwise
box test (the box is convex). Where packed_march_supported holds, the
march reads the occupancy of a segment's 8 points from one packed 3^3 word
(packed_neighborhood), as ngp_tpu's tiles do (Renderer._packed into
count_samples_segments): a packed word addresses a point by floor(pos * G),
occupancy_lookup by floor(((pos - 0.5) + 0.5) * G), and below 0.25 the two
put a point within an ulp of a cell face in neighbouring cells, so the frame
follows ngp_tpu's. Elsewhere (aabb_scale > 1) the spp-1 march reads the grid
point by point (occupancy_lookup). The cone lattice marches the whole
lattice point by point, culling only the rays that miss the occupied box
(ngp_tpu/render/renderer.py:921-932; _packed is None).

A spp-1 pass marches through render/march.py on every device and lattice:
pass_march builds the pass's march (FrameMarch on constant dt, one launch a
round of csrc/render_march.cu's kernel on the card's PACKED lattice or of
its plain PyTorch version elsewhere; ConeMarch's whole-lattice rounds on the
cone lattice), and _render_pass composites each Round it hands out: the
network and the composite read the round's flat sample rows and its
(L, W) mask. The spp-n Shade frame with shared evaluations marches each
block of its hit rays through march.py's CoverMarch (one launch a round of
csrc/render_cover_march.cu's kernel on the card's jitter-cover lattice, of
its plain version elsewhere), whose first launch of a block is also its
coarse pass and cull; the other spp-n frames plan the frame's kept segments
and march the plan's rounds here (_kept_segments, segment_plan,
march_round).

One pass (n_spp = 1), exactly as ngp_tpu: the pixel offset
ld_random_pixel_offset(0 if snap else spp); the march start
t0 = max(tmin, 0.05) + 1e-6 (a ray is alive only if that point is inside
the box) plus ld_random_val(spp, ray_id*786433)*dt, the t of ordinal i
being lattice_t(startt, i) (a fused multiply-add) as the full march from t0
computes it; ranges aligned at ordinal 0 (the window starts at k0 rounded
down to a multiple of 8); network inputs relative_pos(pos) and (d + 1)/2; a
sample counts iff the transmittance before it is >= transmittance_threshold;
Shade converts the accumulated colour with srgb_to_linear unless
train_in_linear_color, and the output is zero where opacity <= 0.001.

n_spp passes in one frame (can_batch_spp: pixel snapping and the
jitter-cover march), as ngp_tpu's batched frame: ONE cover march from the
unjittered t0 at ordinals k0 + j (ranges aligned at k0) over the kept
segments (the pooled halo absorbs the jitter; count_samples_segments'
jitter_cover tests) finds every lattice point that any pass's jittered start
(ld_random_val(s, seed), s < n_spp) can sample. Shade with share_spp_evals
evaluates the network once per cover point, at the unjittered point, and
each pass takes its sample at t + u*dt from the in-cell lerp towards the
next point's evaluation (the point itself across a gap, at a ray's last
sample and at the last sample of each ngp_tpu compositing round of
SHARE_ROUND samples; a round's 17th segment is the lookahead), with its own
box test t + u*dt <= tmax and its own transmittance chain; the ray runs
while any pass is above the threshold. The other modes (or share_spp_evals
off) evaluate each pass at its own jittered points where the cover mask and
the box test both hold. The frame is the passes' mean in accum_space
(linear, or sRGB for the colour), i.e. render/buffer.accumulate over the
passes. The rays are composited in blocks so that the (rays, passes, round
width) temporaries stay near SPP_BLOCK_SLOTS entries.

Spans (utils/profiling.py), on every path, so that a trace gives each
stage's device time: spp_march (the camera rays, the frame geometry, the
coarse pass, each round's march and its index bookkeeping), spp_network
(the network on a round's samples, written into the round's outputs) and
spp_composite (the compositing, the accumulation and, at n_spp = 1, the
shade; at n_spp > 1 the shared composite's span covers its rounds alone).
Every host<->device synchronisation of a frame (each nonzero, boolean-mask
index, int() of a device value and blocking copy to the card) sits in a
render.sync.<site> span at the statement that synchronises, in this module
or in its callee (utils/qmc.py's ld_random_val, render/buffer.py's
tonemap, render/march.py's frame geometry, hit rays and syncs a round: site
`march` at spp 1, `cover_march` for the shared spp-n frame), and
counts into the render.host_syncs counters.

With `mesh` of size > 1 (parallel/mesh.py; ngp_tpu's _dp_render_tile,
:658-684 and :1063-1104), every rank plans the whole frame (window, coarse
premask, cull) and then renders every size-th of the kept rays from its rank
on (image order in contiguous blocks would give one rank the sky; the spp-1
march and the shared spp-n cover march, which cull as they march, every
size-th of the rays that meet the occupied box), spp 1, spp n and every mode
through the same pass; each
rank's shaded rows land in a zero frame and one SUM all-reduce after its
rounds merges the frame, exactly, since one rank writes each pixel. The
envmap is composited after the merge. `last_frame_samples` and
`last_frame_points` count this rank's share.

With an envmap (H, W, 4), every ray of a pass shows out + env * (1 - alpha),
env the bilinear lookup along its direction: culled and missed rays the
envmap alone; at n_spp > 1 per pass, before the accumulation-space
conversion and the mean. `last_frame_samples` counts the network samples
of the last frame, `last_frame_points` the lattice points its march tested
(the coarse midpoints and every slot of the fine rounds).
"""

from dataclasses import dataclass

import torch

from ngp_tpu_torch.grid.occupancy import occupied_aabb, packed_neighborhood, pooled_occupancy
from ngp_tpu_torch.models.ngp import NGPModel, apply_density_activation, apply_rgb_activation
from ngp_tpu_torch.render.envmap import read_envmap
from ngp_tpu_torch.render.march import RANGE_SEGS, CoverMarch, Round, frame_geometry, march_round, pass_march, segment_plan
from ngp_tpu_torch.sampling.lattice import (
    CHUNK,
    coarse_segment_mask,
    jitter_cover_supported,
    lattice_dt,
    window_start_inside,
)
from ngp_tpu_torch.utils import profiling
from ngp_tpu_torch.utils.aabb import AABB, warp_dt
from ngp_tpu_torch.utils.color import linear_to_srgb, srgb_to_linear
from ngp_tpu_torch.utils.config import NGPConfig
from ngp_tpu_torch.utils.fma import fma
from ngp_tpu_torch.utils.qmc import ld_random_pixel_offset, ld_random_val

RENDER_MODES = ("AO", "Shade", "Normals", "Depth", "Distance", "Stepsize", "Cost")
EVAL_BATCH = 1 << 18  # rows per network evaluation (the fused kernel's batch)
SPP_BLOCK_SLOTS = 1 << 27  # (ray, pass, lattice point) entries a block of the n_spp composite holds


def camera_rays(cam: torch.Tensor, w: int, h: int, focal_length, principal_point, off):
    """Pixel-grid rays for subpixel offset `off`: origins and unit directions
    (W*H, 3), row-major over (y, x). cam (3, 4) float32 on the target device."""
    dev = cam.device
    with profiling.host_sync("render", "camera_rays", 3):  # each copied to the card
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


def composite_weights(valid: torch.Tensor, sdt: torch.Tensor, trans: torch.Tensor, thresh: float):
    """Front-to-back compositing of samples along the last axis (early stop:
    a sample counts iff the transmittance BEFORE it is >= thresh), from
    sdt = sigma*dt (0 where not valid) and the transmittance `trans` before
    them: (alpha, include, weights, transmittance after them)."""
    alpha = 1.0 - torch.exp(-sdt)
    t_before = trans[..., None] * torch.exp(-(torch.cumsum(sdt, dim=-1) - sdt))
    include = valid & (t_before >= thresh)
    wgt = torch.where(include, alpha * t_before, 0.0)
    return alpha, include, wgt, trans * torch.exp(-torch.where(include, sdt, 0.0).sum(dim=-1))


@dataclass
class Renderer:
    """Renders frames (one spp pass, or n_spp passes at once) from a model and
    an occupancy grid, with an optional envmap behind them."""

    model: NGPModel
    config: NGPConfig
    train_in_linear_color: bool = False
    rgb_activation: str = "Logistic"
    density_activation: str = "Exponential"
    # n_spp > 1 Shade frames evaluate the network once per cover point and
    # lerp each pass's sample from it; False evaluates every pass's points
    share_spp_evals: bool = True
    mesh: object = None  # parallel/mesh.Mesh -> each rank renders its share of a frame's rays
    last_frame_samples: int = 0  # network samples evaluated by the last frame
    last_frame_points: int = 0  # lattice points the last frame's march tested

    def can_batch_spp(self) -> bool:
        """render_frame(n_spp > 1) needs pixel snapping (every pass traces the
        same rays) and the jitter-cover march."""
        scfg = self.config.sampler
        return scfg.snap_to_pixel_centers_in_rendering and jitter_cover_supported(scfg)

    def _evaluate(self, pos_w: torch.Tensor, dir_w: torch.Tensor, normals: bool = False):
        """Network on a flat batch of samples -> (sigma (M,), rgb (M, 3)); with
        `normals` the colour is the unit normal -grad(sigma)/|grad(sigma)|.
        Each EVAL_BATCH rows go into the preallocated outputs."""
        m = pos_w.shape[0]
        sig = torch.empty((m,), dtype=torch.float32, device=pos_w.device)
        col = torch.empty((m, 3), dtype=torch.float32, device=pos_w.device)
        for s in range(0, m, EVAL_BATCH):
            p = pos_w[s : s + EVAL_BATCH]
            rgb_raw, sigma_raw = self.model.rgbsigma_raw(p, dir_w[s : s + EVAL_BATCH])
            sig[s : s + EVAL_BATCH] = apply_density_activation(sigma_raw, self.density_activation)
            if normals:
                # volume_rendering_kernel (testbed.cu:260-265): the normal
                # points down the density gradient
                grad = self.model.input_gradient(p, self.density_activation)
                col[s : s + EVAL_BATCH] = -grad / torch.clamp(torch.linalg.norm(grad, dim=-1, keepdim=True), min=1e-12)
            else:
                col[s : s + EVAL_BATCH] = apply_rgb_activation(rgb_raw, self.rgb_activation)
        return sig, col

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
        occ_aabb: torch.Tensor | None = None,
        n_spp: int = 1,
        accum_space: str = "linear",
        envmap: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """One frame at spp index `spp` -> (H, W, 4) premultiplied linear; with
        n_spp > 1 (can_batch_spp) the passes spp .. spp + n_spp - 1 at once,
        returned as their mean in accum_space ("linear" or "srgb"). occ_aabb
        is the grid's occupied box (computed from `occupancy` when None);
        envmap (H_e, W_e, 4), where given, lies behind every ray."""
        scfg = self.config.sampler
        w, h = resolution
        with profiling.span("spp_march"):
            with profiling.host_sync("render", "camera"):
                cam = torch.as_tensor(camera_matrix, dtype=torch.float32).to(occupancy.device)
            off = ld_random_pixel_offset(0 if scfg.snap_to_pixel_centers_in_rendering else int(spp))
            o, d = camera_rays(cam, w, h, focal_length, principal_point, off.tolist())
        out = self.render_rays(occupancy, cam, o, d, spp, render_mode, scene_scale, occ_aabb, n_spp, accum_space, envmap)
        return out.reshape(h, w, 4)

    @torch.no_grad()
    def render_rays(
        self,
        occupancy: torch.Tensor,
        cam: torch.Tensor,
        o: torch.Tensor,
        d: torch.Tensor,
        spp: int,
        render_mode: str = "Shade",
        scene_scale: float = 1.0,
        occ_aabb: torch.Tensor | None = None,
        n_spp: int = 1,
        accum_space: str = "linear",
        envmap: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """render_frame on given rays: origins and unit directions (N, 3), the
        camera (3, 4) for Depth and Distance, all on occupancy's device ->
        (N, 4)."""
        if render_mode not in RENDER_MODES:
            raise NotImplementedError(f"render mode {render_mode!r} is not ported (have {RENDER_MODES})")
        if n_spp > 1 and not self.can_batch_spp():
            raise ValueError("n_spp > 1 requires can_batch_spp() (pixel snapping + jitter-cover march)")
        if occ_aabb is None:
            occ_aabb = occupied_aabb(self.config.sampler, occupancy)
        env = None if envmap is None else read_envmap(envmap.to(o.device), d)
        self.model.prepare_inference()
        self.last_frame_samples = self.last_frame_points = 0
        if n_spp == 1:
            out = self._render_pass(occupancy, occ_aabb, o, d, cam, int(spp), render_mode, 1.0 / scene_scale)
            return out if env is None else out + env * (1.0 - out[:, 3:4])
        return self._render_passes(
            occupancy, occ_aabb, o, d, cam, int(spp), n_spp, render_mode, 1.0 / scene_scale, accum_space.lower(), env
        )

    def _shade(self, rgb_acc, opac, processed, render_mode):
        """shade_kernel (testbed.cu:448-477): accumulated sums -> RGBA."""
        if render_mode == "Cost":
            col = processed.to(torch.float32) / 128.0
            out = torch.stack([col, col, col, torch.ones_like(col)], dim=-1)
        elif render_mode == "Normals":
            # remap the mean normal to [0, 1] (testbed.cu:463-465)
            nrm = rgb_acc / torch.clamp(torch.linalg.norm(rgb_acc, dim=-1, keepdim=True), min=1e-12)
            out = torch.cat([(0.5 * nrm + 0.5) * opac[..., None], opac[..., None]], dim=-1)
        else:
            rgb_out = rgb_acc
            if render_mode == "Shade" and not self.train_in_linear_color:
                rgb_out = srgb_to_linear(rgb_acc)
            out = torch.cat([rgb_out, opac[..., None]], dim=-1)
        return torch.where((opac > 0.001)[..., None], out, 0.0)

    def _sharded(self) -> bool:
        return self.mesh is not None and self.mesh.size > 1

    def _rank_rays(self) -> slice:
        """This rank's share of a frame's rays: every size-th from its rank on."""
        return slice(self.mesh.rank, None, self.mesh.size) if self._sharded() else slice(None)

    def _share(self, ids, plan):
        """This rank's share of the frame's kept rays ids and their plan rows."""
        if not self._sharded():
            return ids, plan
        sel = self._rank_rays()
        return ids[sel], plan.rows(sel)

    def _merge(self, out: torch.Tensor) -> torch.Tensor:
        """The frame from every rank's rows (zero elsewhere): one SUM all-reduce."""
        if self._sharded():
            out = out.contiguous()
            self.mesh.all_reduce_([out], "sum")
        return out

    def _kept_segments(self, occupancy, o, d, t0, ids, w0, n_seg: int, s0, n_rounds: int, limit=None):
        """The coarse pass on rays ids at the unjittered t0 (ngp_tpu's
        _coarse_pass): (ids of the rays with a kept segment in a round they
        march, their SegmentPlan)."""
        scfg = self.config.sampler
        keep = coarse_segment_mask(scfg, pooled_occupancy(scfg, occupancy), o[ids], d[ids], t0[ids], n_seg, w0)
        self.last_frame_points += keep.numel()
        plan = segment_plan(keep, w0, s0, n_rounds, limit)
        cull = plan.nxt[:, 0] < n_rounds
        with profiling.host_sync("render", "cull"):  # a boolean-mask index
            ids = ids[cull]
        return ids, plan.rows(cull)

    def _render_pass(self, occupancy, occ_aabb, o, d, cam, spp, render_mode, depth_scale):
        """One exact pass over all rays -> (N, 4): the rounds of
        march.pass_march composited one by one."""
        dev = occupancy.device
        scfg = self.config.sampler
        n = o.shape[0]
        with profiling.span("spp_march"):
            t0, alive = ray_start(AABB.scene(scfg.aabb_scale), o, d)
            seed = (torch.arange(n, dtype=torch.int64, device=dev) * 786433) & 0xFFFFFFFF
            startt = fma(ld_random_val(spp, seed), scfg.min_cone_stepsize, t0)
            rgb_acc = torch.zeros((n, 3), dtype=torch.float32, device=dev)
            opac = torch.zeros((n,), dtype=torch.float32, device=dev)
            trans = torch.ones((n,), dtype=torch.float32, device=dev)
            processed = torch.zeros((n,), dtype=torch.int64, device=dev)  # included samples (Cost)
            march = pass_march(scfg, occupancy, occ_aabb, o, d, t0, startt, alive, trans,
                               self.config.render.transmittance_threshold, self._rank_rays())
        while march is not None:
            with profiling.span("spp_march"):
                r = march.next()
            if r is None:
                self.last_frame_points += march.tested
                self.last_frame_samples += march.sampled
                break
            self._composite_round((rgb_acc, opac, trans, processed), r, cam, render_mode, depth_scale)
        with profiling.span("spp_composite"):
            return self._merge(self._shade(rgb_acc, opac, processed, render_mode))

    def _composite_round(self, acc, r: Round, cam, render_mode, depth_scale):
        """The network on a round's samples and the round's composite into the
        pass's sums acc = (rgb_acc, opac, trans, processed), for the round's
        rays r.ids (L,) with sample mask r.mask (L, W): the samples are its
        rows r.flat (M,) at positions r.pos with warped directions r.dirs.
        Depth and Distance read the positions where a sample is, the step
        size comes from r.t where the lattice's dt varies."""
        rgb_acc, opac, trans, processed = acc
        scfg = self.config.sampler
        ids, mask, flat = r.ids, r.mask, r.flat
        dev = mask.device
        with profiling.span("spp_network"):
            sigma = torch.zeros(mask.shape, dtype=torch.float32, device=dev)
            rgb = torch.zeros(mask.shape + (3,), dtype=torch.float32, device=dev)
            if flat.numel():
                sig_s, rgb_s = self._evaluate(
                    AABB.scene(scfg.aabb_scale).relative_pos(r.pos), r.dirs, normals=render_mode == "Normals"
                )
                sigma.view(-1)[flat] = sig_s
                rgb.view(-1, 3)[flat] = rgb_s
        with profiling.span("spp_composite"):
            dts = torch.full(mask.shape, scfg.min_cone_stepsize, device=dev) if r.t is None else lattice_dt(scfg, r.t)
            cam_fwd, cam_org = cam[:, 2], cam[:, 3]
            if render_mode in ("Depth", "Distance"):
                pos = torch.zeros(mask.shape + (3,), dtype=torch.float32, device=dev)
                pos.view(-1, 3)[flat] = r.pos
                if render_mode == "Depth":
                    z = ((pos - cam_org) * cam_fwd).sum(dim=-1) * depth_scale
                else:
                    z = torch.linalg.norm(pos - cam_org, dim=-1) * depth_scale
                rgb = z[..., None].expand(-1, -1, 3)
            elif render_mode == "Stepsize":
                rgb = warp_dt(dts, scfg.min_cone_stepsize, scfg.n_cascades)[..., None].expand(-1, -1, 3)

            alpha, include, wgt, tr = composite_weights(
                mask, torch.where(mask, sigma * dts, 0.0), trans[ids], self.config.render.transmittance_threshold
            )
            if render_mode == "AO":
                rgb = alpha[..., None].expand(-1, -1, 3)
            rgb_acc[ids] += (wgt[..., None] * rgb).sum(dim=1)
            opac[ids] += wgt.sum(dim=1)
            trans[ids] = tr
            processed[ids] += include.sum(dim=1)

    def _render_passes(self, occupancy, occ_aabb, o, d, cam, spp, n_spp, render_mode, depth_scale, accum_space, env):
        """Passes spp .. spp + n_spp - 1 from one cover march -> (N, 4), their
        mean in accum_space (each pass over the envmap `env` (N, 4), if any).
        Shade with share_spp_evals marches each block of the hit rays (this
        rank's share) through march.CoverMarch, whose first launch finds each
        ray's first round that keeps a segment; the other modes plan the
        frame's kept segments here and march the plan's rounds."""
        dev = occupancy.device
        scfg = self.config.sampler
        aabb = AABB.scene(scfg.aabb_scale)
        n = o.shape[0]
        share = self.share_spp_evals and render_mode == "Shade"
        with profiling.span("spp_march"):
            hit, k0, span = frame_geometry(scfg, o, d, occ_aabb)
            t0, alive = ray_start(aabb, o, d)
            _, tmax = aabb.ray_intersect(o, d)
            start_in = window_start_inside(scfg, aabb, o, d, t0, k0, jitter_cover=True)
            with profiling.host_sync("render", "hit_rays"):
                ids = torch.nonzero(hit & alive & start_in).squeeze(1)
            rgb_acc = torch.zeros((n, n_spp, 3), dtype=torch.float32, device=dev)
            opac = torch.zeros((n, n_spp), dtype=torch.float32, device=dev)
            processed = torch.zeros((n, n_spp), dtype=torch.int64, device=dev)
            if ids.numel():
                # rounds aligned at k0, as the cover march's chunks, up to the
                # window's span; each round looks one segment ahead
                limit = torch.ceil(span[ids] / CHUNK).to(torch.int64)
                with profiling.host_sync("render", "n_rounds"):
                    n_rounds = int(limit.max())
                n_seg = RANGE_SEGS * n_rounds + 1
                if share:
                    # every rank's coarse pass counts the whole frame's midpoints, as the plan's does
                    self.last_frame_points += ids.numel() * n_seg
                    mine = self._rank_rays()
                    ids, limit = ids[mine], limit[mine]
                    grids = (occupancy, pooled_occupancy(scfg, occupancy), packed_neighborhood(scfg, occupancy))
                else:
                    ids, plan = self._share(*self._kept_segments(
                        occupancy, o, d, t0, ids, k0[ids], n_seg, torch.zeros_like(limit), n_rounds, limit
                    ))
                    packed = packed_neighborhood(scfg, occupancy)
                seed = (ids * 786433) & 0xFFFFFFFF
                u = torch.stack([ld_random_val(spp + s, seed) for s in range(n_spp)], dim=-1)  # (R, P) start jitter
        if ids.numel():
            per_pass_colour = not share and render_mode in ("Shade", "Normals")
            block = max(1, SPP_BLOCK_SLOTS // (n_spp * CHUNK * (4 if per_pass_colour else 1)))
            for b0 in range(0, ids.numel(), block):
                r = ids[b0 : b0 + block]
                rays = (o[r], d[r], t0[r], tmax[r], u[b0 : b0 + block])
                if share:
                    acc, op, proc = self._composite_shared(grids, rays, k0[r], limit[b0 : b0 + block], n_rounds)
                else:
                    acc, op, proc = self._composite_passes(
                        occupancy, packed, (*rays, plan.rows(slice(b0, b0 + block))), cam, render_mode, depth_scale
                    )
                rgb_acc[r], opac[r], processed[r] = acc, op, proc
        out = self._merge(self._shade(rgb_acc, opac, processed, render_mode))  # (N, P, 4)
        if env is not None:
            out = out + env[:, None, :] * (1.0 - out[..., 3:4])
        if accum_space == "srgb":
            out = torch.cat([linear_to_srgb(out[..., :3]), out[..., 3:]], dim=-1)
        return out.mean(dim=1)

    def _composite_shared(self, grids, rays, k0, limit, n_rounds: int):
        """Shade passes sharing one network evaluation per cover point: sums
        (rgb (R, P, 3), opacity (R, P), processed (R, P)) of a block of rays
        o, d, t0, tmax (R,...), u (R, P), with window starts k0 and rounds
        limit (R,), marched by march.CoverMarch over grids (occupancy, pooled,
        packed). Each pass takes its sample at t + u*dt from the in-cell lerp
        of the round's evaluations (columns j and j + 1 where adj holds), with
        its own box test and transmittance chain."""
        o, d, t0, tmax, u = rays
        scfg = self.config.sampler
        aabb = AABB.scene(scfg.aabb_scale)
        dt = scfg.min_cone_stepsize
        thresh = self.config.render.transmittance_threshold
        dev = o.device
        R, P = u.shape
        trans = torch.ones((R, P), dtype=torch.float32, device=dev)
        rgb_acc = torch.zeros((R, P, 3), dtype=torch.float32, device=dev)
        opac = torch.zeros((R, P), dtype=torch.float32, device=dev)
        # the evaluation at a round's first point, made by the round before
        # (its lookahead) where that round's last point lerps towards it
        carry_sig = torch.zeros((R,), dtype=torch.float32, device=dev)
        carry_rgb = torch.zeros((R, 3), dtype=torch.float32, device=dev)
        with profiling.span("spp_march"):
            march = CoverMarch(scfg, *grids, o, d, t0, k0, limit, n_rounds, trans, thresh)
        while True:
            with profiling.span("spp_march"):
                r = march.next()
            if r is None:
                break
            live, m, adj = r.ids, r.mask, r.adj
            with profiling.span("spp_network"):
                sig = torch.zeros((live.numel(), CHUNK + 1), dtype=torch.float32, device=dev)
                rgb = torch.zeros((live.numel(), CHUNK + 1, 3), dtype=torch.float32, device=dev)
                if r.flat.numel():
                    sig.view(-1)[r.flat], rgb.view(-1, 3)[r.flat] = self._evaluate(aabb.relative_pos(r.pos), r.dirs)
                c_in = r.carry[:, 0]
                sig[:, 0] = torch.where(c_in, carry_sig[live], sig[:, 0])
                rgb[:, 0] = torch.where(c_in[:, None], carry_rgb[live], rgb[:, 0])
                carry_sig[live], carry_rgb[live] = sig[:, CHUNK], rgb[:, CHUNK]

            with profiling.span("spp_composite"):
                s0, c0 = sig[:, :CHUNK], rgb[:, :CHUNK]
                s1 = torch.where(adj, sig[:, 1:], s0)
                c1 = torch.where(adj[..., None], rgb[:, 1:], c0)
                ul = u[live][:, :, None]  # (nl, P, 1)
                sig_p = s0[:, None, :] * (1.0 - ul) + s1[:, None, :] * ul  # (nl, P, CHUNK)
                # each pass's box test at its jittered point (t grows along the ray)
                valid = m[:, None, :] & (fma(ul, dt, r.t[:, None, :]) <= tmax[live][:, None, None])
                _, _, wgt, tr = composite_weights(valid, torch.where(valid, sig_p * dt, 0.0), trans[live], thresh)
                # sum_j w_j * ((1 - u) c0_j + u c1_j), as two (P, CHUNK) x (CHUNK, 3) products
                rgb_acc[live] += (1.0 - ul) * torch.bmm(wgt, c0) + ul * torch.bmm(wgt, c1)
                opac[live] += wgt.sum(dim=2)
                trans[live] = tr
        self.last_frame_points += march.tested
        self.last_frame_samples += march.sampled
        return rgb_acc, opac, torch.zeros((R, P), dtype=torch.int64, device=dev)

    def _composite_passes(self, occupancy, packed, rays, cam, render_mode, depth_scale):
        """Every pass evaluated at its own jittered points of the cover march
        (ngp_tpu's virtual rays): sums (rgb (R, P, 3), opacity (R, P),
        processed (R, P)) of a block of rays."""
        o, d, t0, tmax, u, plan = rays
        scfg = self.config.sampler
        aabb = AABB.scene(scfg.aabb_scale)
        dt = scfg.min_cone_stepsize
        thresh = self.config.render.transmittance_threshold
        dev = o.device
        R, P = u.shape
        n_rounds = plan.nxt.shape[1] - 1
        dirs_w = (d + 1.0) * 0.5
        startt = fma(u, dt, t0[:, None])  # (R, P) each pass's march start
        cam_fwd, cam_org = cam[:, 2], cam[:, 3]
        colour = render_mode in ("Shade", "Normals")  # per-sample colour from the network
        trans = torch.ones((R, P), dtype=torch.float32, device=dev)
        rgb_acc = torch.zeros((R, P, 3), dtype=torch.float32, device=dev)
        opac = torch.zeros((R, P), dtype=torch.float32, device=dev)
        processed = torch.zeros((R, P), dtype=torch.int64, device=dev)
        taken = torch.zeros((R,), dtype=torch.int64, device=dev)
        live = torch.arange(R, device=dev)
        rnd = plan.nxt[:, 0]
        while live.numel():
            if dev.type == "cuda":
                profiling.count("render.march.plain")
            with profiling.span("spp_march"):
                mask, _, _, idx, exited = march_round(
                    scfg, aabb, occupancy, packed, plan, live, rnd, o[live], d[live], t0[live], taken[live], jitter_cover=True
                )
                self.last_frame_points += mask.numel()
                with profiling.host_sync("render", "cover_points"):
                    rows, cols = torch.nonzero(mask, as_tuple=True)
                ray = live[rows]
                lat = idx[rows, cols].to(torch.float32)
                tp = fma(lat[:, None], dt, startt[ray])  # (M, P) each pass's point
                pos = fma(tp[..., None], d[ray][:, None, :], o[ray][:, None, :])  # (M, P, 3)
                inside = aabb.contains(pos)
                tr = trans[live]
                # evaluate where the pass is still above the threshold
                ev = inside & (tr[rows] >= thresh)
                with profiling.host_sync("render", "samples"):
                    er, ep = torch.nonzero(ev, as_tuple=True)
                self.last_frame_samples += er.numel()
                nl = live.numel()
                shape = (nl, P, CHUNK)
                valid = torch.zeros(shape, dtype=torch.bool, device=dev)
                valid[rows, :, cols] = inside
            with profiling.span("spp_network"):
                sig = torch.zeros(shape, dtype=torch.float32, device=dev)
                if colour:
                    col = torch.zeros(shape + (3,), dtype=torch.float32, device=dev)
                if er.numel():
                    s_e, c_e = self._evaluate(
                        aabb.relative_pos(pos[er, ep]), dirs_w[ray[er]], normals=render_mode == "Normals"
                    )
                    sig[rows[er], ep, cols[er]] = s_e
                    if colour:
                        col[rows[er], ep, cols[er]] = c_e
            with profiling.span("spp_composite"):
                if render_mode in ("Depth", "Distance", "Stepsize"):
                    if render_mode == "Depth":
                        z = ((pos - cam_org) * cam_fwd).sum(dim=-1) * depth_scale
                    elif render_mode == "Distance":
                        z = torch.linalg.norm(pos - cam_org, dim=-1) * depth_scale
                    else:
                        z = warp_dt(torch.full(tp.shape, dt, device=dev), dt, scfg.n_cascades)
                    scalar = torch.zeros(shape, dtype=torch.float32, device=dev)
                    scalar[rows, :, cols] = z

                alpha, include, wgt, tr = composite_weights(valid, torch.where(valid, sig * dt, 0.0), tr, thresh)
                if colour:
                    rgb_acc[live] += (wgt[..., None] * col).sum(dim=2)
                elif render_mode != "Cost":
                    c = alpha if render_mode == "AO" else scalar
                    rgb_acc[live] += (wgt * c).sum(dim=2)[..., None].expand(-1, -1, 3)
                opac[live] += wgt.sum(dim=2)
                processed[live] += include.sum(dim=2)
                trans[live] = tr
            with profiling.span("spp_march"):
                tk = taken[live] + mask.sum(dim=1)
                taken[live] = tk
                nxt = plan.nxt[live, rnd + 1]
                more = ~exited & (tr >= thresh).any(dim=1) & (tk < scfg.maximum_marching_steps) & (nxt < n_rounds)
                with profiling.host_sync("render", "live_rays", 2):
                    live, rnd = live[more], nxt[more]
        return rgb_acc, opac, processed
