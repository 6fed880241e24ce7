"""The tests' reference for the spp-1 pass on a constant-dt lattice: the
coarse pass and the segment plan once a frame (coarse_segment_mask,
segment_plan), then march_round over each ray's kept segments, a round's
samples compacted on the host and composited through
Renderer._composite_round. The tests hold render/march.py's FrameMarch
(over render_march_plain on the CPU, over the kernel on the card) against
it: frames, samples and points bit for bit, and every round's samples.
Not a test module: it imports torch and ngp_tpu_torch only, so the card
tests (run with --noconftest) import it too."""

import torch

from ngp_tpu_torch.grid.occupancy import packed_neighborhood, pooled_occupancy
from ngp_tpu_torch.render.march import Round, frame_geometry
from ngp_tpu_torch.render.renderer import march_round, ray_start, segment_plan
from ngp_tpu_torch.sampling.lattice import (
    CHUNK,
    SEG,
    coarse_segment_mask,
    n_lattice_points,
    packed_march_supported,
    window_start_inside,
)
from ngp_tpu_torch.utils.aabb import AABB
from ngp_tpu_torch.utils.fma import fma
from ngp_tpu_torch.utils.qmc import ld_random_val


@torch.no_grad()
def planned_pass(renderer, occupancy, occ_aabb, o, d, cam, spp: int, render_mode: str = "Shade", share=slice(None)):
    """Renderer.render_rays' spp-1 pass (scene_scale 1, no envmap, no merge)
    of rays o, d (N, 3) through the planned march; with `share` the rays
    meeting the occupied box are cut to that slice before the coarse pass,
    as a rank's share. -> (out (N, 4), network samples, lattice points
    tested: the frame's coarse midpoints and 128 a marched ray a round)."""
    r = renderer
    scfg = r.config.sampler
    dev = o.device
    aabb = AABB.scene(scfg.aabb_scale)
    thresh = r.config.render.transmittance_threshold
    n = o.shape[0]
    n_rounds = n_lattice_points(scfg) // CHUNK
    r.model.prepare_inference()
    t0, alive = ray_start(aabb, o, d)
    seed = (torch.arange(n, dtype=torch.int64, device=dev) * 786433) & 0xFFFFFFFF
    startt = fma(ld_random_val(spp, seed), scfg.min_cone_stepsize, t0)
    rgb_acc = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    opac = torch.zeros((n,), dtype=torch.float32, device=dev)
    trans = torch.ones((n,), dtype=torch.float32, device=dev)
    processed = torch.zeros((n,), dtype=torch.int64, device=dev)
    hit, k0, span = frame_geometry(scfg, o, d, occ_aabb)
    start_in = window_start_inside(scfg, aabb, o, d, startt, torch.zeros_like(k0))
    ids = torch.nonzero(hit & alive & start_in).squeeze(1)
    samples = points = 0
    if ids.numel():
        # rounds aligned at ordinal 0: the window starts at k0 rounded down to a whole segment
        w0 = k0[ids] - k0[ids] % SEG
        n_seg = int(torch.clamp(torch.ceil((k0[ids] - w0 + span[ids]).max() / SEG), min=1))
        points += ids.numel() * n_seg
        ids, w0 = ids[share], w0[share]
        keep = coarse_segment_mask(scfg, pooled_occupancy(scfg, occupancy), o[ids], d[ids], t0[ids], n_seg, w0)
        plan = segment_plan(keep, w0, w0 // SEG, n_rounds)
        cull = plan.nxt[:, 0] < n_rounds
        ids, plan = ids[cull], plan.rows(cull)
        live, rnd = torch.arange(ids.numel(), device=dev), plan.nxt[:, 0]
        packed = packed_neighborhood(scfg, occupancy) if packed_march_supported(scfg) else None
        dirs_w = (d + 1.0) * 0.5
        taken = torch.zeros((n,), dtype=torch.int64, device=dev)
        while ids.numel():
            mask, _, pos, _, exited = march_round(
                scfg, aabb, occupancy, packed, plan, live, rnd, o[ids], d[ids], startt[ids], taken[ids]
            )
            points += mask.numel()
            rows, cols = torch.nonzero(mask, as_tuple=True)
            samples += rows.numel()
            marched = Round(ids, mask, rows * CHUNK + cols, pos[rows, cols], dirs_w[ids[rows]])
            r._composite_round((rgb_acc, opac, trans, processed), marched, cam, render_mode, 1.0)
            tk = taken[ids] + mask.sum(dim=1)
            taken[ids] = tk
            nxt = plan.nxt[live, rnd + 1]
            more = (trans[ids] >= thresh) & (tk < scfg.maximum_marching_steps) & ~exited & (nxt < n_rounds)
            ids, live, rnd = ids[more], live[more], nxt[more]
    return r._shade(rgb_acc, opac, processed, render_mode), samples, points
