"""The tests' references for the renderer's marches on a constant-dt
lattice: the coarse pass and the segment plan once a frame
(coarse_segment_mask, segment_plan, the cull of rays with no kept segment),
then march_round over each ray's kept segments, a round's rows compacted on
the host. planned_pass is the spp-1 pass, composited through
Renderer._composite_round; the tests hold render/march.py's FrameMarch (over
render_march_plain on the CPU, over the kernel on the card) against it.
planned_shared is the spp-n Shade frame with one shared evaluation a cover
point (the renderer's round loop before march.py's CoverMarch took its
march: march_round(lookahead=1, jitter_cover=True), the lerp partners, the
rows to evaluate with the carried point, the shared composite); the tests
hold CoverMarch (over render_cover_march_plain on the CPU, over the kernel
on the card) against it. Frames, samples and points bit for bit. Not a test
module: it imports torch and ngp_tpu_torch only, so the card tests (run with
--noconftest) import it too."""

import torch

from ngp_tpu_torch.grid.occupancy import packed_neighborhood, pooled_occupancy
from ngp_tpu_torch.render.march import RANGE_SEGS, SHARE_ROUND, Round, frame_geometry, march_round, segment_plan
from ngp_tpu_torch.render.renderer import SPP_BLOCK_SLOTS, composite_weights, ray_start
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


@torch.no_grad()
def planned_shared(renderer, occupancy, occ_aabb, o, d, spp: int, n_spp: int, share=slice(None), cull_first=False,
                   block=None, stats=None):
    """Renderer.render_rays' spp-n Shade frame with shared evaluations
    (scene_scale 1, no envmap, no merge, accum_space linear) of rays o, d
    (N, 3) through the planned cover march; with `share` the hit rays are cut
    to that slice before the coarse pass, as a rank's share (the whole
    frame's coarse midpoints counted all the same). The frame's rays go in
    blocks of `block` (SPP_BLOCK_SLOTS' share, by default), each cut from the
    hit rays as the renderer cuts them, or with `cull_first` from the rays
    the cull keeps: then a block's live lists, and on the card the bits of
    its batched products, differ wherever the cull drops rays of a frame of
    more than one block. -> (out (N, 4), network samples, lattice points
    tested: the frame's coarse midpoints and 136 a marched ray a round); a
    dict `stats` gets the share's hit rays, the rays the cull keeps and the
    block's rays (`hit`, `kept`, `block`)."""
    r = renderer
    scfg = r.config.sampler
    dev = o.device
    aabb = AABB.scene(scfg.aabb_scale)
    dt = scfg.min_cone_stepsize
    thresh = r.config.render.transmittance_threshold
    n = o.shape[0]
    r.model.prepare_inference()
    hit, k0, span = frame_geometry(scfg, o, d, occ_aabb)
    t0, alive = ray_start(aabb, o, d)
    _, tmax = aabb.ray_intersect(o, d)
    start_in = window_start_inside(scfg, aabb, o, d, t0, k0, jitter_cover=True)
    ids = torch.nonzero(hit & alive & start_in).squeeze(1)
    rgb_acc = torch.zeros((n, n_spp, 3), dtype=torch.float32, device=dev)
    opac = torch.zeros((n, n_spp), dtype=torch.float32, device=dev)
    samples = points = 0
    if ids.numel():
        limit = torch.ceil(span[ids] / CHUNK).to(torch.int64)
        n_rounds = int(limit.max())
        n_seg = RANGE_SEGS * n_rounds + 1
        points += ids.numel() * n_seg
        ids, limit = ids[share], limit[share]
        keep = coarse_segment_mask(scfg, pooled_occupancy(scfg, occupancy), o[ids], d[ids], t0[ids], n_seg, k0[ids])
        plan = segment_plan(keep, k0[ids], torch.zeros_like(limit), n_rounds, limit)
        cull = plan.nxt[:, 0] < n_rounds
        seed = (ids * 786433) & 0xFFFFFFFF
        u_all = torch.stack([ld_random_val(spp + s, seed) for s in range(n_spp)], dim=-1)
        packed = packed_neighborhood(scfg, occupancy)
        block = block or max(1, SPP_BLOCK_SLOTS // (n_spp * CHUNK))
        if stats is not None:
            stats.update(hit=ids.numel(), kept=int(cull.sum()), block=block)
        if cull_first:
            ids, plan, u_all, cull = ids[cull], plan.rows(cull), u_all[cull], cull[cull]
        for b0 in range(0, ids.numel(), block):
            kept = cull[b0 : b0 + block]
            rays = ids[b0 : b0 + block][kept]
            bplan, u = plan.rows(slice(b0, b0 + block)).rows(kept), u_all[b0 : b0 + block][kept]
            R, P = u.shape
            dirs_w = (d[rays] + 1.0) * 0.5
            trans = torch.ones((R, P), dtype=torch.float32, device=dev)
            acc = torch.zeros((R, P, 3), dtype=torch.float32, device=dev)
            op = torch.zeros((R, P), dtype=torch.float32, device=dev)
            taken = torch.zeros((R,), dtype=torch.int64, device=dev)
            carried = torch.zeros((R,), dtype=torch.bool, device=dev)
            carry_sig = torch.zeros((R,), dtype=torch.float32, device=dev)
            carry_rgb = torch.zeros((R, 3), dtype=torch.float32, device=dev)
            live, rnd = torch.arange(R, device=dev), bplan.nxt[:, 0]
            while live.numel():
                ray = rays[live]
                mask, t, pos, _, exited = march_round(
                    scfg, aabb, occupancy, packed, bplan, live, rnd, o[ray], d[ray], t0[ray], taken[live], lookahead=1,
                    jitter_cover=True,
                )
                points += mask.numel()
                m, m_next = mask[:, :CHUNK], mask[:, CHUNK]
                mi = m.to(torch.int64)
                q = taken[live][:, None] + torch.cumsum(mi, dim=1) - mi
                adj = torch.cat([m[:, 1:], m_next[:, None]], dim=1) & ((q + 1) % SHARE_ROUND != 0)
                ev = torch.cat([m, m[:, -1:] & adj[:, -1:]], dim=1)
                c_in = carried[live]
                ev[:, 0] &= ~c_in
                rows, cols = torch.nonzero(ev, as_tuple=True)
                samples += rows.numel()
                sig = torch.zeros(ev.shape, dtype=torch.float32, device=dev)
                rgb = torch.zeros(ev.shape + (3,), dtype=torch.float32, device=dev)
                if rows.numel():
                    sig[rows, cols], rgb[rows, cols] = r._evaluate(aabb.relative_pos(pos[rows, cols]), dirs_w[live[rows]])
                sig[:, 0] = torch.where(c_in, carry_sig[live], sig[:, 0])
                rgb[:, 0] = torch.where(c_in[:, None], carry_rgb[live], rgb[:, 0])
                carried[live] = ev[:, CHUNK]
                carry_sig[live], carry_rgb[live] = sig[:, CHUNK], rgb[:, CHUNK]
                s0, c0 = sig[:, :CHUNK], rgb[:, :CHUNK]
                s1 = torch.where(adj, sig[:, 1:], s0)
                c1 = torch.where(adj[..., None], rgb[:, 1:], c0)
                ul = u[live][:, :, None]
                sig_p = s0[:, None, :] * (1.0 - ul) + s1[:, None, :] * ul
                valid = m[:, None, :] & (fma(ul, dt, t[:, None, :CHUNK]) <= tmax[ray][:, None, None])
                _, _, wgt, tr = composite_weights(valid, torch.where(valid, sig_p * dt, 0.0), trans[live], thresh)
                acc[live] += (1.0 - ul) * torch.bmm(wgt, c0) + ul * torch.bmm(wgt, c1)
                op[live] += wgt.sum(dim=2)
                trans[live] = tr
                tk = taken[live] + mi.sum(dim=1)
                taken[live] = tk
                nxt = bplan.nxt[live, rnd + 1]
                more = ~exited & (tr >= thresh).any(dim=1) & (tk < scfg.maximum_marching_steps) & (nxt < n_rounds)
                live, rnd = live[more], nxt[more]
            rgb_acc[rays], opac[rays] = acc, op
    processed = torch.zeros((n, n_spp), dtype=torch.int64, device=dev)
    return r._shade(rgb_acc, opac, processed, "Shade").mean(dim=1), samples, points
