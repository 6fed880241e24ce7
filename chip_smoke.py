"""Chip smoke test of the PyTorch + CUDA port (ngp_tpu_torch) on one H100.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. print the card's name and power limit; build every kernel of the port
     from the sources in the checkout (one nvcc per csrc/*.cu, all started
     together, sm_90a) and print the registers, stack and spills ptxas
     reports for each instantiation of every kernel;
  2. hold each kernel against its plain PyTorch version on the card at the
     main paths' shapes (fused_mlp_fwd and fused_mlp_bwd on KERNEL_CASES,
     adam_ema on the base.json hash table, hash_encode_fwd and both entries
     of hash_encode_bwd on HASH_CASES), and time the kernel, the plain
     version, a library yardstick where one exists and the card's lower bound
     for the same work;
  3. serve at the full width of experiment/nerf_synthetic/config/base.json:
     a Testbed on the card with seeded weights and a procedural density grid
     renders 800x800 frames (Shade spp 1 from three ring poses, then Shade
     spp 4, Depth, and one spp-1 frame of each of Normals, AO, Distance,
     Stepsize and Cost), with every kernel launch counter zeroed just before
     and read just after; small Shade and Normals frames rendered on the card
     are held against the same frames rendered on the CPU through the plain
     versions;
  4. train at base.json width: the port writes a procedural scene under
     build/, a Testbed on the card loads it (load_training_data) and runs
     train(16, 2**18) TRAIN_CALLS times, with every counter zeroed just before
     and read just after (each kernel must have launched); one more call is
     profiled; a held-out view must beat PSNR_FLOOR; one train() call of a
     small config on the card and on the CPU, from the same state and draws,
     must give the same loss within TRAIN_REF_RTOL; then hash_encode_fwd and
     the stochastic hash_encode_bwd are held against their plain versions
     and timed on path-shaped positions: one network batch of an 800x800
     Shade frame and one train(1, 2**18) step's batch, both captured by
     wrapping the kernels' wrappers, with each set's distinct (level, row)
     pairs and bounds beside the uniform case's;
  5. print each kernel's time alone beside its device time per launch inside
     the profiled serve frame and train() call; print one {"kernels": [...]}
     line, one {"serve": {...}} line, one {"train": {...}} line, and as the
     last line {"ok": true, "device": {...}}.

Imports torch, numpy and ngp_tpu_torch only (never jax or ngp_tpu). Needs
neither PIL nor msgpack: the scene's PNGs go through ngp_tpu_torch/data/png.py
and no snapshot is saved.
"""

import dataclasses
import json
import math
import re
import subprocess
import sys
import time

import numpy as np
import torch

# kernel (N, dims) cases on the card: the render path's batch at default
# widths, a ragged N, deep narrow heads and the widest heads the kernel takes
KERNEL_CASES = [
    ("default 2^18", 1 << 18, 1, 2, 64),
    ("ragged 2^18+37", (1 << 18) + 37, 1, 2, 64),
    ("16-wide, 3 hidden", 1 << 18, 3, 3, 16),
    ("128-wide", 1 << 18, 1, 2, 128),
]
# bf16 operands: the kernel's fp32 sums run in another order than the plain
# version's, so a hidden activation can round to the neighbouring bf16 value
# (the tolerances of tests/test_fused_mlp.py)
RTOL, ATOL = 2e-2, 3e-2
# gradients: rtol and atol x the gradient's max (tests/test_fused_mlp.py:59)
BWD_RTOL, BWD_ATOL = 3e-2, 3e-2
# A ReLU unit whose fp32 pre-activation sits at zero can take the other mask
# when the sum runs in another order, and then its row's whole d_enc moves. On
# an H100 (PERF.md, row 2 of the kernel table) one row of the ragged case fell
# outside the tolerance above and d_enc's relative L2 error was at most 3.0e-4
# over the cases. So at most BWD_FLIP_ROWS rows of a case may fall outside it,
# and d_enc's relative L2 error must stay under BWD_ENC_REL: one warp's wrong
# 16-row tile fails both. The weight gradients, sums over all rows, must all
# lie within the tolerance.
BWD_FLIP_ROWS, BWD_ENC_REL = 4, 1e-3
# adam_ema repeats the plain version's IEEE operations one by one
ADAM_RTOL, ADAM_ATOL = 1e-6, 1e-12
ADAM_SHAPE = (16, 1 << 19, 2)  # the base.json hash table (L, T, F)
ADAM_VISITED = 0.04  # share of rows one step visits (tools/mb22_optfuse.py:108-110)
FRAME = (800, 800)
POSES = (0.3, 2.4, 4.5)
SMALL_FRAME = (64, 48)
BASE_JSON = "experiment/nerf_synthetic/config/base.json"
SCENE_DIR = "build/chip_smoke_scene"
SCENE = dict(n_train=16, n_test=2, width=200, height=200)
TRAIN_CALLS = 32  # train(16, TRAIN_BATCH) calls: 512 steps
TRAIN_BATCH = 1 << 18
PSNR_FLOOR = 24.0  # tests/test_end_to_end.py:65
# small config of the card-vs-CPU train() check (tests/test_end_to_end.py:19-27)
TINY = {
    "samlper": {"aabb_scale": 1, "grid_size": 32, "maximum_marching_steps": 256},
    "network": {
        "encoding": {"n_levels": 8, "log2_hashmap_size": 14, "base_resolution": 16, "desired_resolution": 256},
        "network": {"n_neurons": 64, "n_hidden_layers": 1},
        "dir_encoding": {"degree": 4},
        "rgb_network": {"n_neurons": 64, "n_hidden_layers": 2},
    },
}
TINY_SCENE = dict(n_train=8, n_test=1, width=64, height=64)
TRAIN_REF_RTOL = 1e-3
# hash-grid kernel cases on the card: (label, spec, N); "tiny" is TINY's
# encoding (8 levels, 2^14 rows, dense and hash levels)
HASH_CASES = [("base.json 2^18", "base", 1 << 18), ("base.json 2^18+37", "base", (1 << 18) + 37), ("TINY 2^16", "tiny", 1 << 16)]
# the forward differs from its plain version only in the order of the fp32
# 8-term sum: |out| <= 1 with the table in (-1, 1), so a few ulps of 1
HASH_FWD_ATOL = 1e-5
# the exact deposit sums w * g in another order (atomics): rtol and atol x
# the gradient's max
HASH_EXACT_RTOL, HASH_EXACT_ATOL = 1e-5, 1e-5
# fp32 operations per (sample, level), for the bound: the cell (3 fma, 6
# subtractions, clamps), then forward 8 x (2 + 2F), exact 8 x (2 + F),
# stochastic 3 hash rounds and F
HASH_CELL_OPS = 9
SERVE_MODES = ("Normals", "AO", "Distance", "Stepsize", "Cost")  # one spp-1 frame each, after Shade and Depth
SERVE_KERNELS = ("fused_mlp_fwd", "hash_encode_fwd")  # must launch while serving
TRAIN_KERNELS = ("fused_mlp_fwd", "fused_mlp_bwd", "adam_ema", "hash_encode_fwd", "hash_encode_bwd_stochastic")
# small-frame card vs CPU (phase_reference), max and mean abs on linear RGBA
# by mode: in Shade, bf16 flips in the MLP and fp32 ordering move a pixel by
# a few 1e-3. Normals differentiates the density head: a ReLU unit whose
# pre-activation sits at zero can take the other mask on the card, and the
# gradient (not only the value) of that sample then jumps by the unit's
# whole contribution, turning its normal. On an H100 (PERF.md, section 6) that
# moved one pixel of 3072 by 2.4e-2, with a mean of 6.9e-5.
REF_LIMITS = {"Shade": (2e-2, 1e-3), "Normals": (5e-2, 1e-3)}
# device kernels of each wrapper, for its time per launch inside a profiled
# run: (kernels whose launches count, kernels whose time counts); the
# backward's launch runs its fixed-order block reduction too
PROFILE_KERNELS = {
    "fused_mlp_fwd": (("fused_mlp_fwd_kernel",), ("fused_mlp_fwd_kernel",)),
    "fused_mlp_bwd": (("fused_mlp_bwd_kernel",), ("fused_mlp_bwd_kernel", "reduce_blocks_kernel")),
    "adam_ema": (("adam_ema_kernel",), ("adam_ema_kernel",)),
    "hash_encode_fwd": (("hash_encode_fwd_kernel",), ("hash_encode_fwd_kernel",)),
    "hash_encode_bwd": (("hash_bwd_stochastic_kernel", "hash_bwd_exact_kernel"),) * 2,
}
# (memory bytes/s, bf16 dense tensor FLOP/s, fp32 FLOP/s outside the tensor
# cores) by card, from NVIDIA's data sheets
PEAKS = {
    "H100 PCIe": (2.0e12, 756e12, 51e12),
    "H100 NVL": (3.9e12, 835e12, 60e12),
    "H100": (3.35e12, 989e12, 67e12),
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def peaks(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return val
    raise SystemExit(f"no peak rates known for {name!r}")


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean device time of fn() over reps launches, after a warm-up."""
    for _ in range(3):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def head_weights(gen, n_in, width, n_out, hidden):
    dims = [n_in] + [width] * hidden + [n_out]
    out = []
    for i in range(len(dims) - 1):
        b = math.sqrt(6.0 / (dims[i] + dims[i + 1]))
        out.append((torch.rand((dims[i], dims[i + 1]), generator=gen, device="cuda") * 2.0 - 1.0) * b)
    return out


def library_heads(enc, sh, dmats, rmats):
    """The yardstick: both heads as a torch.matmul bf16 chain (cuBLAS)."""
    h = enc.to(torch.bfloat16)
    for w in dmats[:-1]:
        h = torch.relu(h @ w)
    dens = h @ dmats[-1]
    r = torch.cat([dens, sh.to(torch.bfloat16)], dim=-1)
    for w in rmats[:-1]:
        r = torch.relu(r @ w)
    return r @ rmats[-1], dens


def phase_kernels(fm, bw, flops):
    """Kernel vs plain on the card; timings at the default-width batch."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    timing = None
    for label, n, dh, rh, width in KERNEL_CASES:
        dmlp = head_weights(gen, 32, width, 16, dh)
        rmlp = head_weights(gen, 32, width, 3, rh)
        fw = fm.pack_weights(dmlp, rmlp)
        enc = torch.randn((n, 32), generator=gen, device="cuda")
        sh = torch.randn((n, 16), generator=gen, device="cuda")
        k_rgb, k_dens = fm.fused_mlp_fwd_cuda(enc, sh, fw)
        torch.cuda.synchronize()
        p_rgb, p_dens = fm.fused_mlp_fwd_plain(enc, sh, fw)
        err = max((k_rgb - p_rgb).abs().max().item(), (k_dens - p_dens).abs().max().item())
        ok = torch.allclose(k_rgb, p_rgb, rtol=RTOL, atol=ATOL) and torch.allclose(k_dens, p_dens, rtol=RTOL, atol=ATOL)
        print(f"fused_mlp_fwd {label}: N={n} max_abs_err={err:.3e} (rtol {RTOL}, atol {ATOL}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"fused_mlp_fwd disagrees with its plain version ({label})")
        worst = max(worst, err)
        if timing is None:
            lib_d = [w.to(torch.bfloat16) for w in dmlp]
            lib_r = [w.to(torch.bfloat16) for w in rmlp]
            macs = sum(w.shape[0] * w.shape[1] for w in dmlp + rmlp)  # per row
            n_bytes = n * (32 + 16) * 4 + n * (3 + 16) * 4 + fw.packed.numel() * 2
            bound_ms = max(n_bytes / bw, 2.0 * macs * n / flops) * 1e3
            timing = {
                "ms": cuda_ms(lambda: fm.fused_mlp_fwd_cuda(enc, sh, fw)),
                "plain_ms": cuda_ms(lambda: fm.fused_mlp_fwd_plain(enc, sh, fw)),
                "library_ms": cuda_ms(lambda: library_heads(enc, sh, lib_d, lib_r)),
                "bound_ms": bound_ms,
                "bound_by": "bytes" if n_bytes / bw >= 2.0 * macs * n / flops else "operations",
                "macs_per_row": macs,
                "bytes": n_bytes,
            }
            print(f"fused_mlp_fwd timing at N={n}: {timing}")
    return worst, timing


def blob_density(cfg, seed: int) -> np.ndarray:
    """Procedural density grid (n_cascades * G^3,), linear x + G*y + G^2*z:
    a few Gaussian blobs inside the unit box in cascade 0."""
    g = cfg.grid_size
    rng = np.random.default_rng(seed)
    ax = ((np.arange(g) + 0.5) / g).astype(np.float32)
    z, y, x = np.meshgrid(ax, ax, ax, indexing="ij")
    dens = np.zeros((cfg.n_cascades, g, g, g), np.float32)
    for _ in range(6):
        c = rng.uniform(0.3, 0.7, 3).astype(np.float32)
        r2 = ((x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2) / np.float32(rng.uniform(0.006, 0.02))
        dens[0] += np.exp(-r2)
    return dens.reshape(-1)


def ring_pose(theta, radius=1.3, height=0.4):
    """OpenGL camera-to-world (3, 4) on a ring around the origin, looking at it."""
    pos = np.array([radius * np.cos(theta), radius * np.sin(theta), height])
    back = pos / np.linalg.norm(pos)
    right = np.cross([0.0, 0.0, 1.0], back)
    right /= np.linalg.norm(right)
    up = np.cross(back, right)
    return np.stack([right, up, back, pos], axis=1).astype(np.float32)


def make_testbed(Testbed, NGPModel, device: str):
    """Testbed at base.json's full width with weights drawn from a seeded CPU
    generator (so every device gets the same ones; the density channel is
    pushed up so rays turn opaque, as a trained scene's do) and the blob grid."""
    tb = Testbed(device=device)
    tb.load_model_config("experiment/nerf_synthetic/config/base.json")
    params = NGPModel(tb.config.network).init(torch.Generator().manual_seed(0)).params()
    params["density_mlp"][-1][:, 0] = params["density_mlp"][-1][:, 0].abs() * 4.0 + 0.5
    tb.set_state(params, blob_density(tb.config.sampler, 1))
    return tb


def render_timed(tb, w, h, spp, mode):
    tb.rendering_buffer.render_mode = mode
    torch.cuda.synchronize()
    t = time.perf_counter()
    img = tb.render(w, h, spp=spp, to_srgb=False)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    acc = tb._accum
    if not (np.isfinite(img).all() and torch.isfinite(acc).all()):
        raise SystemExit(f"{mode} spp {spp}: non-finite output")
    if img.shape != (h, w, 4):
        raise SystemExit(f"{mode}: image shape {img.shape}")
    opacity = float(acc[..., 3].mean())
    if not acc[..., 3].max() > 0.0:
        raise SystemExit(f"{mode} spp {spp}: zero opacity everywhere")
    return ms, opacity, tb._renderer.last_frame_samples


def phase_serve(Testbed, NGPModel):
    tb = make_testbed(Testbed, NGPModel, "cuda")
    w, h = FRAME
    tb.set_nerf_camera_matrix(ring_pose(POSES[0]))
    render_timed(tb, w, h, 1, "Shade")  # warm-up: allocator, cuBLAS, caches
    torch.cuda.reset_peak_memory_stats()

    zero_counters()  # every kernel counter, zeroed just before the main path
    frames = []
    for theta in POSES:
        tb.set_nerf_camera_matrix(ring_pose(theta))
        ms, opac, samples = render_timed(tb, w, h, 1, "Shade")
        frames.append({"mode": "Shade", "spp": 1, "theta": theta, "ms": ms, "mean_opacity": opac, "samples_last_pass": samples})
    for mode, spp in (("Shade", 4), ("Depth", 1)) + tuple((m, 1) for m in SERVE_MODES):
        ms, opac, samples = render_timed(tb, w, h, spp, mode)
        frames.append({"mode": mode, "spp": spp, "theta": POSES[-1], "ms": ms, "mean_opacity": opac, "samples_last_pass": samples})
    launches = counters()  # read just after
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"serve peak device memory {peak_gib:.2f} GiB; launches {launches}")
    for f in frames:
        print(f"serve {w}x{h} {f}")
    missing = [k for k in SERVE_KERNELS if launches[k] < 1]
    if missing:
        raise SystemExit(f"the serving path launched no {missing} kernel")
    n_passes = sum(f["spp"] for f in frames)
    return tb, frames, launches, n_passes, peak_gib


def phase_profile(tb, frame_ms: float):
    """Where an 800x800 Shade spp-1 frame's device time goes: kernel time by
    name over one profiled frame (torch.profiler), the device's idle share
    against the unprofiled frame time `frame_ms` of the same view, and the
    network's parts timed alone on one 2^18-sample batch."""
    from ngp_tpu_torch.ops.hash_encoding import hash_encode
    from ngp_tpu_torch.ops.sh_encoding import sh_encode

    w, h = FRAME
    tb.rendering_buffer.render_mode = "Shade"
    rows = device_profile(lambda: tb.render(w, h, spp=1, to_srgb=False))
    busy_ms = sum(r[1] for r in rows)
    print(f"profile {w}x{h} Shade spp 1: device busy {busy_ms:.1f} ms of an unprofiled {frame_ms:.1f} ms frame")
    for key, ms, count in rows[:12]:
        print(f"  {ms:9.2f} ms {count:6d}x  {key[:110]}")

    model = tb.model
    gen = torch.Generator(device="cuda").manual_seed(1)
    n = 1 << 18
    pos = torch.rand((n, 3), generator=gen, device="cuda")
    dirs = torch.rand((n, 3), generator=gen, device="cuda")
    batch = {
        "hash_encode_ms": cuda_ms(lambda: hash_encode(model.hash_table, pos, model.grid_spec)),
        "sh_encode_ms": cuda_ms(lambda: sh_encode(dirs, model.config.sh_degree)),
        "rgbsigma_raw_ms": cuda_ms(lambda: model.rgbsigma_raw(pos, dirs)),
    }
    print(f"network parts on one {n}-sample batch: {batch}")
    return {
        "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / frame_ms,
        "top_kernels": [[k[:80], ms, c] for k, ms, c in rows[:8]],
        "in_path": in_path(rows),
        "network_batch_2^18": batch,
    }


def phase_reference(Testbed, NGPModel):
    """Small Shade and Normals frames on the card (kernels) vs the same frames
    on the CPU (plain versions), same weights and grid."""
    w, h = SMALL_FRAME
    out = {}
    for mode, (max_abs, mean_abs) in REF_LIMITS.items():
        imgs = []
        for device in ("cuda", "cpu"):
            tb = make_testbed(Testbed, NGPModel, device)
            tb.rendering_buffer.render_mode = mode
            tb.set_nerf_camera_matrix(ring_pose(POSES[1]))
            tb.render(w, h, spp=1, to_srgb=False)
            imgs.append(tb._accum.cpu())
        err = (imgs[0] - imgs[1]).abs()
        print(f"reference {mode} {w}x{h}: card vs CPU max_abs={err.max().item():.3e} mean_abs={err.mean().item():.3e} "
              f"(limits {max_abs}, {mean_abs})")
        if err.max() > max_abs or err.mean() > mean_abs or imgs[1][..., 3].max() <= 0.0:
            raise SystemExit(f"the card's {mode} frame disagrees with the CPU reference")
        out[mode] = {"max_abs": err.max().item(), "mean_abs": err.mean().item()}
    return out


def counters() -> dict:
    """Launches of each kernel so far in this process."""
    from ngp_tpu_torch.ops import fused_mlp as fm
    from ngp_tpu_torch.ops import hash_encoding as he
    from ngp_tpu_torch.train import optimizer as opt

    return {
        "fused_mlp_fwd": fm.N_LAUNCHES, "fused_mlp_bwd": fm.N_LAUNCHES_BWD, "adam_ema": opt.N_LAUNCHES,
        "hash_encode_fwd": he.N_LAUNCHES_HASH_FWD, "hash_encode_bwd_stochastic": he.N_LAUNCHES_HASH_BWD_STOCHASTIC,
        "hash_encode_bwd_exact": he.N_LAUNCHES_HASH_BWD_EXACT,
    }


def zero_counters():
    from ngp_tpu_torch.ops import fused_mlp as fm
    from ngp_tpu_torch.ops import hash_encoding as he
    from ngp_tpu_torch.train import optimizer as opt

    fm.N_LAUNCHES = fm.N_LAUNCHES_BWD = opt.N_LAUNCHES = 0
    he.N_LAUNCHES_HASH_FWD = he.N_LAUNCHES_HASH_BWD_STOCHASTIC = he.N_LAUNCHES_HASH_BWD_EXACT = 0


def device_profile(fn):
    """Run fn() once under torch.profiler: [(kernel name, device ms, count)],
    busiest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [
        (e.key, e.self_device_time_total / 1e3, e.count)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]
    return sorted(rows, key=lambda r: -r[1])


def in_path(rows) -> dict:
    """Device ms per wrapper launch of each kernel of PROFILE_KERNELS inside a
    profiled run (rows from device_profile), with the launches seen."""
    def match(key, names):
        return any(re.search(rf"\b{k}\b", key) for k in names)

    out = {}
    for name, (counted, timed) in PROFILE_KERNELS.items():
        launches = sum(c for key, _, c in rows if match(key, counted))
        ms = sum(t for key, t, _ in rows if match(key, timed))
        out[name] = {"ms_per_launch": ms / launches if launches else None, "launches": launches, "ms": ms}
    return out


def ptxas_summary(log: str) -> dict:
    """{kernel<template args>: registers, stack and spill bytes} from nvcc's
    -Xptxas -v output (kernels.BUILD_LOGS)."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )(\w+)", line)
        if m:
            base = re.search(r"([a-z_]+_kernel)", m.group(1))
            args = re.findall(r"Li(\d+)E", m.group(1))
            cur = (base.group(1) if base else m.group(1)) + (f"<{','.join(args)}>" if args else "")
            out.setdefault(cur, {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur:
            out[cur].update(stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur]["registers"] = int(m.group(1))
    return out


def phase_backward_kernels(fm, bw, flops):
    """fused_mlp_bwd vs its plain version on KERNEL_CASES; timings at the
    training path's batch (2^18 rows, default widths)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    worst, timing = 0.0, None
    for label, n, dh, rh, width in KERNEL_CASES:
        dmlp = head_weights(gen, 32, width, 16, dh)
        rmlp = head_weights(gen, 32, width, 3, rh)
        fw = fm.pack_weights(dmlp, rmlp)
        args = [torch.randn((n, c), generator=gen, device="cuda") for c in (32, 16, 3, 16)]
        k_enc, k_w = fm.fused_mlp_bwd_cuda(*args, fw)
        torch.cuda.synchronize()
        p_enc, p_w = fm.fused_mlp_bwd_plain(*args, fw)
        err = max((k_enc - p_enc).abs().max().item(), (k_w - p_w).abs().max().item())
        w_ok = torch.allclose(k_w, p_w, rtol=BWD_RTOL, atol=BWD_ATOL * p_w.abs().max().item())
        off = ~torch.isclose(k_enc, p_enc, rtol=BWD_RTOL, atol=BWD_ATOL * p_enc.abs().max().item())
        off_rows = int(off.any(dim=1).sum())
        enc_rel = (k_enc - p_enc).norm().item() / p_enc.norm().item()
        rel = (k_w - p_w).norm().item() / p_w.norm().item()
        ok = w_ok and off_rows <= BWD_FLIP_ROWS and enc_rel < BWD_ENC_REL
        print(
            f"fused_mlp_bwd {label}: N={n} max_abs_err={err:.3e} weight grads within (rtol {BWD_RTOL}, "
            f"atol {BWD_ATOL} x max): {w_ok}, rel L2 {rel:.2e}; d_enc rows outside: {off_rows} "
            f"(limit {BWD_FLIP_ROWS}), rel L2 {enc_rel:.2e} (limit {BWD_ENC_REL}) {'ok' if ok else 'FAIL'}"
        )
        if not ok:
            raise SystemExit(f"fused_mlp_bwd disagrees with its plain version ({label})")
        if not torch.equal(fm.fused_mlp_bwd_cuda(*args, fw)[1], k_w):
            raise SystemExit(f"fused_mlp_bwd is not deterministic ({label})")
        if timing is None:
            worst_default = err
            lib_w = [w.to(torch.bfloat16).requires_grad_(True) for w in dmlp + rmlp]
            lib_enc = args[0].to(torch.bfloat16).requires_grad_(True)
            lib_rgb, lib_dens = library_heads(lib_enc, args[1], lib_w[: len(dmlp)], lib_w[len(dmlp) :])
            lib_g = (args[2].to(torch.bfloat16), args[3].to(torch.bfloat16))
            macs = 3 * sum(w.shape[0] * w.shape[1] for w in dmlp + rmlp)  # forward recompute + 2 backward products
            n_bytes = n * (32 + 16 + 3 + 16) * 4 + n * 32 * 4 + fw.packed.numel() * (2 + 4)
            t_bytes, t_ops = n_bytes / bw, 2.0 * macs * n / flops
            timing = {
                "ms": cuda_ms(lambda: fm.fused_mlp_bwd_cuda(*args, fw)),
                "plain_ms": cuda_ms(lambda: fm.fused_mlp_bwd_plain(*args, fw)),
                "library_ms": cuda_ms(
                    lambda: torch.autograd.grad((lib_rgb, lib_dens), [lib_enc, *lib_w], lib_g, retain_graph=True)
                ),
                "bound_ms": max(t_bytes, t_ops) * 1e3,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "macs_per_row": macs,
                "bytes": n_bytes,
                "max_abs_err_default": worst_default,
            }
            print(f"fused_mlp_bwd timing at N={n}: {timing}")
        worst = max(worst, err)
    return worst, timing


def phase_adam_kernel(opt, bw, fp32_flops):
    """adam_ema vs its plain version on the base.json hash table with ~4 % of
    its rows visited (lazy), and on a dense MLP-sized leaf with L2."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    L, T, F = ADAM_SHAPE
    g = torch.randn(ADAM_SHAPE, generator=gen, device="cuda") * 1e-2
    g *= (torch.rand((L, T, 1), generator=gen, device="cuda") < ADAM_VISITED).float()
    state = [torch.randn(ADAM_SHAPE, generator=gen, device="cuda") * s for s in (1e-3, 1e-4, 1e-2, 1e-2)]
    state[1] = state[1].abs()
    kw = dict(lr=1e-2, bc1=1 - 0.9**10, bc2=1 - 0.99**10, b1=0.9, b2=0.99, eps=1e-15, decay=0.95)
    worst = 0.0
    for label, lazy, l2, n in (("hash table, lazy", True, 0.0, g.numel()), ("dense + L2", False, 1e-6, 9408)):
        gg = g.reshape(-1)[:n]
        kern = [s.reshape(-1)[:n].clone() for s in state]
        plain = [s.reshape(-1)[:n].clone() for s in state]
        opt.adam_ema_cuda(gg, *kern, lazy=lazy, l2=l2, **kw)
        torch.cuda.synchronize()
        opt.adam_ema_plain(gg, *plain, lazy=lazy, l2=l2, **kw)
        err = max((a - b).abs().max().item() for a, b in zip(kern, plain, strict=True))
        ok = all(torch.allclose(a, b, rtol=ADAM_RTOL, atol=ADAM_ATOL) for a, b in zip(kern, plain, strict=True))
        print(f"adam_ema {label}: n={n} max_abs_err={err:.3e} (rtol {ADAM_RTOL}, atol {ADAM_ATOL}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"adam_ema disagrees with its plain version ({label})")
        worst = max(worst, err)
    n = g.numel()
    n_visited = int((g != 0).sum())
    # bytes this data needs: g and p read, e read and written everywhere (16 B);
    # m and v read, m, v and p written on the visited elements (20 B more)
    n_bytes = 16 * n + 20 * n_visited
    # fp32 operations: the EMA (3) everywhere, Adam and the lr step (14) on the
    # visited elements
    n_ops = 3 * n + 14 * n_visited
    t_bytes, t_ops = n_bytes / bw, n_ops / fp32_flops
    bufs = [s.clone() for s in state]
    timing = {
        "ms": cuda_ms(lambda: opt.adam_ema_cuda(g, *bufs, lazy=True, **kw)),
        "plain_ms": cuda_ms(lambda: opt.adam_ema_plain(g, *bufs, lazy=True, **kw)),
        "library_ms": None,  # no single PyTorch call computes lazy Adam + lr step + EMA
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "elements": n,
        "visited": n_visited,
        "bytes": n_bytes,
    }
    print(f"adam_ema timing at n={n}: {timing}")
    return worst, timing


def hash_spec(which: str):
    from ngp_tpu_torch.ops.hash_encoding import HashGridSpec
    from ngp_tpu_torch.utils.config import NGPConfig, load_commented_json

    doc = load_commented_json(BASE_JSON) if which == "base" else TINY
    return HashGridSpec.create(NGPConfig.from_json(doc).network.encoding)


def hash_positions(spec, n: int, seed: int) -> torch.Tensor:
    """(n, 3) on the card: uniform in [0, 1)^3, with 1/8 of the rows (up to
    4096) on a face of the box (one coordinate exactly 0.0 or 1.0) and as
    many on a cell face of a random level (pos * scale + 0.5 whole), where
    the dense levels clamp."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    m = min(n // 8, 4096)
    rows = np.arange(m)
    pos[rows, rng.integers(0, 3, m)] = rng.choice([0.0, 1.0], m)
    lv = rng.integers(0, spec.n_levels, m)
    scale = np.asarray(spec.scales)[lv]
    k = rng.integers(0, np.asarray(spec.resolutions)[lv] + 1)
    pos[m + rows, rng.integers(0, 3, m)] = np.clip((k - 0.5) / scale, 0.0, 1.0).astype(np.float32)
    return torch.from_numpy(pos).cuda()


def phase_hash_kernels(he, bw, fp32_flops):
    """hash_encode_fwd and both hash_encode_bwd entries vs their plain
    versions on HASH_CASES; timings at base.json's N = 2^18."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    worst = {"fwd": 0.0, "stochastic": 0.0, "exact": 0.0}
    timing = {}
    for ci, (label, which, n) in enumerate(HASH_CASES):
        spec = hash_spec(which)
        L, T, F = spec.n_levels, spec.padded_size, spec.n_features
        pos = hash_positions(spec, n, ci)
        table = torch.rand((L, T, F), generator=gen, device="cuda") * 2.0 - 1.0
        k_out = he.hash_encode_cuda(table, pos, spec)
        torch.cuda.synchronize()
        p_out = he.hash_encode_plain(table, pos, spec)
        err = (k_out - p_out).abs().max().item()
        ok = err <= HASH_FWD_ATOL
        print(f"hash_encode_fwd {label}: N={n} max_abs_err={err:.3e} (atol {HASH_FWD_ATOL}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"hash_encode_fwd disagrees with its plain version ({label})")
        worst["fwd"] = max(worst["fwd"], err)

        # stochastic: g of small integers x 2^-8, so every fp32 sum is exact in
        # any order and the kernel must equal the plain version bit for bit
        g_dy = torch.randint(-8, 9, (n, L * F), generator=gen, device="cuda").float() * 2.0**-8
        for rate in (2, 1):
            sp = dataclasses.replace(spec, stochastic_level_rate=rate)
            kd = he.hash_bwd_oadd_stochastic_cuda(pos, sp, g_dy)
            torch.cuda.synchronize()
            pd = he.hash_bwd_oadd_stochastic_plain(pos, sp, g_dy)
            same = torch.equal(kd, pd)
            err = (kd - pd).abs().max().item()
            print(f"hash_encode_bwd stochastic {label}: N={n} rate {rate} (kr {he.level_rate(sp, n)}) "
                  f"bit-equal: {same}, max_abs_err={err:.3e}, rows deposited {int((pd != 0).any(-1).sum())} {'ok' if same else 'FAIL'}")
            if not same:
                raise SystemExit(f"the stochastic hash_encode_bwd differs from its plain version ({label}, rate {rate})")
            worst["stochastic"] = max(worst["stochastic"], err)

        g = torch.randn((n, L * F), generator=gen, device="cuda")
        kd = he.hash_bwd_oadd_cuda(pos, spec, g)
        torch.cuda.synchronize()
        pd = he.hash_bwd_oadd_plain(pos, spec, g)
        err = (kd - pd).abs().max().item()
        atol = HASH_EXACT_ATOL * pd.abs().max().item()
        ok = torch.allclose(kd, pd, rtol=HASH_EXACT_RTOL, atol=atol)
        print(f"hash_encode_bwd exact {label}: N={n} max_abs_err={err:.3e} (rtol {HASH_EXACT_RTOL}, atol {HASH_EXACT_ATOL} "
              f"x max {pd.abs().max().item():.3e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"the exact hash_encode_bwd disagrees with its plain version ({label})")
        worst["exact"] = max(worst["exact"], err)

        if timing:
            continue
        work = hash_work(he, spec, pos)
        cases = {
            "fwd": (lambda: he.hash_encode_cuda(table, pos, spec), lambda: he.hash_encode_plain(table, pos, spec)),
            "stochastic": (lambda: he.hash_bwd_oadd_stochastic_cuda(pos, spec, g), lambda: he.hash_bwd_oadd_stochastic_plain(pos, spec, g)),
            "exact": (lambda: he.hash_bwd_oadd_cuda(pos, spec, g), lambda: he.hash_bwd_oadd_plain(pos, spec, g)),
        }
        for key, (kern, plain) in cases.items():
            timing[key] = {
                "ms": cuda_ms(kern),
                "plain_ms": cuda_ms(plain),
                "library_ms": None,  # no single PyTorch call computes the hash encoding or its deposits
                **bound(*work[key], bw, fp32_flops),
            }
        timing["fwd"]["distinct_rows"] = work["distinct_rows"]
        timing["stochastic"]["distinct_rows"] = work["distinct_deposit_rows"]
        timing["stochastic"]["level_rate"] = work["level_rate"]
        print(f"hash kernels timing at N={HASH_CASES[0][2]} (base.json, uniform positions): {timing}")
    return worst, timing


def bound(n_bytes, n_ops, bw, fp32_flops) -> dict:
    """The least time of the work: its bytes over the memory rate or its fp32
    operations over the fp32 rate, whichever is longer."""
    t_bytes, t_ops = n_bytes / bw, n_ops / fp32_flops
    return {"bound_ms": max(t_bytes, t_ops) * 1e3, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "fp32_ops": n_ops}


def hash_work(he, spec, pos) -> dict:
    """(bytes, fp32 operations) that the gather and the two deposits of
    `spec` need on these positions (each input read once, each output
    written once), and the distinct (level, row) pairs behind them: the
    gather reads each row its corners touch once; the stochastic deposit
    writes the whole (L, T_pad, F) gradient, whatever rows it adds into."""
    n = pos.shape[0]
    L, T, F = spec.n_levels, spec.padded_size, spec.n_features
    u_rows = torch.unique(he.corner_rows(pos, spec)).numel()
    kr = he.level_rate(spec, n)
    ones = torch.ones((n, L * F), device=pos.device)  # every deposit positive: its row is nonzero
    u_dep = int((he.hash_bwd_oadd_stochastic_plain(pos, spec, ones) != 0).any(-1).sum())
    grad_bytes = 4 * L * T * F
    return {
        "fwd": (12 * n + 4 * F * u_rows + 4 * L * F * n, (HASH_CELL_OPS + 8 * (2 + 2 * F)) * L * n),
        "stochastic": (12 * n + 4 * L * F * n // kr + grad_bytes, (HASH_CELL_OPS + 12 + F) * L * n // kr),
        "exact": (12 * n + 4 * L * F * n + grad_bytes, (HASH_CELL_OPS + 8 * (2 + F)) * L * n),
        "distinct_rows": u_rows,
        "distinct_deposit_rows": u_dep,
        "level_rate": kr,
    }


def capture_positions(he, name: str, n: int, run) -> list:
    """Clones of the positions of every call of the wrapper he.<name> with n
    rows while run() runs. The capture calls the wrapper it replaces, which
    launches and counts as before."""
    orig = getattr(he, name)
    seen = []

    def capture(*args):
        pos = args[1] if name.startswith("hash_encode") else args[0]  # (table, pos, spec) or (pos, spec, g)
        if pos.shape[0] == n:
            seen.append(pos.clone())
        return orig(*args)

    setattr(he, name, capture)
    try:
        run()
    finally:
        setattr(he, name, orig)
    return seen


def phase_path_hash(he, bw, fp32_flops, batches: dict, uniform: dict):
    """hash_encode_fwd and the stochastic hash_encode_bwd on the positions the
    main paths feed them (`batches`: label -> (N, 3) on the card, captured
    from a served frame and a training step): held against their plain
    versions as on HASH_CASES and timed, with each set's distinct rows and
    bounds printed beside the uniform case's (`uniform`, phase_hash_kernels'
    timing)."""
    spec = hash_spec("base")
    L, T, F = spec.n_levels, spec.padded_size, spec.n_features
    gen = torch.Generator(device="cuda").manual_seed(4)
    table = torch.rand((L, T, F), generator=gen, device="cuda") * 2.0 - 1.0
    worst = 0.0  # the gather's largest error (the deposit must be bit-equal)
    out = {key: {"uniform": {k: uniform[key][k] for k in ("ms", "bound_ms", "bound_by", "bytes", "fp32_ops", "distinct_rows")}}
           for key in ("fwd", "stochastic")}
    for label, pos in batches.items():
        n = pos.shape[0]
        err = (he.hash_encode_cuda(table, pos, spec) - he.hash_encode_plain(table, pos, spec)).abs().max().item()
        ok = err <= HASH_FWD_ATOL
        print(f"hash_encode_fwd {label}: N={n} max_abs_err={err:.3e} (atol {HASH_FWD_ATOL}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"hash_encode_fwd disagrees with its plain version ({label})")
        worst = max(worst, err)
        g = torch.randint(-8, 9, (n, L * F), generator=gen, device="cuda").float() * 2.0**-8  # exact sums
        for rate in (2, 1):
            sp = dataclasses.replace(spec, stochastic_level_rate=rate)
            same = torch.equal(he.hash_bwd_oadd_stochastic_cuda(pos, sp, g), he.hash_bwd_oadd_stochastic_plain(pos, sp, g))
            print(f"hash_encode_bwd stochastic {label}: N={n} rate {rate} bit-equal: {same} {'ok' if same else 'FAIL'}")
            if not same:
                raise SystemExit(f"the stochastic hash_encode_bwd differs from its plain version ({label}, rate {rate})")
        work = hash_work(he, spec, pos)
        runs = {"fwd": lambda: he.hash_encode_cuda(table, pos, spec),
                "stochastic": lambda: he.hash_bwd_oadd_stochastic_cuda(pos, spec, g)}
        rows = {"fwd": work["distinct_rows"], "stochastic": work["distinct_deposit_rows"]}
        for key, run in runs.items():
            out[key][label] = {"ms": cuda_ms(run), **bound(*work[key], bw, fp32_flops), "distinct_rows": rows[key]}
    for key, name in (("fwd", "hash_encode_fwd"), ("stochastic", "hash_encode_bwd stochastic")):
        for label, r in out[key].items():
            print(f"{name} on {label} positions: {r['distinct_rows']} distinct (level, row) pairs, {r['bytes'] / 1e6:.2f} MB, "
                  f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}), {r['ms']:.4f} ms alone")
    return worst, out


def psnr_view(tb, test_json, i, width, height):
    """PSNR of test view i rendered by tb (spp 2) against the port's ground
    truth rendered on the same device, in clipped sRGB (tests/test_end_to_end.py:60-64)."""
    from ngp_tpu_torch.data.synthetic import render_ground_truth
    from ngp_tpu_torch.utils.color import linear_to_srgb

    doc = json.loads(open(test_json).read())
    tb.rendering_buffer.fov_axis = 0
    tb.fov = doc["camera_angle_x"]
    pose = np.asarray(doc["frames"][i]["transform_matrix"], np.float32)[:3, :4]
    ref = render_ground_truth(pose, width, height, doc["camera_angle_x"], device=tb.device)
    tb.set_nerf_camera_matrix(pose)
    img = torch.from_numpy(tb.render(width, height, spp=2, to_srgb=False)).to(tb.device)
    if not torch.isfinite(img).all():
        raise SystemExit("the trained model renders non-finite values")
    a = torch.clamp(linear_to_srgb(img[..., :3]), 0, 1)
    r = torch.clamp(linear_to_srgb(ref[..., :3]), 0, 1)
    return float(-10.0 * torch.log10(torch.mean((a - r) ** 2)))


def phase_train(Testbed):
    """Train at base.json width on a procedural scene the port writes on the
    card, through load_training_data and train(16, 2**18)."""
    from ngp_tpu_torch.data.synthetic import write_synthetic_dataset

    t = time.perf_counter()
    train_json, test_json = write_synthetic_dataset(SCENE_DIR, **SCENE, device="cuda")
    scene_s = time.perf_counter() - t
    print(f"train scene {SCENE} written in {scene_s:.1f} s")
    tb = Testbed()
    tb.load_model_config(BASE_JSON)
    tb.load_training_data(train_json)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    zero_counters()  # just before the main path
    calls = []
    for _ in range(TRAIN_CALLS):
        t = time.perf_counter()
        tb.train(16, TRAIN_BATCH)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        b = tb.training_buffer
        calls.append({"ms": ms, "loss": b.loss, "n_rays_per_batch": b.n_rays_per_batch, "measured_batch_size": b.measured_batch_size,
                      "prep_ms": b.training_prep_ms, "steps_ms": b.training_ms})
    launches = counters()  # just after
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    n_steps = 16 * TRAIN_CALLS
    for i, c in enumerate(calls):
        print(f"train call {i}: {c}")
    missing = [k for k in TRAIN_KERNELS if launches[k] < 1]
    if missing:
        raise SystemExit(f"the training path launched no {missing} kernel")
    losses = [c["loss"] for c in calls]
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"non-finite training loss: {losses}")
    if not np.mean(losses[-4:]) < 0.5 * np.mean(losses[:2]):
        raise SystemExit(f"the training loss did not fall: {losses}")
    steady = calls[1:]
    total_ms = sum(c["ms"] for c in steady)
    samples = sum(16 * c["measured_batch_size"] for c in steady)

    # one more call under the profiler (not counted above)
    call_ms = total_ms / len(steady)
    rows = device_profile(lambda: tb.train(16, TRAIN_BATCH))
    busy_ms = sum(r[1] for r in rows)
    print(f"profile train(16, 2**18): device busy {busy_ms:.1f} ms of an unprofiled {call_ms:.1f} ms call")
    for key, ms, count in rows[:12]:
        print(f"  {ms:9.2f} ms {count:6d}x  {key[:110]}")

    w, h = SCENE["width"], SCENE["height"]
    psnr = psnr_view(tb, test_json, 0, w, h)
    print(f"held-out view 0 at {w}x{h}: PSNR {psnr:.2f} dB (floor {PSNR_FLOOR})")
    if not psnr > PSNR_FLOOR:
        raise SystemExit(f"held-out PSNR {psnr:.2f} dB is below the floor of {PSNR_FLOOR} dB")
    return tb, {
        "config": BASE_JSON,
        "scene": SCENE,
        "scene_write_s": scene_s,
        "calls": TRAIN_CALLS,
        "steps": n_steps,
        "ms_per_call_first": calls[0]["ms"],
        "ms_per_call": call_ms,
        "samples_per_s": samples / (total_ms / 1e3),
        "n_rays_per_batch": [c["n_rays_per_batch"] for c in calls],
        "measured_batch_size_last": calls[-1]["measured_batch_size"],
        "loss": losses,
        "launches": launches,
        "launches_per_step": {k: v / n_steps for k, v in launches.items()},
        "peak_memory_gib": peak_gib,
        "profile": {
            "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / call_ms,
            "top_kernels": [[k[:80], ms, c] for k, ms, c in rows[:10]],
            "in_path": in_path(rows),
        },
        "psnr_test_view_0": psnr,
    }


def phase_train_reference(Testbed, NGPModel):
    """One train(16, 2**14) call of the TINY config on the card (kernels) and
    on the CPU (plain versions), from the same weights, grid and draws."""
    from ngp_tpu_torch.data.synthetic import write_synthetic_dataset

    train_json, _ = write_synthetic_dataset(SCENE_DIR + "_tiny", **TINY_SCENE, device="cuda")
    out = {}
    for device in ("cuda", "cpu"):
        tb = Testbed(device=device)
        tb.load_model_config_dict(TINY)
        params = NGPModel(tb.config.network).init(torch.Generator().manual_seed(0)).params()
        tb.set_state(params, np.zeros(tb.config.sampler.n_total_elements, np.float32))
        tb._trainer.sample_capacity = 1 << 15
        tb.load_training_data(train_json)
        tb.train(16, 1 << 14)
        out[device] = (tb.training_buffer.loss, tb.training_buffer.n_rays_per_batch)
    rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    print(f"train reference (TINY, one train(16, 2**14) call): card loss {out['cuda'][0]:.6e}, "
          f"CPU loss {out['cpu'][0]:.6e}, relative difference {rel:.2e} (limit {TRAIN_REF_RTOL})")
    if not rel < TRAIN_REF_RTOL:
        raise SystemExit("the card's train() loss disagrees with the CPU reference")
    return {"card_loss": out["cuda"][0], "cpu_loss": out["cpu"][0], "relative_difference": rel,
            "n_rays_per_batch": [out["cuda"][1], out["cpu"][1]]}


def kernel_entry(name, source, replaces, launches, max_err, timing):
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": max_err,
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
    }


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from ngp_tpu_torch import Testbed
    from ngp_tpu_torch.models.ngp import NGPModel
    from ngp_tpu_torch.ops import fused_mlp as fm
    from ngp_tpu_torch.ops import hash_encoding as he
    from ngp_tpu_torch.ops import kernels as kb
    from ngp_tpu_torch.ops.mlp import exact_fp32_matmul
    from ngp_tpu_torch.render.renderer import EVAL_BATCH
    from ngp_tpu_torch.train import optimizer as opt

    exact_fp32_matmul()
    t_start = time.perf_counter()
    card = card_line()
    print(card)
    name = torch.cuda.get_device_name(0)
    bw, flops, fp32_flops = peaks(name)

    # phase 1: build every kernel source, one nvcc each, all started together
    t = time.perf_counter()
    libs = kb.build_all()
    print(f"built {sorted(str(p) for p in libs.values())} in {time.perf_counter() - t:.1f} s")
    for src, log in kb.BUILD_LOGS.items():
        print(f"--- {src}.cu\n{log.strip()}")
    ptxas = {src: ptxas_summary(log) for src, log in kb.BUILD_LOGS.items()}
    for src in kb.SOURCES:
        for inst, info in ptxas.get(src, {}).items():
            print(f"ptxas {inst}: {info.get('registers')} registers, {info.get('stack')} B stack, "
                  f"{info.get('spill_stores')} B spill stores, {info.get('spill_loads')} B spill loads")

    # phase 2: kernels vs plain versions
    fwd_err, fwd_timing = phase_kernels(fm, bw, flops)
    bwd_err, bwd_timing = phase_backward_kernels(fm, bw, flops)
    adam_err, adam_timing = phase_adam_kernel(opt, bw, fp32_flops)
    hash_err, hash_timing = phase_hash_kernels(he, bw, fp32_flops)
    print(f"kernel phases done; total {time.perf_counter() - t_start:.1f} s")

    # phase 3: serve
    t = time.perf_counter()
    tb, frames, serve_launches, n_passes, peak_gib = phase_serve(Testbed, NGPModel)
    profile = phase_profile(tb, frames[len(POSES) - 1]["ms"])
    # the positions of one network batch of an 800x800 Shade frame (the
    # profiled view), for the path-shaped hash timing of phase 4
    w, h = FRAME
    frame_batches = capture_positions(he, "hash_encode_cuda", EVAL_BATCH, lambda: tb.render(w, h, spp=1, to_srgb=False))
    print(f"captured {len(frame_batches)} network batches of {EVAL_BATCH} samples from one {w}x{h} Shade frame")
    del tb
    reference = phase_reference(Testbed, NGPModel)
    print(f"serve phase {time.perf_counter() - t:.1f} s; total {time.perf_counter() - t_start:.1f} s")

    # phase 4: train
    t = time.perf_counter()
    train_tb, train = phase_train(Testbed)
    # the positions of one train(1, 2**18) step's batch (the deposit's N)
    train_batches = capture_positions(he, "hash_bwd_oadd_stochastic_cuda", TRAIN_BATCH, lambda: train_tb.train(1, TRAIN_BATCH))
    del train_tb
    train["reference"] = phase_train_reference(Testbed, NGPModel)
    train["card"] = card
    path_fwd_err, path_hash = phase_path_hash(
        he, bw, fp32_flops, {"frame_batch": frame_batches[len(frame_batches) // 2], "train_batch": train_batches[0]}, hash_timing
    )
    del frame_batches, train_batches
    print(f"train phase {time.perf_counter() - t:.1f} s; total {time.perf_counter() - t_start:.1f} s")

    # phase 5: results; `launches` counts the training path (the last
    # slice's main path), launches_by_path each path's own run
    tl = train["launches"]

    def by_path(*names):
        return {"serve": sum(serve_launches[k] for k in names), "train": sum(tl[k] for k in names)}

    fwd = kernel_entry("fused_mlp_fwd", "ngp_tpu_torch/csrc/fused_mlp_fwd.cu", "ngp_tpu/ops/fused_mlp.py:91",
                       tl["fused_mlp_fwd"], fwd_err, fwd_timing)
    bwd = kernel_entry("fused_mlp_bwd", "ngp_tpu_torch/csrc/fused_mlp_bwd.cu", "ngp_tpu/ops/fused_mlp.py:107",
                       tl["fused_mlp_bwd"], bwd_err, bwd_timing)
    adam = kernel_entry("adam_ema", "ngp_tpu_torch/csrc/adam_ema.cu", "tools/mb22_optfuse.py:56",
                        tl["adam_ema"], adam_err, adam_timing)
    hfwd = kernel_entry(
        "hash_encode_fwd", "ngp_tpu_torch/csrc/hash_encode_fwd.cu",
        "tools/microbench.py:29; tools/microbench.py:54; tools/microbench.py:94; tools/microbench.py:123; "
        "tools/microbench.py:428; tools/mb23_mosaic_gather.py:53; tools/mb23_mosaic_gather.py:77; "
        "tools/mb23_mosaic_gather.py:114",
        tl["hash_encode_fwd"], max(hash_err["fwd"], path_fwd_err), hash_timing["fwd"],
    )
    bwd_names = ("hash_encode_bwd_stochastic", "hash_encode_bwd_exact")
    hbwd = kernel_entry(
        "hash_encode_bwd", "ngp_tpu_torch/csrc/hash_encode_bwd.cu", "tools/microbench.py:252; tools/microbench.py:299",
        sum(tl[k] for k in bwd_names), hash_err["stochastic"], hash_timing["stochastic"],
    )
    ex = hash_timing["exact"]
    hfwd["path_shaped"] = path_hash["fwd"]
    hbwd["path_shaped"] = path_hash["stochastic"]
    hbwd["exact"] = {"ms": ex["ms"], "plain_ms": ex["plain_ms"], "bound_ms": ex["bound_ms"], "bound_by": ex["bound_by"],
                     "library_ms": None, "max_abs_err": hash_err["exact"]}
    fwd["launches_by_path"] = by_path("fused_mlp_fwd")
    bwd["launches_by_path"] = by_path("fused_mlp_bwd")
    adam["launches_by_path"] = by_path("adam_ema")
    hfwd["launches_by_path"] = by_path("hash_encode_fwd")
    hbwd["launches_by_path"] = {**by_path(*bwd_names), "train_stochastic": tl[bwd_names[0]], "train_exact": tl[bwd_names[1]]}
    kernels = [fwd, bwd, adam, hfwd, hbwd]
    for k in kernels:
        k["ms_in_frame"] = profile["in_path"][k["name"]]["ms_per_launch"]
        k["ms_in_step"] = train["profile"]["in_path"][k["name"]]["ms_per_launch"]
    fwd["ptxas"] = ptxas.get("fused_mlp_fwd", {})
    bwd["ptxas"] = ptxas.get("fused_mlp_bwd", {})
    for k in kernels:
        print(f"{k['name']}: {k['ms']:.4f} ms alone, {k['ms_in_frame']} ms a launch in the profiled frame, "
              f"{k['ms_in_step']} ms a launch in the profiled train() call (bound {k['bound_ms']:.4f} ms)")
    shade1 = [f for f in frames if f["mode"] == "Shade" and f["spp"] == 1]
    serve = {
        "frame": list(FRAME),
        "config": BASE_JSON,
        "shade_spp1_ms_per_frame": sum(f["ms"] for f in shade1) / len(shade1),
        "shade_spp1_samples_per_frame": sum(f["samples_last_pass"] for f in shade1) / len(shade1),
        "frames": frames,
        "passes": n_passes,
        "launches": serve_launches,
        "launches_per_pass": {k: v / n_passes for k, v in serve_launches.items()},
        "peak_memory_gib": peak_gib,
        "profile": profile,
        "reference": reference,
        "card": card,
    }
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"serve": serve}))
    print(json.dumps({"train": train}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
