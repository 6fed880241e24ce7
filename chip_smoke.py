"""Chip smoke test of the PyTorch + CUDA port (ngp_tpu_torch) on one H100.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. print the card's name and power limit; build every kernel of the
     serving path from the sources in the checkout (nvcc, sm_90a);
  2. hold each kernel against its plain PyTorch version on the card at the
     render path's shapes, and time the kernel, the plain version, a library
     yardstick and the card's lower bound for the same work;
  3. serve at the full width of experiment/nerf_synthetic/config/base.json:
     a Testbed on the card with seeded weights and a procedural density grid
     renders 800x800 frames (Shade spp 1 from three ring poses, then Shade
     spp 4 and Depth spp 1), with every kernel launch counter zeroed just
     before and read just after; a small frame rendered on the card is held
     against the same frame rendered on the CPU through the plain versions;
  4. print one {"kernels": [...]} line, one {"serve": {...}} line, and as the
     last line {"ok": true, "device": {...}}.

Imports torch, numpy and ngp_tpu_torch only (never jax or ngp_tpu).
"""

import json
import math
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
FRAME = (800, 800)
POSES = (0.3, 2.4, 4.5)
SMALL_FRAME = (64, 48)
# (memory bytes/s, bf16 dense tensor FLOP/s) by card, from NVIDIA's data sheets
PEAKS = {"H100 PCIe": (2.0e12, 756e12), "H100 NVL": (3.9e12, 835e12), "H100": (3.35e12, 989e12)}


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


def phase_serve(fm, Testbed, NGPModel):
    tb = make_testbed(Testbed, NGPModel, "cuda")
    w, h = FRAME
    tb.set_nerf_camera_matrix(ring_pose(POSES[0]))
    render_timed(tb, w, h, 1, "Shade")  # warm-up: allocator, cuBLAS, caches
    torch.cuda.reset_peak_memory_stats()

    fm.N_LAUNCHES = 0  # every kernel counter, zeroed just before the main path
    frames = []
    for theta in POSES:
        tb.set_nerf_camera_matrix(ring_pose(theta))
        ms, opac, samples = render_timed(tb, w, h, 1, "Shade")
        frames.append({"mode": "Shade", "spp": 1, "theta": theta, "ms": ms, "mean_opacity": opac, "samples_last_pass": samples})
    ms, opac, samples = render_timed(tb, w, h, 4, "Shade")
    frames.append({"mode": "Shade", "spp": 4, "theta": POSES[-1], "ms": ms, "mean_opacity": opac, "samples_last_pass": samples})
    ms, opac, samples = render_timed(tb, w, h, 1, "Depth")
    frames.append({"mode": "Depth", "spp": 1, "theta": POSES[-1], "ms": ms, "mean_opacity": opac, "samples_last_pass": samples})
    launches = fm.N_LAUNCHES  # read just after
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"serve peak device memory {peak_gib:.2f} GiB")
    for f in frames:
        print(f"serve {w}x{h} {f}")
    if launches < 1:
        raise SystemExit("the serving path launched no fused_mlp_fwd kernel")
    n_passes = sum(f["spp"] for f in frames)
    return tb, frames, launches, n_passes, peak_gib


def phase_profile(tb, frame_ms: float):
    """Where an 800x800 Shade spp-1 frame's device time goes: kernel time by
    name over one profiled frame (torch.profiler), the device's idle share
    against the unprofiled frame time `frame_ms` of the same view, and the
    network's parts timed alone on one 2^18-sample batch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ngp_tpu_torch.ops.hash_encoding import hash_encode
    from ngp_tpu_torch.ops.sh_encoding import sh_encode

    w, h = FRAME
    tb.rendering_buffer.render_mode = "Shade"
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tb.render(w, h, spp=1, to_srgb=False)
        torch.cuda.synchronize()
    rows = [
        (e.key, e.self_device_time_total / 1e3, e.count)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]
    rows.sort(key=lambda r: -r[1])
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
        "network_batch_2^18": batch,
    }


def phase_reference(Testbed, NGPModel):
    """A small frame on the card (kernel) vs the same frame on the CPU (plain
    versions), same weights and grid."""
    w, h = SMALL_FRAME
    imgs = []
    for device in ("cuda", "cpu"):
        tb = make_testbed(Testbed, NGPModel, device)
        tb.set_nerf_camera_matrix(ring_pose(POSES[1]))
        tb.render(w, h, spp=1, to_srgb=False)
        imgs.append(tb._accum.cpu())
    err = (imgs[0] - imgs[1]).abs()
    print(f"reference {w}x{h}: card vs CPU max_abs={err.max().item():.3e} mean_abs={err.mean().item():.3e}")
    # bf16 flips in the MLP and fp32 ordering move a pixel by a few 1e-3
    if err.max() > 2e-2 or err.mean() > 1e-3 or imgs[1][..., 3].max() <= 0.0:
        raise SystemExit("the card's frame disagrees with the CPU reference")
    return err.max().item(), err.mean().item()


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from ngp_tpu_torch import Testbed
    from ngp_tpu_torch.models.ngp import NGPModel
    from ngp_tpu_torch.ops import fused_mlp as fm
    from ngp_tpu_torch.ops.mlp import exact_fp32_matmul

    exact_fp32_matmul()
    t_start = time.perf_counter()
    card = card_line()
    print(card)
    name = torch.cuda.get_device_name(0)
    bw, flops = peaks(name)

    # phase 1: build (one nvcc per kernel source; the port has one)
    t = time.perf_counter()
    so = fm.build()
    print(f"built {so} in {time.perf_counter() - t:.1f} s")
    print(fm.BUILD_LOG.strip())

    # phase 2: kernels vs plain versions
    max_err, timing = phase_kernels(fm, bw, flops)

    # phase 3: serve
    t = time.perf_counter()
    tb, frames, launches, n_passes, peak_gib = phase_serve(fm, Testbed, NGPModel)
    profile = phase_profile(tb, frames[len(POSES) - 1]["ms"])
    del tb
    ref_max, ref_mean = phase_reference(Testbed, NGPModel)
    print(f"serve phase {time.perf_counter() - t:.1f} s; total {time.perf_counter() - t_start:.1f} s")

    # phase 4: results
    kernels = [{
        "name": "fused_mlp_fwd",
        "route": "cuda",
        "source": "ngp_tpu_torch/csrc/fused_mlp_fwd.cu",
        "replaces": "ngp_tpu/ops/fused_mlp.py:91",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
    }]
    shade1 = [f for f in frames if f["mode"] == "Shade" and f["spp"] == 1]
    serve = {
        "frame": list(FRAME),
        "config": "experiment/nerf_synthetic/config/base.json",
        "shade_spp1_ms_per_frame": sum(f["ms"] for f in shade1) / len(shade1),
        "shade_spp1_samples_per_frame": sum(f["samples_last_pass"] for f in shade1) / len(shade1),
        "frames": frames,
        "passes": n_passes,
        "launches_per_pass": launches / n_passes,
        "peak_memory_gib": peak_gib,
        "profile": profile,
        "reference_max_abs": ref_max,
        "reference_mean_abs": ref_mean,
        "card": card,
    }
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"serve": serve}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
