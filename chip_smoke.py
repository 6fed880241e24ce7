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
     adam_ema on the base.json hash table and, bit for bit, on the envmap's
     dense 256x256x4 leaf with its bound, hash_encode_fwd and both entries
     of hash_encode_bwd on HASH_CASES), and time the kernel, the plain
     version, a library yardstick where one exists and the card's lower bound
     for the same work (the exact hash_encode_bwd is timed in phase 6);
  3. serve at the full width of experiment/nerf_synthetic/config/base.json:
     a Testbed on the card with seeded weights and a procedural density grid
     renders 800x800 frames (Shade spp 1 from three ring poses, then the
     protocol's Shade spp-8 frame (all passes from one cover march, one
     network evaluation per cover point, its launches counted on their
     own), Depth, and one spp-1 frame of each of Normals, AO, Distance,
     Stepsize and Cost), with every kernel launch counter zeroed just before
     and read just after; small Shade and Normals frames rendered on the card
     are held against the same frames rendered on the CPU through the plain
     versions; then the protocol frames alone: Shade and Depth spp-8 800x800
     frames from the three ring poses (ms, network samples, lattice points
     and peak memory of each), and small spp-8 Shade and Depth frames card
     vs CPU; the empty-space skipping: one 800x800 Shade spp-1 frame again
     and the same view taken by the full march from t0 (full_march_frame:
     the network samples must be equal), each frame's lattice points, and a
     small frame's march card vs CPU on the same rays with a transparent
     model at spp 1 and 8 (samples and lattice points must be equal);
  4. train at base.json width: the port writes a procedural scene under
     build/, a Testbed on the card loads it (load_training_data) and runs
     train(16, 2**18) TRAIN_CALLS times with the loop's default (a call whose
     shape equals the last call's replays CUDA graphs of 8 captured steps),
     with every counter zeroed just before and read just after (each kernel
     must have launched; a replay counts the launches its graph makes);
     some call among calls 2-TRAIN_CALLS must have replayed graphs; it
     prints each call's shape tuple, ms, graphed or not, and the peak memory
     and the memory the captures reserved; one more call is profiled and
     must run no indexing_backward_kernel; then PER_STEP_CALLS calls with
     stochastic_fuse_steps = 1 (ngp_tpu's per-step path), one of them
     profiled with shapes and stacks to name each gather kernel's caller;
     from one state and one draw table, a captured call of 8 steps against
     the same steps eager (loss_sum within GRAPH_LOSS_RTOL, parameters
     within GRAPH_PARAM_REL relative L2); one step under
     torch.cuda.set_sync_debug_mode("error"); a held-out view must beat
     PSNR_FLOOR; one train() call of a
     small config on the card and on the CPU, from the same state and draws,
     must give the same loss within TRAIN_REF_RTOL; then hash_encode_fwd and
     the stochastic hash_encode_bwd are held against their plain versions
     and timed on path-shaped positions: one network batch of an 800x800
     Shade frame and one train(1, 2**18) step's batch, both captured by
     wrapping the kernels' wrappers, with each set's distinct (level, row)
     pairs and bounds beside the uniform case's; then the training batch
     kernels at the training cells' shape (TRAIN_BATCH_SHAPE) on the trained
     grid and scene, two-level march on and off, and on the cone lattice
     over five cascades (AABB16_CONFIG trained 8 calls on that scene) at
     aabb16-oadd-train-800's shape (AABB16_TRAIN_BATCH_SHAPE): the kernels'
     batch against the plain path's, every field bit for bit, and
     train_march and train_emit each timed alone (their inputs captured by
     wrapping their wrappers), with their bounds, beside the whole batch
     through the kernels and through the plain path;
  5. the protocol CLI (python -m ngp_tpu_torch.experiment.run, called
     in-process) on the card on that scene, with every counter zeroed just
     before and read just after: base.json, --n_steps CLI_STEPS with a
     snapshot every CLI_INTERVAL steps; then a second run resumes from the
     mid-run snapshot (optimizer state included, as a stalled run's restart
     finds it), trains to CLI_RESUME_STEPS and evaluates the test views at
     spp 8; their PSNR must beat PSNR_FLOOR;
  5b. the trainable envmap at base.json width: base.json with envmap.train
     (256x256) on that scene, ENVMAP_CALLS train(16, 2**18) calls with every
     counter zeroed just before and read just after (adam_ema once a step
     per network leaf and once a call for the envmap), the graphed call's
     median ms and samples/s beside phase 4's call without the envmap, the
     loss trajectory, the envmap's largest value (must be > 0), the
     envmap's adam_ema launch in a profiled call, 800x800 Shade spp-1 and
     spp-8 frames of a test view over the trained envmap; a TINY train()
     call with an envmap card vs CPU (loss within TRAIN_REF_RTOL, the
     envmap within ENVMAP_REF_REL relative L2) and small Shade frames over
     an envmap card vs CPU at spp 1 and 8;
  6. the hash variants beside oadd at base.json width: after phase 4 the
     xadd and tcnn instantiations of hash_encode_fwd and of the exact
     hash_encode_bwd are held against their plain versions on VARIANT_CASES
     and a frame's network batch, and timed with their bounds; then a tcnn
     model's reference-layout snapshot is saved and loaded (bit-equal params
     and grid in "float", the fp16 values in "__half") and served, with
     every counter zeroed just before and read just after: 800x800 Shade
     spp-1 frames from the three ring poses and a Shade spp-8 frame, one
     frame profiled, small Shade and Normals frames card vs CPU; an xadd
     model serves one frame and trains XADD_TRAIN_CALLS calls (one more
     call profiled); a tcnn model trains TCNN_TRAIN_CALLS train(16, 2**18)
     calls (the exact deposit must launch at least once a step, the
     stochastic one never; one more call profiled; one eager
     train(1, 2**18) step's positions captured; held-out PSNR above
     PSNR_FLOOR), its TINY card-vs-CPU train() check, and its
     reference-layout export is evaluated by the protocol CLI (PSNR above
     PSNR_FLOOR); then the exact hash_encode_bwd of every variant (oadd,
     xadd, tcnn) is held against its plain version and timed on 2^18
     uniform positions, the frame's batch and that tcnn step's batch, with
     its bound, distinct rows and, for information, index_add_ of the same
     deposits, and each instantiation's ptxas registers and spills;
  8. (after 5b) data parallelism on the one card (phase_dp): (a) a
     world-size-1 NCCL group; a base.json Testbed trains DP_WARM_CALLS
     calls for its shape; from one state and one draw table the
     single-card call of DP_CALL_STEPS steps and make_dp_train_call's, both
     captured in CUDA graphs (the sharded one with its all-reduces inside)
     and replayed, held against each other (a one-step call's losses,
     parameters, EMA and moments within DP_REL relative, the 16-step call's
     within GRAPH_LOSS_RTOL and GRAPH_PARAM_REL, the single-card call's
     replay against its first run printed beside; the one-rank all-reduce
     must leave a step's gradients bit-equal),
     make_dp_grid_update against the single card's grid update
     (bit-equal), the two graphed calls timed in turns, the all-reduces'
     device ms a step from a profiled eager sharded step, and the five
     kernels' launches in one replay of the sharded call with every counter
     zeroed just before and read just after (each must launch); (b)
     DP_GANG gloo ranks spawned on the one card after the kernels are built
     (base.json widths, stochastic level rate 1, capacity DP_GANG_CAPACITY)
     from a saved state: a grid update (candidate cells bit-equal to the
     single card's, density within DP_GRID_ATOL), DP_GANG_STEPS eager steps
     (loss within DP_LOSS_RTOL of the same steps on the single card,
     parameters within DP_PARAM_ATOL but for at most DP_PARAM_OUTLIERS and
     within GRAPH_PARAM_REL relative L2; equal measured batches) and one 800x800
     Shade spp-1 frame through Testbed(use_mesh=True) (within DP_FRAME_ATOL
     of the single card's); a rank that fails or outlives DP_JOIN_S is
     killed and fails the smoke;
  7. print each kernel's time alone beside its device time per launch inside
     the profiled serve frame and train() call; print one {"kernels": [...]}
     line (launches: the protocol CLI's run; launches_by_path each path's,
     the sharded call's among them; the [xadd] and [tcnn] entries their own
     paths'; adam_ema's envmap_leaf entry), one {"serve": {...}} line (with
     the skipping's numbers under "skip"), one {"train": {...}} line, one
     {"protocol": {...}} line, one {"variants": {...}} line, one {"envmap":
     {...}} line, one {"dp": {...}} line, and as the last line {"ok": true,
     "device": {...}}.

Imports torch, numpy and ngp_tpu_torch only (never jax or ngp_tpu). PNGs
go through ngp_tpu_torch/data/png.py (no PIL); the snapshots need msgpack.
"""

import dataclasses
import json
import math
import os
import re
import shutil
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
PER_STEP_CALLS = 3  # the same scene with stochastic_fuse_steps = 1 (ngp_tpu's per-step path); calls 2-3 give its ms
# the captured call against the same steps eager: the stochastic deposit adds
# in float atomics, so the last bits of a step follow the order of the adds
GRAPH_CHECK_STEPS = 8
GRAPH_LOSS_RTOL = 1e-4
GRAPH_PARAM_REL = 1e-3
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
PROTOCOL_SPP = 8  # the protocol's samples per pixel (experiment/nerf_synthetic/python/run.py)
PROTOCOL_MODES = ("Shade", "Depth")  # what the protocol renders of every test view
# the CLI on the card: a first run trains CLI_STEPS with a snapshot (optimizer
# included) every CLI_INTERVAL steps; a second run resumes from that mid-run
# snapshot and trains to CLI_RESUME_STEPS before it evaluates
CLI_STEPS, CLI_INTERVAL, CLI_RESUME_STEPS = 256, 128, 272
CLI_DIR = "build/chip_smoke_cli"
SERVE_KERNELS = ("fused_mlp_fwd", "hash_encode_fwd")  # must launch while serving
# the hash variants beside oadd: each gather and exact scatter instantiation
# against its plain version on VARIANT_CASES and one frame batch; a tcnn
# model served from a reference-layout snapshot and trained with
# TCNN_TRAIN_CALLS train(16, 2**18) calls (its exact scatter's first path);
# an xadd model serving one frame and training XADD_TRAIN_CALLS calls
VARIANTS = ("xadd", "tcnn")
VARIANT_CASES = [("2^18", 1 << 18), ("2^18+37", (1 << 18) + 37)]
TCNN_TRAIN_CALLS = 16
XADD_TRAIN_CALLS = 2
# a variant's training path: the exact scatter, never the stochastic one
VARIANT_TRAIN_KERNELS = ("fused_mlp_fwd", "fused_mlp_bwd", "adam_ema", "hash_encode_fwd", "hash_encode_bwd_exact",
                         "train_march", "train_emit")
REF_DIR = "build/chip_smoke_reference"
TRAIN_KERNELS = ("fused_mlp_fwd", "fused_mlp_bwd", "adam_ema", "hash_encode_fwd", "hash_encode_bwd_stochastic",
                 "train_march", "train_emit")
# the training cells' step shape (portbench's train-800 traffic): n_rays,
# capacity, s_pad, n_window, s_short, n_long, n_seg_cap
TRAIN_BATCH_SHAPE = (10240, 1 << 18, 512, 1152, 32, 2560, 96)
# ngp-aabb16-oadd's sampler and hash scale (portbench/configs/ngp-aabb16-oadd.json)
# and aabb16-oadd-train-800's step shape on an H100 (the cone lattice marches
# the whole lattice, 1,664 points, with no coarse pass)
AABB16_CONFIG = {"samlper": {"aabb_scale": 16, "cone_angle_constant": 0.00390625},
                 "network": {"encoding": {"per_level_scale": 1.66248}}}
AABB16_TRAIN_BATCH_SHAPE = (24576, 1 << 18, 256, 1664, 32, 6144, 0)
# the envmap phase: base.json with envmap.train (its default 256x256 envmap)
# trained ENVMAP_CALLS train(16, 2**18) calls on the training scene
ENVMAP_CALLS = 16
ENVMAP_SHAPE = (256, 256, 4)
# the envmap after one TINY train() call, card vs CPU: the relative L2 of the
# difference. Adam's first step moves an entry by about lr times the sign of
# its mean gradient; the card's splat adds in atomic order and its network
# rounds in bf16, so an entry whose gradient sits near zero may move
# otherwise. On an H100 (PERF.md, section 6) it was 4.4e-6
ENVMAP_REF_REL = 1e-3
ENVMAP_TINY = (64, 128)  # the TINY check's envmap (height, width)
# small-frame card vs CPU (phase_reference), max and mean abs on linear RGBA
# by mode: in Shade, bf16 flips in the MLP and fp32 ordering move a pixel by
# a few 1e-3. Normals differentiates the density head: a ReLU unit whose
# pre-activation sits at zero can take the other mask on the card, and the
# gradient (not only the value) of that sample then jumps by the unit's
# whole contribution, turning its normal. On an H100 (PERF.md, section 6) that
# moved one pixel of 3072 by 2.4e-2, with a mean of 6.9e-5.
REF_LIMITS = {"Shade": (2e-2, 1e-3), "Normals": (5e-2, 1e-3)}
# the spp-8 frames card vs CPU, under the spp-1 Shade limits: Depth composites
# the same sigma, and the shared Shade frame the same evaluations lerped
PROTOCOL_REF_LIMITS = {"Shade": (2e-2, 1e-3), "Depth": (2e-2, 1e-3)}
# device kernels of each wrapper, for its time per launch inside a profiled
# run: (kernels whose launches count, kernels whose time counts); the
# backward's launch runs its fixed-order block reduction too
PROFILE_KERNELS = {
    "fused_mlp_fwd": (("fused_mlp_fwd_kernel",), ("fused_mlp_fwd_kernel",)),
    "fused_mlp_bwd": (("fused_mlp_bwd_kernel",), ("fused_mlp_bwd_kernel", "reduce_blocks_kernel")),
    "adam_ema": (("adam_ema_kernel",), ("adam_ema_kernel",)),
    "hash_encode_fwd": (("hash_encode_fwd_kernel",), ("hash_encode_fwd_kernel",)),
    "hash_encode_bwd": (("hash_bwd_stochastic_kernel", "hash_bwd_exact_kernel"),) * 2,
    "train_march": (("train_march_kernel",), ("train_march_kernel",)),
    "train_emit": (("train_emit_kernel",), ("train_emit_kernel",)),
    "render_march": (("render_march_kernel",), ("render_march_kernel",)),
    "render_cover_march": (("render_cover_march_kernel",), ("render_cover_march_kernel",)),
}
# (memory bytes/s, bf16 dense tensor FLOP/s, fp32 FLOP/s outside the tensor
# cores) by card, from NVIDIA's data sheets
PEAKS = {
    "H100 PCIe": (2.0e12, 756e12, 51e12),
    "H100 NVL": (3.9e12, 835e12, 60e12),
    "H100": (3.35e12, 989e12, 67e12),
}


def timed(fn):
    """A phase that prints its own seconds when it returns."""
    def run(*args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        print(f"[{fn.__name__}: {time.perf_counter() - t:.1f} s]")
        return out

    run.__name__, run.__doc__ = fn.__name__, fn.__doc__
    return run


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


@timed
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


def with_variant(doc: dict, variant: str) -> dict:
    """A copy of a config document with network.encoding.hash_variant set."""
    net = dict(doc.get("network", {}))
    net["encoding"] = dict(net.get("encoding", {}), hash_variant=variant)
    return dict(doc, network=net)


def variant_doc(variant: str) -> dict:
    """base.json with the given hash variant."""
    from ngp_tpu_torch.utils.config import load_commented_json

    return with_variant(load_commented_json(BASE_JSON), variant)


def make_testbed(Testbed, NGPModel, device: str, variant: str = "oadd", doc: dict | None = None):
    """Testbed at base.json's full width (with the given hash variant, or the
    config document `doc`) with weights drawn from a seeded CPU generator (so
    every device gets the same ones; the density channel is pushed up so
    rays turn opaque, as a trained scene's do) and the blob grid."""
    tb = Testbed(device=device)
    if doc is not None:
        tb.load_model_config_dict(doc)
    elif variant == "oadd":
        tb.load_model_config(BASE_JSON)
    else:
        tb.load_model_config_dict(variant_doc(variant))
    params = NGPModel(tb.config.network, device="cpu").init(torch.Generator().manual_seed(0)).params()
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


@timed
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
        frames.append({"mode": "Shade", "spp": 1, "theta": theta, "ms": ms, "mean_opacity": opac, "samples": samples,
                       "points": tb._renderer.last_frame_points})
    # the protocol's frame: its launches are counted apart (one shared
    # evaluation, not one a pass), as the difference of the running counts
    before = counters()
    ms, opac, samples = render_timed(tb, w, h, PROTOCOL_SPP, "Shade")
    spp8_launches = {k: v - before[k] for k, v in counters().items()}
    frames.append({"mode": "Shade", "spp": PROTOCOL_SPP, "theta": POSES[-1], "ms": ms, "mean_opacity": opac, "samples": samples,
                   "points": tb._renderer.last_frame_points})
    for mode in ("Depth",) + SERVE_MODES:
        ms, opac, samples = render_timed(tb, w, h, 1, mode)
        frames.append({"mode": mode, "spp": 1, "theta": POSES[-1], "ms": ms, "mean_opacity": opac, "samples": samples,
                       "points": tb._renderer.last_frame_points})
    launches = counters()  # read just after
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"serve peak device memory {peak_gib:.2f} GiB; launches {launches}; in the Shade spp-{PROTOCOL_SPP} frame {spp8_launches}")
    for f in frames:
        print(f"serve {w}x{h} {f}")
    missing = [k for k in SERVE_KERNELS if launches[k] < 1 or spp8_launches[k] < 1]
    if missing:
        raise SystemExit(f"the serving path launched no {missing} kernel")
    n_passes = sum(1 for f in frames if f["spp"] == 1)  # the spp-1 passes; the spp-8 frame is its own entry
    per_pass = {k: (v - spp8_launches[k]) / n_passes for k, v in launches.items()}
    return tb, frames, launches, per_pass, spp8_launches, peak_gib


@timed
def phase_protocol_frames(tb):
    """The protocol's frames alone at 800x800: Shade and Depth spp 8 from each
    ring pose, with the ms, network samples and peak memory of each."""
    w, h = FRAME
    out = []
    for theta in POSES:
        tb.set_nerf_camera_matrix(ring_pose(theta))
        for mode in PROTOCOL_MODES:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms, opac, samples = render_timed(tb, w, h, PROTOCOL_SPP, mode)
            peak = torch.cuda.max_memory_allocated() / 2**30
            out.append({"mode": mode, "spp": PROTOCOL_SPP, "theta": theta, "ms": ms, "samples": samples,
                        "points": tb._renderer.last_frame_points, "peak_memory_gib": peak, "mean_opacity": opac})
            print(f"protocol {w}x{h} {out[-1]}")
    summary = {}
    for mode in PROTOCOL_MODES:
        fr = [f for f in out if f["mode"] == mode]
        summary[mode] = {k: sum(f[k] for f in fr) / len(fr) for k in ("ms", "samples", "points")}
        summary[mode]["peak_memory_gib"] = max(f["peak_memory_gib"] for f in fr)
    print(f"protocol spp-{PROTOCOL_SPP} {w}x{h} means over {len(POSES)} poses: {summary}")
    # where the shared Shade frame's device time goes: the march, the network
    # and the plain-torch composite (the renderer's profiler labels)
    tb.rendering_buffer.render_mode = "Shade"
    labels = ("spp_march", "spp_network", "spp_composite")
    rows, by_label = device_profile(lambda: tb.render(w, h, spp=PROTOCOL_SPP, to_srgb=False), labels)
    busy = sum(r[1] for r in rows)
    frame_ms = [f["ms"] for f in out if f["mode"] == "Shade"][-1]
    print(f"profile {w}x{h} Shade spp {PROTOCOL_SPP}: device busy {busy:.1f} ms of an unprofiled {frame_ms:.1f} ms frame; "
          f"by stage {by_label}")
    for key, ms, count in rows[:12]:
        print(f"  {ms:9.2f} ms {count:6d}x  {key[:110]}")
    profile = {"device_busy_ms": busy, "idle_share": 1.0 - busy / frame_ms, "by_stage_ms": by_label,
               "top_kernels": [[k[:80], ms, c] for k, ms, c in rows[:10]], "in_path": in_path(rows)}
    return {"frames": out, "mean": summary, "profile_shade": profile}


@timed
def phase_protocol_reference(Testbed, NGPModel):
    """Small spp-8 Shade and Depth frames on the card (kernels) vs the CPU
    (plain versions), same weights and grid."""
    w, h = SMALL_FRAME
    out = {}
    for mode, (max_abs, mean_abs) in PROTOCOL_REF_LIMITS.items():
        imgs = []
        for device in ("cuda", "cpu"):
            tb = make_testbed(Testbed, NGPModel, device)
            tb.rendering_buffer.render_mode = mode
            tb.set_nerf_camera_matrix(ring_pose(POSES[1]))
            tb.render(w, h, spp=PROTOCOL_SPP, to_srgb=False)
            imgs.append(tb._accum.cpu())
        err = (imgs[0] - imgs[1]).abs()
        print(f"reference {mode} spp {PROTOCOL_SPP} {w}x{h}: card vs CPU max_abs={err.max().item():.3e} "
              f"mean_abs={err.mean().item():.3e} (limits {max_abs}, {mean_abs})")
        if err.max() > max_abs or err.mean() > mean_abs or imgs[1][..., 3].max() <= 0.0:
            raise SystemExit(f"the card's spp-{PROTOCOL_SPP} {mode} frame disagrees with the CPU reference")
        out[mode] = {"max_abs": err.max().item(), "mean_abs": err.mean().item()}
    return out


@timed
def phase_cli(Testbed, train_json, test_json):
    """The protocol CLI on the card, in-process: a base.json run of CLI_STEPS
    with a snapshot every CLI_INTERVAL steps, then a run that resumes from
    the mid-run snapshot (the CLI writes it with the optimizer state and
    overwrites it at the end; the smoke keeps a copy, as a stalled run's
    restart finds it), trains to CLI_RESUME_STEPS and evaluates the test
    views at spp 8. Every counter is zeroed just before and read just after."""
    from ngp_tpu_torch.experiment import run as cli
    from ngp_tpu_torch.train.snapshot import load_snapshot

    shutil.rmtree(CLI_DIR, ignore_errors=True)
    snap, mid = f"{CLI_DIR}/ckpt.msgpack", f"{CLI_DIR}/resume/ckpt.msgpack"
    os.makedirs(os.path.dirname(mid), exist_ok=True)
    save = Testbed.save_snapshot

    def keep_mid_run(self, path, serialize_optimizer=False, reference_format=False):
        save(self, path, serialize_optimizer, reference_format)
        if serialize_optimizer:
            shutil.copy(path, mid)

    zero_counters()  # just before the main path
    t = time.perf_counter()
    Testbed.save_snapshot = keep_mid_run
    try:
        cli.run(cli.parse_args(["--scene", train_json, "--network", BASE_JSON, "--n_steps", str(CLI_STEPS),
                                "--save_snapshot", snap, "--snapshot_interval", str(CLI_INTERVAL)]))
    finally:
        Testbed.save_snapshot = save
    train_s = time.perf_counter() - t
    _, mid_snap = load_snapshot(mid)
    leaves = mid_snap.get("opt_state_leaves")
    if not leaves or int(leaves[0]) != CLI_INTERVAL or not any(np.abs(x).max() > 0 for x in leaves[1:-1]):
        raise SystemExit(f"the CLI's mid-run snapshot holds no optimizer state at step {CLI_INTERVAL}")
    t = time.perf_counter()
    summary = cli.run(cli.parse_args(["--load_snapshot", mid, "--scene", train_json, "--n_steps", str(CLI_RESUME_STEPS),
                                      "--test_transforms", test_json]))
    resume_s = time.perf_counter() - t
    launches = counters()  # just after
    print(f"CLI: {CLI_STEPS} steps in {train_s:.1f} s; resumed at step {CLI_INTERVAL} (optimizer count "
          f"{int(leaves[0])}) to {CLI_RESUME_STEPS} and evaluated in {resume_s:.1f} s; PSNR {summary['psnr']:.2f} dB "
          f"(floor {PSNR_FLOOR}), SSIM {summary['ssim']:.4f}, FPS {summary['fps']:.2f}; launches {launches}")
    missing = [k for k in TRAIN_KERNELS if launches[k] < 1]
    if missing:
        raise SystemExit(f"the protocol CLI launched no {missing} kernel")
    if not summary["psnr"] > PSNR_FLOOR:
        raise SystemExit(f"the CLI's test-view PSNR {summary['psnr']:.2f} dB is below the floor of {PSNR_FLOOR} dB")
    for f in ("train_timing.txt", "resume/train_timing.txt", "resume/eval_stat.xls", "resume/image", "resume/depth"):
        if not os.path.exists(f"{CLI_DIR}/{f}"):
            raise SystemExit(f"the CLI wrote no {CLI_DIR}/{f}")
    return {"steps": CLI_STEPS, "snapshot_interval": CLI_INTERVAL, "resume_steps": CLI_RESUME_STEPS, "train_s": train_s,
            "resume_and_eval_s": resume_s, "psnr": summary["psnr"], "ssim": summary["ssim"], "fps": summary["fps"],
            "views": [[v if not isinstance(v, float) or math.isfinite(v) else None for v in row] for row in summary["views"]],
            "launches": launches}


@timed
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


@timed
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
    from ngp_tpu_torch.ops import kernels

    return kernels.launch_counts()


def zero_counters():
    from ngp_tpu_torch.ops import kernels

    kernels.set_launch_counts({k: 0 for k in kernels.LAUNCH_COUNTERS})


def device_profile(fn, labels=()):
    """Run fn() once under torch.profiler: [(kernel name, device ms, count)],
    busiest first; with `labels`, also {label: (device ms of the kernels
    launched inside its record_function ranges, ms its ranges span on the
    device's timeline)}. The ranges' own device-side spans are not kernels
    and stay out of the rows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [
        (e.key, e.self_device_time_total / 1e3, e.count)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0 and e.key not in labels
    ]
    rows = sorted(rows, key=lambda r: -r[1])
    if not labels:
        return rows
    by_label = {}
    for label in labels:
        events = [e for e in prof.events() if e.name == label]
        kernels = sum(e.device_time_total for e in events if e.device_type == DeviceType.CPU) / 1e3
        span = sum(e.device_time_total for e in events if e.device_type == DeviceType.CUDA) / 1e3
        by_label[label] = {"kernel_ms": kernels, "span_ms": span}
    return rows, by_label


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


@timed
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


@timed
def phase_adam_kernel(opt, bw, fp32_flops):
    """adam_ema vs its plain version on the base.json hash table with ~4 % of
    its rows visited (lazy), and on a dense MLP-sized leaf with L2."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    L, T, F = ADAM_SHAPE
    g = torch.randn(ADAM_SHAPE, generator=gen, device="cuda") * 1e-2
    g *= (torch.rand((L, T, 1), generator=gen, device="cuda") < ADAM_VISITED).float()
    state = [torch.randn(ADAM_SHAPE, generator=gen, device="cuda") * s for s in (1e-3, 1e-4, 1e-2, 1e-2)]
    state[1] = state[1].abs()
    kw = dict(b1=0.9, b2=0.99, eps=1e-15, decay=0.95)
    # the step's (lr, bc1, bc2): a float32 row on the card that the kernel reads
    row = torch.tensor([1e-2, 1 - 0.9**10, 1 - 0.99**10], dtype=torch.float32, device="cuda")
    worst = 0.0
    for label, lazy, l2, n in (("hash table, lazy", True, 0.0, g.numel()), ("dense + L2", False, 1e-6, 9408)):
        gg = g.reshape(-1)[:n]
        kern = [s.reshape(-1)[:n].clone() for s in state]
        plain = [s.reshape(-1)[:n].clone() for s in state]
        opt.adam_ema_cuda(gg, *kern, row, lazy=lazy, l2=l2, **kw)
        torch.cuda.synchronize()
        opt.adam_ema_plain(gg, *plain, row, lazy=lazy, l2=l2, **kw)
        err = max((a - b).abs().max().item() for a, b in zip(kern, plain, strict=True))
        ok = all(torch.allclose(a, b, rtol=ADAM_RTOL, atol=ADAM_ATOL) for a, b in zip(kern, plain, strict=True))
        bit_equal = all(torch.equal(a, b) for a, b in zip(kern, plain, strict=True))
        ok = ok and bit_equal
        print(f"adam_ema {label} (lr, bc1, bc2 from a device row): n={n} max_abs_err={err:.3e} (rtol {ADAM_RTOL}, "
              f"atol {ADAM_ATOL}), bit-equal: {bit_equal} {'ok' if ok else 'FAIL'}")
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
        "ms": cuda_ms(lambda: opt.adam_ema_cuda(g, *bufs, row, lazy=True, **kw)),
        "plain_ms": cuda_ms(lambda: opt.adam_ema_plain(g, *bufs, row, lazy=True, **kw)),
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


@timed
def phase_hash_kernels(he, bw, fp32_flops):
    """hash_encode_fwd and both hash_encode_bwd entries vs their plain
    versions on HASH_CASES; the gather's and the stochastic deposit's
    timings at base.json's N = 2^18 (the exact entry's: phase_exact_scatter)."""
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
        kd = he.hash_bwd_exact_cuda(pos, spec, g)
        torch.cuda.synchronize()
        pd = he.hash_bwd_exact_plain(pos, spec, g)
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
    """(bytes, fp32 operations) that the gather and the deposits of `spec`
    need on these positions (each input read once, each output written
    once), and the distinct (level, row) pairs behind them, counted with
    the variant's own corner rows: the gather reads each row its corners
    touch once; a deposit writes the whole (L, T_pad, F) gradient, whatever
    rows it adds into. The stochastic deposit is oadd's only."""
    n = pos.shape[0]
    L, T, F = spec.n_levels, spec.padded_size, spec.n_features
    u_rows = torch.unique(he.corner_rows(pos, spec)).numel()
    grad_bytes = 4 * L * T * F
    out = {
        "fwd": (12 * n + 4 * F * u_rows + 4 * L * F * n, (HASH_CELL_OPS + 8 * (2 + 2 * F)) * L * n),
        "exact": (12 * n + 4 * L * F * n + grad_bytes, (HASH_CELL_OPS + 8 * (2 + F)) * L * n),
        "distinct_rows": u_rows,
    }
    if spec.variant == "oadd":
        kr = he.level_rate(spec, n)
        ones = torch.ones((n, L * F), device=pos.device)  # every deposit positive: its row is nonzero
        u_dep = int((he.hash_bwd_oadd_stochastic_plain(pos, spec, ones) != 0).any(-1).sum())
        out["stochastic"] = (12 * n + 4 * L * F * n // kr + grad_bytes, (HASH_CELL_OPS + 12 + F) * L * n // kr)
        out["distinct_deposit_rows"] = u_dep
        out["level_rate"] = kr
    return out


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


@timed
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


def batches_equal(a, b) -> bool:
    """Every tensor field of two TrainingBatches (and of their layouts) equal."""
    def same(x, y):
        return (x is None and y is None) or (x is not None and y is not None and x.shape == y.shape and torch.equal(x, y))

    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        if name in ("layout", "layout_long"):
            if (x is None) != (y is None) or (x is not None and not all(same(u, v) for u, v in zip(x, y))):
                return False
        elif not same(x, y):
            return False
    return True


def graphed_ms(fn, reps: int = 50) -> float:
    """Device ms of fn() captured in a CUDA graph and replayed (warmed on a
    side stream first, as torch.cuda.graph asks)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, reps)


@timed
def phase_train_batch(tb, bw, fp32_flops) -> dict:
    """The training batch kernels on trained grids and the smoke's scene, in
    three cases: base.json at TRAIN_BATCH_SHAPE with the two-level march on
    (n_seg_cap 96) and off, and the cone lattice over five cascades
    (AABB16_CONFIG, a model of tb's class trained 8 x train(16, 2**18) first,
    none of whose card batches may take the plain path) at
    AABB16_TRAIN_BATCH_SHAPE. In each: the kernels' batch against the plain
    path's on the same tensors (every field equal), the march's counters
    from one more launch, train_march and train_emit each timed alone on the
    inputs of that call (captured by wrapping their wrappers; the kernel's
    device time and its wrapper's eager time), and the whole batch timed
    through the kernels and through the plain path, each replayed from a
    CUDA graph as a training step runs it. Bounds in bytes: the march reads
    a ray's 37 B (and its 16 B of cone anchors) and writes its count, its
    segment count with the coarse pass and its lat_pad row, and reads once
    the occupancy of every cascade it marches (cascade 0 alone on the packed
    lattice) and the pooled grid with the coarse pass; the emission reads
    17 B a slot, a ray's 36 B (and 17 B more on the cone lattice) and the
    valid slots' ordinals and writes 24 B a slot and 6 B a step-size slot."""
    from ngp_tpu_torch.sampling import training
    from ngp_tpu_torch.utils import profiling

    cone_tb = type(tb)(device="cuda")
    cone_tb.load_model_config_dict(AABB16_CONFIG)
    cone_tb.load_training_data(f"{SCENE_DIR}/transforms_train.json")
    plain0 = profiling.get("train.batch.plain")
    for _ in range(8):
        cone_tb.train(16, TRAIN_BATCH)
    n_plain = profiling.get("train.batch.plain") - plain0
    if n_plain:
        raise SystemExit(f"{n_plain} card batches of the cone model's training took the plain path")
    base = TRAIN_BATCH_SHAPE
    cases = (("two_level", tb, base), ("single_level", tb, base[:6] + (0,)), ("cone", cone_tb, AABB16_TRAIN_BATCH_SHAPE))
    salts = torch.tensor([0x12345678, 0x9ABCDEF0], dtype=torch.int64, device="cuda")
    shift = torch.tensor(987654321, dtype=torch.int64, device="cuda")
    real = {"march": training.train_march, "emit": training.train_emit}
    out = {"shape": list(base), "cone_shape": list(AABB16_TRAIN_BATCH_SHAPE), "cone_train_batch_plain": n_plain}
    for label, model, shape in cases:
        tr, ds = model._trainer, model._loop.dataset
        scfg = tr.config.sampler
        n_rays, capacity, s_pad, n_window, s_short, n_long, cap = shape
        args = (scfg, tr.aabb, ds.images, ds.xforms, ds.focal_length, (0.5, 0.5), tr.grid.occupancy, salts, n_rays,
                shift, capacity, s_pad)
        kw = dict(occ_aabb=tr.grid.occ_aabb, n_window=n_window, s_short=s_short, n_long=n_long, n_seg_cap=cap)
        seen = {}

        def spy(name):
            def run(*a):
                seen[name] = a
                return real[name](*a)
            return run

        training.train_march, training.train_emit = spy("march"), spy("emit")
        try:
            got = training.generate_training_batch(*args, **kw)
        finally:
            training.train_march, training.train_emit = real["march"], real["emit"]

        def plain():
            return training._batch(*args, 0, 0, kw["occ_aabb"], n_window, s_short, n_long, cap, False, False)

        equal = batches_equal(got, plain())
        counters = training.MarchCounters("cuda")
        _, lat_pad, seg_counts = real["march"](*seen["march"][:-1], counters)
        totals = dict(zip(training.MARCH_COUNTERS, counters.totals.tolist()))
        samples = [totals[f"train.batch.samples.mip{k}"] for k in range(scfg.n_cascades)]
        mode = training.march_mode(scfg)
        cone, coarse = mode == training.CONE, seg_counts is not None
        g = scfg.grid_size
        n_grids = 1 if mode == training.PACKED else scfg.n_cascades
        march_bytes = (n_rays * (37 + 16 * cone + 8 + 8 * coarse + 2 * lat_pad.shape[1]) + n_grids * g**3
                       + (tr.grid.occupancy.numel() // 512 if coarse else 0))
        n_valid = int(got.layout.flat_valid.sum()) + (int(got.layout_long.flat_valid.sum()) if got.layout_long is not None else 0)
        dt_slots = sum(t.numel() for t in (got.dt_pad, got.dt_pad_long) if t is not None)
        emit_bytes = capacity * (17 + 24) + n_rays * (36 + 17 * cone) + 2 * n_valid + 6 * dt_slots
        # a kernel's own device time (the profiler's, the median of 20
        # launches) beside its wrapper's eager time, host launch included
        timings = {}
        for name in ("march", "emit"):
            launches = kernel_launch_ms(lambda: [real[name](*seen[name]) for _ in range(20)], f"train_{name}_kernel")
            timings[name] = {"ms": float(np.median(launches)), "wrapper_ms": cuda_ms(lambda: real[name](*seen[name]))}
        march = {**timings["march"], **bound(march_bytes, 0, bw, fp32_flops)}
        emit = {**timings["emit"], **bound(emit_bytes, 0, bw, fp32_flops)}
        batch_ms = graphed_ms(lambda: training.generate_training_batch(*args, **kw))
        plain_ms = graphed_ms(plain)
        # the plain path's time for the work the kernels replace: the plain
        # batch less what the kernels' batch spends around them
        replaced_plain_ms = plain_ms - (batch_ms - march["ms"] - emit["ms"])
        out[label] = {"equal": equal, "train_march": march, "train_emit": emit, "batch_ms": batch_ms,
                      "plain_batch_ms": plain_ms, "replaced_plain_ms": replaced_plain_ms,
                      "n_samples": int(got.n_samples), "max_ray_count": int(got.max_ray_count),
                      "seg_count_hi": int(got.seg_count_hi), "valid_slots": n_valid, "counters": totals,
                      "points_per_sample": totals["train.batch.points"] / sum(samples) if sum(samples) else None}
        print(f"train batch {label} at {shape}: kernels == plain: {equal}; train_march "
              f"{march['ms']:.4f} ms (wrapper {march['wrapper_ms']:.4f}; bound {march['bound_ms']:.4f}, "
              f"{march_bytes / 1e6:.1f} MB), train_emit {emit['ms']:.4f} ms (wrapper {emit['wrapper_ms']:.4f}; bound "
              f"{emit['bound_ms']:.4f}, {emit_bytes / 1e6:.1f} MB); whole batch "
              f"{batch_ms:.3f} ms through the kernels, {plain_ms:.3f} ms plain (graphed); samples {int(got.n_samples)}, "
              f"longest ray {int(got.max_ray_count)}, seg p99.5 {int(got.seg_count_hi)}, points a sample "
              f"{out[label]['points_per_sample']}, samples by cascade {samples} ({card_line()})")
        if not equal:
            raise SystemExit(f"the training batch kernels disagree with the plain path ({label})")
    del cone_tb
    return out


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


def kernel_callers(fn, pattern: str, depth: int = 4) -> list:
    """Run fn() once under torch.profiler with shapes and stacks recorded:
    for each device kernel whose name matches `pattern`, the op that launched
    it, its input shapes and the innermost port or torch frames of its Python
    stack, with launches and device ms; busiest first."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True, with_stack=True) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        for k in e.kernels:
            m = re.search(pattern, k.name)
            if not m:
                continue
            frames = [f for f in e.stack if "ngp_tpu_torch" in f or "chip_smoke" in f][:depth]
            parents, p = [], e.cpu_parent
            while p is not None and len(parents) < depth:
                parents.append(p.name)
                p = p.cpu_parent
            key = (m.group(0), e.name, str(e.input_shapes), " <- ".join(parents), " | ".join(frames))
            n, ms = out.get(key, (0, 0.0))
            out[key] = (n + 1, ms + k.duration / 1e3)
    rows = [{"kernel": k[0], "op": k[1], "input_shapes": k[2], "parents": k[3], "stack": k[4], "launches": n, "ms": ms}
            for k, (n, ms) in out.items()]
    return sorted(rows, key=lambda r: -r["ms"])


def train_state(tr) -> list:
    """Copies of everything a training step writes: parameters, EMA, moments."""
    return [t.detach().clone() for t in (*tr.model.param_list(), *tr.ema, *tr.optimizer.mu, *tr.optimizer.nu)]


def set_train_state(tr, state: list):
    with torch.no_grad():
        for dst, src in zip((*tr.model.param_list(), *tr.ema, *tr.optimizer.mu, *tr.optimizer.nu), state, strict=True):
            dst.copy_(src)


@timed
def phase_graph_check(tb) -> dict:
    """From one state and one draw table, the loop's captured call of
    GRAPH_CHECK_STEPS steps (replayed) against the same steps eager: each
    step's loss_sum within GRAPH_LOSS_RTOL and the parameters within
    GRAPH_PARAM_REL relative L2 (the stochastic deposit adds in float
    atomics, so the last bits follow the order of the adds); then one step
    under torch.cuda.set_sync_debug_mode("error"), which raises on any host
    sync or copy from pageable memory inside the step."""
    from ngp_tpu_torch.train.trainer import STAT_KEYS

    tr, loop, ds = tb._trainer, tb._loop, tb._loop.dataset
    n_rays, capacity, s_pad, n_window, s_short, n_long, n_seg_cap, _ = loop._last_shape
    n = GRAPH_CHECK_STEPS
    start = train_state(tr)
    table = torch.from_numpy(tr.draw_table(torch.Generator().manual_seed(7), n, 12345, n_rays)).to("cuda")
    graphed = torch.zeros((n, len(STAT_KEYS)), dtype=torch.float64, device="cuda")
    eager = torch.zeros_like(graphed)
    call = tr.train_call(n_rays, capacity, s_pad, n, n_window, s_short, n_long, n_seg_cap)
    call(ds, table, graphed)
    torch.cuda.synchronize()
    if call.graph is None:
        raise SystemExit("the training call was not captured in a CUDA graph")
    after_graph = train_state(tr)
    set_train_state(tr, start)
    step = tr.train_step(n_rays, capacity, s_pad, n_window, s_short, n_long, n_seg_cap)
    for k in range(n):
        step(ds, table[k], eager[k])
    torch.cuda.synchronize()
    n_params = len(tr.model.param_list())
    param_rel = max(((a - b).norm() / b.norm()).item() for a, b in zip(after_graph[:n_params], train_state(tr)[:n_params]))
    g, e = graphed.cpu().numpy(), eager.cpu().numpy()
    loss_rel = float(np.max(np.abs(g[:, 0] - e[:, 0]) / np.abs(e[:, 0])))
    ok = loss_rel <= GRAPH_LOSS_RTOL and param_rel <= GRAPH_PARAM_REL
    print(f"graphed vs eager, {n} steps of shape {loop._last_shape[:7]}: loss_sum max relative difference {loss_rel:.3e} "
          f"(limit {GRAPH_LOSS_RTOL}), parameters max relative L2 {param_rel:.3e} (limit {GRAPH_PARAM_REL}); "
          f"integer stats equal: {bool((g[:, 1:] == e[:, 1:]).all())} {'ok' if ok else 'FAIL'} ({card_line()})")
    if not ok:
        raise SystemExit("the captured training call disagrees with the same steps run eagerly")

    out = torch.zeros(len(STAT_KEYS), dtype=torch.float64, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(ds, table[0], out)
    except RuntimeError as err:
        raise SystemExit(f"a training step synchronised with the host: {err}") from err
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    set_train_state(tr, after_graph)
    tr.optimizer.advance(n)
    print("one training step under torch.cuda.set_sync_debug_mode('error'): no host sync")
    return {"steps": n, "shape": list(loop._last_shape[:7]), "loss_sum_max_rel": loss_rel, "param_max_rel_l2": param_rel,
            "integer_stats_equal": bool((g[:, 1:] == e[:, 1:]).all()), "sync_free_step": True,
            "graph_launches": call.launches}


def timed_calls(tb, n_calls: int) -> list:
    calls = []
    for _ in range(n_calls):
        t = time.perf_counter()
        tb.train(16, TRAIN_BATCH)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        b = tb.training_buffer
        calls.append({"ms": ms, "loss": b.loss, "n_rays_per_batch": b.n_rays_per_batch, "measured_batch_size": b.measured_batch_size,
                      "prep_ms": b.training_prep_ms, "steps_ms": b.training_ms, "graphed": b.graphed, "demoted": b.demoted,
                      "shape": list(tb._loop._last_shape[:7])})
    return calls


@timed
def phase_train(Testbed):
    """Train at base.json width on a procedural scene the port writes on the
    card, through load_training_data and train(16, 2**18), with the loop's
    default: calls of a shape equal to the last call's replay captured CUDA
    graphs of stochastic_fuse_steps steps."""
    from ngp_tpu_torch.data.synthetic import write_synthetic_dataset

    t = time.perf_counter()
    train_json, test_json = write_synthetic_dataset(SCENE_DIR, **SCENE, device="cuda")
    scene_s = time.perf_counter() - t
    print(f"train scene {SCENE} written in {scene_s:.1f} s")
    tb = Testbed(device="cuda")
    tb.load_model_config(BASE_JSON)
    tb.load_training_data(train_json)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    zero_counters()  # just before the main path
    calls = timed_calls(tb, TRAIN_CALLS)
    launches = counters()  # just after
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    pool_gib = tb._trainer.capture_reserved_bytes / 2**30  # what the captures added to the graph pool
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
    n_graphed = sum(c["graphed"] for c in steady)
    demoted = any(c["demoted"] for c in calls)
    print(f"calls 2-{TRAIN_CALLS}: {n_graphed} graphed, {len(steady) - n_graphed} eager; demoted: {demoted}; "
          f"peak memory {peak_gib:.2f} GiB, graph pool (reserved by the captures) {pool_gib:.2f} GiB ({card_line()})")
    if n_graphed == 0:
        raise SystemExit(f"no call among calls 2-{TRAIN_CALLS} ran a captured graph")
    total_ms = sum(c["ms"] for c in steady)
    samples = sum(16 * c["measured_batch_size"] for c in steady)
    call_ms = total_ms / len(steady)
    graphed = [c for c in steady if c["graphed"]]
    graphed_ms = [c["ms"] for c in graphed]
    # a graphed call at a steady shape (the median: the first graphed call of
    # each shape includes its capture)
    graphed_median_ms = float(np.median(graphed_ms))
    graphed_samples_per_s = float(np.median([16 * c["measured_batch_size"] / (c["ms"] / 1e3) for c in graphed]))

    # one more call under the profiler (not counted above), a graphed one
    # when the shape holds
    rows = device_profile(lambda: tb.train(16, TRAIN_BATCH))
    profiled_graphed = tb.training_buffer.graphed
    busy_ms = sum(r[1] for r in rows)
    if not rows:
        print("the profiler traced no kernel of the profiled call (graph replays untraced): no busy time or idle share")
    print(f"profile train(16, 2**18) (graphed: {profiled_graphed}): device busy {busy_ms:.1f} ms of an unprofiled "
          f"{graphed_median_ms:.1f} ms graphed call (median), {sum(r[2] for r in rows)} kernels; idle share "
          f"{1.0 - busy_ms / graphed_median_ms:.3f} ({card_line()})")
    for key, ms, count in rows[:12]:
        print(f"  {ms:9.2f} ms {count:6d}x  {key[:110]}")
    if any("indexing_backward_kernel" in key for key, _, _ in rows):
        raise SystemExit("the profiled training call ran autograd's sort-based indexing backward")

    # JAX's own per-step path: the same scene and state, one step a launch
    loop = tb._loop
    loop.stochastic_fuse_steps = 1
    per_step = timed_calls(tb, PER_STEP_CALLS)
    per_step_ms = float(np.mean([c["ms"] for c in per_step[1:]]))
    callers = kernel_callers(lambda: tb.train(16, TRAIN_BATCH), r"vectorized_gather_kernel|indexing_backward_kernel")
    loop.stochastic_fuse_steps = 8
    print(f"per-step run, {PER_STEP_CALLS} calls: {per_step_ms:.1f} ms a call (calls 2-{PER_STEP_CALLS}) against "
          f"{call_ms:.1f} ms a call over calls 2-{TRAIN_CALLS} with graphs, {graphed_median_ms:.1f} ms a graphed call "
          f"(median; {graphed_samples_per_s / 1e6:.2f}M samples/s) ({card_line()})")
    print("gather kernels of one per-step call, by the op and stack that launched them:")
    for r in callers:
        print(f"  {r['ms']:8.2f} ms {r['launches']:4d}x  {r['kernel']} from {r['op']} {r['input_shapes'][:90]} <- "
              f"{r['parents'][:80]} | {r['stack'][:160]}")
    if any(r["kernel"] == "indexing_backward_kernel" for r in callers):
        raise SystemExit("a per-step training call ran autograd's sort-based indexing backward")

    graph_check = phase_graph_check(tb)

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
        "ms_per_graphed_call_mean": float(np.mean(graphed_ms)),
        "ms_per_graphed_call_median": graphed_median_ms,
        "samples_per_s": samples / (total_ms / 1e3),
        "samples_per_s_graphed_median": graphed_samples_per_s,
        "graphed_calls": n_graphed,
        "eager_calls": len(steady) - n_graphed,
        "demoted": demoted,
        "shapes": [c["shape"] for c in calls],
        "n_rays_per_batch": [c["n_rays_per_batch"] for c in calls],
        "measured_batch_size_last": calls[-1]["measured_batch_size"],
        "loss": losses,
        "launches": launches,
        "launches_per_step": {k: v / n_steps for k, v in launches.items()},
        "peak_memory_gib": peak_gib,
        "capture_reserved_gib": pool_gib,
        "per_step_run": {"calls": PER_STEP_CALLS, "ms_per_call": per_step_ms, "calls_ms": [c["ms"] for c in per_step],
                         "gather_callers": callers[:12]},
        "graph_check": graph_check,
        "profile": {
            "graphed": profiled_graphed,
            "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / graphed_median_ms if rows else None,
            "top_kernels": [[k[:80], ms, c] for k, ms, c in rows[:10]],
            "in_path": in_path(rows),
        },
        "psnr_test_view_0": psnr,
        "scene_json": [str(train_json), str(test_json)],
    }


@timed
def phase_train_reference(Testbed, NGPModel, variant: str = "oadd"):
    """One train(16, 2**14) call of the TINY config (with the given hash
    variant) on the card (kernels) and on the CPU (plain versions), from the
    same weights, grid and draws."""
    from ngp_tpu_torch.data.synthetic import write_synthetic_dataset

    train_json, _ = write_synthetic_dataset(SCENE_DIR + "_tiny", **TINY_SCENE, device="cuda")
    out = {}
    for device in ("cuda", "cpu"):
        tb = Testbed(device=device)
        tb.load_model_config_dict(TINY if variant == "oadd" else with_variant(TINY, variant))
        params = NGPModel(tb.config.network, device="cpu").init(torch.Generator().manual_seed(0)).params()
        tb.set_state(params, np.zeros(tb.config.sampler.n_total_elements, np.float32))
        tb._trainer.sample_capacity = 1 << 15
        tb.load_training_data(train_json)
        tb.train(16, 1 << 14)
        out[device] = (tb.training_buffer.loss, tb.training_buffer.n_rays_per_batch)
    rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    print(f"train reference (TINY, {variant}, one train(16, 2**14) call): card loss {out['cuda'][0]:.6e}, "
          f"CPU loss {out['cpu'][0]:.6e}, relative difference {rel:.2e} (limit {TRAIN_REF_RTOL})")
    if not rel < TRAIN_REF_RTOL:
        raise SystemExit("the card's train() loss disagrees with the CPU reference")
    return {"card_loss": out["cuda"][0], "cpu_loss": out["cpu"][0], "relative_difference": rel,
            "n_rays_per_batch": [out["cuda"][1], out["cpu"][1]]}


@timed
def phase_variant_kernels(he, bw, fp32_flops, frame_pos: torch.Tensor, ptxas: dict) -> dict:
    """The xadd and tcnn instantiations of hash_encode_fwd and of the exact
    hash_encode_bwd against their plain versions at base.json's spec, on
    VARIANT_CASES (uniform positions with box and cell faces) and on one
    network batch of an 800x800 Shade frame (`frame_pos`): max and mean
    error, and the gather's ms, plain ms and bound on the 2^18 set and the
    frame batch with the variant's own distinct rows (the exact scatter's:
    phase_exact_scatter). The exact scatter adds w * g with weights that are
    no dyadic fractions, in the order its atomics land, so it is held within
    HASH_EXACT_RTOL / HASH_EXACT_ATOL (x the gradient's max), not bit for
    bit."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    base = hash_spec("base")
    out = {}
    for vi, variant in enumerate(VARIANTS):
        spec = dataclasses.replace(base, variant=variant)
        L, T, F = spec.n_levels, spec.padded_size, spec.n_features
        table = torch.rand((L, T, F), generator=gen, device="cuda") * 2.0 - 1.0
        sets = {label: hash_positions(spec, n, 10 * vi + i) for i, (label, n) in enumerate(VARIANT_CASES)}
        sets["frame_batch"] = frame_pos
        res = {"fwd": {}, "max_abs_err": {"fwd": 0.0, "exact": 0.0}}
        for label, pos in sets.items():
            n = pos.shape[0]
            g = torch.randn((n, L * F), generator=gen, device="cuda")
            err = (he.hash_encode_cuda(table, pos, spec) - he.hash_encode_plain(table, pos, spec)).abs()
            ok = err.max().item() <= HASH_FWD_ATOL
            print(f"hash_encode_fwd [{variant}] {label}: N={n} max_abs_err={err.max().item():.3e} "
                  f"mean_abs_err={err.mean().item():.3e} (atol {HASH_FWD_ATOL}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"hash_encode_fwd [{variant}] disagrees with its plain version ({label})")
            kd = he.hash_bwd_exact_cuda(pos, spec, g)
            torch.cuda.synchronize()
            pd = he.hash_bwd_exact_plain(pos, spec, g)
            derr = (kd - pd).abs()
            ok = torch.allclose(kd, pd, rtol=HASH_EXACT_RTOL, atol=HASH_EXACT_ATOL * pd.abs().max().item())
            print(f"hash_encode_bwd exact [{variant}] {label}: N={n} max_abs_err={derr.max().item():.3e} "
                  f"mean_abs_err={derr.mean().item():.3e} (rtol {HASH_EXACT_RTOL}, atol {HASH_EXACT_ATOL} x max "
                  f"{pd.abs().max().item():.3e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"the exact hash_encode_bwd [{variant}] disagrees with its plain version ({label})")
            res["max_abs_err"]["fwd"] = max(res["max_abs_err"]["fwd"], err.max().item())
            res["max_abs_err"]["exact"] = max(res["max_abs_err"]["exact"], derr.max().item())
            del kd, pd, derr
            if label == VARIANT_CASES[1][0]:
                continue  # the ragged N is checked, not timed
            work = hash_work(he, spec, pos)
            res["fwd"][label] = {"ms": cuda_ms(lambda: he.hash_encode_cuda(table, pos, spec)),
                                 "plain_ms": cuda_ms(lambda: he.hash_encode_plain(table, pos, spec), reps=5), "library_ms": None,
                                 **bound(*work["fwd"], bw, fp32_flops), "distinct_rows": work["distinct_rows"]}
            r = res["fwd"][label]
            print(f"hash_encode_fwd [{variant}] on {label}: {r['ms']:.4f} ms alone, plain {r['plain_ms']:.3f} ms, bound "
                  f"{r['bound_ms']:.5f} ms ({r['bound_by']}, {r['bytes'] / 1e6:.2f} MB), {r['distinct_rows']} distinct "
                  f"(level, row) pairs")
        res["ptxas"] = instantiations(he, ptxas, "hash_encode_fwd", "hash_encode_fwd_kernel", variant)
        for inst, info in res["ptxas"].items():
            print(f"ptxas {inst} [{variant}]: {info.get('registers')} registers, {info.get('spill_stores')} B spill stores")
        out[variant] = res
    return out


def instantiations(he, ptxas: dict, src: str, kernel: str, variant: str) -> dict:
    """ptxas_summary's entries of `kernel` <F, variant> in `src` for `variant`."""
    code = he.VARIANTS.index(variant)
    return {k: v for k, v in ptxas.get(src, {}).items() if k.startswith(kernel) and k.endswith(f",{code}>")}


@timed
def phase_exact_scatter(he, bw, fp32_flops, sets: dict, ptxas: dict) -> dict:
    """The exact hash_encode_bwd of every variant at base.json's spec on the
    position sets of its paths (`sets`: 2^18 uniform positions with box and
    cell faces, one network batch of an 800x800 Shade frame, one eager tcnn
    train(1, 2**18) step's batch): held against its plain version within
    HASH_EXACT_RTOL / HASH_EXACT_ATOL (x the gradient's max) and timed, with
    its bound and the variant's distinct rows. Beside it, for information
    only, index_add_ of the same deposits (exact_deposits' flat rows and
    w * g, computed beforehand) into a zeroed flat (L * T_pad, F) gradient:
    PyTorch's own scatter on identical work. It is not the table's library
    column: no single PyTorch call computes the rows and weights too. Prints
    each instantiation's ptxas registers and spills."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    base = hash_spec("base")
    out = {}
    for variant in he.VARIANTS:
        spec = dataclasses.replace(base, variant=variant)
        L, T, F = spec.n_levels, spec.padded_size, spec.n_features
        res = {"max_abs_err": 0.0}
        for label, pos in sets.items():
            n = pos.shape[0]
            g = torch.randn((n, L * F), generator=gen, device="cuda")
            kd = he.hash_bwd_exact_cuda(pos, spec, g)
            torch.cuda.synchronize()
            pd = he.hash_bwd_exact_plain(pos, spec, g)
            err = (kd - pd).abs().max().item()
            ok = torch.allclose(kd, pd, rtol=HASH_EXACT_RTOL, atol=HASH_EXACT_ATOL * pd.abs().max().item())
            print(f"hash_encode_bwd exact [{variant}] {label}: N={n} max_abs_err={err:.3e} (rtol {HASH_EXACT_RTOL}, atol "
                  f"{HASH_EXACT_ATOL} x max {pd.abs().max().item():.3e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"the exact hash_encode_bwd [{variant}] disagrees with its plain version ({label})")
            res["max_abs_err"] = max(res["max_abs_err"], err)
            del kd, pd
            work = hash_work(he, spec, pos)
            rows, vals = he.exact_deposits(pos, spec, g)
            r = res[label] = {
                "ms": cuda_ms(lambda: he.hash_bwd_exact_cuda(pos, spec, g)),
                "plain_ms": cuda_ms(lambda: he.hash_bwd_exact_plain(pos, spec, g), reps=5),
                "library_ms": None,
                "index_add_ms": cuda_ms(lambda: torch.zeros((L * T, F), device="cuda").index_add_(0, rows, vals)),
                **bound(*work["exact"], bw, fp32_flops),
                "distinct_rows": work["distinct_rows"],
            }
            del rows, vals
            print(f"hash_encode_bwd exact [{variant}] on {label}: {r['ms']:.4f} ms alone, plain {r['plain_ms']:.3f} ms, "
                  f"index_add_ of the same deposits {r['index_add_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
                  f"({r['bound_by']}, {r['bytes'] / 1e6:.2f} MB), {r['distinct_rows']} distinct (level, row) pairs")
        res["ptxas"] = instantiations(he, ptxas, "hash_encode_bwd", "hash_bwd_exact_kernel", variant)
        for inst, info in res["ptxas"].items():
            print(f"ptxas {inst} [{variant}]: {info.get('registers')} registers, {info.get('spill_stores')} B spill stores, "
                  f"{info.get('spill_loads')} B spill loads")
        out[variant] = res
    return out


def snapshot_params(tb) -> dict:
    """A Testbed's training params on the host, the table as (L, T_pad, F)."""
    p = tb._trainer.model.params()
    return {"hash_table": p["hash_table"].detach().cpu(), "density_mlp": [w.detach().cpu() for w in p["density_mlp"]],
            "rgb_mlp": [w.detach().cpu() for w in p["rgb_mlp"]]}


@timed
def phase_interchange(Testbed, NGPModel) -> dict:
    """The reference-snapshot interchange at base.json width with the tcnn
    hash: a seeded tcnn Testbed (the serving phase's weights and blob grid)
    writes a reference-layout snapshot, a fresh Testbed loads it (params and
    grid bit-equal after the "float" round trip, over each level's rows),
    the same weights written as "__half" load as their fp16 values; then,
    with every counter zeroed just before and read just after, 800x800 Shade
    spp-1 frames from the three ring poses and one Shade spp-8 frame from
    the loaded model, one of them profiled; and small Shade and Normals
    frames of the loaded snapshot on the card against the CPU."""
    from ngp_tpu_torch.train.snapshot import pack_reference_params, read_snapshot_doc

    os.makedirs(REF_DIR, exist_ok=True)
    ref, half = f"{REF_DIR}/tcnn_ref.msgpack", f"{REF_DIR}/tcnn_ref_half.msgpack"
    src = make_testbed(Testbed, NGPModel, "cuda", "tcnn")
    t = time.perf_counter()
    src.save_snapshot(ref, False, True)
    save_s = time.perf_counter() - t
    tb = Testbed(device="cuda")
    t = time.perf_counter()
    tb.load_snapshot(ref)
    load_s = time.perf_counter() - t
    spec = tb.model.grid_spec
    if spec.variant != "tcnn":
        raise SystemExit(f"a reference snapshot loaded as hash variant {spec.variant!r}")
    a, b = snapshot_params(src), snapshot_params(tb)
    same = all(torch.equal(a["hash_table"][l, :n], b["hash_table"][l, :n]) for l, n in enumerate(spec.sizes))
    same = same and all(torch.equal(x, y) for k in ("density_mlp", "rgb_mlp") for x, y in zip(a[k], b[k], strict=True))
    grid_same = torch.equal(src.grid.density, tb.grid.density) and torch.equal(src.grid.occupancy, tb.grid.occupancy)
    flat = pack_reference_params(a, spec, tb.config.network)
    print(f"interchange: {flat.size} params ({os.path.getsize(ref) / 2**20:.1f} MiB) saved in {save_s:.2f} s, loaded in "
          f"{load_s:.2f} s; params bit-equal: {same}, grid and bitfield bit-equal: {grid_same} "
          f"{'ok' if same and grid_same else 'FAIL'}")
    if not (same and grid_same):
        raise SystemExit("the reference snapshot's float round trip changed the params or the grid")
    doc = read_snapshot_doc(ref)
    doc["snapshot"].update(params_type="__half", params_binary=flat.astype(np.float16).tobytes())
    import msgpack

    with open(half, "wb") as f:
        f.write(msgpack.packb(doc, use_bin_type=True))
    th = Testbed(device="cuda")
    th.load_snapshot(half)
    got = pack_reference_params(snapshot_params(th), spec, th.config.network)
    half_ok = np.array_equal(got, flat.astype(np.float16).astype(np.float32))
    half_err = float(np.abs(got - flat).max())
    print(f"interchange __half: the loaded params equal the fp16 values: {half_ok}; max abs change from float "
          f"{half_err:.3e} {'ok' if half_ok else 'FAIL'}")
    if not half_ok:
        raise SystemExit("the __half reference snapshot did not load as its fp16 values")
    del src, th

    w, h = FRAME
    tb.set_nerf_camera_matrix(ring_pose(POSES[0]))
    render_timed(tb, w, h, 1, "Shade")  # warm-up
    zero_counters()  # just before the main path
    frames = []
    for theta in POSES:
        tb.set_nerf_camera_matrix(ring_pose(theta))
        ms, opac, samples = render_timed(tb, w, h, 1, "Shade")
        frames.append({"mode": "Shade", "spp": 1, "theta": theta, "ms": ms, "mean_opacity": opac, "samples": samples})
    ms, opac, samples = render_timed(tb, w, h, PROTOCOL_SPP, "Shade")
    frames.append({"mode": "Shade", "spp": PROTOCOL_SPP, "theta": POSES[-1], "ms": ms, "mean_opacity": opac, "samples": samples})
    launches = counters()  # just after
    for f in frames:
        print(f"tcnn serve {w}x{h} {f}")
    missing = [k for k in SERVE_KERNELS if launches[k] < 1]
    if missing:
        raise SystemExit(f"the tcnn serving path launched no {missing} kernel")
    tb.rendering_buffer.render_mode = "Shade"
    rows = device_profile(lambda: tb.render(w, h, spp=1, to_srgb=False))
    prof = in_path(rows)
    print(f"tcnn serve launches {launches}; profiled Shade spp-1 frame: hash_encode_fwd {prof['hash_encode_fwd']} "
          f"({card_line()})")
    del tb

    ref_err = {}
    sw, sh = SMALL_FRAME
    for mode, (max_abs, mean_abs) in REF_LIMITS.items():
        imgs = []
        for device in ("cuda", "cpu"):
            t2 = Testbed(device=device)
            t2.load_snapshot(ref)
            t2.rendering_buffer.render_mode = mode
            t2.set_nerf_camera_matrix(ring_pose(POSES[1]))
            t2.render(sw, sh, spp=1, to_srgb=False)
            imgs.append(t2._accum.cpu())
        err = (imgs[0] - imgs[1]).abs()
        print(f"tcnn reference {mode} {sw}x{sh}: card vs CPU max_abs={err.max().item():.3e} mean_abs={err.mean().item():.3e} "
              f"(limits {max_abs}, {mean_abs})")
        if err.max() > max_abs or err.mean() > mean_abs or imgs[1][..., 3].max() <= 0.0:
            raise SystemExit(f"the card's tcnn {mode} frame disagrees with the CPU reference")
        ref_err[mode] = {"max_abs": err.max().item(), "mean_abs": err.mean().item()}
    shade1 = [f for f in frames if f["spp"] == 1]
    return {"n_params": int(flat.size), "save_s": save_s, "load_s": load_s, "float_round_trip_bit_equal": True,
            "half_max_abs_change": half_err, "frames": frames, "launches": launches,
            "shade_spp1_ms_per_frame": sum(f["ms"] for f in shade1) / len(shade1),
            "shade_spp1_samples_per_frame": sum(f["samples"] for f in shade1) / len(shade1),
            "hash_encode_fwd_in_frame": prof["hash_encode_fwd"], "reference": ref_err}


def check_variant_launches(label: str, launches: dict, n_steps: int):
    """A variant's training path: every kernel of VARIANT_TRAIN_KERNELS
    launched, the exact scatter at least once a step, the stochastic never."""
    missing = [k for k in VARIANT_TRAIN_KERNELS if launches[k] < 1]
    if missing:
        raise SystemExit(f"the {label} training path launched no {missing} kernel")
    if launches["hash_encode_bwd_exact"] < n_steps or launches["hash_encode_bwd_stochastic"] != 0:
        raise SystemExit(f"the {label} training path launched the exact scatter {launches['hash_encode_bwd_exact']} times "
                         f"in {n_steps} steps and the stochastic one {launches['hash_encode_bwd_stochastic']} times")


@timed
def phase_xadd_path(Testbed, NGPModel, train_json) -> dict:
    """An xadd model on the main paths, with every counter zeroed just before
    and read just after: one 800x800 Shade spp-1 frame of the seeded serving
    model, then XADD_TRAIN_CALLS train(16, 2**18) calls on the procedural
    scene; then one more call profiled (the exact scatter's time a launch)."""
    tb = make_testbed(Testbed, NGPModel, "cuda", "xadd")
    w, h = FRAME
    tb.set_nerf_camera_matrix(ring_pose(POSES[0]))
    zero_counters()  # just before the main path
    ms, opac, samples = render_timed(tb, w, h, 1, "Shade")
    serve = counters()
    tr = Testbed(device="cuda")
    tr.load_model_config_dict(variant_doc("xadd"))
    tr.load_training_data(train_json)
    calls = timed_calls(tr, XADD_TRAIN_CALLS)
    launches = counters()  # just after
    train = {k: v - serve[k] for k, v in launches.items()}
    print(f"xadd: 800x800 Shade frame {ms:.1f} ms, {samples} samples, launches {serve}; {XADD_TRAIN_CALLS} train(16, 2**18) "
          f"calls {[round(c['ms'], 1) for c in calls]} ms, losses {[c['loss'] for c in calls]}, launches {train}")
    if serve["hash_encode_fwd"] < 1 or not all(math.isfinite(c["loss"]) for c in calls):
        raise SystemExit("the xadd paths launched no gather or trained to a non-finite loss")
    check_variant_launches("xadd", train, 16 * XADD_TRAIN_CALLS)
    prof = in_path(device_profile(lambda: tr.train(16, TRAIN_BATCH)))
    print(f"xadd: profiled train(16, 2**18) call (graphed: {tr.training_buffer.graphed}): exact hash_encode_bwd "
          f"{prof['hash_encode_bwd']} ({card_line()})")
    return {"frame_ms": ms, "frame_samples": samples, "serve_launches": serve, "calls": calls, "train_launches": train,
            "launches": launches, "profile": {"graphed": tr.training_buffer.graphed, "in_path": prof}}


@timed
def phase_tcnn_train(Testbed, NGPModel, train_json, test_json) -> dict:
    """A tcnn model at base.json width trained on the procedural scene with
    TCNN_TRAIN_CALLS train(16, 2**18) calls (the loop's default, so a call
    of a steady shape replays 8 captured steps with the exact scatter
    inside), every counter zeroed just before and read just after: the
    exact hash_encode_bwd must launch at least once a step and the
    stochastic one never; one more call profiled; one eager train(1, 2**18)
    step whose exact scatter's positions are captured (returned beside the
    results); the held-out PSNR; the card-vs-CPU train() check of the TINY
    config with the tcnn hash; then the model exported as a reference-layout
    snapshot and the protocol CLI evaluating that file on the test views
    (PSNR floor PSNR_FLOOR)."""
    from ngp_tpu_torch.experiment import run as cli
    from ngp_tpu_torch.ops import hash_encoding as he

    tb = Testbed(device="cuda")
    tb.load_model_config_dict(variant_doc("tcnn"))
    tb.load_training_data(train_json)
    torch.cuda.synchronize()
    zero_counters()  # just before the main path
    calls = timed_calls(tb, TCNN_TRAIN_CALLS)
    launches = counters()  # just after
    n_steps = 16 * TCNN_TRAIN_CALLS
    for i, c in enumerate(calls):
        print(f"tcnn train call {i}: {c}")
    check_variant_launches("tcnn", launches, n_steps)
    losses = [c["loss"] for c in calls]
    if not all(math.isfinite(x) for x in losses) or not np.mean(losses[-4:]) < 0.5 * np.mean(losses[:2]):
        raise SystemExit(f"the tcnn training loss did not fall: {losses}")
    graphed = [c for c in calls[1:] if c["graphed"]]
    if not graphed:
        raise SystemExit(f"no tcnn call among calls 2-{TCNN_TRAIN_CALLS} ran a captured graph")
    median_ms = float(np.median([c["ms"] for c in graphed]))
    samples_per_s = float(np.median([16 * c["measured_batch_size"] / (c["ms"] / 1e3) for c in graphed]))
    rows = device_profile(lambda: tb.train(16, TRAIN_BATCH))
    prof, profiled_graphed = in_path(rows), tb.training_buffer.graphed
    busy = sum(r[1] for r in rows)
    print(f"tcnn train: {len(graphed)} of {TCNN_TRAIN_CALLS - 1} calls 2-{TCNN_TRAIN_CALLS} graphed, a graphed call "
          f"{median_ms:.1f} ms (median), {samples_per_s / 1e6:.2f}M samples/s; launches {launches} "
          f"({launches['hash_encode_bwd_exact'] / n_steps:.2f} exact scatters a step); profiled call (graphed: "
          f"{profiled_graphed}): device busy {busy:.1f} ms, exact hash_encode_bwd {prof['hash_encode_bwd']} "
          f"({card_line()})")
    for key, ms, count in rows[:8]:
        print(f"  {ms:9.2f} ms {count:6d}x  {key[:110]}")
    # the positions of one eager train(1, 2**18) step's batch, for phase_exact_scatter
    batch = capture_positions(he, "hash_bwd_exact_cuda", TRAIN_BATCH, lambda: tb.train(1, TRAIN_BATCH))
    if not batch:
        raise SystemExit(f"the tcnn train(1, 2**18) step ran no exact scatter of {TRAIN_BATCH} rows")
    w, h = SCENE["width"], SCENE["height"]
    psnr = psnr_view(tb, test_json, 0, w, h)
    print(f"tcnn held-out view 0 at {w}x{h}: PSNR {psnr:.2f} dB (floor {PSNR_FLOOR})")
    if not psnr > PSNR_FLOOR:
        raise SystemExit(f"the tcnn model's held-out PSNR {psnr:.2f} dB is below the floor of {PSNR_FLOOR} dB")
    reference = phase_train_reference(Testbed, NGPModel, "tcnn")

    ref = f"{REF_DIR}/cli/tcnn_trained_ref.msgpack"
    os.makedirs(os.path.dirname(ref), exist_ok=True)
    tb.save_snapshot(ref, False, True)
    del tb
    t = time.perf_counter()
    summary = cli.run(cli.parse_args(["--load_snapshot", ref, "--test_transforms", str(test_json)]))
    cli_s = time.perf_counter() - t
    print(f"CLI on the exported tcnn reference snapshot: PSNR {summary['psnr']:.2f} dB (floor {PSNR_FLOOR}), SSIM "
          f"{summary['ssim']:.4f}, FPS {summary['fps']:.2f}, {cli_s:.1f} s")
    if not summary["psnr"] > PSNR_FLOOR:
        raise SystemExit(f"the CLI's PSNR {summary['psnr']:.2f} dB on the tcnn reference snapshot is below {PSNR_FLOOR} dB")
    return {"calls": calls, "steps": n_steps, "launches": launches, "graphed_calls": len(graphed),
            "ms_per_graphed_call_median": median_ms, "samples_per_s_graphed_median": samples_per_s,
            "profile": {"graphed": profiled_graphed, "device_busy_ms": busy, "in_path": prof,
                        "top_kernels": [[k[:80], ms, c] for k, ms, c in rows[:8]]},
            "psnr_test_view_0": psnr, "reference": reference,
            "cli": {"psnr": summary["psnr"], "ssim": summary["ssim"], "fps": summary["fps"], "s": cli_s}}, batch[0]


def full_march_frame(tb, w: int, h: int) -> dict:
    """The tb's current 800x800 Shade spp-1 view as the march took it before
    the empty-space skipping: every alive ray from lattice ordinal 0, CHUNK
    points a round (march_chunk, reading the grid from packed words where
    packed_march_supported holds, as the renderer's spp-1 march does), the
    renderer's own network evaluation and
    composite. Its network samples must equal the skipping frame's (the
    same rounds stop the same rays); returns its ms, samples, lattice
    points and (N, 4) output."""
    from ngp_tpu_torch.render import renderer as rd
    from ngp_tpu_torch.grid.occupancy import packed_neighborhood
    from ngp_tpu_torch.sampling.lattice import CHUNK, march_chunk, n_lattice_points, packed_march_supported
    from ngp_tpu_torch.utils.fma import fma
    from ngp_tpu_torch.utils.qmc import ld_random_pixel_offset, ld_random_val

    r, scfg = tb._renderer, tb.config.sampler
    aabb = rd.AABB.scene(scfg.aabb_scale)
    dt, thresh = scfg.min_cone_stepsize, tb.config.render.transmittance_threshold
    cam = torch.as_tensor(tb.rendering_buffer.camera_matrix, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    t = time.perf_counter()
    o, d = rd.camera_rays(cam, w, h, (float(h), float(h)), (0.5, 0.5), ld_random_pixel_offset(0).tolist())
    r.model.prepare_inference()
    n = o.shape[0]
    t0, alive = rd.ray_start(aabb, o, d)
    seed = (torch.arange(n, dtype=torch.int64, device="cuda") * 786433) & 0xFFFFFFFF
    startt = fma(ld_random_val(0, seed), dt, t0)
    dirs_w = (d + 1.0) * 0.5
    rgb_acc = torch.zeros((n, 3), device="cuda")
    opac = torch.zeros((n,), device="cuda")
    trans = torch.ones((n,), device="cuda")
    taken = torch.zeros((n,), dtype=torch.int64, device="cuda")
    ids = torch.nonzero(alive).squeeze(1)
    samples = points = 0
    occ = tb.grid.occupancy
    packed = packed_neighborhood(scfg, occ) if packed_march_supported(scfg) else None  # as the renderer reads the grid
    for i0 in range(0, n_lattice_points(scfg), CHUNK):
        if ids.numel() == 0:
            break
        mask, _, pos, inside_end = march_chunk(scfg, aabb, occ, o[ids], d[ids], startt[ids], taken[ids], i0, packed=packed)
        points += mask.numel()
        rows, cols = torch.nonzero(mask, as_tuple=True)
        samples += rows.numel()
        sigma = torch.zeros(mask.shape, device="cuda")
        rgb = torch.zeros(mask.shape + (3,), device="cuda")
        if rows.numel():
            sigma[rows, cols], rgb[rows, cols] = r._evaluate(aabb.relative_pos(pos[rows, cols]), dirs_w[ids[rows]])
        _, _, wgt, tr = rd.composite_weights(mask, torch.where(mask, sigma * dt, 0.0), trans[ids], thresh)
        rgb_acc[ids] += (wgt[..., None] * rgb).sum(dim=1)
        opac[ids] += wgt.sum(dim=1)
        trans[ids] = tr
        tk = taken[ids] + mask.sum(dim=1)
        taken[ids] = tk
        ids = ids[inside_end & (tr >= thresh) & (tk < scfg.maximum_marching_steps)]
    out = r._shade(rgb_acc, opac, None, "Shade")
    torch.cuda.synchronize()
    return {"ms": (time.perf_counter() - t) * 1e3, "samples": samples, "points": points, "out": out}


@timed
def phase_skip(tb, frames: list) -> dict:
    """The serving phase's empty-space skipping at 800x800: the Shade spp-1
    view of the last ring pose rendered again and taken the old way
    (full_march_frame), whose network samples must equal the frame's, with
    both frames' lattice points and ms."""
    w, h = FRAME
    tb.rendering_buffer.render_mode = "Shade"
    tb.set_nerf_camera_matrix(ring_pose(POSES[-1]))
    ms, _, samples = render_timed(tb, w, h, 1, "Shade")
    points = tb._renderer.last_frame_points
    new = tb._accum.reshape(-1, 4)
    full = full_march_frame(tb, w, h)
    err = float((full.pop("out") - new).abs().max())
    print(f"skipping, {w}x{h} Shade spp 1 at theta {POSES[-1]}: kept segments {ms:.1f} ms, {samples} network samples, "
          f"{points} lattice points; the full march from t0 {full['ms']:.1f} ms, {full['samples']} samples, "
          f"{full['points']} points; max abs difference {err:.3e} ({card_line()})")
    if samples != full["samples"] or err > 1e-6:
        raise SystemExit("the frame over the kept segments takes other samples than the full march")
    shade1 = [f for f in frames if f["mode"] == "Shade" and f["spp"] == 1]
    return {"spp1": {"ms": ms, "samples": samples, "points": points}, "full_march": full, "max_abs_difference": err,
            "spp1_mean_over_poses": {k: sum(f[k] for f in shade1) / len(shade1) for k in ("ms", "samples", "points")}}


@timed
def phase_render_march(tb, bw, fp32_flops) -> dict:
    """The spp-1 renderer's march kernel (render_march) in the 800x800 Shade
    spp-1 view of the last ring pose: the frame through the kernel against
    the frame through its plain version, render_march_plain (equal, with the
    same samples and points), its launches
    a frame and each launch's rays, rows and device ms (the profiler's)
    against the bytes the launches must move: a listed ray's id (8 B) and,
    after the first launch, its taken and round (8 B) and, where the round
    is not -1, its transmittance (4 B); 32 B more (o, d, t0, k0) for a ray
    that goes on to the coarse pass; 148 B more for a marched ray (startt,
    its state written, its id in the live list, its mask row); 32 B a sample
    row; and once a frame the occupancy's cascade 0 and the pooled grid.
    Beside them the spp_march span's device ms in both frames and a plain
    round's."""
    from ngp_tpu_torch.render import march as rm
    from ngp_tpu_torch.render import renderer as rd

    w, h = FRAME
    tb.set_nerf_camera_matrix(ring_pose(POSES[-1]))
    r, scfg = tb._renderer, tb.config.sampler
    cam = torch.as_tensor(tb.rendering_buffer.camera_matrix, dtype=torch.float32, device="cuda")
    o, d = rd.camera_rays(cam, w, h, (float(h), float(h)), (0.5, 0.5), (0.5, 0.5))
    take, real = rm.render_march_takes, rm.render_march
    launches = []

    def frame(kernel: bool):
        rm.render_march_takes = take if kernel else (lambda cfg, device: False)
        try:
            out = r.render_rays(tb.grid.occupancy, cam, o, d, 0, "Shade", occ_aabb=tb.grid.occ_aabb)
        finally:
            rm.render_march_takes = take
        return out, r.last_frame_samples, r.last_frame_points

    def spy(cfg, occupancy, pooled, a, n_in, first, thresh):
        # the rays the kernel reads beyond their state: the rays whose last
        # round left them going, read before the launch rewrites the state
        if first:
            n_last = n_go = n_in
        else:
            listed = a.list_in[:n_in]
            last = a.rnd[listed] >= 0
            n_last, n_go = int(last.sum()), int((last & (a.trans[listed] >= thresh)).sum())
        real(cfg, occupancy, pooled, a, n_in, first, thresh)
        launches.append((n_in, first, n_last, n_go, a.counts))

    rm.render_march = spy
    try:
        got = frame(True)
    finally:
        rm.render_march = real
    want = frame(False)
    equal = bool(torch.equal(got[0], want[0])) and got[1:] == want[1:]
    rows = [(n_in, *(int(v) for v in c.tolist()[:2])) for n_in, _, _, _, c in launches]  # (listed, live, sample rows)
    g = scfg.grid_size
    state = sum(8 * n_in + (0 if first else 8 * n_in + 4 * n_last) + 32 * n_go
                for n_in, first, n_last, n_go, _ in launches)
    n_bytes = state + sum(148 * live + 32 * m for _, live, m in rows) + g**3 + scfg.n_cascades * (g // 8) ** 3
    ms = kernel_launch_ms(lambda: frame(True), "render_march_kernel")
    spans = {}
    for label, kernel in (("kernel", True), ("plain", False)):
        _, by = device_profile(lambda: frame(kernel), labels=("spp_march",))
        spans[label] = by["spp_march"]["kernel_ms"]
    n_rounds = len(rows) - 1  # the last launch finds every ray ended
    out = {"equal": equal, "samples": got[1], "points": got[2], "launches_per_frame": len(rows), "rounds": n_rounds,
           "launches": [{"listed": a, "live": b, "rows": c, "ms": t} for (a, b, c), t in zip(rows, ms)],
           "ms": float(np.median(ms)), "frame_kernel_ms": float(sum(ms)), **bound(n_bytes / len(rows), 0, bw, fp32_flops),
           "frame_bound_ms": n_bytes / bw * 1e3, "spp_march_ms": spans, "plain_round_ms": spans["plain"] / max(n_rounds, 1)}
    print(f"render_march {w}x{h} Shade spp 1: kernel == plain: {equal}; {len(rows)} launches ({n_rounds} rounds), "
          f"{sum(ms):.3f} ms of kernel a frame against a {out['frame_bound_ms']:.4f} ms bound ({n_bytes / 1e6:.1f} MB); "
          f"spp_march {spans['kernel']:.2f} ms a frame through the kernel, {spans['plain']:.2f} ms plain "
          f"({out['plain_round_ms']:.2f} a round); launches (listed, live, rows, ms) "
          f"{[(a, b, c, round(t, 4)) for (a, b, c), t in zip(rows, ms)]} ({card_line()})")
    if not equal:
        raise SystemExit("the renderer's march kernel disagrees with the plain march")
    return out


@timed
def phase_render_cover_march(tb, bw, fp32_flops) -> dict:
    """The spp-n Shade frame's cover march kernel (render_cover_march) in the
    800x800 Shade spp-8 view of the last ring pose, the serve path's protocol
    frame: each launch against render_cover_march_plain on copies of its
    inputs and state (the live list, the mask, adj, carried-flag and t rows,
    every row to evaluate, the listed rays' taken, round and carried state
    and the counters, all equal and in the same order), the frame through
    the kernel against the frame through the plain version (equal, with the
    same samples and points), its launches a frame and each launch's rays,
    rows and device ms (the profiler's) against the bytes the launches must
    move: a listed ray's id and state (17 B) and its P transmittances; for a
    marched ray its rays (40 B), state written, slot, its mask and adj rows,
    its 2 flags and its t row; 32 B a row; the packed words and the pooled
    grid once a launch. Beside them the spp_march span's device ms in both
    frames and a plain round's."""
    from ngp_tpu_torch.render import march as rm
    from ngp_tpu_torch.render import renderer as rd

    w, h = FRAME
    tb.set_nerf_camera_matrix(ring_pose(POSES[-1]))
    r, scfg = tb._renderer, tb.config.sampler
    cam = torch.as_tensor(tb.rendering_buffer.camera_matrix, dtype=torch.float32, device="cuda")
    o, d = rd.camera_rays(cam, w, h, (float(h), float(h)), (0.5, 0.5), (0.5, 0.5))
    take, real = rm.cover_march_takes, rm.render_cover_march
    if not take(scfg, o.device):
        raise SystemExit("base.json's frame on the card does not take render_cover_march")
    launches, mismatch = [], []

    def frame(kernel: bool):
        rm.cover_march_takes = take if kernel else (lambda cfg, device: False)
        try:
            out = r.render_rays(tb.grid.occupancy, cam, o, d, 0, "Shade", occ_aabb=tb.grid.occ_aabb, n_spp=PROTOCOL_SPP)
        finally:
            rm.cover_march_takes = take
        return out, r.last_frame_samples, r.last_frame_points

    def both(cfg, occupancy, pooled, packed, a, n_in, first, n_rounds, thresh):
        b = rm.CoverLaunch(*(t.clone() for t in a))
        rm.render_cover_march_plain(cfg, occupancy, pooled, packed, b, n_in, first, n_rounds, thresh)
        real(cfg, occupancy, pooled, packed, a, n_in, first, n_rounds, thresh)
        n_live, n_rows = a.counts.tolist()
        listed = a.list_in[:n_in]
        same = b.counts.tolist() == [n_live, n_rows]
        for name, n in (("list_out", n_live), ("mask", n_live), ("adj", n_live), ("carry", n_live), ("t", n_live),
                        ("flat", n_rows), ("pos", n_rows), ("dirs", n_rows)):
            same = same and torch.equal(getattr(a, name)[:n], getattr(b, name)[:n])
        for name in ("taken", "rnd", "carried"):
            same = same and torch.equal(getattr(a, name)[listed], getattr(b, name)[listed])
        if not same:
            mismatch.append(len(launches))
        launches.append((n_in, n_live, n_rows, a.trans.shape[-1]))

    rm.render_cover_march = both
    try:
        got = frame(True)
    finally:
        rm.render_cover_march = real
    want = frame(False)
    equal = not mismatch and bool(torch.equal(got[0], want[0])) and got[1:] == want[1:]
    g = scfg.grid_size
    grids = 4 * g**3 + scfg.n_cascades * (g // 8) ** 3
    launch_bytes = [n_in * (8 + 9 + 4 * p) + live * (40 + 9 + 8 + 2 * rm.CHUNK + 2 + 4 * rm.CHUNK) + 32 * rows + grids
                    for n_in, live, rows, p in launches]
    n_bytes = sum(launch_bytes)
    ms = kernel_launch_ms(lambda: frame(True), "render_cover_march_kernel")
    spans = {}
    for label, kernel in (("kernel", True), ("plain", False)):
        _, by = device_profile(lambda: frame(kernel), labels=("spp_march",))
        spans[label] = by["spp_march"]["kernel_ms"]
    n_rounds = sum(1 for _, live, _, _ in launches if live > 0)
    out = {"equal": equal, "mismatched_launches": mismatch, "samples": got[1], "points": got[2],
           "launches_per_frame": len(launches), "rounds": n_rounds,
           "launches": [{"listed": a, "live": b, "rows": c, "ms": t} for (a, b, c, _), t in zip(launches, ms)],
           "ms": float(np.median(ms)), "frame_kernel_ms": float(sum(ms)),
           **bound(n_bytes / len(launches), 0, bw, fp32_flops),
           "frame_bound_ms": n_bytes / bw * 1e3, "spp_march_ms": spans, "plain_round_ms": spans["plain"] / max(n_rounds, 1)}
    print(f"render_cover_march {w}x{h} Shade spp {PROTOCOL_SPP}: kernel == plain (launch by launch and the frame): "
          f"{equal}; {len(launches)} launches ({n_rounds} rounds), {sum(ms):.3f} ms of kernel a frame against a "
          f"{out['frame_bound_ms']:.4f} ms bound ({n_bytes / 1e6:.1f} MB); spp_march {spans['kernel']:.2f} ms a frame "
          f"through the kernel, {spans['plain']:.2f} ms plain ({out['plain_round_ms']:.2f} a round); launches "
          f"(listed, live, rows, ms) {[(a, b, c, round(t, 4)) for (a, b, c, _), t in zip(launches, ms)]} ({card_line()})")
    if not equal:
        raise SystemExit(f"the cover march kernel disagrees with its plain version (launches {mismatch})")
    return out


@timed
def phase_march_reference(Testbed, NGPModel) -> dict:
    """The march alone, card vs CPU: a transparent model (the density head's
    output column <= 0 under a ReLU density activation, so sigma = 0 and no
    ray stops early) renders the same rays of a small frame (computed once
    on the CPU) over the same occupancy grid at spp 1 and spp 8 on both; the
    network samples and the lattice points must be equal."""
    from ngp_tpu_torch.render.renderer import camera_rays

    w, h = SMALL_FRAME
    out, rays = {}, None
    for device in ("cpu", "cuda"):
        tb = Testbed(device=device)
        tb.load_model_config(BASE_JSON)
        params = NGPModel(tb.config.network, device="cpu").init(torch.Generator().manual_seed(0)).params()
        params["density_mlp"][-1][:, 0] = -params["density_mlp"][-1][:, 0].abs()
        tb.set_state(params, blob_density(tb.config.sampler, 1))
        r = tb._renderer
        r.density_activation = "ReLU"
        if rays is None:
            tb.set_nerf_camera_matrix(ring_pose(POSES[1]))
            cam = torch.as_tensor(tb.rendering_buffer.camera_matrix)
            o, d = camera_rays(cam, w, h, (float(h), float(h)), (0.5, 0.5), (0.5, 0.5))
            rays = (tb.grid.occupancy, tb.grid.occ_aabb, cam, o, d)
        occ, box, cam, o, d = (x.to(device) for x in rays)
        for n_spp in (1, PROTOCOL_SPP):
            r.render_rays(occ, cam, o, d, 0, "Shade", occ_aabb=box, n_spp=n_spp)
            out[(device, n_spp)] = (r.last_frame_samples, r.last_frame_points)
    res = {}
    for n_spp in (1, PROTOCOL_SPP):
        card, host = out[("cuda", n_spp)], out[("cpu", n_spp)]
        print(f"march reference {w}x{h} spp {n_spp} (transparent model, the same rays): card {card[0]} samples, "
              f"{card[1]} lattice points; CPU {host[0]} samples, {host[1]} points")
        if card != host or host[0] == 0:
            raise SystemExit(f"the card's spp-{n_spp} march differs from the CPU's")
        res[f"spp{n_spp}"] = {"samples": host[0], "points": host[1]}
    return res


@timed
def phase_adam_envmap(opt, bw, fp32_flops):
    """adam_ema on the envmap's leaf (262,144 fp32 entries) as its optimizer
    runs it: dense, L2 and eps 1e-10, EMA decay 0.99 (EnvmapConfig), bit for
    bit against its plain version, timed, with its bound: 36 B an entry (g
    read; m, v, p and e read and written), 9.4 MB, a few microseconds at the
    card's bandwidth, so the launch sets the kernel's time."""
    from ngp_tpu_torch.utils.config import EnvmapConfig

    cfg = EnvmapConfig().optimizer
    gen = torch.Generator(device="cuda").manual_seed(3)
    g = torch.randn(ENVMAP_SHAPE, generator=gen, device="cuda") * 1e-4
    g *= (torch.rand(ENVMAP_SHAPE[:2] + (1,), generator=gen, device="cuda") < 0.3).float()
    state = [torch.randn(ENVMAP_SHAPE, generator=gen, device="cuda") * s for s in (1e-5, 1e-9, 1e-1, 1e-1)]
    state[1] = state[1].abs()
    kw = dict(b1=cfg.adam.beta1, b2=cfg.adam.beta2, eps=cfg.adam.epsilon, decay=cfg.ema_decay, l2=cfg.adam.l2_reg, lazy=False)
    row = torch.tensor([1e-2, 1 - 0.9**3, 1 - 0.99**3], dtype=torch.float32, device="cuda")
    kern, plain = [s.clone() for s in state], [s.clone() for s in state]
    opt.adam_ema_cuda(g, *kern, row, **kw)
    torch.cuda.synchronize()
    opt.adam_ema_plain(g, *plain, row, **kw)
    err = max((a - b).abs().max().item() for a, b in zip(kern, plain, strict=True))
    bit_equal = all(torch.equal(a, b) for a, b in zip(kern, plain, strict=True))
    moved = bool((kern[2] != state[2])[(g == 0).expand_as(g)].all())
    n = g.numel()
    # bytes: g read, m, v, p and e read and written (36 B an entry); fp32
    # operations: L2 (2), Adam and the lr step (14), the EMA (3)
    n_bytes, n_ops = 36 * n, 19 * n
    t_bytes, t_ops = n_bytes / bw, n_ops / fp32_flops
    bufs = [s.clone() for s in state]
    timing = {
        "ms": cuda_ms(lambda: opt.adam_ema_cuda(g, *bufs, row, **kw)),
        "plain_ms": cuda_ms(lambda: opt.adam_ema_plain(g, *bufs, row, **kw)),
        "library_ms": None,  # no single PyTorch call computes Adam + L2 + lr step + EMA
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "elements": n,
        "bytes": n_bytes,
        "bit_equal": bit_equal,
        "max_abs_err": err,
    }
    print(f"adam_ema on the envmap leaf {ENVMAP_SHAPE} (dense, l2 {cfg.adam.l2_reg}, eps {cfg.adam.epsilon}): bit-equal to "
          f"plain: {bit_equal}; entries without a gradient moved: {moved}; {timing} ({card_line()})")
    if not (bit_equal and moved):
        raise SystemExit("adam_ema disagrees with its plain version on the envmap leaf")
    return err, timing


def kernel_launch_ms(fn, name: str) -> list:
    """Run fn() once under torch.profiler: the device ms of each launch of
    the kernels whose name holds `name`, in launch order."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA and name in e.name]
    return [e.time_range.elapsed_us() / 1e3 for e in sorted(events, key=lambda e: e.time_range.start)]


@timed
def phase_envmap(Testbed, NGPModel, train_json, test_json, oadd: dict) -> dict:
    """base.json with envmap.train (a 256x256 envmap) on the training scene,
    ENVMAP_CALLS train(16, 2**18) calls with every counter zeroed just before
    and read just after: adam_ema once a step per network leaf and once a
    call for the envmap (the loop's default graphs), the graphed call's
    median ms and samples/s beside the oadd call without the envmap (phase
    4), the loss trajectory, the envmap's largest value (> 0); one more call
    profiled for the envmap's adam_ema launch in path (the call's last);
    800x800 Shade spp-1 and spp-8 frames of a test view over the trained
    envmap; then a TINY train() call with an envmap card vs CPU (loss within
    TRAIN_REF_RTOL, envmap within ENVMAP_REF_REL relative L2) and small
    frames over an envmap card vs CPU (REF_LIMITS["Shade"])."""
    from ngp_tpu_torch.utils.config import load_commented_json

    tb = Testbed(device="cuda")
    tb.load_model_config_dict(dict(load_commented_json(BASE_JSON), envmap={"train": True}))
    tb.load_training_data(train_json)
    env = tb._trainer.envmap
    n_leaves = len(tb._trainer.model.param_list())
    torch.cuda.synchronize()
    zero_counters()  # just before the main path
    calls = timed_calls(tb, ENVMAP_CALLS)
    launches = counters()  # just after
    for i, c in enumerate(calls):
        print(f"envmap train call {i}: {c}")
    want_adam = 16 * ENVMAP_CALLS * n_leaves + ENVMAP_CALLS
    missing = [k for k in TRAIN_KERNELS if launches[k] < 1]
    if missing or launches["adam_ema"] != want_adam:
        raise SystemExit(f"the envmap training path launched {launches}; want every kernel of {TRAIN_KERNELS} and "
                         f"{want_adam} adam_ema ({n_leaves} a step, 1 a call)")
    losses = [c["loss"] for c in calls]
    if not all(math.isfinite(x) for x in losses) or not np.mean(losses[-4:]) < 0.5 * np.mean(losses[:2]):
        raise SystemExit(f"the envmap training loss did not fall: {losses}")
    graphed = [c for c in calls[1:] if c["graphed"]]
    if not graphed:
        raise SystemExit(f"no envmap call among calls 2-{ENVMAP_CALLS} ran a captured graph")
    median_ms = float(np.median([c["ms"] for c in graphed]))
    samples_per_s = float(np.median([16 * c["measured_batch_size"] / (c["ms"] / 1e3) for c in graphed]))
    env_max = float(env.params.abs().max())
    if not (env_max > 0 and env.optimizer.count == ENVMAP_CALLS):
        raise SystemExit(f"the envmap did not train: max |value| {env_max}, {env.optimizer.count} steps")
    adam_ms = kernel_launch_ms(lambda: tb.train(16, TRAIN_BATCH), "adam_ema_kernel")
    print(f"envmap train: {len(graphed)} of {ENVMAP_CALLS - 1} calls 2-{ENVMAP_CALLS} graphed, a graphed call "
          f"{median_ms:.1f} ms (median), {samples_per_s / 1e6:.2f}M samples/s; without the envmap (phase 4) "
          f"{oadd['ms_per_graphed_call_median']:.1f} ms, {oadd['samples_per_s_graphed_median'] / 1e6:.2f}M samples/s; "
          f"launches {launches}; envmap max |value| {env_max:.4f}; the envmap's adam_ema in path (the call's last of "
          f"{len(adam_ms)} traced launches) {adam_ms[-1] if adam_ms else None} ms ({card_line()})")

    doc = json.loads(open(test_json).read())
    tb.rendering_buffer.fov_axis = 0
    tb.fov = doc["camera_angle_x"]
    tb.set_nerf_camera_matrix(np.asarray(doc["frames"][0]["transform_matrix"], np.float32)[:3, :4])
    w, h = FRAME
    render_timed(tb, w, h, 1, "Shade")  # warm-up
    frames = {}
    for spp in (1, PROTOCOL_SPP):
        ms, opac, samples = render_timed(tb, w, h, spp, "Shade")
        acc = tb._accum
        behind = acc[..., :3][acc[..., 3] < 0.001]
        frames[f"spp{spp}"] = {"ms": ms, "samples": samples, "points": tb._renderer.last_frame_points,
                               "mean_opacity": opac, "envmap_pixels": int(behind.shape[0]),
                               "envmap_pixel_max_abs": float(behind.abs().max()) if behind.numel() else 0.0}
        print(f"envmap frame {w}x{h} Shade spp {spp}: {frames[f'spp{spp}']}")
    if not frames["spp1"]["envmap_pixel_max_abs"] > 0:
        raise SystemExit("the frame shows no envmap behind the rays that miss the scene")
    del tb
    return {"calls": calls, "launches": launches, "n_leaves": n_leaves, "graphed_calls": len(graphed),
            "ms_per_graphed_call_median": median_ms, "samples_per_s_graphed_median": samples_per_s,
            "without_envmap": {k: oadd[k] for k in ("ms_per_graphed_call_median", "samples_per_s_graphed_median")},
            "loss": losses, "envmap_max_abs": env_max, "adam_ema_envmap_in_path_ms": adam_ms[-1] if adam_ms else None,
            "frames": frames, "reference": phase_envmap_reference(Testbed, NGPModel)}


@timed
def phase_envmap_reference(Testbed, NGPModel) -> dict:
    """One train(16, 2**14) call of the TINY config with a ENVMAP_TINY
    envmap on the card and on the CPU from the same weights, grid and draws
    (loss within TRAIN_REF_RTOL, the stepped envmap within ENVMAP_REF_REL
    relative L2); then small Shade frames spp 1 and spp 8 at base.json width
    over a seeded envmap card vs CPU, within REF_LIMITS["Shade"]."""
    from ngp_tpu_torch.utils.config import load_commented_json

    train_json = f"{SCENE_DIR}_tiny/transforms_train.json"
    out = {}
    for device in ("cuda", "cpu"):
        tb = Testbed(device=device)
        tb.load_model_config_dict(dict(TINY, envmap={"train": True, "height": ENVMAP_TINY[0], "width": ENVMAP_TINY[1]}))
        params = NGPModel(tb.config.network, device="cpu").init(torch.Generator().manual_seed(0)).params()
        tb.set_state(params, np.zeros(tb.config.sampler.n_total_elements, np.float32))
        tb._trainer.sample_capacity = 1 << 15
        tb.load_training_data(train_json)
        tb.train(16, 1 << 14)
        out[device] = (tb.training_buffer.loss, tb._trainer.envmap.params.cpu())
    rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    env_rel = float((out["cuda"][1] - out["cpu"][1]).norm() / out["cpu"][1].norm())
    print(f"envmap train reference (TINY, one train(16, 2**14) call): card loss {out['cuda'][0]:.6e}, CPU loss "
          f"{out['cpu'][0]:.6e}, relative difference {rel:.2e} (limit {TRAIN_REF_RTOL}); envmap relative L2 {env_rel:.3e} "
          f"(limit {ENVMAP_REF_REL})")
    if not (rel < TRAIN_REF_RTOL and env_rel < ENVMAP_REF_REL and out["cpu"][1].abs().max() > 0):
        raise SystemExit("the card's envmap train() call disagrees with the CPU reference")
    res = {"card_loss": out["cuda"][0], "cpu_loss": out["cpu"][0], "relative_difference": rel, "envmap_rel_l2": env_rel}
    w, h = SMALL_FRAME
    doc = dict(load_commented_json(BASE_JSON), envmap={"train": True})
    texture = torch.rand(ENVMAP_SHAPE, generator=torch.Generator().manual_seed(5))
    max_abs, mean_abs = REF_LIMITS["Shade"]
    for spp in (1, PROTOCOL_SPP):
        imgs = []
        for device in ("cuda", "cpu"):
            tb = make_testbed(Testbed, NGPModel, device, doc=doc)
            tb._trainer.envmap.ema_params.copy_(texture)
            tb.set_nerf_camera_matrix(ring_pose(POSES[1]))
            tb.render(w, h, spp=spp, to_srgb=False)
            imgs.append(tb._accum.cpu())
        err = (imgs[0] - imgs[1]).abs()
        print(f"envmap reference Shade spp {spp} {w}x{h}: card vs CPU max_abs={err.max().item():.3e} "
              f"mean_abs={err.mean().item():.3e} (limits {max_abs}, {mean_abs})")
        if err.max() > max_abs or err.mean() > mean_abs or imgs[1][..., 3].min() <= 0.0:
            raise SystemExit(f"the card's spp-{spp} frame over the envmap disagrees with the CPU reference")
        res[f"frame_spp{spp}"] = {"max_abs": err.max().item(), "mean_abs": err.mean().item()}
    return res


# ------------------------------------------------------------------ phase 8
DP_DIR = "build/chip_smoke_dp"
DP_CALL_STEPS = 16  # one train(16, 2**18) call's steps, captured with the all-reduces inside
DP_WARM_CALLS = 4  # train(16, 2**18) calls that give the loop its shape and the grid its content
# the world-size-1 sharded call against the single-card call, relative, over
# one captured step; over the DP_CALL_STEPS steps of a call the stochastic
# deposit's float atomics (the single-card call's replay does not reproduce
# its first run either) compound through Adam's steps on tiny gradients, and
# the call is held to the captured-vs-eager limits of phase 4 (GRAPH_LOSS_RTOL,
# GRAPH_PARAM_REL), which answer the same cause
DP_REL = 1e-6
DP_GANG = 2  # ranks sharing the one card over gloo
DP_GANG_STEPS = 4
DP_GANG_CAPACITY = 1 << 19  # every rank's share of the samples fits its buffer (capacity // 2)
# tests/test_dp_equivalence.py:141-146. The gang sums a table row's deposits in
# another order than the single card's atomics, and where they cancel to ~0
# Adam's normalised step can flip its sign (2 x lr): at most
# DP_PARAM_OUTLIERS parameters may fall outside DP_PARAM_ATOL, the whole
# within GRAPH_PARAM_REL relative L2 (as fault g lets a few d_enc rows out)
DP_LOSS_RTOL, DP_PARAM_ATOL = 2e-4, 5e-4
DP_PARAM_OUTLIERS = 64
DP_FRAME_ATOL = 2e-3  # tests/test_end_to_end.py:224
DP_GRID_ATOL = 1e-6
DP_JOIN_S = 300


def to_cpu(obj):
    """A copy of obj with every tensor on the CPU (dicts, lists and tuples kept)."""
    if torch.is_tensor(obj):
        return obj.detach().cpu().clone()
    if isinstance(obj, dict):
        return {k: to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_cpu(v) for v in obj)
    return obj


def rel_diff(a: list, b: list) -> float:
    """Largest relative L2 difference over matching tensors (0 where both are 0)."""
    out = 0.0
    for x, y in zip(a, b, strict=True):
        den = float(y.float().norm())
        num = float((x.float() - y.float()).norm())
        out = max(out, num / den if den > 0 else num)
    return out


def dp_level_rate_1(doc: dict) -> dict:
    """base.json's document with the stochastic deposit into every level: at
    a level rate k > 1 a sample feeds the levels l with l % k == its flat
    slot % k, and a rank's slots are its own (as in ngp_tpu's shard_map), so
    a sharded step deposits into other levels than one card; at k = 1 the
    drawn corner is a function of the position alone and the sharded steps
    are the single card's up to the order of float sums. Widths unchanged."""
    net = dict(doc.get("network", {}))
    net["encoding"] = dict(net.get("encoding", {}), stochastic_level_rate=1)
    return {**doc, "network": net}


def dp_trainer(Testbed, train_json, state: dict, mesh: bool):
    """A base.json Testbed (level rate 1) on the card at `state` (training
    params, EMA, grid density), the gang's capacity; with `mesh` over the
    initialised process group."""
    from ngp_tpu_torch.utils.config import load_commented_json

    tb = Testbed(device="cuda", use_mesh=mesh)
    tb.load_model_config_dict(dp_level_rate_1(load_commented_json(BASE_JSON)))
    tb._trainer.sample_capacity = DP_GANG_CAPACITY
    tb.load_training_data(train_json)
    tb.set_state(state["params"], state["density"].cpu().numpy(), ema=state["ema"])
    return tb


def dp_gang_work(tb, state: dict, rank_of=None) -> dict:
    """What the gang and the single card each do from `state`: one grid
    update (its candidate cells and the new density), DP_GANG_STEPS eager
    steps at the state's shape with the gang's capacity from one draw table,
    and one 800x800 Shade spp-1 frame of the state's pose. rank_of: (rank,
    size) under a mesh."""
    from ngp_tpu_torch.grid.occupancy import sample_grid_positions, update_occupancy
    from ngp_tpu_torch.train.trainer import STAT_KEYS

    tr, ds = tb._trainer, tb._loop.dataset
    scfg = tr.config.sampler
    n = scfg.n_total_elements // 4
    grid0 = tr.grid.density.clone()
    salts = [2**32 - 17, 12345]
    if rank_of is None:
        pos, idx = sample_grid_positions(scfg, tr.grid.density, salts, n, n, tr.grid.step)
    else:
        r, size = rank_of
        nu = nn = n // size
        pos, idx = sample_grid_positions(scfg, tr.grid.density, salts, nu, nn, tr.grid.step, uniform_offset=r * nu,
                                         nonuniform_offset=nu * size + r * nn, n_total_global=(nu + nn) * size)
    tr.grid_update(1024, salts)
    density = tr.grid.density.clone()
    tr.grid.density.copy_(grid0)
    tr.grid = update_occupancy(scfg, tr.grid._replace(step=tr.grid.step - 1))  # back to the state's grid

    n_rays, _, s_pad, n_window, s_short, n_long, n_seg_cap = state["shape"]
    draws = torch.from_numpy(tr.draw_table(torch.Generator().manual_seed(11), DP_GANG_STEPS, 4321, n_rays)).to("cuda")
    out = torch.zeros((DP_GANG_STEPS, len(STAT_KEYS)), dtype=torch.float64, device="cuda")
    step = tr.train_step(n_rays, DP_GANG_CAPACITY, s_pad, n_window, s_short, n_long, n_seg_cap)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for k in range(DP_GANG_STEPS):
        step(ds, draws[k], out[k])
    torch.cuda.synchronize()
    steps_ms = (time.perf_counter() - t) * 1e3
    params = [p.detach().cpu() for p in tr.model.param_list()]

    # the frame from the state's EMA weights (the steps leave the renderer's model alone)
    tb.rendering_buffer.render_mode = "Shade"
    tb.set_nerf_camera_matrix(state["pose"])
    w, h = FRAME
    torch.cuda.synchronize()
    t = time.perf_counter()
    frame = torch.from_numpy(tb.render(w, h, spp=1, to_srgb=False))
    frame_ms = (time.perf_counter() - t) * 1e3
    return {"candidates": (pos.cpu(), idx.cpu()), "density": density.cpu(), "stats": out.cpu(), "params": params,
            "frame": frame, "steps_ms": steps_ms, "frame_ms": frame_ms, "samples": tb._renderer.last_frame_samples,
            "eager_reason": tb._trainer.train_call(n_rays, DP_GANG_CAPACITY, s_pad, 2, n_window, s_short, n_long,
                                                   n_seg_cap).eager_reason if rank_of else ""}


def dp_gang_rank(rank: int, size: int, train_json: str, state_path: str, rdzv: str):
    """One gloo rank on cuda:0: the gang's work from the saved state, its
    results saved beside the state."""
    import datetime

    import torch.distributed as dist

    from ngp_tpu_torch import Testbed
    from ngp_tpu_torch.ops.mlp import exact_fp32_matmul

    torch.cuda.set_device(0)
    exact_fp32_matmul()
    dist.init_process_group("gloo", init_method=f"file://{rdzv}", rank=rank, world_size=size,
                            timeout=datetime.timedelta(seconds=120))
    try:
        state = torch.load(state_path, weights_only=False)
        tb = dp_trainer(Testbed, train_json, state, mesh=True)
        if tb._trainer.mesh is None or tb._trainer.mesh.size != size or tb._renderer.mesh is None:
            raise SystemExit("Testbed(use_mesh=True) did not take the process group")
        res = dp_gang_work(tb, state, (rank, size))
        torch.save(res, os.path.join(os.path.dirname(state_path), f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@timed
def phase_dp(Testbed, train_json) -> dict:
    """Data parallelism on the one card.
    (a) A world-size-1 NCCL group: a base.json Testbed trains DP_WARM_CALLS
    train(16, 2**18) calls for its shape and grid; from one state and one
    draw table the single-card call of DP_CALL_STEPS steps (a CUDA graph) and
    make_dp_train_call's (a CUDA graph with the all-reduces inside), each
    replayed: over one step, losses, parameters, EMA and moments within
    DP_REL relative; over the call's steps within phase 4's captured-vs-eager
    limits (the single-card call's replay against its first run beside
    them); the one-rank all-reduce leaves a step's gradients bit-equal; the
    grid update through
    make_dp_grid_update against the single card's (bit-equal); the graphed
    calls' ms in turns; the all-reduces' device ms per step from a profiled
    eager sharded step; every kernel's launches in one replay of the sharded
    call, the counters zeroed just before and read just after.
    (b) DP_GANG gloo ranks spawned on cuda:0 (after the kernels are built)
    from a saved state: one grid update (candidate cells bit-equal to the
    single card's, density within DP_GRID_ATOL), DP_GANG_STEPS eager steps
    (losses within DP_LOSS_RTOL of the single card's same steps, parameters
    within DP_PARAM_ATOL but for at most DP_PARAM_OUTLIERS and within
    GRAPH_PARAM_REL relative L2; two single-card runs against each other
    beside) and one 800x800 Shade spp-1
    frame under Testbed(use_mesh=True) (within DP_FRAME_ATOL of the single
    card's). A rank that fails or outlives DP_JOIN_S fails the phase."""
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ngp_tpu_torch.parallel.mesh import make_dp_grid_update, make_dp_train_call, make_dp_train_step, make_mesh
    from ngp_tpu_torch.train.trainer import STAT_KEYS

    os.makedirs(DP_DIR, exist_ok=True)
    rdzv = os.path.abspath(os.path.join(DP_DIR, "nccl_rendezvous"))
    if os.path.exists(rdzv):
        os.remove(rdzv)
    torch.cuda.set_device(0)  # before the group: NCCL binds the current device
    dist.init_process_group("nccl", init_method=f"file://{rdzv}", rank=0, world_size=1)
    try:
        mesh = make_mesh()
        tb = Testbed(device="cuda")
        tb.load_model_config(BASE_JSON)
        tb.load_training_data(train_json)
        for _ in range(DP_WARM_CALLS):
            tb.train(16, TRAIN_BATCH)
        tr, loop, ds = tb._trainer, tb._loop, tb._loop.dataset
        shape = tuple(loop._last_shape[:7])
        n_rays, capacity, s_pad, n_window, s_short, n_long, n_seg_cap = shape
        n = DP_CALL_STEPS
        start = train_state(tr)
        table = torch.from_numpy(tr.draw_table(torch.Generator().manual_seed(5), n, 777, n_rays)).to("cuda")
        single = tr.train_call(n_rays, capacity, s_pad, n, n_window, s_short, n_long, n_seg_cap)
        sharded = make_dp_train_call(tr, mesh, n_rays, capacity, s_pad, n, n_window, s_short, n_long, n_seg_cap)
        single1 = tr.train_call(n_rays, capacity, s_pad, 1, n_window, s_short, n_long, n_seg_cap)
        sharded1 = make_dp_train_call(tr, mesh, n_rays, capacity, s_pad, 1, n_window, s_short, n_long, n_seg_cap)

        def run(call, steps):
            set_train_state(tr, start)
            out = torch.zeros((steps, len(STAT_KEYS)), dtype=torch.float64, device="cuda")
            call(ds, table[:steps], out)
            torch.cuda.synchronize()
            return out.cpu(), train_state(tr)

        k = len(tr.model.param_list())
        groups = {"params": slice(0, k), "ema": slice(k, 2 * k), "mu": slice(2 * k, 3 * k), "nu": slice(3 * k, 4 * k)}

        def diff(a, b):
            loss = float(((a[0][:, 0] - b[0][:, 0]).abs() / b[0][:, 0].abs()).max())
            return {"loss": loss, **{g: rel_diff(a[1][sl], b[1][sl]) for g, sl in groups.items()}}

        # one captured step, then the call's steps
        one_single, one_sharded = run(single1, 1), run(sharded1, 1)
        one = diff(one_sharded, one_single)
        one_bit_equal = torch.equal(one_sharded[0], one_single[0]) and all(
            torch.equal(a, b) for a, b in zip(one_sharded[1], one_single[1]))
        first = run(single, n)
        replay = diff(run(single, n), first)  # a replay of the same graph
        zero_counters()  # just before the sharded call's replay (its capture launches nothing)
        sd, pd = run(sharded, n)
        launches = counters()  # just after
        if any(c.graph is None for c in (single, sharded, single1, sharded1)):
            raise SystemExit("a training call was not captured in a CUDA graph")
        missing = [k for k in TRAIN_KERNELS if launches[k] < 1]
        if missing:
            raise SystemExit(f"the sharded call launched no {missing} kernel")
        s1, p1 = first
        vs_single = diff((sd, pd), first)
        bit_equal = all(torch.equal(a, b) for a, b in zip(pd, p1)) and torch.equal(sd, s1)
        ints_equal = bool(torch.equal(sd[:, 1:], s1[:, 1:]))
        call_ok = vs_single["loss"] <= GRAPH_LOSS_RTOL and vs_single["params"] <= GRAPH_PARAM_REL
        one_over = {g: v for g, v in one.items() if v > DP_REL}

        # the one-rank all-reduce itself: a step's gradients before and after it
        set_train_state(tr, start)
        _, _, _, grads = tr.loss_and_grads(ds, n_rays, capacity, s_pad, table[0, 2].to(torch.int64),
                                           table[0, 0:2].to(torch.int64), table[0, 3:6].to(torch.float32),
                                           n_window, s_short, n_long, n_seg_cap)
        grads = [g.detach().contiguous() for g in grads]
        before = [g.clone() for g in grads]
        mesh.all_reduce_(grads, "sum")
        torch.cuda.synchronize()
        identity = all(torch.equal(a, b) for a, b in zip(grads, before))
        del grads, before
        print(f"dp (a): world-size-1 NCCL, shape {shape}: the one-rank all-reduce leaves a step's gradients bit-equal "
              f"{identity}; one captured step, sharded vs single-card: bit-equal {one_bit_equal}, {one} (limit {DP_REL}); "
              f"{n} captured steps: bit-equal {bit_equal}, {vs_single} (limits loss {GRAPH_LOSS_RTOL}, parameters "
              f"{GRAPH_PARAM_REL}), integer stats equal {ints_equal}; the single-card call's replay against its first run "
              f"{replay} ({card_line()})")
        if not identity or not ints_equal or one_over or not call_ok:
            raise SystemExit(f"the world-size-1 sharded call differs from the single-card call: one step {one_over}, "
                             f"{n} steps {vs_single}, all-reduce identity {identity}, integer stats equal {ints_equal}")

        # the grid update: make_dp_grid_update over the group against the single card's
        set_train_state(tr, start)
        grid0 = (tr.grid.density.clone(), tr.grid.step)
        salts = [99, 2**31 + 7]
        nq = tr.config.sampler.n_total_elements // 4
        tr.grid_update(1024, salts)
        want = (tr.grid.density.clone(), tr.grid.occupancy.clone())
        tr.grid.density.copy_(grid0[0])
        tr.grid = tr.grid._replace(step=grid0[1])
        make_dp_grid_update(tr, mesh, nq, nq)(salts)
        grid_equal = torch.equal(tr.grid.density, want[0]) and torch.equal(tr.grid.occupancy, want[1])
        print(f"dp (a): make_dp_grid_update over the group vs the single card's update: bit-equal {grid_equal}")
        if not grid_equal:
            raise SystemExit("the sharded grid update differs from the single card's")

        # the graphed calls in turns: single, sharded, sharded, single
        times = {"single": [], "sharded": []}
        out = torch.zeros((n, len(STAT_KEYS)), dtype=torch.float64, device="cuda")
        for name in ("single", "sharded", "sharded", "single", "single", "sharded"):
            call = single if name == "single" else sharded
            torch.cuda.synchronize()
            t = time.perf_counter()
            call(ds, table, out)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t) * 1e3)
        # the all-reduces' device time: one eager sharded step, profiled
        step = make_dp_train_step(tr, mesh, n_rays, capacity, s_pad, n_window, s_short, n_long, n_seg_cap)
        step(ds, table[0], out[0])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step(ds, table[1], out[1])
            torch.cuda.synchronize()
        nccl = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and "nccl" in e.key.lower()]
        allreduce_ms = sum(r[1] for r in nccl)
        busy_ms = sum(e.self_device_time_total for e in prof.key_averages() if e.device_type == DeviceType.CUDA) / 1e3
        # and in a replay of the captured sharded call, where the profiler sees it
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            sharded(ds, table, out)
            torch.cuda.synchronize()
        nccl_graph = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and "nccl" in e.key.lower()]
        med = {k: float(np.median(v)) for k, v in times.items()}
        per_step = {k: v / n for k, v in launches.items()}
        print(f"dp (a): graphed {n}-step calls in turns: single-card {times['single']} ms, sharded {times['sharded']} ms "
              f"(medians {med['single']:.2f} / {med['sharded']:.2f}); all-reduce device time in one eager sharded step "
              f"{allreduce_ms:.4f} ms over {sum(r[2] for r in nccl)} kernels {nccl[:4]} (step busy {busy_ms:.2f} ms); in a "
              f"profiled replay of the captured call {nccl_graph[:4]}; launches per step of the sharded call {per_step} "
              f"({card_line()})")

        # the gang's state: the trained weights, their EMA, the grid, a view
        state = to_cpu({"params": tr.model.params(), "ema": tr.ema_params(), "density": tr.grid.density,
                        "pose": ring_pose(POSES[0]), "shape": shape})
        del tb, tr, single, sharded, single1, sharded1, step, start, first, one_single, one_sharded, p1, pd
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    state_path = os.path.abspath(os.path.join(DP_DIR, "state.pt"))
    torch.save(state, state_path)

    # (b) the single card's work, twice (its own spread), then the gang's
    ref = dp_gang_work(dp_trainer(Testbed, train_json, state, mesh=False), state)
    ref2 = dp_gang_work(dp_trainer(Testbed, train_json, state, mesh=False), state)
    torch.cuda.empty_cache()
    gang_rdzv = os.path.abspath(os.path.join(DP_DIR, "gloo_rendezvous"))
    for f in [gang_rdzv] + [os.path.join(DP_DIR, f"rank{r}.pt") for r in range(DP_GANG)]:
        if os.path.exists(f):
            os.remove(f)
    ctx = mp.get_context("spawn")
    t = time.perf_counter()
    procs = [ctx.Process(target=dp_gang_rank, args=(r, DP_GANG, train_json, state_path, gang_rdzv)) for r in range(DP_GANG)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DP_JOIN_S
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for r in hung:
        procs[r].kill()
        procs[r].join()
    gang_s = time.perf_counter() - t
    codes = [p.exitcode for p in procs]
    if hung or codes != [0] * DP_GANG:
        raise SystemExit(f"the gloo gang failed: ranks {hung} hung, exit codes {codes}")
    ranks = [torch.load(os.path.join(DP_DIR, f"rank{r}.pt"), weights_only=False) for r in range(DP_GANG)]
    got = ranks[0]
    for r in ranks[1:]:
        if not all(torch.equal(a, b) for a, b in zip(r["params"], got["params"])):
            raise SystemExit("the gang's ranks hold different parameters")
    cand_pos = torch.cat([r["candidates"][0][: len(r["candidates"][0]) // 2] for r in ranks]
                         + [r["candidates"][0][len(r["candidates"][0]) // 2 :] for r in ranks])
    cand_idx = torch.cat([r["candidates"][1][: len(r["candidates"][1]) // 2] for r in ranks]
                         + [r["candidates"][1][len(r["candidates"][1]) // 2 :] for r in ranks])
    cand_equal = torch.equal(cand_pos, ref["candidates"][0]) and torch.equal(cand_idx, ref["candidates"][1])
    dens_err = float((got["density"] - ref["density"]).abs().max())
    s, g, s2 = ref["stats"].numpy(), got["stats"].numpy(), ref2["stats"].numpy()
    loss_rel = float(np.max(np.abs(g[:, 0] - s[:, 0]) / np.abs(s[:, 0])))
    param_err = max(float((a - b).abs().max()) for a, b in zip(got["params"], ref["params"]))
    param_rel = rel_diff(got["params"], ref["params"])
    spread = {"loss_max_rel": float(np.max(np.abs(s2[:, 0] - s[:, 0]) / np.abs(s[:, 0]))),
              "param_max_abs": max(float((a - b).abs().max()) for a, b in zip(ref2["params"], ref["params"])),
              "param_rel_l2": rel_diff(ref2["params"], ref["params"]),
              "frame_max_abs": float((ref2["frame"] - ref["frame"]).abs().max())}
    outliers = sum(int(((a - b).abs() > DP_PARAM_ATOL).sum()) for a, b in zip(got["params"], ref["params"]))
    frame_err = float((got["frame"] - ref["frame"]).abs().max())
    samples = [r["samples"] for r in ranks]
    ok = (cand_equal and dens_err <= DP_GRID_ATOL and loss_rel <= DP_LOSS_RTOL and outliers <= DP_PARAM_OUTLIERS
          and param_rel <= GRAPH_PARAM_REL and frame_err <= DP_FRAME_ATOL and np.array_equal(g[:, 1:3], s[:, 1:3]))
    print(f"dp (b): {DP_GANG} gloo ranks on cuda:0 ({got['eager_reason']}): grid update candidates bit-equal {cand_equal}, "
          f"density max abs {dens_err:.3e} (limit {DP_GRID_ATOL}); {DP_GANG_STEPS} steps of shape "
          f"{state['shape'][:1] + (DP_GANG_CAPACITY,) + state['shape'][2:]}: loss max relative {loss_rel:.3e} (limit "
          f"{DP_LOSS_RTOL}), parameters max abs {param_err:.3e}, {outliers} beyond {DP_PARAM_ATOL} (limit "
          f"{DP_PARAM_OUTLIERS}), relative L2 {param_rel:.3e} (limit {GRAPH_PARAM_REL}); "
          f"two runs of the steps on the single card against each other {spread}; "
          f"measured batch equal {bool(np.array_equal(g[:, 1:3], s[:, 1:3]))}; {FRAME[0]}x{FRAME[1]} Shade spp 1 max abs "
          f"{frame_err:.3e} (limit {DP_FRAME_ATOL}), samples {samples} of {ref['samples']}; steps {got['steps_ms']:.1f} ms "
          f"(single card {ref['steps_ms']:.1f}), frame {got['frame_ms']:.1f} ms (single card {ref['frame_ms']:.1f}); "
          f"the gang {gang_s:.1f} s ({'ok' if ok else 'FAIL'}; {card_line()})")
    if not ok:
        raise SystemExit("the gloo gang disagrees with the single card")
    return {
        "world1_nccl": {
            "shape": list(shape), "steps": n, "graphed": True, "allreduce_identity": identity,
            "one_step": {"bit_equal": one_bit_equal, "vs_single": one, "limit": DP_REL},
            "bit_equal": bit_equal, "vs_single": vs_single, "single_replay_vs_first": replay,
            "limits": {"loss": GRAPH_LOSS_RTOL, "params": GRAPH_PARAM_REL}, "integer_stats_equal": ints_equal, "grid_update_bit_equal": grid_equal, "call_ms": times,
            "call_ms_median": med, "allreduce_ms_per_step": allreduce_ms, "allreduce_kernels": nccl,
            "eager_step_busy_ms": busy_ms, "allreduce_kernels_in_replay": nccl_graph, "launches_per_call": launches,
            "launches_per_step": per_step,
        },
        "gloo_gang": {
            "ranks": DP_GANG, "steps": DP_GANG_STEPS, "capacity": DP_GANG_CAPACITY, "eager_reason": got["eager_reason"],
            "candidates_bit_equal": cand_equal, "density_max_abs": dens_err, "loss_max_rel": loss_rel,
            "param_max_abs": param_err, "param_rel_l2": param_rel, "frame_max_abs": frame_err,
            "param_outliers": outliers, "single_card_spread": spread,
            "frame_samples_by_rank": samples, "frame_samples_single": ref["samples"], "steps_ms": got["steps_ms"],
            "steps_ms_single": ref["steps_ms"], "frame_ms": got["frame_ms"], "frame_ms_single": ref["frame_ms"],
            "gang_s": gang_s,
        },
        "launches": launches,
    }

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
    adam_env_err, adam_env_timing = phase_adam_envmap(opt, bw, fp32_flops)
    hash_err, hash_timing = phase_hash_kernels(he, bw, fp32_flops)
    print(f"kernel phases done; total {time.perf_counter() - t_start:.1f} s")

    # phase 3: serve
    t = time.perf_counter()
    tb, frames, serve_launches, per_pass, spp8_launches, peak_gib = phase_serve(Testbed, NGPModel)
    profile = phase_profile(tb, frames[len(POSES) - 1]["ms"])
    # the positions of one network batch of an 800x800 Shade frame (the
    # profiled view), for the path-shaped hash timing of phase 4
    w, h = FRAME
    frame_batches = capture_positions(he, "hash_encode_cuda", EVAL_BATCH, lambda: tb.render(w, h, spp=1, to_srgb=False))
    print(f"captured {len(frame_batches)} network batches of {EVAL_BATCH} samples from one {w}x{h} Shade frame")
    protocol = phase_protocol_frames(tb)
    # the empty-space skipping: the spp-1 frame against the full march, the
    # march card vs CPU on the same rays
    skip = phase_skip(tb, frames)
    render_march = phase_render_march(tb, bw, fp32_flops)
    cover_march = phase_render_cover_march(tb, bw, fp32_flops)
    del tb
    reference = phase_reference(Testbed, NGPModel)
    protocol["reference"] = phase_protocol_reference(Testbed, NGPModel)
    skip["march_reference"] = phase_march_reference(Testbed, NGPModel)
    spp8 = [f for f in protocol["frames"] if f["mode"] == "Shade"]
    skip["spp1"]["device_busy_ms"] = profile["device_busy_ms"]
    skip["spp8"] = {**{k: sum(f[k] for f in spp8) / len(spp8) for k in ("ms", "samples", "points")},
                    "device_busy_ms": protocol["profile_shade"]["device_busy_ms"]}
    print(f"skipping summary {FRAME[0]}x{FRAME[1]} ({card_line()}): Shade spp 1 (means over {len(POSES)} poses) "
          f"{skip['spp1_mean_over_poses']}, busy {profile['device_busy_ms']:.1f} ms; Shade spp {PROTOCOL_SPP} (means over "
          f"{len(spp8)} poses) {skip['spp8']}")
    print(f"serve phase {time.perf_counter() - t:.1f} s; total {time.perf_counter() - t_start:.1f} s")

    # phase 4: train
    t = time.perf_counter()
    train_tb, train = phase_train(Testbed)
    # the positions of one train(1, 2**18) step's batch (the deposit's N)
    train_batches = capture_positions(he, "hash_bwd_oadd_stochastic_cuda", TRAIN_BATCH, lambda: train_tb.train(1, TRAIN_BATCH))
    train_batch = train["batch_kernels"] = phase_train_batch(train_tb, bw, fp32_flops)
    del train_tb
    train["reference"] = phase_train_reference(Testbed, NGPModel)
    train["card"] = card
    frame_pos = frame_batches[len(frame_batches) // 2]
    path_fwd_err, path_hash = phase_path_hash(
        he, bw, fp32_flops, {"frame_batch": frame_pos, "train_batch": train_batches[0]}, hash_timing
    )
    # the xadd and tcnn instantiations of the hash kernels, on the same frame batch
    variant_kernels = phase_variant_kernels(he, bw, fp32_flops, frame_pos, ptxas)
    del frame_batches, train_batches
    print(f"train phase {time.perf_counter() - t:.1f} s; total {time.perf_counter() - t_start:.1f} s")

    # phase 5: the protocol CLI (this slice's main path)
    t = time.perf_counter()
    protocol["cli"] = phase_cli(Testbed, *train["scene_json"])
    protocol["card"] = card
    print(f"CLI phase {time.perf_counter() - t:.1f} s; total {time.perf_counter() - t_start:.1f} s")

    # phase 5b: the trainable envmap at base.json width on the same scene
    t = time.perf_counter()
    envmap = phase_envmap(Testbed, NGPModel, *train["scene_json"], train)
    envmap["adam_ema_envmap_leaf"] = {**adam_env_timing, "ms_in_path": envmap["adam_ema_envmap_in_path_ms"],
                                      "launches_per_call": 1}
    envmap["card"] = card
    print(f"envmap phase {time.perf_counter() - t:.1f} s; total {time.perf_counter() - t_start:.1f} s")

    # phase 8: data parallelism on the one card, on the same scene
    t = time.perf_counter()
    dp = phase_dp(Testbed, train["scene_json"][0])
    dp["card"] = card
    print(f"dp phase {time.perf_counter() - t:.1f} s; total {time.perf_counter() - t_start:.1f} s")

    # phase 6: the hash variants on the main paths: a tcnn model served from
    # a reference-layout snapshot, an xadd model serving and training, a
    # tcnn model trained, exported and evaluated by the CLI; then the exact
    # scatter of every variant on uniform positions, the frame batch and the
    # tcnn training step's batch
    t = time.perf_counter()
    variants = {"kernels": variant_kernels, "interchange": phase_interchange(Testbed, NGPModel),
                "xadd": phase_xadd_path(Testbed, NGPModel, train["scene_json"][0]), "card": card}
    variants["tcnn_train"], tcnn_pos = phase_tcnn_train(Testbed, NGPModel, *train["scene_json"])
    exact_sets = {"uniform": hash_positions(hash_spec("base"), TRAIN_BATCH, 0), "frame_batch": frame_pos,
                  "tcnn_train_batch": tcnn_pos}
    exact = variants["exact_scatter"] = phase_exact_scatter(he, bw, fp32_flops, exact_sets, ptxas)
    del frame_pos, tcnn_pos, exact_sets
    print(f"variant phase {time.perf_counter() - t:.1f} s; total {time.perf_counter() - t_start:.1f} s")

    # phase 7: results; `launches` counts the protocol CLI's run (this
    # slice's main path), launches_by_path each path's own run
    tl, pl, el, dl = train["launches"], protocol["cli"]["launches"], envmap["launches"], dp["launches"]

    def by_path(*names):
        return {"serve": sum(serve_launches[k] for k in names), "serve_shade_spp8_frame": sum(spp8_launches[k] for k in names),
                "train": sum(tl[k] for k in names), "protocol_cli": sum(pl[k] for k in names),
                "train_envmap": sum(el[k] for k in names),
                f"dp_sharded_call_{DP_CALL_STEPS}_steps": sum(dl[k] for k in names)}

    fwd = kernel_entry("fused_mlp_fwd", "ngp_tpu_torch/csrc/fused_mlp_fwd.cu", "ngp_tpu/ops/fused_mlp.py:91",
                       pl["fused_mlp_fwd"], fwd_err, fwd_timing)
    bwd = kernel_entry("fused_mlp_bwd", "ngp_tpu_torch/csrc/fused_mlp_bwd.cu", "ngp_tpu/ops/fused_mlp.py:107",
                       pl["fused_mlp_bwd"], bwd_err, bwd_timing)
    adam = kernel_entry("adam_ema", "ngp_tpu_torch/csrc/adam_ema.cu", "tools/mb22_optfuse.py:56",
                        pl["adam_ema"], adam_err, adam_timing)
    adam["note"] = "the step's lr, bc1 and bc2 are read from a float32 row on the card (one row a step of the call's draw table)"
    adam["max_abs_err"] = max(adam_err, adam_env_err)
    adam["envmap_leaf"] = envmap["adam_ema_envmap_leaf"]
    hfwd = kernel_entry(
        "hash_encode_fwd", "ngp_tpu_torch/csrc/hash_encode_fwd.cu",
        "tools/microbench.py:29; tools/microbench.py:54; tools/microbench.py:94; tools/microbench.py:123; "
        "tools/microbench.py:428; tools/mb23_mosaic_gather.py:53; tools/mb23_mosaic_gather.py:77; "
        "tools/mb23_mosaic_gather.py:114",
        pl["hash_encode_fwd"], max(hash_err["fwd"], path_fwd_err), hash_timing["fwd"],
    )
    bwd_names = ("hash_encode_bwd_stochastic", "hash_encode_bwd_exact")
    hbwd = kernel_entry(
        "hash_encode_bwd", "ngp_tpu_torch/csrc/hash_encode_bwd.cu", "tools/microbench.py:252; tools/microbench.py:299",
        sum(pl[k] for k in bwd_names), hash_err["stochastic"], hash_timing["stochastic"],
    )
    ex = exact["oadd"]["uniform"]
    hfwd["path_shaped"] = path_hash["fwd"]
    hbwd["path_shaped"] = path_hash["stochastic"]
    hbwd["exact"] = {"ms": ex["ms"], "plain_ms": ex["plain_ms"], "bound_ms": ex["bound_ms"], "bound_by": ex["bound_by"],
                     "library_ms": None, "max_abs_err": max(hash_err["exact"], exact["oadd"]["max_abs_err"]),
                     "path_shaped": {k: exact["oadd"][k] for k in ("frame_batch", "tcnn_train_batch")}}
    fwd["launches_by_path"] = by_path("fused_mlp_fwd")
    bwd["launches_by_path"] = by_path("fused_mlp_bwd")
    adam["launches_by_path"] = by_path("adam_ema")
    hfwd["launches_by_path"] = by_path("hash_encode_fwd")
    hbwd["launches_by_path"] = {**by_path(*bwd_names), "train_stochastic": tl[bwd_names[0]], "train_exact": tl[bwd_names[1]],
                                "protocol_cli_stochastic": pl[bwd_names[0]], "protocol_cli_exact": pl[bwd_names[1]]}
    batch_kernels = []
    for kernel in ("train_march", "train_emit"):
        timing = {**train_batch["two_level"][kernel], "plain_ms": train_batch["two_level"]["replaced_plain_ms"],
                  "library_ms": None}
        e = kernel_entry(kernel, "ngp_tpu_torch/csrc/train_batch.cu",
                         "none: XLA code of ngp_tpu/sampling/training.py:83-329 and ngp_tpu/sampling/lattice.py",
                         pl[kernel], 0.0 if train_batch["two_level"]["equal"] else float("inf"), timing)
        e["single_level"] = train_batch["single_level"][kernel]
        e["cone"] = train_batch["cone"][kernel]
        e["launches_by_path"] = by_path(kernel)
        batch_kernels.append(e)
    rmk = kernel_entry("render_march", "ngp_tpu_torch/csrc/render_march.cu",
                       "none: XLA code of ngp_tpu/render/renderer.py (_coarse_pass) and ngp_tpu/sampling/lattice.py",
                       serve_launches["render_march"], 0.0 if render_march["equal"] else float("inf"),
                       {**render_march, "plain_ms": render_march["plain_round_ms"], "library_ms": None})
    rmk["per_frame"] = {k: render_march[k] for k in ("launches_per_frame", "rounds", "frame_kernel_ms", "frame_bound_ms",
                                                     "spp_march_ms")}
    rmk["launches_by_path"] = by_path("render_march")
    rck = kernel_entry("render_cover_march", "ngp_tpu_torch/csrc/render_cover_march.cu",
                       "none: XLA code of ngp_tpu/render/renderer.py (_coarse_pass, the jitter_cover march) and "
                       "ngp_tpu/sampling/lattice.py", serve_launches["render_cover_march"],
                       0.0 if cover_march["equal"] else float("inf"),
                       {**cover_march, "plain_ms": cover_march["plain_round_ms"], "library_ms": None})
    rck["per_frame"] = {k: cover_march[k] for k in ("launches_per_frame", "rounds", "frame_kernel_ms", "frame_bound_ms",
                                                    "spp_march_ms")}
    rck["launches_by_path"] = by_path("render_cover_march")
    kernels = [fwd, bwd, adam, hfwd, hbwd, *batch_kernels, rmk, rck]
    for k in kernels:
        k["ms_in_frame"] = profile["in_path"][k["name"]]["ms_per_launch"]
        k["ms_in_step"] = train["profile"]["in_path"][k["name"]]["ms_per_launch"]
    # the cover march runs in the Shade spp-8 frame, not the profiled spp-1 one
    rck["ms_in_frame"] = protocol["profile_shade"]["in_path"]["render_cover_march"]["ms_per_launch"]
    fwd["ptxas"] = ptxas.get("fused_mlp_fwd", {})
    bwd["ptxas"] = ptxas.get("fused_mlp_bwd", {})
    # the variants' instantiations, each with the launches of its own paths
    il, xs, xt = variants["interchange"]["launches"], variants["xadd"]["serve_launches"], variants["xadd"]["train_launches"]
    tt, tprof = variants["tcnn_train"]["launches"], variants["tcnn_train"]["profile"]["in_path"]
    xprof = variants["xadd"]["profile"]["in_path"]
    for variant, launches, in_frame, in_step in (
        ("tcnn", {"serve_reference_snapshot": il, "train": tt}, variants["interchange"]["hash_encode_fwd_in_frame"], tprof),
        ("xadd", {"serve": xs, "train": xt}, None, xprof),
    ):
        vk, ek = variant_kernels[variant], exact[variant]
        for key, base, counter, src in (("fwd", hfwd, "hash_encode_fwd", "hash_encode_fwd"),
                                        ("exact", hbwd, "hash_encode_bwd_exact", "hash_encode_bwd")):
            by = {path: n[counter] for path, n in launches.items()}
            if key == "fwd":
                e = kernel_entry(f"{src}[{variant}]", base["source"], base["replaces"], sum(by.values()),
                                 vk["max_abs_err"][key], vk[key]["2^18"])
                e["path_shaped"] = {"frame_batch": vk[key]["frame_batch"]}
                e["ptxas"] = vk["ptxas"]
                e["ms_in_frame"] = in_frame["ms_per_launch"] if in_frame else None
            else:
                e = kernel_entry(f"hash_encode_bwd_exact[{variant}]", base["source"], base["replaces"], sum(by.values()),
                                 max(vk["max_abs_err"][key], ek["max_abs_err"]), ek["uniform"])
                e["path_shaped"] = {k: ek[k] for k in ("frame_batch", "tcnn_train_batch")}
                e["ptxas"] = ek["ptxas"]
                e["ms_in_frame"] = None
            e["ms_in_step"] = in_step[src]["ms_per_launch"]
            e["launches_by_path"] = by
            kernels.append(e)
    for k in kernels:
        print(f"{k['name']}: {k['ms']:.4f} ms alone, {k['ms_in_frame']} ms a launch in the profiled frame, "
              f"{k['ms_in_step']} ms a launch in the profiled train() call (bound {k['bound_ms']:.4f} ms)")
    shade1 = [f for f in frames if f["mode"] == "Shade" and f["spp"] == 1]
    serve = {
        "frame": list(FRAME),
        "config": BASE_JSON,
        "shade_spp1_ms_per_frame": sum(f["ms"] for f in shade1) / len(shade1),
        "shade_spp1_samples_per_frame": sum(f["samples"] for f in shade1) / len(shade1),
        "frames": frames,
        "spp1_passes": sum(1 for f in frames if f["spp"] == 1),
        "launches": serve_launches,
        "launches_per_pass": per_pass,
        "launches_shade_spp8_frame": spp8_launches,
        "peak_memory_gib": peak_gib,
        "profile": profile,
        "reference": reference,
        "skip": skip,
        "card": card,
    }
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"serve": serve}))
    print(json.dumps({"train": train}))
    print(json.dumps({"protocol": protocol}))
    print(json.dumps({"variants": variants}))
    print(json.dumps({"envmap": envmap}))
    print(json.dumps({"dp": dp}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
