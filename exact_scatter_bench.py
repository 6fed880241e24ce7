"""Time builds of the exact hash-grid scatter against each other on one card.

Run from the repository root:

    python3 exact_scatter_bench.py LABEL=PATH [LABEL=PATH ...]

Each PATH is a version of ngp_tpu_torch/csrc/hash_encode_bwd.cu (the
checkout's, or an earlier commit's unpacked with `git show`), built with
nvcc for sm_90a against the checkout's csrc/hash_grid.cuh into
build/exact_scatter_bench/ and loaded with ctypes in place of the port's own
library, so hash_bwd_exact_cuda (zero fill included) launches its
hash_encode_bwd_exact entry. At base.json's hash spec, for each variant
(oadd, xadd, tcnn), every build is held against hash_bwd_exact_plain (rtol
and atol x max 1e-5, as chip_smoke.py holds it) and timed alone with CUDA
events on three position sets: 2^18 uniform positions with box and cell faces
(chip_smoke.hash_positions), one network batch of an 800x800 Shade frame of
the smoke's seeded serving model, and the batch of one eager tcnn
train(1, 2**18) step on the smoke's procedural scene after WARM_CALLS calls.
The builds are timed in the order A B .. B A and each build's mean is
printed; then the tcnn variant by level group (the spec cut to one group's
levels, each group timed alone), where the time of the whole goes. Then each build's device time a launch inside a profiled tcnn
train(16, 2**18) call that replays CUDA graphs captured with that build, in
the same order. Prints the card's name and power limit, then one JSON line
{"exact_scatter_bench": {...}}; exits non-zero without CUDA, if a build
fails or disagrees with the plain version.
"""

import ctypes
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs

OUT_DIR = Path("build/exact_scatter_bench")
WARM_CALLS = 6  # tcnn train(16, 2**18) calls before the training batch is captured
MAX_GRAPH_TRIES = 4  # calls a build may take to replay its own captured graph


def build(builds: dict) -> dict:
    """{label: loaded library}, one nvcc per source, all started together;
    prints each build's ptxas lines for hash_bwd_exact_kernel."""
    from ngp_tpu_torch.ops import kernels as kb

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, src in builds.items():
        out = OUT_DIR / f"lib{label}.so"
        cmd = [kb._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler",
               "-fPIC", "-Xptxas", "-v", "-I", str(kb.CSRC), "-o", str(out), str(src)]
        procs[label] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), out)
    libs = {}
    for label, (proc, out) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {builds[label]} ({proc.returncode}):\n{err}")
        for inst, info in cs.ptxas_summary(err).items():
            if inst.startswith("hash_bwd_exact_kernel"):
                print(f"[{label}] ptxas {inst}: {info.get('registers')} registers, {info.get('spill_stores')} B spill stores")
        libs[label] = ctypes.CDLL(str(out))
    return libs


def use(lib):
    """Make the port's wrappers launch `lib`'s entries."""
    from ngp_tpu_torch.ops import kernels as kb

    kb._LIBS["hash_encode_bwd"] = lib


def position_sets(he) -> tuple:
    """The three position sets, and a tcnn Testbed trained on the scene."""
    from ngp_tpu_torch import Testbed
    from ngp_tpu_torch.data.synthetic import write_synthetic_dataset
    from ngp_tpu_torch.models.ngp import NGPModel
    from ngp_tpu_torch.render.renderer import EVAL_BATCH

    spec = cs.hash_spec("base")
    sets = {"uniform": cs.hash_positions(spec, cs.TRAIN_BATCH, 0)}
    tb = cs.make_testbed(Testbed, NGPModel, "cuda")
    tb.set_nerf_camera_matrix(cs.ring_pose(cs.POSES[-1]))
    w, h = cs.FRAME
    frame = cs.capture_positions(he, "hash_encode_cuda", EVAL_BATCH, lambda: tb.render(w, h, spp=1, to_srgb=False))
    sets["frame_batch"] = frame[len(frame) // 2]
    del tb, frame
    train_json, _ = write_synthetic_dataset(cs.SCENE_DIR, **cs.SCENE, device="cuda")
    tr = Testbed(device="cuda")
    tr.load_model_config_dict(cs.variant_doc("tcnn"))
    tr.load_training_data(train_json)
    for _ in range(WARM_CALLS):
        tr.train(16, cs.TRAIN_BATCH)
    batch = cs.capture_positions(he, "hash_bwd_exact_cuda", cs.TRAIN_BATCH, lambda: tr.train(1, cs.TRAIN_BATCH))
    if not batch:
        raise SystemExit(f"the tcnn train(1, {cs.TRAIN_BATCH}) step ran no exact scatter of {cs.TRAIN_BATCH} rows")
    sets["tcnn_train_batch"] = batch[0]
    return sets, tr


def alone(he, libs: dict, sets: dict) -> dict:
    """{variant: {set: {label: ms}}}: each build checked, then timed A B .. B A."""
    base = cs.hash_spec("base")
    order = list(libs) + list(libs)[::-1]
    gen = torch.Generator(device="cuda").manual_seed(9)
    out = {}
    for variant in he.VARIANTS:
        spec = dataclasses.replace(base, variant=variant)
        out[variant] = {}
        for name, pos in sets.items():
            g = torch.randn((pos.shape[0], spec.n_output_dims), generator=gen, device="cuda")
            want = he.hash_bwd_exact_plain(pos, spec, g)
            atol = cs.HASH_EXACT_ATOL * want.abs().max().item()
            for label, lib in libs.items():
                use(lib)
                got = he.hash_bwd_exact_cuda(pos, spec, g)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                if not torch.allclose(got, want, rtol=cs.HASH_EXACT_RTOL, atol=atol):
                    raise SystemExit(f"[{label}] the exact scatter [{variant}] disagrees with its plain version on {name}: {err:.3e}")
            del want
            runs = {label: [] for label in libs}
            for label in order:
                use(libs[label])
                runs[label].append(cs.cuda_ms(lambda: he.hash_bwd_exact_cuda(pos, spec, g)))
            out[variant][name] = {label: float(np.mean(ms)) for label, ms in runs.items()}
            print(f"exact [{variant}] on {name} (N={pos.shape[0]}): "
                  + ", ".join(f"{label} {ms} ms" for label, ms in runs.items()))
    return out


def level_groups(spec) -> list:
    """(first, last) levels of each of the kernels' level groups (8 / F levels)."""
    size = 8 // spec.n_features
    return [(a, min(a + size, spec.n_levels)) for a in range(0, spec.n_levels, size)]


def by_group(he, libs: dict, sets: dict) -> dict:
    """{set: {label: [ms of each level group alone]}} for the tcnn variant:
    the spec cut to one group's levels, g to their columns, A B .. B A."""
    base = dataclasses.replace(cs.hash_spec("base"), variant="tcnn")
    order = list(libs) + list(libs)[::-1]
    gen = torch.Generator(device="cuda").manual_seed(10)
    F = base.n_features
    out = {}
    for name, pos in sets.items():
        g_all = torch.randn((pos.shape[0], base.n_output_dims), generator=gen, device="cuda")
        runs = {label: [] for label in libs}
        for a, b in level_groups(base):
            spec = dataclasses.replace(base, n_levels=b - a, **{k: getattr(base, k)[a:b] for k in ("scales", "resolutions", "dense", "sizes", "offsets")})
            g = g_all[:, a * F : b * F].contiguous()
            ms = {label: [] for label in libs}
            for label in order:
                use(libs[label])
                ms[label].append(cs.cuda_ms(lambda: he.hash_bwd_exact_cuda(pos, spec, g)))
            for label in libs:
                runs[label].append(float(np.mean(ms[label])))
        out[name] = runs
        print(f"exact [tcnn] on {name} by level group {level_groups(base)}: "
              + ", ".join(f"{label} {[round(x, 4) for x in ms]} ms" for label, ms in runs.items()))
    return out


def in_graphed_call(libs: dict, tr) -> dict:
    """{label: [device ms a launch of the exact scatter in a profiled
    graphed tcnn train(16, 2**18) call]}, A B .. B A."""
    order = list(libs) + list(libs)[::-1]
    out = {label: [] for label in libs}
    for label in order:
        use(libs[label])
        tr._trainer.drop_graphs()
        for _ in range(MAX_GRAPH_TRIES):
            tr.train(16, cs.TRAIN_BATCH)
            if tr.training_buffer.graphed:
                break
        rows = cs.device_profile(lambda: tr.train(16, cs.TRAIN_BATCH))
        if not tr.training_buffer.graphed:
            raise SystemExit(f"[{label}] the profiled tcnn call replayed no captured graph")
        prof = cs.in_path(rows)["hash_encode_bwd"]
        busy = sum(r[1] for r in rows)
        print(f"[{label}] graphed tcnn call: exact scatter {prof['ms_per_launch']:.4f} ms a launch over {prof['launches']}, "
              f"device busy {busy:.1f} ms")
        out[label].append({"ms_per_launch": prof["ms_per_launch"], "launches": prof["launches"], "busy_ms": busy})
    return out


def main():
    if not torch.cuda.is_available():
        print("exact_scatter_bench: CUDA is not available", file=sys.stderr)
        return 1
    builds = dict(arg.split("=", 1) for arg in sys.argv[1:])
    if not builds:
        raise SystemExit(__doc__)
    from ngp_tpu_torch.ops import hash_encoding as he
    from ngp_tpu_torch.ops.mlp import exact_fp32_matmul

    exact_fp32_matmul()
    t = time.perf_counter()
    card = cs.card_line()
    print(card)
    libs = build(builds)
    print(f"built {list(libs)} in {time.perf_counter() - t:.1f} s")
    sets, tr = position_sets(he)
    result = {"card": card, "builds": builds, "sets": {k: int(v.shape[0]) for k, v in sets.items()},
              "alone_ms": alone(he, libs, sets), "tcnn_by_level_group_ms": by_group(he, libs, sets),
              "in_graphed_tcnn_call": in_graphed_call(libs, tr)}
    print(card)
    print(json.dumps({"exact_scatter_bench": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
