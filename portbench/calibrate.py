"""Readings for the limits of `correct`, at a cell's own size, many seeds in
one process:

    python3 portbench/calibrate.py --workload <name> --seeds 11 12 ... [--control N] [--faults N]

For each seed it prints one JSON line: the port's numbers against the
reference (the lower readings), and for the first N seeds the control's
(the reference at float8 operands in the port's place: the upper readings)
and, for a training cell, the fault "half of the batch left out, the mean
taken over the rest" planted in the port's checked call. The training
readings take the first call's steps and the checked call after the full
set-up and `--window` seconds of calls; the serving readings take the cell's first
`check_frames` window poses after the full set-up. Lines also go to
chiprun_out/calibrate_<workload>.jsonl. The benchmark's runs never call this.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


@contextlib.contextmanager
def half_batch():
    """The port's step trains on the first half of its rays and takes the
    mean over them."""
    from ngp_tpu_torch.train.trainer import Trainer

    orig = Trainer.loss_and_grads

    def half(self, ds, n_rays, capacity, s_pad, n_rays_shift, salts, bg_srgb, n_window=0, s_short=0, n_long=0,
             n_seg_cap=0, n_rays_denom=0, stride_denom=0, index_offset=0):
        return orig(self, ds, n_rays // 2, capacity, s_pad, n_rays_shift, salts, bg_srgb, n_window, s_short,
                    n_long // 2, n_seg_cap, n_rays // 2, stride_denom or n_rays, index_offset)

    Trainer.loss_and_grads = half
    try:
        yield
    finally:
        Trainer.loss_and_grads = orig


def train_readings(cell, seed: int, device, control: bool, fault: bool, tweak=None, window_s: float = 0.0) -> dict:
    """The port's numbers against the reference after the cell's full set-up
    and `window_s` seconds of the window's calls: the first call's first
    steps, then the checked call of the timed path; with `control`, the
    reference at float8 in the port's place on both; with `fault`, a second
    checked call with half of its batch left out."""
    from portbench.harness import cell as C
    from portbench.reference import compare, follow

    t = cell.traffic
    steps, batch, n = int(t["steps_per_call"]), int(t["batch"]), int(t["follow_steps"])
    program = C.prepare(cell, seed, device, tweak)
    tb = program.tb
    t_end = time.perf_counter() + window_s
    while time.perf_counter() < t_end:
        tb.train(steps, batch)
    prog, shape, params0 = program.first.record(C.leaves(program.params0)), program.first.shape, program.params0
    call_inp, call_prog, graphed = C.check_call(tb, steps, batch, n)
    if fault:
        with half_batch():
            fault_inp, fault_prog, _ = C.check_call(tb, steps, batch, n)
    del tb, program
    C.free(device)
    sc = cell.config["scene"]
    ds = follow.load_dataset(C.scenes.ensure_scene(sc, device), sc["scale"], sc["offset"], device)

    def numbers(first, call):
        return {**compare.train_numbers(*first), **{f"call_{k}": v for k, v in compare.train_numbers(*call).items()}}

    ref = C.follow_reference(cell, seed, shape, params0, device, ds=ds)
    ref_call = C.follow_checked_call(cell, call_inp, device, ds=ds)
    out = {"program": numbers((prog, ref), (call_prog, ref_call))}
    keep = compare.kept_leaves(ref_call.grad)
    out["call_leaves"] = {"kept": keep, "grad": compare.leaf_gaps(call_prog.grad, ref_call.grad, keep),
                          "change": compare.change_gaps(call_prog, ref_call, keep)}
    if control:
        ctrl = C.follow_reference(cell, seed, shape, params0, device, "float8", ds=ds)
        ctrl_call = C.follow_checked_call(cell, call_inp, device, "float8", ds=ds)
        out["control"] = numbers((ctrl, ref), (ctrl_call, ref_call))
        del ctrl, ctrl_call
    if fault:
        del ref, ref_call
        C.free(device)
        ref_fault = C.follow_checked_call(cell, fault_inp, device, ds=ds)
        out["half_batch"] = {f"call_{k}": v for k, v in compare.train_numbers(fault_prog, ref_fault).items()}
    out["shape"], out["call_shape"], out["call_i_step"], out["graphed"] = (
        list(shape), list(call_inp.shape), call_inp.i_step, graphed)
    return out


def serve_readings(cell, seed: int, device, control: bool, tweak=None) -> dict:
    from portbench.harness import cell as C
    from portbench.reference import compare

    t = cell.traffic
    program = C.prepare(cell, seed, device, tweak)
    tb = program.tb
    pose_of = C.frame_poses(t, cell.config["scene"], seed)
    poses = [pose_of(k) for k in range(int(t["check_frames"]))]
    frames, samples = [], []
    C.set_rendering(tb, t)
    for pose in poses:
        tb.set_nerf_camera_matrix(pose)
        frames.append(tb.render(*C.render_request(t)))
        samples.append(int(tb._renderer.last_frame_samples))
    state = C.served_state(tb)
    del tb, program
    C.free(device)
    ref = C.render_reference(cell, state, poses, device)
    out = {"program": compare.serve_numbers(frames, [img for img, _ in ref]),
           "samples": {"program": samples, "reference": [s for _, s in ref]}}
    if control:
        ctrl = C.render_reference(cell, state, poses, device, "float8")
        out["control"] = compare.serve_numbers([img for img, _ in ctrl], [img for img, _ in ref])
        out["samples"]["control"] = [s for _, s in ctrl]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=0, help="seeds (the first ones) that also read the control")
    ap.add_argument("--faults", type=int, default=0, help="seeds that also read the planted faults")
    ap.add_argument("--window", type=float, default=0.0, help="seconds of the window's train() calls before the check")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench.harness.spec import load_cell

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    cell = load_cell(args.workload)
    log = ROOT / "chiprun_out" / f"calibrate_{args.workload}.jsonl"
    log.parent.mkdir(exist_ok=True)
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        if cell.traffic["kind"] == "train":
            out = train_readings(cell, seed, "cuda", i < args.control, i < args.faults, window_s=args.window)
        else:
            out = serve_readings(cell, seed, "cuda", i < args.control)
        line = json.dumps({"workload": args.workload, "seed": seed, "s": time.perf_counter() - t0, **out})
        print(line, flush=True)
        with log.open("a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
