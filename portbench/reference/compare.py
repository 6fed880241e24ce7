"""The numbers `correct` compares, each held against its limit.

Training, the first three steps of the first call against the reference,
and (prefixed `call_`) the first steps of a call of the timed path with its
grid update, against the reference from the port's state there:
  loss_gap    the widest relative gap of a step's loss sum
  grad_gap    the first gradient, as the optimizer took it: the widest gap
              between the two norms of a leaf, over the larger of the
              reference's norm of that leaf and its median leaf's norm
  change_gap  the same, of each leaf's change over the three steps
  grid_gap    the density grid after the call's grid update: relative L2
Leaves whose reference gradient is under a thousandth of the median leaf's
take no part in grad_gap and change_gap (moved by round-off alone).

Serving (the sampled frames of the window, against the reference's):
  pixel_gap_mean  mean absolute gap of the RGBA frame (0..1), the worst frame
  pixel_gap_max   widest absolute gap of a pixel's channel
A frame's network samples are not compared: the float8 control moves them
no more than the port's own rounding does (PERF.md, the limits).
"""

import math

import numpy as np
import torch

NEGLIGIBLE_GRAD = 1e-3  # a leaf below this share of the median leaf's gradient norm moves by round-off


def _norms(leaves) -> list:
    return [float(torch.linalg.vector_norm(x.detach().double())) for x in leaves]


def leaf_gaps(prog: list, ref: list, keep: list) -> dict:
    """{kept leaf: | |prog_i| - |ref_i| | / max(|ref_i|, median |ref|)}."""
    np_, nr = _norms(prog), _norms(ref)
    med = float(np.median([nr[i] for i in keep]))
    return {i: abs(np_[i] - nr[i]) / max(nr[i], med, 1e-30) for i in keep}


def change_gaps(prog, ref, keep: list) -> dict:
    return leaf_gaps([a.double() - b.double() for a, b in zip(prog.params, prog.params0)],
                     [a.double() - b.double() for a, b in zip(ref.params, ref.params0)], keep)


def kept_leaves(ref_grad: list) -> list:
    norms = _norms(ref_grad)
    med = float(np.median(norms))
    return [i for i, n in enumerate(norms) if n >= NEGLIGIBLE_GRAD * med]


def train_numbers(prog, ref) -> dict:
    """prog, ref: follow.TrainRecord."""
    lp = prog.stats[:, 0].double().cpu()
    lr = ref.stats[:, 0].double().cpu()
    loss = float(torch.max(torch.abs(lp - lr) / torch.clamp(torch.abs(lr), min=1e-30)))
    keep = kept_leaves(ref.grad)
    grad = max(leaf_gaps(prog.grad, ref.grad, keep).values())
    change = max(change_gaps(prog, ref, keep).values())
    dg = prog.grid.double() - ref.grid.double()
    grid = float(torch.linalg.vector_norm(dg) / torch.clamp(torch.linalg.vector_norm(ref.grid.double()), min=1e-30))
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change, "grid_gap": grid}


def serve_numbers(prog_frames: list, ref_frames: list) -> dict:
    """[image] of the port and of the reference, frame by frame."""
    mean = worst = 0.0
    for ip, ir in zip(prog_frames, ref_frames, strict=True):
        d = np.abs(np.asarray(ip, np.float64) - np.asarray(ir, np.float64))
        mean = max(mean, float(d.mean()))
        worst = max(worst, float(d.max()))
    return {"pixel_gap_mean": mean, "pixel_gap_max": worst}


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number finite and at most
    its limit; a number the limits file does not name fails. A number whose
    limit the file gives as null is reported and not compared: its sound runs
    and its control or faults gave no two readings to set a limit between
    (PERF.md names each, with its readings)."""
    out, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name)
        if limit is None and name in limits:
            out[name] = {"value": value, "limit": None}
            continue
        good = limit is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        out[name] = {"value": value, "limit": limit}
    return ok, out
