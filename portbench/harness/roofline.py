"""Peaks, the least time of a piece of work, and the NGP heads' operations
and bytes a sample.

`bound` is a frozen copy of chip_smoke.py:960 (`bound`, commit ef1215de9ec9),
with the tensor-core peak in place of the fp32 one (the heads' products run
on bf16 operands). `PEAKS` is chip_smoke.py:274's table: NVIDIA's data
sheets, dense rates without sparsity, at the full 700 W power limit.
"""

# (memory bytes/s, bf16 dense tensor FLOP/s) by card
PEAKS = {
    "H100 PCIe": (2.0e12, 756e12),
    "H100 NVL": (3.9e12, 835e12),
    "H100": (3.35e12, 989e12),
}


def peaks(device_name: str) -> tuple:
    for key, val in PEAKS.items():
        if key in device_name:
            return val
    raise KeyError(f"no peak rates known for {device_name!r}")


def bound(n_bytes: float, n_ops: float, bw: float, flops: float) -> dict:
    """The least time of the work: its bytes over the memory rate or its
    operations over the compute rate, whichever is longer."""
    t_bytes, t_ops = n_bytes / bw, n_ops / flops
    return {"bound_s": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "ops": n_ops}


def head_dims(model: dict) -> dict:
    """The real (unpadded) widths of both heads from a config document."""
    net = model["network"]
    enc = net["encoding"]
    d_in = int(enc["n_levels"]) * int(enc.get("n_features_per_level", 2))
    d_sh = int(net["dir_encoding"].get("degree", 4)) ** 2
    d_dens = 16  # the density head's outputs (the first is sigma, all feed the rgb head)
    dn, rn = net["network"], net["rgb_network"]
    dens = [d_in] + [int(dn["n_neurons"])] * int(dn["n_hidden_layers"]) + [d_dens]
    rgb = [d_dens + d_sh] + [int(rn["n_neurons"])] * int(rn["n_hidden_layers"]) + [3]
    return {"d_in": d_in, "d_sh": d_sh, "d_dens": d_dens, "density": dens, "rgb": rgb}


def mlp_macs(model: dict) -> int:
    """Multiply-adds of both heads' forward for one sample (no biases)."""
    d = head_dims(model)
    return sum(a * b for widths in (d["density"], d["rgb"]) for a, b in zip(widths, widths[1:]))


def mlp_flops(model: dict, trained: bool) -> float:
    """Operations a sample: the forward's 2 x MACs, three times that trained
    (the backward's products for the inputs' and the weights' gradients).
    The hash encoding and the SH basis are left out."""
    return 2.0 * mlp_macs(model) * (3 if trained else 1)


def mlp_bytes(model: dict, backward: bool) -> float:
    """Bytes a sample that the fused kernel must move, each read or written
    once: the forward reads the encoding and the SH basis and writes rgb and
    the density head's outputs; the backward reads the same inputs and both
    output gradients and writes the encoding's gradient. Weights are left
    out (a few KB a launch)."""
    d = head_dims(model)
    fwd = d["d_in"] + d["d_sh"] + 3 + d["d_dens"]
    return 4.0 * (fwd + d["d_in"] if backward else fwd)


def mlp_step_bound_s(model: dict, n_samples: float, bw: float, flops: float) -> float:
    """Least time of one training step's heads (forward and backward) on
    n_samples network samples."""
    fwd = bound(n_samples * mlp_bytes(model, False), n_samples * mlp_flops(model, False), bw, flops)
    bwd = bound(n_samples * mlp_bytes(model, True), n_samples * 2.0 * mlp_flops(model, False), bw, flops)
    return fwd["bound_s"] + bwd["bound_s"]


def union_seconds(intervals) -> float:
    """Length of the union of [start, end) intervals (any unit in, same out)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals, start: float, end: float) -> list:
    """[(gap start, gap length)] of [start, end) not covered by any interval."""
    gaps, t = [], start
    for s, e in sorted(intervals):
        if s > t:
            gaps.append((t, s - t))
        t = max(t, e)
    if end > t:
        gaps.append((t, end - t))
    return gaps
