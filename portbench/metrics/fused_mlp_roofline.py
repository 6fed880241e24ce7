"""fused_mlp_roofline: the least time of the traced steps' heads (forward and
backward on each step's measured samples: roofline.mlp_step_bound_s) over the
device time of the MLP kernels, in %."""

from portbench.harness.roofline import mlp_step_bound_s
from portbench.harness.trace import MLP_KERNELS, kernel_base


def read(run):
    if not run.traced_calls or run.trace is None or not run.trace.ops:
        return None
    bw, flops = run.peaks
    least = sum(c["steps"] * mlp_step_bound_s(run.model, c["measured"], bw, flops) for c in run.traced_calls)
    spent = run.trace.device_s(lambda name: kernel_base(name) in MLP_KERNELS)
    return 100.0 * least / spent if spent > 0 else None
