"""torch_ops_ms.train: device ms a traced training step of every operation not built from ngp_tpu_torch/csrc."""

from portbench.harness.trace import is_csrc


def read(run):
    steps = sum(c["steps"] for c in run.traced_calls)
    if not steps or run.trace is None or not run.trace.ops:
        return None
    return run.trace.device_s(lambda name: not is_csrc(name)) * 1e3 / steps
