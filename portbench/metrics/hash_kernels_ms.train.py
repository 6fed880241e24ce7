"""hash_kernels_ms.train: device ms a traced training step of the hash gather and deposit kernels."""

from portbench.harness.trace import HASH_KERNELS, kernel_base


def read(run):
    steps = sum(c["steps"] for c in run.traced_calls)
    if not steps or run.trace is None or not run.trace.ops:
        return None
    ms = run.trace.device_s(lambda name: kernel_base(name) in HASH_KERNELS) * 1e3
    return ms / steps if ms > 0 else None
