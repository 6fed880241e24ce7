"""torch_ops_ms.serve: device ms a traced frame of every operation not built from ngp_tpu_torch/csrc."""

from portbench.harness.trace import is_csrc


def read(run):
    if not run.traced_frames or run.trace is None or not run.trace.ops:
        return None
    return run.trace.device_s(lambda name: not is_csrc(name)) * 1e3 / len(run.traced_frames)
