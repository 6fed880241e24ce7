"""grid_update_ms.train: device ms a traced training step of the once-a-call grid update: the kernels that the
port's train.grid_update span launched (it runs eagerly, up to the occupied box's readback train.sync.grid_box),
from the device trace, over the traced calls' steps."""

from portbench.harness.spans import device_s_launched_in


def read(run):
    steps = sum(c["steps"] for c in run.traced_calls)
    if not steps or run.trace is None or not run.trace.ops:
        return None
    s = device_s_launched_in(run.trace, "train.grid_update", "train.sync.grid_box")
    return None if s is None else s * 1e3 / steps
