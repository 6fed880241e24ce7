"""sync_idle_ms.train: device idle ms a traced training step inside the port's train.sync.* spans (the
host readbacks of the occupied box, the probe and the stats): the trace's idle gaps intersected with them."""

from portbench.harness.spans import idle_under


def read(run):
    steps = sum(c["steps"] for c in run.traced_calls)
    if not steps or run.trace is None or not run.trace.ops:
        return None
    s = idle_under(run.trace, "train.sync.")
    return None if s is None else s * 1e3 / steps
