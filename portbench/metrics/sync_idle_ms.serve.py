"""sync_idle_ms.serve: device idle ms a traced frame inside the port's render.sync.* spans (each
nonzero, boolean-mask index, readback of a device value and blocking copy of a frame): the trace's idle
gaps intersected with them."""

from portbench.harness.spans import idle_under


def read(run):
    if not run.traced_frames or run.trace is None or not run.trace.ops:
        return None
    s = idle_under(run.trace, "render.sync.")
    return None if s is None else s * 1e3 / len(run.traced_frames)
