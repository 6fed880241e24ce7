"""device_idle_pct.serve: 1 - the union of the device's operations over the traced frames' span, in %."""


def read(run):
    if not run.traced_frames or run.trace is None or not run.trace.ops:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
