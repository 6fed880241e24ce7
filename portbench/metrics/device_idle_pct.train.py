"""device_idle_pct.train: 1 - the union of the device's operations over the traced training stretch's span, in %."""


def read(run):
    if not run.traced_calls or run.trace is None or not run.trace.ops:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
