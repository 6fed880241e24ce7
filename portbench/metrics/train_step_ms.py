"""train_step_ms: the window's seconds over the training steps its calls completed, in ms."""


def read(run):
    steps = sum(c["steps"] for c in run.calls)
    return run.window_s * 1e3 / steps if steps else None
