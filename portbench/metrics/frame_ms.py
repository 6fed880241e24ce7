"""frame_ms: the window's seconds over the frames it completed, in ms."""


def read(run):
    return run.window_s * 1e3 / len(run.frames) if run.frames else None
