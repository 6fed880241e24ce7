"""frame_ms_p90: the 90th percentile of every window frame's own time (host clock, ending on the numpy frame), in ms."""

import numpy as np


def read(run):
    return float(np.percentile([f["ms"] for f in run.frames], 90)) if len(run.frames) >= 10 else None
