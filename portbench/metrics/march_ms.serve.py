"""march_ms.serve: device ms a traced frame of the kernels under the renderer's spp_march spans:
the march: camera rays, frame geometry, the coarse pass, each round's march and its
index bookkeeping."""


def read(run):
    if not run.traced_frames or run.trace is None or not run.trace.ops:
        return None
    s = run.trace.span_device_s.get("spp_march", 0.0)
    return s * 1e3 / len(run.traced_frames) if s > 0 else None
