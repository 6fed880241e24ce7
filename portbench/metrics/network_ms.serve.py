"""network_ms.serve: device ms a traced frame of the kernels under the renderer's spp_network spans:
the network on the frame's samples."""


def read(run):
    if not run.traced_frames or run.trace is None or not run.trace.ops:
        return None
    s = run.trace.span_device_s.get("spp_network", 0.0)
    return s * 1e3 / len(run.traced_frames) if s > 0 else None
