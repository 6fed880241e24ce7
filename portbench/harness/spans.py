"""The port's own spans and counters (ngp_tpu_torch/utils/profiling.py), as
the per-layer metrics read them.

The port keeps a record of every request made while tracing is active; in a
run that is exactly the traced stretch, since torch.profiler records there
and nowhere else. A port without that module (an older checkout) reads None
everywhere, and so do spans or counters it does not have.
"""

from portbench.harness.roofline import idle_gaps


def port_profiling():
    """The port's profiling module, or None where the port has none."""
    try:
        from ngp_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling


def records(kind: str) -> list:
    """The port's request records of `kind` ("train" or "render"); [] where there are none."""
    p = port_profiling()
    return p.records(kind) if p is not None else []


def device_ms(recs: list, name: str) -> tuple:
    """(device ms, timed spans) of the span `name` summed over the records `recs`."""
    return sum(r["device_ms"].get(name, 0.0) for r in recs), sum(r["device_n"].get(name, 0) for r in recs)


def graphed_step_ms(name: str):
    """Device ms a training step of the phase `name`, the mean over the steps
    that the traced calls replayed from CUDA graphs timed (the events captured
    in the graph); None where no traced call was graphed. A step run eagerly
    is left out: its events also time the host's launches."""
    recs = [r for r in records("train") if r["counters"].get("train.graphed_calls")]
    ms, n = device_ms(recs, name)
    return ms / n if n else None


def counter(name: str):
    """The port's process counter `name`; None where the port has none."""
    p = port_profiling()
    return None if p is None else p.counters().get(name)


def idle_under(trace, prefix: str):
    """Device idle seconds of the traced stretch that fall inside host ranges
    whose name starts with `prefix` (the program's sync spans); None where
    the stretch has no such range."""
    ranges = sorted((max(s, trace.start), min(e, trace.end)) for name, s, e in trace.host
                    if name.startswith(prefix) and e > trace.start and s < trace.end)
    if not ranges:
        return None
    merged = []
    for s, e in ranges:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    total = 0.0
    for t, length in idle_gaps([(s, e) for _, s, e in trace.ops], trace.start, trace.end):
        for s, e in merged:
            total += max(0.0, min(e, t + length) - max(s, t))
    return total


def device_s_launched_in(trace, name: str, until: str):
    """Device seconds of the operations an eager section launched: each op
    that starts inside a host range `name`, or after it up to the end of the
    first host range `until` that opens after it (the sync that waits for
    them), that sync's own copy to the host excepted. The section starts on
    an idle card (the call before ended on a sync), and the card starts no
    op before its launch, so the ops between are the section's. None where
    the stretch has no such range."""
    ranges = sorted((s, e) for n, s, e in trace.host if n == name and e > trace.start and s < trace.end)
    if not ranges:
        return None
    syncs = sorted((s, e) for n, s, e in trace.host if n == until)
    total = 0.0
    for s, e in ranges:
        stop = next((se for ss, se in syncs if ss >= e), e)
        total += sum(oe - os for op, os, oe in trace.ops if s <= os < stop and not op.startswith("Memcpy DtoH"))
    return total
