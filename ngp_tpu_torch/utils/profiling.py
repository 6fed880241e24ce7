"""Spans and counters of the port: where a request's host time and device
time go, and how often things happen.

Counterpart: ngp_tpu/utils/profiling.py (ScopeTimer, trace, annotate), on
torch. Tracing is *active* while `enable()` is on or while torch.profiler
records; otherwise `span`, `phases` and `request` are one flag check and a
shared no-op context.

- `span(name, device=False)`: while active, a record of the name, the host
  start and end (time.perf_counter_ns), the enclosing span and the request
  id, and, while the profiler records, a torch.profiler record_function of
  the same name, so the span sits in the device trace on that trace's clock.
  With `device=True` it also times the device between two CUDA events.
- `phases()` / `phase(name)`: consecutive device spans that partition a
  stretch of work; a boundary is one event, the end of one phase and the
  start of the next. A device span or phase inside a CUDA graph capture
  opened through `capture()` records timing events with `external=True`,
  whether or not tracing is active: the graph then times its own phases on
  every replay, and the caller keeps the events with its graph and hands
  them to `replayed()` after each replay.
- `request(kind)`: opened around one train() call or one frame; while
  active it appends one record to a bounded ring when it ends: the kind, a
  sequence number (the request id), its spans with their device ms, the
  device ms and the number of timed spans by name, and the counters'
  changes over the request. Device ms are read when the request ends, after
  its own last readback, so reading them adds no synchronisation.
- `count(name, n)` and `add(name, seconds)`: process totals, always on.
  `host_sync(layer, site, n)` counts n host<->device synchronisations at a
  site and spans them as `<layer>.sync.<site>`.
- `records(kind)`, `counters()` and `reset()` read and clear.

There is no exporter: torch.profiler's export_chrome_trace shows the spans.
"""

import collections
import itertools
import threading
import time

import torch

RING = 256  # request records kept, the oldest dropped first

_enabled = False
_counts: dict = collections.defaultdict(int)
_records: collections.deque = collections.deque(maxlen=RING)
_ids = itertools.count(1)
_local = threading.local()


class _Null:
    """The shared no-op context of an inactive span, phase block or request."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def enable(on: bool = True):
    """Trace whether or not torch.profiler records (an operator's switch)."""
    global _enabled
    _enabled = bool(on)


def active() -> bool:
    return _enabled or torch.autograd._profiler_enabled()


def _state():
    st = _local.__dict__
    if not st:
        st.update(stack=[], request=None, phases=None, capture=None)
    return _local


def _event_pair(start=None):
    """Two timing events (the first `start` if given): external inside a
    capture opened through capture(); plain in a request off any capture;
    None where nothing is timed."""
    st = _state()
    if st.capture is not None:
        external = True
    elif st.request is None or not torch.cuda.is_initialized() or torch.cuda.is_current_stream_capturing():
        return None
    else:
        external = False
    first = start if start is not None else torch.cuda.Event(enable_timing=True, external=external)
    return first, torch.cuda.Event(enable_timing=True, external=external)


class _Span:
    """A span while tracing is active (or a device span inside a capture)."""

    __slots__ = ("name", "traced", "device", "start_ns", "end_ns", "parent", "request", "events", "captured", "_rf",
                 "device_ms")

    def __init__(self, name: str, traced: bool, device: bool):
        self.name, self.traced, self.device = name, traced, device
        self.start_ns = self.end_ns = 0
        self.parent = self.request = self.events = self._rf = self.device_ms = None
        self.captured = False

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6

    def open(self, start_event=None):
        st = _state()
        if self.traced:
            self.parent = st.stack[-1].name if st.stack else None
            self.request = st.request.id if st.request is not None else None
            st.stack.append(self)
            if torch.autograd._profiler_enabled():
                self._rf = torch.profiler.record_function(self.name)
                self._rf.__enter__()
        if self.device:
            self.events = _event_pair(start_event)
            self.captured = st.capture is not None
            if self.events is not None and start_event is None:
                self.events[0].record()
        self.start_ns = time.perf_counter_ns()
        return self

    def close(self):
        self.end_ns = time.perf_counter_ns()
        st = _state()
        if self.events is not None:
            self.events[1].record()
            if self.captured:
                st.capture.append((self.name, *self.events))
        if self.traced:
            if self._rf is not None:
                self._rf.__exit__(None, None, None)
                self._rf = None
            if st.stack and st.stack[-1] is self:
                st.stack.pop()
            if st.request is not None:
                st.request.spans.append(self)
        return False

    __enter__ = open

    def __exit__(self, *exc):
        return self.close()


class _Timer:
    """A timed() block while tracing is off: its host duration alone."""

    __slots__ = ("start_ns", "end_ns")

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6

    def __enter__(self):
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        return False


def span(name: str, device: bool = False):
    """A span named `name` (see the module's doc); device=True times the
    device too."""
    if active():
        return _Span(name, True, device)
    if device and _state().capture is not None:
        return _Span(name, False, True)
    return _NULL


def timed(name: str):
    """A span whose host duration (`.ms`) is always taken."""
    return _Span(name, True, False) if active() else _Timer()


def host_sync(layer: str, site: str, n: int = 1):
    """`n` host<->device synchronisations at `site` (each nonzero, boolean
    mask index, readback of a device value or blocking copy to the card),
    for a layer whose sync count a metric reads: counts them into
    `<layer>.host_syncs` and `<layer>.host_syncs.<site>`, and spans them as
    `<layer>.sync.<site>`; n = 0 is nothing. A sync that is only timed is a
    plain span of that name."""
    if not n:
        return _NULL
    _counts[f"{layer}.host_syncs"] += n
    _counts[f"{layer}.host_syncs.{site}"] += n
    return _Span(f"{layer}.sync.{site}", True, False) if active() else _NULL


class _Phases:
    """A block of consecutive device phases (phases(), phase())."""

    __slots__ = ("traced", "open_span", "saved")

    def __init__(self, traced: bool):
        self.traced, self.open_span = traced, None

    def __enter__(self):
        st = _state()
        self.saved, st.phases = st.phases, self
        return self

    def next(self, name: str | None):
        prev = self.open_span
        if prev is not None:
            prev.close()
        shared = prev.events[1] if prev is not None and prev.events is not None else None
        self.open_span = None if name is None else _Span(name, self.traced, True).open(shared)

    def __exit__(self, *exc):
        self.next(None)
        _state().phases = self.saved
        return False


def phases():
    """Open a block of phases; phase(name) inside it starts the next one
    where the last one ends, and leaving the block ends the last."""
    if active():
        return _Phases(True)
    if _state().capture is not None:
        return _Phases(False)
    return _NULL


def phase(name: str):
    """End the open phase of the innermost phases() block and open `name`
    at the same point (nothing outside such a block)."""
    ph = _state().phases
    if ph is not None:
        ph.next(name)


class _Capture:
    """capture(): collects the device spans' external events of a CUDA graph capture."""

    __slots__ = ("events", "saved")

    def __enter__(self):
        st = _state()
        self.events, self.saved = [], st.capture
        st.capture = self.events
        return self.events

    def __exit__(self, *exc):
        _state().capture = self.saved
        return False


def capture():
    """Around a CUDA graph capture: yields the list that receives (name,
    start event, end event) of every device span the capture records."""
    return _Capture()


def replayed(events: list):
    """A graph holding `events` (from capture()) was replayed: the open
    request times its device spans from this replay (the last one wins)."""
    req = _state().request if events else None
    if req is not None:
        req.replayed = events


class _Request:
    __slots__ = ("kind", "id", "spans", "replayed", "before", "saved")

    def __init__(self, kind: str):
        self.kind, self.id, self.spans, self.replayed = kind, next(_ids), [], ()

    def __enter__(self):
        st = _state()
        self.before = dict(_counts)
        self.saved, st.request = st.request, self
        return self

    def __exit__(self, *exc):
        _state().request = self.saved
        device_ms, device_n = collections.defaultdict(float), collections.defaultdict(int)
        timed_events = [(s, s.name, s.events) for s in self.spans if s.events is not None and not s.captured]
        timed_events += [(None, name, (a, b)) for name, a, b in self.replayed]
        for s, name, (a, b) in timed_events:
            try:
                ms = a.elapsed_time(b)
            except RuntimeError:  # not reached by the request's readback
                continue
            if s is not None:
                s.device_ms = ms
            device_ms[name] += ms
            device_n[name] += 1
        before = self.before
        _records.append({
            "kind": self.kind,
            "seq": self.id,
            "spans": [{"name": s.name, "start_ns": s.start_ns, "end_ns": s.end_ns, "parent": s.parent,
                       "request": s.request, "device_ms": s.device_ms} for s in self.spans],
            "device_ms": dict(device_ms),
            "device_n": dict(device_n),
            "counters": {k: v - before.get(k, 0) for k, v in _counts.items() if v != before.get(k, 0)},
        })
        return False


def request(kind: str):
    """One request (a train() call, a frame): a record when tracing is active."""
    return _Request(kind) if active() else _NULL


def count(name: str, n: int = 1):
    """Add n to the process counter `name` (always on)."""
    _counts[name] += n


def add(name: str, seconds: float):
    """Add seconds to the process total `name` (always on)."""
    _counts[name] += seconds


def records(kind: str | None = None) -> list:
    """The kept request records, oldest first (of one kind, if given)."""
    return [r for r in _records if kind is None or r["kind"] == kind]


def counters() -> dict:
    return dict(_counts)


def get(name: str, default=0):
    return _counts.get(name, default)


def reset():
    """Clear the records and the counters."""
    _records.clear()
    _counts.clear()
