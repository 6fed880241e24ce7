"""A traced stretch of a run: every device operation, the program's spans,
and the host's events, from one torch.profiler trace.

The profiling follows chip_smoke.py:687 (`device_profile`, commit
ef1215de9ec9): CPU and CUDA activities, a synchronise inside the profiled
region, device rows from the events whose device type is CUDA, a label's
device time from the kernels launched inside its record_function ranges.
Here the stretch is bracketed by a range of its own, whose host start and
end give the traced window on the same clock as the kernels.
"""

from dataclasses import dataclass, field

from portbench.harness.roofline import idle_gaps, union_seconds

STRETCH = "portbench_stretch"

# the kernels built from ngp_tpu_torch/csrc (the hand-written ones): the
# hash gather and deposits (hash_encode_fwd.cu, hash_encode_bwd.cu), the
# heads (fused_mlp_fwd.cu, fused_mlp_bwd.cu) and the optimizer (adam_ema.cu)
HASH_KERNELS = ("hash_encode_fwd_kernel", "hash_bwd_stochastic_kernel", "hash_bwd_exact_kernel")
MLP_KERNELS = ("fused_mlp_fwd_kernel", "fused_mlp_bwd_kernel", "reduce_blocks_kernel")
CSRC_KERNELS = frozenset(HASH_KERNELS + MLP_KERNELS + ("adam_ema_kernel",))


def op_label(name: str) -> str:
    """A device operation's name without 'void', anonymous namespaces and its
    argument list: 'void (anonymous namespace)::hash_encode_fwd_kernel<2,
    0>(float const*, ...)' -> 'hash_encode_fwd_kernel<2, 0>'."""
    s = name.replace("(anonymous namespace)::", "").strip()
    if s.startswith("void "):
        s = s[5:]
    depth = 0
    for i, ch in enumerate(s):  # cut at the argument list's "(", outside template brackets
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            return s[:i].strip()
    return s


def kernel_base(name: str) -> str:
    """'void (anonymous namespace)::hash_encode_fwd_kernel<2, 0>(float const*, ...)' -> 'hash_encode_fwd_kernel'."""
    return op_label(name).split("<", 1)[0].rsplit("::", 1)[-1].strip()


def is_csrc(name: str) -> bool:
    return kernel_base(name) in CSRC_KERNELS


@dataclass
class Trace:
    """Times in seconds on the profiler's clock."""

    ops: list  # [(name, start, end)] device operations (kernels, copies, fills)
    start: float  # the stretch's host start and end
    end: float
    span_device_s: dict = field(default_factory=dict)  # {span label: device seconds of its kernels}
    host: list = field(default_factory=list)  # [(name, start, end)] host events, for labelling gaps

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy_s(self) -> float:
        return union_seconds([(max(s, self.start), min(e, self.end)) for _, s, e in self.ops if e > self.start and s < self.end])

    def device_s(self, select) -> float:
        return sum(e - s for name, s, e in self.ops if select(name))

    def top_ops(self, n: int = 10) -> list:
        by = {}
        for name, s, e in self.ops:
            key = op_label(name)[:160]
            by[key] = by.get(key, 0.0) + (e - s)
        return sorted(([k, v] for k, v in by.items()), key=lambda r: -r[1])[:n]

    def top_gaps(self, n: int = 10) -> list:
        """The longest idle stretches of the device, each named by the
        innermost host event open where it starts."""
        gaps = sorted(idle_gaps([(s, e) for _, s, e in self.ops], self.start, self.end), key=lambda g: -g[1])[:n]
        out = []
        for t, length in gaps:
            open_ = [(s, name) for name, s, e in self.host if s <= t < e and name != STRETCH]
            out.append([max(open_)[1] if open_ else "host outside any op", length])
        return out


def profile_stretch(fn, labels=()) -> Trace:
    """Run fn() once under torch.profiler and return its Trace; `labels` are
    record_function names whose kernels' device time is summed."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        with record_function(STRETCH):
            fn()
            if cuda:
                torch.cuda.synchronize()
    events = prof.events()
    names = set(labels) | {STRETCH}
    ops, host, span_s = [], [], {label: 0.0 for label in labels}
    start = end = None
    for e in events:
        t0, t1 = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.device_type == DeviceType.CUDA:
            if e.name in names or getattr(e, "is_user_annotation", False):
                continue
            ops.append((e.name, t0, t1))
        elif e.device_type == DeviceType.CPU:
            if e.name == STRETCH:
                start, end = t0, t1
            elif e.name in span_s:
                span_s[e.name] += e.device_time_total * 1e-6
            host.append((e.name, t0, t1))
    if start is None:
        raise RuntimeError("the profiler recorded no host range for the traced stretch")
    return Trace(ops=ops, start=start, end=end, span_device_s=span_s, host=host)
