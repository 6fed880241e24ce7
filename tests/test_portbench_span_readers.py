"""The benchmark's readers of the port's spans and counters
(portbench/metrics/*, portbench/harness/spans.py) on a synthetic run: the
records, counters and trace a traced stretch would leave, and None where
nothing was traced or the port has no such span or counter."""

import pytest

from ngp_tpu_torch.utils import profiling
from portbench.harness import spans
from portbench.harness.cell import Run
from portbench.harness.spec import load_reader
from portbench.harness.trace import Trace

TRAIN = ("grid_update_ms.train", "batch_gen_ms.train", "forward_ms.train", "backward_ms.train", "optimizer_ms.train",
         "sync_idle_ms.train")
SERVE = ("march_ms.serve", "network_ms.serve", "composite_ms.serve", "host_syncs.serve", "sync_idle_ms.serve")
ALL = TRAIN + SERVE + ("data_load_s",)


def _record(kind, device_ms=None, device_n=None, counters=None):
    return {"kind": kind, "seq": 1, "spans": [], "device_ms": device_ms or {}, "device_n": device_n or {},
            "counters": counters or {}}


@pytest.fixture
def port(monkeypatch):
    """The port's profiling module holding the given records and counters."""

    def install(recs=(), counters=None):
        monkeypatch.setattr(profiling, "records", lambda kind=None: [r for r in recs if kind in (None, r["kind"])])
        monkeypatch.setattr(profiling, "counters", lambda: dict(counters or {}))

    return install


def _run(calls=(), frames=(), trace=None):
    run = Run(cell=None, device_name="NVIDIA H100 80GB HBM3", peaks=(3.35e12, 989e12))
    run.traced_calls, run.traced_frames, run.trace = list(calls), list(frames), trace
    return run


def _train_trace():
    """1 s of stretch: the grid update's kernels over [0, 0.3) and, after its range, [0.31, 0.38); the box's
    readback copy [0.38, 0.4) inside the train.sync.grid_box range [0.35, 0.55), which holds 0.15 s of the
    idle [0.4, 0.6); the steps' kernels [0.6, 0.9); the stats' sync [0.95, 1.0) holds 0.05 s of idle."""
    ops = [("k", 0.0, 0.3), ("k", 0.31, 0.38), ("Memcpy DtoH (Device -> Pageable)", 0.38, 0.4), ("k", 0.6, 0.9)]
    host = [("train.grid_update", 0.0, 0.3), ("train.sync.grid_box", 0.35, 0.55), ("train.sync.stats", 0.95, 1.0),
            ("train.steps", 0.0, 1.0)]
    return Trace(ops=ops, start=0.0, end=1.0, host=host)


def test_the_training_readers(port):
    """The step phases read the graphed calls' records alone (an eager call's
    events also time the host's launches); the grid update reads the kernels
    its range launched, from the trace."""
    steps = [{"steps": 16, "ms": 140.0, "graphed": True, "measured": 2.6e5}] * 3
    graphed = _record("train", {"train.grid_update": 1.6, "step.batch": 8.0, "step.forward": 4.0, "step.backward": 12.0,
                                "step.optimizer": 2.0}, {"train.grid_update": 1, "step.batch": 8, "step.forward": 8,
                                                         "step.backward": 8, "step.optimizer": 8},
                      {"train.calls": 1, "train.graphed_calls": 1})
    eager = _record("train", {"train.grid_update": 1.6, "step.batch": 80.0}, {"train.grid_update": 1, "step.batch": 16},
                    {"train.calls": 1, "train.eager.shape.s_pad": 1})
    port([graphed, eager, graphed])
    run = _run(steps, trace=_train_trace())
    got = {m: load_reader(m)(run) for m in TRAIN}
    assert got["grid_update_ms.train"] == pytest.approx((0.3 + 0.07) * 1e3 / 48)
    assert got["batch_gen_ms.train"] == pytest.approx(1.0)
    assert got["forward_ms.train"] == pytest.approx(0.5)
    assert got["backward_ms.train"] == pytest.approx(1.5)
    assert got["optimizer_ms.train"] == pytest.approx(0.25)
    assert got["sync_idle_ms.train"] == pytest.approx((0.15 + 0.05) * 1e3 / 48)
    port([eager])
    assert load_reader("batch_gen_ms.train")(run) is None  # no graphed call traced


def test_the_serving_readers(port):
    port([_record("render", counters={"render.host_syncs": 40}), _record("render", counters={"render.host_syncs": 44}),
          _record("train", counters={"render.host_syncs": 1000})])
    ops = [("k", 0.0, 0.3), ("k", 0.4, 1.0), ("k", 1.2, 2.0)]
    host = [("render.sync.samples", 0.25, 0.45), ("render.sync.readback", 1.0, 1.1), ("spp_march", 0.0, 0.5)]
    trace = Trace(ops=ops, start=0.0, end=2.0, span_device_s={"spp_march": 0.6, "spp_network": 0.2, "spp_composite": 0.4},
                  host=host)
    run = _run(frames=[{"ms": 1000.0, "samples": 1, "points": 1}] * 2, trace=trace)
    got = {m: load_reader(m)(run) for m in SERVE}
    assert got == pytest.approx({"march_ms.serve": 300.0, "network_ms.serve": 100.0, "composite_ms.serve": 200.0,
                                 "host_syncs.serve": 42.0, "sync_idle_ms.serve": (0.1 + 0.1) * 1e3 / 2})


def test_data_load_s_reads_the_counter(port):
    port(counters={"data.load_s": 3.5})
    assert load_reader("data_load_s")(_run()) == 3.5
    port(counters={})
    assert load_reader("data_load_s")(_run()) is None


def test_nothing_traced_reads_none(port):
    port([_record("train", {"step.batch": 1.0}, {"step.batch": 1}, {"train.graphed_calls": 1}),
          _record("render", counters={"render.host_syncs": 3})])
    run = _run()
    for m in TRAIN + SERVE:
        assert load_reader(m)(run) is None, m


def test_a_port_without_the_spans_reads_none(port, monkeypatch):
    """An older port: no profiling module, no sync ranges in the trace, no spp-1 stage ranges."""
    monkeypatch.setattr(spans, "port_profiling", lambda: None)
    trace = Trace(ops=[("k", 0.0, 0.5)], start=0.0, end=1.0, span_device_s={"spp_march": 0.0}, host=[("aten::nonzero", 0.5, 0.9)])
    calls = [{"steps": 16, "ms": 1.0, "graphed": True, "measured": 1.0}]
    frames = [{"ms": 1.0, "samples": 1, "points": 1}]
    for m in ALL:
        assert load_reader(m)(_run(calls, frames, trace)) is None, m


def test_idle_under_counts_only_idle_inside_the_ranges():
    trace = Trace(ops=[("k", 0.0, 1.0), ("k", 0.5, 2.0), ("k", 3.0, 4.0)], start=0.0, end=5.0,
                  host=[("render.sync.a", 1.5, 3.5), ("render.sync.b", 2.5, 3.2), ("other", 0.0, 5.0)])
    assert spans.idle_under(trace, "render.sync.") == pytest.approx(1.0)  # [2, 3) of the idle [2, 3) + [4, 5)
    assert spans.idle_under(trace, "train.sync.") is None
