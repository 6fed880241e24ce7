"""The port's spans and counters (ngp_tpu_torch/utils/profiling.py) on the CPU:
the module inactive, enabled and under torch.profiler, then the spans and
counters of a tiny training call and of tiny spp-1 and spp-n frames."""

import numpy as np
import pytest
import torch

from ngp_tpu_torch.utils import profiling

torch.set_num_threads(2)

# tests/test_end_to_end.py:19-27
TINY = {
    "samlper": {"aabb_scale": 1, "grid_size": 32, "maximum_marching_steps": 256},
    "network": {
        "encoding": {"n_levels": 8, "log2_hashmap_size": 14, "base_resolution": 16, "desired_resolution": 256},
        "network": {"n_neurons": 64, "n_hidden_layers": 1},
        "dir_encoding": {"degree": 4},
        "rgb_network": {"n_neurons": 64, "n_hidden_layers": 2},
    },
}
STEP_PHASES = ("step.batch", "step.forward", "step.backward", "step.optimizer")


@pytest.fixture
def clean():
    profiling.enable(False)
    profiling.reset()
    yield
    profiling.enable(False)
    profiling.reset()


class FakeEvent:
    """Stands in for a timing CUDA event: elapsed_time is the difference of two stamps."""

    def __init__(self, t_ms, ready=True):
        self.t, self.ready = t_ms, ready

    def elapsed_time(self, other):
        if not (self.ready and other.ready):
            raise RuntimeError("cudaErrorNotReady")
        return other.t - self.t


def _by_name(rec):
    return {s["name"]: s for s in rec["spans"]}


# ---------------------------------------------------------------- the module


def test_inactive_spans_record_nothing_and_counters_count(clean, monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("made while tracing is off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert not profiling.active()
    with profiling.request("train") as req:
        with profiling.span("a") as a, profiling.span("b", device=True) as b:
            with profiling.phases() as ph:
                profiling.phase("p")
        with profiling.host_sync("render", "site", 3) as s, profiling.host_sync("render", "none", 0) as z:
            pass
    assert a is b is ph is req is s is z  # one shared no-op context, nothing allocated
    profiling.count("x", 2)
    profiling.add("y_s", 0.25)
    assert profiling.records() == []
    c = profiling.counters()
    assert c["x"] == 2 and c["y_s"] == 0.25 and c["render.host_syncs"] == 3 and c["render.host_syncs.site"] == 3
    assert "render.host_syncs.none" not in c  # no sync at that site: nothing counted
    profiling.replayed([("p", FakeEvent(0.0), FakeEvent(1.0))])  # no request open: nothing happens
    assert profiling.records() == []


def test_enabled_records_nested_spans_of_one_request(clean):
    profiling.enable()
    profiling.count("before")
    with profiling.request("render"):
        with profiling.span("outer"):
            with profiling.span("inner"):
                profiling.count("hits", 4)
            with profiling.host_sync("render", "readback"):
                pass
    with profiling.request("train"):
        with profiling.span("other"):
            pass
    recs = profiling.records()
    assert [r["kind"] for r in recs] == ["render", "train"] and recs[0]["seq"] < recs[1]["seq"]
    assert profiling.records("train") == [recs[1]]
    rec = recs[0]
    spans = _by_name(rec)
    assert set(spans) == {"outer", "inner", "render.sync.readback"}
    assert {s["request"] for s in rec["spans"]} == {rec["seq"]}
    assert spans["outer"]["parent"] is None
    assert spans["inner"]["parent"] == spans["render.sync.readback"]["parent"] == "outer"
    for name in ("inner", "render.sync.readback"):
        assert spans["outer"]["start_ns"] <= spans[name]["start_ns"] <= spans[name]["end_ns"] <= spans["outer"]["end_ns"]
    assert all(s["device_ms"] is None for s in rec["spans"])  # nothing on a card
    assert rec["counters"] == {"hits": 4, "render.host_syncs": 1, "render.host_syncs.readback": 1}
    assert _by_name(recs[1])["other"]["request"] == recs[1]["seq"]


def test_spans_are_profiler_events_while_it_records(clean):
    from torch.profiler import ProfilerActivity, profile

    assert not profiling.active()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.active()
        with profiling.request("render"):
            with profiling.span("spp_march"):
                torch.ones(4).sum()
                with profiling.host_sync("render", "samples"):
                    torch.zeros(3).cumsum(0)
            with profiling.phases():
                profiling.phase("step.batch")
                profiling.phase("step.forward")
    names = [e.name for e in prof.events()]
    for name in ("spp_march", "render.sync.samples", "step.batch", "step.forward"):
        assert name in names
    assert len(profiling.records("render")) == 1
    assert not profiling.active()
    with profiling.request("render"), profiling.span("spp_march"):
        pass
    assert len(profiling.records("render")) == 1  # it stopped with the profiler


def test_phases_partition_a_block(clean):
    profiling.enable()
    with profiling.request("train"):
        profiling.phase("outside")  # no block open: nothing
        with profiling.span("train.steps"), profiling.phases():
            for name in STEP_PHASES:
                profiling.phase(name)
    spans = profiling.records("train")[0]["spans"]
    phases = [s for s in spans if s["name"] in STEP_PHASES]
    assert [s["name"] for s in phases] == list(STEP_PHASES)
    assert all(s["parent"] == "train.steps" for s in phases)
    assert all(a["end_ns"] <= b["start_ns"] for a, b in zip(phases, phases[1:]))
    assert "outside" not in {s["name"] for s in spans}


def test_a_replayed_graph_times_the_request(clean):
    """The device ms of a request come from the events of the last replay
    handed to replayed(); events not reached by its readback are left out."""
    profiling.enable()
    first = [("step.batch", FakeEvent(0.0), FakeEvent(9.0))]
    last = [("step.batch", FakeEvent(0.0), FakeEvent(1.5)), ("step.forward", FakeEvent(1.5), FakeEvent(4.0)),
            ("step.batch", FakeEvent(4.0), FakeEvent(5.0)), ("step.forward", FakeEvent(5.0), FakeEvent(6.0, ready=False))]
    with profiling.request("train"):
        profiling.replayed(first)
        profiling.replayed(last)
    rec = profiling.records("train")[0]
    assert rec["device_ms"] == {"step.batch": 2.5, "step.forward": 2.5}
    assert rec["device_n"] == {"step.batch": 2, "step.forward": 1}


def test_timed_blocks_always_take_their_host_time(clean):
    with profiling.timed("off") as off:
        sum(range(1000))
    profiling.enable()
    with profiling.request("train"), profiling.timed("on") as on:
        sum(range(1000))
    assert off.ms > 0 and on.ms > 0
    assert _by_name(profiling.records("train")[0])["on"]["end_ns"] > 0


def test_the_ring_keeps_the_newest_records(clean):
    profiling.enable()
    for _ in range(profiling.RING + 5):
        with profiling.request("render"):
            pass
    recs = profiling.records()
    assert len(recs) == profiling.RING and recs[-1]["seq"] - recs[0]["seq"] == profiling.RING - 1
    profiling.reset()
    assert profiling.records() == [] and profiling.counters() == {}


# ----------------------------------------------------- the port's spans


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A TINY model trained three calls on a small scene, on the CPU."""
    from ngp_tpu_torch import Testbed
    from ngp_tpu_torch.data.synthetic import write_synthetic_dataset

    train_json, _ = write_synthetic_dataset(tmp_path_factory.mktemp("scene"), n_train=4, n_test=1, width=24, height=24,
                                            device="cpu")
    tb = Testbed(device="cpu")
    tb.load_model_config_dict(TINY)
    tb._trainer.sample_capacity = 1 << 13
    profiling.reset()
    tb.load_training_data(train_json)
    assert profiling.counters()["data.load_s"] > 0
    for _ in range(3):
        tb.train(8, 1 << 12)
    return tb


def test_a_training_call_has_its_spans_and_counters(tiny, clean):
    tb = tiny
    profiling.enable()
    tb.train(8, 1 << 12)
    rec = profiling.records("train")[-1]
    spans = _by_name(rec)
    for name in ("train.prep", "train.grid_update", "train.sync.grid_box", "train.steps", "train.sync.stats"):
        assert name in spans, name
    assert spans["train.grid_update"]["parent"] == spans["train.sync.grid_box"]["parent"] == "train.prep"
    assert spans["train.sync.stats"]["parent"] == "train.steps"
    phases = [s for s in rec["spans"] if s["name"] in STEP_PHASES]
    assert [s["name"] for s in phases] == list(STEP_PHASES) * 8
    assert all(s["parent"] == "train.steps" for s in phases)
    buf = tb.training_buffer
    ms = {n: (spans[n]["end_ns"] - spans[n]["start_ns"]) * 1e-6 for n in ("train.prep", "train.steps")}
    assert ms == {"train.prep": buf.training_prep_ms, "train.steps": buf.training_ms}
    # off the card no call is graphed: one cause is counted
    assert rec["counters"]["train.calls"] == 1 and "train.graphed_calls" not in rec["counters"]
    assert [v for k, v in rec["counters"].items() if k.startswith("train.eager.")] == [1]
    # the training loop's syncs are timed, not counted: no metric reads a count of them
    assert not [k for k in rec["counters"] if "host_syncs" in k]


def test_eager_causes_name_the_first_shape_field_that_moved(tiny):
    from ngp_tpu_torch.train.trainer import CallShape, TrainingLoop

    loop = TrainingLoop(tiny._trainer, tiny._loop.dataset, torch.Generator())
    shape = CallShape(512, 1 << 13, 256, 128, 32, 128, 16, 8)
    assert tiny._loop.peek_shape(8)._fields == CallShape._fields
    assert loop._eager_cause(shape) == "first_call"
    loop._last_shape = shape
    assert loop._eager_cause(shape) == "one_step"
    assert loop._eager_cause((512, 1 << 13, 512, 128, 64, 128, 16, 8)) == "shape.s_pad"
    assert loop._eager_cause(shape._replace(n_steps=16)) == "shape.n_steps"


@pytest.mark.parametrize("spp", [1, 4])
def test_a_frame_has_its_stages_and_counts_its_syncs(tiny, clean, spp):
    """spp 1 (the pass's march in render/march.py, its syncs at site
    `march`) and spp 4 (one cover march in render/march.py, the shared
    composite, its rows compacted at site `cover_march`): the three stages
    and the sync spans, and the same count of host syncs on two renders of
    one pose."""
    from ngp_tpu_torch.data.synthetic import look_at_pose

    tb = tiny
    tb.set_nerf_camera_matrix(look_at_pose(np.array([2.4, 1.2, 1.6])))
    profiling.enable()
    counts = []
    rounds = "march" if spp == 1 else "cover_march"
    for _ in range(2):
        tb.render(32, 24, spp, True)
        rec = profiling.records("render")[-1]
        counts.append(rec["counters"]["render.host_syncs"])
        names = {s["name"] for s in rec["spans"]}
        assert {"spp_march", "spp_network", "spp_composite", "render.sync.readback", f"render.sync.{rounds}"} <= names
        # the syncs inside the renderer's callees are counted where they happen
        callees = ("camera_rays", "frame_geometry", "jitter", rounds, "background")
        assert all(rec["counters"][f"render.host_syncs.{site}"] > 0 for site in callees)
        assert rec["counters"]["render.frames"] == 1
        per_site = sum(v for k, v in rec["counters"].items() if k.startswith("render.host_syncs."))
        assert per_site == counts[-1]
        assert all(s["parent"] is not None for s in rec["spans"] if s["name"] == f"render.sync.{rounds}")
    assert counts[0] == counts[1] > 0
    assert tb._renderer.last_frame_samples > 0
