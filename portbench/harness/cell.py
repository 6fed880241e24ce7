"""One run of one cell: set-up, the measured window, the traced stretch, the
check against the reference, and the result.

The traffic file names its kind, and this one generator runs every mix of
that kind from the file's parameters:

  "train": `warm_calls` x Testbed.train(steps_per_call, batch) in set-up
           (the first call's first `follow_steps` steps recorded for the
           check), then back-to-back calls of the same for the window;
           after it, one more such call recorded for the check (CheckedCall).
  "serve": the same training in set-up, from the weights and draws of
           `model_seed` where the file gives one (every run then serves the
           same model, and the seed moves only the poses and the check's
           sample), `warm_frames` frames rendered, then back-to-back
           Testbed.render(width, height, spp, to_srgb) frames for the window
           at the poses of `poses` ("orbit" or "test_views"), entered at an
           offset drawn from the seed. `rendering` (optional) sets attributes
           of the Testbed's rendering buffer by name, such as "render_mode",
           on the port and on the reference alike; `to_srgb` defaults to
           true.

The window is closed loop, one caller; every request of it is timed on the
host's clock and ends on its result on the host (train() reads its stats,
render() returns the numpy frame). With trace on, the run measures the same
window unprofiled and then profiles `profile_calls` calls or
`profile_frames` frames.
"""

import gc
import math
import subprocess
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from portbench.harness import scene as scenes
from portbench.harness.roofline import peaks
from portbench.harness.spec import Cell, load_reader
from portbench.harness.trace import profile_stretch
from portbench.reference import compare, follow

SPANS = ("spp_march", "spp_network", "spp_composite")  # the renderer's own record_function ranges


@dataclass
class Run:
    """What a run measured; the metrics' readers read it."""

    cell: Cell
    device_name: str
    peaks: tuple  # (memory bytes/s, bf16 FLOP/s)
    setup_s: float = 0.0
    window_s: float = 0.0
    calls: list = field(default_factory=list)  # train: {"ms", "graphed", "measured", "steps"}
    frames: list = field(default_factory=list)  # serve: {"ms", "samples", "points"}
    trace: object = None  # trace.Trace of the profiled stretch
    traced_calls: list = field(default_factory=list)
    traced_frames: list = field(default_factory=list)

    @property
    def model(self) -> dict:
        return self.cell.config["model"]


class FirstSteps:
    """Records the port's first `n` training steps of the call it is entered
    around: the step stats, the first gradient from the Adam moments, the
    leaves after step n, the grid after the call's grid update and the step
    shape. It wraps the trainer's run_step and grid_update on the instance and
    drops the step it cached on leaving (the first call of a loop runs its
    steps one by one, never from a graph)."""

    def __init__(self, trainer, n: int, beta1: float):
        self.tr, self.n, self.beta1 = trainer, n, beta1
        self.rows, self.grad, self.params, self.grid, self.shape = [], None, None, None, None

    def __enter__(self):
        tr, run_step, grid_update = self.tr, self.tr.run_step, self.tr.grid_update

        def step(shape, ds, draws, out, shard=None):
            res = run_step(shape, ds, draws, out, shard=shard)
            k = len(self.rows)
            if k < self.n:
                self.rows.append(out.detach().clone())
                self.shape = tuple(int(v) for v in shape)
                if k == 0:
                    self.grad = follow.gradient_from_moments(tr.optimizer.mu, self.beta1)
                if k == self.n - 1:
                    self.params = [p.detach().clone() for p in tr.model.param_list()]
            return res

        def grid(i_step, salts):
            grid_update(i_step, salts)
            if self.grid is None:
                self.grid = tr.grid.density.detach().clone()

        tr.run_step, tr.grid_update = step, grid
        return self

    def __exit__(self, *exc):
        del self.tr.run_step, self.tr.grid_update
        self.tr.drop_graphs()
        return False

    def record(self, params0: list) -> follow.TrainRecord:
        if len(self.rows) < self.n or self.grid is None:
            raise RuntimeError(f"the first call ran {len(self.rows)} steps; the check follows {self.n}")
        return follow.TrainRecord(stats=torch.stack(self.rows), grad=self.grad, params0=params0, params=self.params,
                                  grid=self.grid)


class CheckedCall:
    """Records one train() call of the timed path, entered around it after
    the window: the grid update's inputs and result, then the call's steps.
    The step recorder's copies are made inside the trainer's run_step, which
    the call's CUDA graph captures (entering drops the cached graphs, so the
    call captures anew), so every replay makes them: of the last replay (or
    eager pass) of the call's `fuse` steps they keep the leaves and Adam
    moments before its first step, the draw rows and stats of its first `n`
    steps, the first moment after its first step and the leaves after its
    n-th."""

    def __init__(self, trainer, n: int, n_call_steps: int):
        self.tr, self.n, self.fuse, self.calls = trainer, n, n_call_steps, 0
        leaves_ = [p.detach() for p in trainer.model.param_list()]
        self.params0, self.mu0, self.nu0, self.mu1, self.params = (
            [torch.empty_like(x) for x in leaves_] for _ in range(5))
        dev = leaves_[0].device
        self.stats = torch.zeros((n, 6), dtype=torch.float64, device=dev)
        self.draws = torch.zeros((n, 9), dtype=torch.float64, device=dev)
        self.shape, self.grid_in, self.grid_out = None, None, None

    def __enter__(self):
        tr = self.tr
        run_step, grid_update, train_call = tr.run_step, tr.grid_update, tr.train_call
        opt = tr.optimizer

        def copy(dst, src):
            for d, x in zip(dst, src, strict=True):
                d.copy_(x.detach())

        def step(shape, ds, draws, out, shard=None):
            j, m = self.calls % self.fuse, min(self.n, self.fuse)
            self.calls += 1
            self.shape = tuple(int(v) for v in shape)
            with torch.no_grad():
                if j == 0:
                    copy(self.params0, tr.model.param_list())
                    copy(self.mu0, opt.mu)
                    copy(self.nu0, opt.nu)
            res = run_step(shape, ds, draws, out, shard=shard)
            with torch.no_grad():
                if j < m:
                    self.stats[j].copy_(out)
                    self.draws[j].copy_(draws)
                if j == 0:
                    copy(self.mu1, opt.mu)
                if j == m - 1:
                    copy(self.params, tr.model.param_list())
            return res

        def grid(i_step, salts):
            self.grid_in = dict(i_step=int(i_step), salts=[int(v) for v in salts], grid_step=int(tr.grid.step),
                                grid_params=[p.detach().clone() for p in tr.model.param_list()],
                                grid_density=tr.grid.density.detach().clone())
            grid_update(i_step, salts)
            self.grid_out = tr.grid.density.detach().clone()

        def call(*args, **kw):
            c = train_call(*args, **kw)
            self.fuse, self.calls = int(c.n_steps), 0
            return c

        tr.drop_graphs()
        tr.run_step, tr.grid_update, tr.train_call = step, grid, call
        return self

    def __exit__(self, *exc):
        del self.tr.run_step, self.tr.grid_update, self.tr.train_call
        return False

    def record(self) -> tuple:
        """(follow.CallInput, follow.TrainRecord) of the recorded call."""
        m = min(self.n, self.fuse)
        if self.grid_in is None or self.shape is None:
            raise RuntimeError("the checked call ran no grid update or no step")
        inp = follow.CallInput(**self.grid_in, step_density=self.grid_out, shape=self.shape,
                               draws=self.draws[:m].clone(), params=self.params0, mu=self.mu0, nu=self.nu0)
        grad = follow.gradient_from_moment_step(self.mu0, self.mu1, self.tr.config.optimizer.adam.beta1)
        rec = follow.TrainRecord(stats=self.stats[:m].clone(), grad=grad, params0=self.params0, params=self.params,
                                 grid=self.grid_out)
        return inp, rec


def check_call(tb, steps: int, batch: int, n: int, tries: int = 4) -> tuple:
    """One more train(steps, batch) call of the timed path, recorded
    (CheckedCall); on the card, called again (up to `tries` calls) until one
    replays a CUDA graph, as the window's calls mostly do. Returns
    (CallInput, TrainRecord, graphed)."""
    cuda = tb._trainer.device.type == "cuda"
    for _ in range(tries):
        with CheckedCall(tb._trainer, n, steps) as rec:
            tb.train(steps, batch)
        graphed = bool(tb.training_buffer.graphed)
        if graphed or not cuda:
            break
    return (*rec.record(), graphed)


def make_weights(model_doc: dict, seed: int, device) -> dict:
    """The initial weights, drawn on the device from the seed by a
    torch.Generator there: the hash table in one call, each matrix in one."""
    from portbench.reference.frozen.models.ngp import NGPModel
    from portbench.reference.frozen.utils.config import NGPConfig

    cfg = NGPConfig.from_json(model_doc)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = NGPModel(cfg.network, device=device).init(gen).params()
    return {"hash_table": params["hash_table"].detach().clone(),
            "density_mlp": [w.detach().clone() for w in params["density_mlp"]],
            "rgb_mlp": [w.detach().clone() for w in params["rgb_mlp"]]}


def leaves(params: dict) -> list:
    return [params["hash_table"], *params["density_mlp"], *params["rgb_mlp"]]


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def frame_poses(traffic: dict, scene: dict, seed: int):
    """The mix's pose for frame k. Every seed gets the same cycle of poses,
    entered at an offset drawn from the seed: the orbit's `cycle_frames`
    frames, or the test views in the order j * `stride` mod n."""
    p = traffic["poses"]
    rng = np.random.default_rng(seed)
    if p["path"] == "orbit":
        offset = int(rng.integers(0, p["cycle_frames"]))
        return lambda k: scenes.orbit_pose((offset + k) % p["cycle_frames"], p, scene["radius"])
    if p["path"] == "test_views":
        views = scenes.view_poses(scene)
        n, offset = len(views), int(rng.integers(0, len(views)))
        if math.gcd(p["stride"], n) != 1:
            raise ValueError(f"stride {p['stride']} does not visit all {n} test views")
        return lambda k: views[((offset + k) * p["stride"]) % n]
    raise ValueError(f"unknown pose path {p['path']!r}")


@dataclass
class Program:
    """The port after set-up: the Testbed, the benchmark's initial weights
    and the record of the first call's first steps."""

    tb: object
    params0: dict
    first: FirstSteps | None


def prepare(cell: Cell, seed: int, device, tweak=None, warm_calls: int | None = None) -> Program:
    """Set-up: the scene's files, the initial weights, the Testbed with
    them, the training data, and the traffic's warm train() calls (the first
    one recorded when the traffic follows steps). `tweak(tb)` (tests only)
    may shrink the program's buffers before training."""
    from ngp_tpu_torch import Testbed

    t, sc, model_doc = cell.traffic, cell.config["scene"], cell.config["model"]
    seed = int(t.get("model_seed", seed))
    train_json = scenes.ensure_scene(sc, device)
    params0 = make_weights(model_doc, seed, device)
    tb = Testbed(device=device)
    tb.seed = seed
    tb.load_model_config_dict(model_doc)
    if tweak is not None:
        tweak(tb)
    tb.set_state(params0, np.zeros(tb.grid.density.numel(), np.float32), sc["scale"], tuple(sc["offset"]))
    tb.load_training_data(train_json, sc["scale"], tuple(sc["offset"]))
    steps, batch = int(t["steps_per_call"]), int(t["batch"])
    n_calls = int(t["warm_calls"]) if warm_calls is None else warm_calls
    first = None
    if t.get("follow_steps"):
        with FirstSteps(tb._trainer, int(t["follow_steps"]), tb.config.optimizer.adam.beta1) as first:
            tb.train(steps, batch)
        n_calls -= 1
    for _ in range(n_calls):
        tb.train(steps, batch)
    return Program(tb=tb, params0=params0, first=first)


def follow_reference(cell: Cell, seed: int, shape: tuple, params0: dict, device,
                     precision: str = "float32", ds=None) -> follow.TrainRecord:
    """The reference's first steps of the cell's first call, at `precision`."""
    sc, t = cell.config["scene"], cell.traffic
    return follow.follow_training(cell.config["model"], scenes.ensure_scene(sc, device), sc["scale"], sc["offset"],
                                  params0, seed, shape, int(t["steps_per_call"]), int(t["follow_steps"]), precision,
                                  device, ds)


def follow_checked_call(cell: Cell, inp: follow.CallInput, device, precision: str = "float32",
                        ds=None) -> follow.TrainRecord:
    """The reference's checked call of the timed path, at `precision`."""
    sc = cell.config["scene"]
    return follow.follow_call(cell.config["model"], scenes.ensure_scene(sc, device), sc["scale"], sc["offset"], inp,
                              precision, device, ds)


def train_check(cell: Cell, seed: int, shape: tuple, params0: dict, prog, call_inp, call_prog, device) -> dict:
    """The numbers of a training run: the first call's first steps, then
    (prefixed `call_`) the checked call of the timed path."""
    sc = cell.config["scene"]
    ds = follow.load_dataset(scenes.ensure_scene(sc, device), sc["scale"], sc["offset"], device)
    numbers = compare.train_numbers(prog, follow_reference(cell, seed, shape, params0, device, ds=ds))
    free(device)
    ref = follow_checked_call(cell, call_inp, device, ds=ds)
    numbers.update({f"call_{k}": v for k, v in compare.train_numbers(call_prog, ref).items()})
    return numbers


def served_state(tb) -> tuple:
    """The renderer's weights and the density grid, copied out of the port."""
    ema = {key: (v.detach().clone() if torch.is_tensor(v) else [x.detach().clone() for x in v])
           for key, v in tb.model.params().items()}
    return ema, tb.grid.density.detach().clone()


def render_request(traffic: dict) -> tuple:
    """(width, height, spp, to_srgb) of the mix's frames."""
    t = traffic
    return int(t["width"]), int(t["height"]), int(t["spp"]), bool(t.get("to_srgb", True))


def set_rendering(tb, traffic: dict):
    """The mix's rendering-buffer attributes, set by name."""
    for key, value in traffic.get("rendering", {}).items():
        if not hasattr(tb.rendering_buffer, key):
            raise ValueError(f"the rendering buffer has no attribute {key!r}")
        setattr(tb.rendering_buffer, key, value)


def render_reference(cell: Cell, state: tuple, poses: list, device, precision: str = "float32") -> list:
    t, sc = cell.traffic, cell.config["scene"]
    return follow.render_frames(cell.config["model"], state[0], state[1], sc["scale"], sc["offset"],
                                [(pose, *render_request(t)) for pose in poses], precision, device,
                                t.get("rendering", {}))


def card_state() -> str:
    """The card's clocks, power and temperature now (diagnostics only)."""
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.mem,power.draw,temperature.gpu",
                            "--format=csv,noheader"], capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""
    return f"; card: {q}"


def free(device):
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, t_launch: float, device="cuda", tweak=None) -> dict:
    """One run; returns the result's fields."""
    t = cell.traffic
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    name = torch.cuda.get_device_name(dev) if cuda else "cpu"
    run = Run(cell=cell, device_name=name, peaks=peaks(name) if cuda else (0.0, 0.0))
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    # ---- set-up
    program = prepare(cell, seed, device, tweak)
    tb = program.tb
    steps, batch = int(t["steps_per_call"]), int(t["batch"])
    serve = t["kind"] == "serve"
    if serve:
        w, h, spp, to_srgb = render_request(t)
        set_rendering(tb, t)
        pose_of = frame_poses(t, cell.config["scene"], seed)
        for k in range(int(t["warm_frames"])):
            tb.set_nerf_camera_matrix(pose_of(-1 - k))
            tb.render(w, h, spp, to_srgb)
    elif t["kind"] != "train":
        raise ValueError(f"unknown traffic kind {t['kind']!r}")
    sync(device)
    run.setup_s = time.time() - t_launch

    # ---- the window
    rng = np.random.default_rng(seed)
    kept = []  # a reservoir of (k, pose, image) for the check
    n_keep = int(t.get("check_frames", 0))

    def one_call():
        c0 = time.perf_counter()
        tb.train(steps, batch)
        buf = tb.training_buffer
        return {"ms": (time.perf_counter() - c0) * 1e3, "graphed": bool(buf.graphed),
                "measured": float(buf.measured_batch_size), "steps": steps}

    def one_frame(k):
        pose = pose_of(k)
        c0 = time.perf_counter()
        tb.set_nerf_camera_matrix(pose)
        img = tb.render(w, h, spp, to_srgb)
        r = tb._renderer
        rec = {"ms": (time.perf_counter() - c0) * 1e3, "samples": int(r.last_frame_samples),
               "points": int(r.last_frame_points)}
        return rec, pose, img

    sync(device)
    w0 = time.perf_counter()
    k = 0
    while True:
        if serve:
            rec, pose, img = one_frame(k)
            run.frames.append(rec)
            item = (k, pose, img)
            if len(kept) < n_keep:
                kept.append(item)
            elif (j := int(rng.integers(0, k + 1))) < n_keep:
                kept[j] = item
        else:
            run.calls.append(one_call())
        k += 1
        if time.perf_counter() - w0 >= seconds:
            break
    sync(device)
    run.window_s = time.perf_counter() - w0
    ms = np.array([r["ms"] for r in (run.frames if serve else run.calls)])
    if serve:
        work = f"{np.mean([f['samples'] for f in run.frames]):.0f} samples a frame"
    else:
        work = f"eager calls at {[i for i, c in enumerate(run.calls) if not c['graphed']]}"
    print(f"window: {len(ms)} requests, ms min {ms.min():.2f} median {np.median(ms):.2f} p90 {np.percentile(ms, 90):.2f} "
          f"max {ms.max():.2f}, {work}, set-up {run.setup_s:.2f} s{card_state() if cuda else ''}", file=sys.stderr)

    if trace:
        if serve:
            run.trace = profile_stretch(
                lambda: run.traced_frames.extend(one_frame(k + j)[0] for j in range(int(t["profile_frames"]))), SPANS)
        else:
            run.trace = profile_stretch(lambda: run.traced_calls.extend(one_call() for _ in range(int(t["profile_calls"]))))
    memory_peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0

    # ---- the check, once the program's state is freed
    if serve:
        state = served_state(tb)
    else:
        prog, shape = program.first.record(leaves(program.params0)), program.first.shape
        call_inp, call_prog, graphed = check_call(tb, steps, batch, int(t["follow_steps"]))
        print(f"checked call: i_step {call_inp.i_step}, shape {call_inp.shape}, graphed {graphed}", file=sys.stderr)
    params0 = program.params0
    del tb, program
    free(device)
    if serve:
        kept.sort(key=lambda item: item[0])
        ref = render_reference(cell, state, [pose for _, pose, _ in kept], device)
        numbers = compare.serve_numbers([img for _, _, img in kept], [img for img, _ in ref])
    else:
        numbers = train_check(cell, seed, shape, params0, prog, call_inp, call_prog, device)
    correct, checks = compare.judge(numbers, cell.limits)

    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = load_reader(m["name"], cell.bench_dir)(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": name, "count": 1, "memory_peak_bytes": memory_peak}
    out = {"correct": bool(correct), "attempted": len(run.frames if serve else run.calls), "failed": 0,
           "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = run.trace.busy_s()
        device_info["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.top_ops(10), "idle_gaps": run.trace.top_gaps(10)}
    out["checks"] = checks
    return out
