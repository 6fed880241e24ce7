"""Training: one step, a call of several steps, the grid update and the
host-side controllers.

Counterpart: ngp_tpu/train/trainer.py:58-79 (compute_rgb_target), :108-128
(init_state's EnvmapState), :131-278 (the train step: batch -> network
forward -> composite loss over the two buckets -> gradients -> optimizer ->
EMA, and with envmap.train the envmap behind every ray and its gradient
deposit), :280-351 (_semantic_key, train_call, train_step, envmap_apply and
their cache), :360-383 (probe_batch), :385-436
(grid_update, uniform-only below step 256) and :439-776 (TrainingLoop: the
n_rays ladder and its probe with the >25 % drift trigger, the occupied
window n_window, the s_pad, s_short and kept-segment (n_seg_cap)
controllers with their votes, _choose_shape / peek_shape, the periodic
segment probe, stochastic_fuse_steps with the shape-stability gate and the
OOM demotion, loss_scalar, controller_state / restore_controller, and the
envmap's optimizer step once a call, :721-724).

A step's shapes depend only on the tuple (n_rays, capacity, s_pad,
n_window, s_short, n_long, n_seg_cap), and a step neither syncs with the
host nor copies to the card: its per-step draws (two salts, the ray shift,
the sRGB background) and its optimizer row (lr, bc1, bc2) arrive as one
float64 row of the call's draw table on the card, and its six stats go
into a row of a call-level buffer on the card, read with one copy per call.
So `train_call` on the card is one CUDA graph holding `fuse` steps,
captured at its first use and replayed n / fuse times: the counterpart of
ngp_tpu's lax.scan. On the CPU it runs the same step function `fuse` times.

Differs: every random draw comes from a torch.Generator the caller owns,
in ngp_tpu's order of use (grid salts, then per step salts and
background), so tests can inject ngp_tpu's threefry draws; the remat of the
heads (remat_heads) is not ported: a scan keeps every step's activations in
flight, a replayed graph runs its steps one after another in one memory
pool; a capture that runs out of device memory (torch.cuda.OutOfMemoryError)
demotes the loop to per-step calls, where ngp_tpu matches XLA's error text;
the envmap's state is updated in place (a captured step adds its gradient
into the persistent accumulator and reads the persistent texels), the loop
counts the accumulated steps on the host and steps the envmap through
adam_ema once per train() call, after the call's steps, graphed or not.

With `Trainer.mesh` of size > 1 (parallel/mesh.py), train_step, train_call
and grid_update dispatch to the sharded builders, as ngp_tpu's :298-301,
:326-329 and :430-433 do; a step then takes a `Shard` and all-reduces the
gradients and the stats between the backward and the optimizer. ngp_tpu's
loop is one program that decides for every chip; here every rank runs its
own TrainingLoop, and its decisions come out the same on every rank because
each reads only values that are equal on all of them: the all-reduced step
stats, the grid (replicated after the MAX merge), the probe's result
(MAX-reduced, so equal even if a rank's probe differed) and a capture's
out-of-memory demotion (MAX-reduced over the ranks, so all demote together).
"""

import collections
import functools
import sys
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from ngp_tpu_torch.grid.occupancy import GridState, create_grid_state, sample_grid_positions, splat_density_ema, update_occupancy
from ngp_tpu_torch.models.ngp import NGPModel, apply_density_activation, apply_rgb_activation
from ngp_tpu_torch.ops import kernels
from ngp_tpu_torch.render.composite import train_loss
from ngp_tpu_torch.render.envmap import (
    EnvmapState,
    create_envmap_state,
    envmap_accumulate,
    envmap_apply,
    envmap_gradient,
    read_envmap,
)
from ngp_tpu_torch.sampling.lattice import n_lattice_points
from ngp_tpu_torch.sampling.training import MarchCounters, generate_training_batch
from ngp_tpu_torch.train.optimizer import Optimizer
from ngp_tpu_torch.utils import profiling
from ngp_tpu_torch.utils.aabb import AABB
from ngp_tpu_torch.utils.color import linear_to_srgb, srgb_to_linear
from ngp_tpu_torch.utils.config import NGPConfig

_U32 = 1 << 32
GRID_CHUNK = 1 << 18  # grid positions per density evaluation
# one float64 row of a call's draw table per step (u32 and float32 values are exact)
DRAW_COLUMNS = ("salt0", "salt1", "shift", "bg_r", "bg_g", "bg_b", "lr", "bc1", "bc2")
# one float64 row of a call's stats per step
STAT_KEYS = (
    "loss_sum", "measured_batch_size", "measured_batch_size_before_compaction", "max_ray_count", "count_at_split",
    "seg_count_hi",
)
GRAPH_CACHE = 4  # captured calls kept, most recent first


def compute_rgb_target(rgba, bg_linear, color_space: str, train_in_linear_color: bool):
    """Per-ray training target and the background used in the composite:
    (rgb_target (R, 3), background (3,) or (R, 3))."""
    tex_rgb, tex_a = rgba[..., :3], rgba[..., 3:4]
    if train_in_linear_color or color_space.lower() == "linear":
        target = tex_rgb + (1.0 - tex_a) * bg_linear
        bg = bg_linear
        if not train_in_linear_color:
            target = linear_to_srgb(target)
            bg = linear_to_srgb(bg_linear)
        return target, bg
    # SRGB color space: blend in sRGB
    bg_srgb = linear_to_srgb(bg_linear)
    safe_a = torch.clamp(tex_a, min=1e-9)
    straight = linear_to_srgb(tex_rgb / safe_a) * tex_a
    target = torch.where(tex_a > 0, straight + (1.0 - tex_a) * bg_srgb, bg_srgb.expand_as(tex_rgb))
    return target, bg_srgb


def draw_salts(generator: torch.Generator) -> list:
    """Two u32 draws (ngp_tpu takes them from a threefry key)."""
    return torch.randint(0, _U32, (2,), generator=generator, dtype=torch.int64).tolist()


class Shard(NamedTuple):
    """A data-parallel rank's part of a step: the mesh whose collectives
    merge the ranks (parallel/mesh.Mesh), the global ray count (the loss's
    denominator and the image pick's stride) and this rank's first global
    ray index."""

    mesh: object
    n_rays_global: int
    index_offset: int


class StepShape(NamedTuple):
    """Everything a step's shapes depend on (ngp_tpu's static jit arguments)."""

    n_rays: int
    capacity: int
    s_pad: int
    n_window: int = 0
    s_short: int = 0
    n_long: int = 0
    n_seg_cap: int = 0


# a train() call's shape (TrainingLoop._choose_shape): its steps' StepShape and their number
CallShape = NamedTuple("CallShape", [*StepShape.__annotations__.items(), ("n_steps", int)])


class TrainCall:
    """`n_steps` training steps of one shape as one call, the counterpart of
    ngp_tpu's scanned call: on the card one CUDA graph, captured at the first
    call (and again if the dataset or the grid tensors it reads change) and
    replayed after; on the CPU the same steps one by one. A replay counts the
    kernel launches the graph makes (kernels.add_launch_counts); the capture
    itself launches nothing. The capture records the steps' phase events
    (profiling.phases in run_step), kept in `timed` with the graph, so every
    replay times its steps' phases. With a `shard` the steps are a data-parallel
    rank's, their all-reduces inside the graph where the mesh's collectives
    can be captured (NCCL); otherwise (gloo) the steps run eagerly and
    `eager_reason` says why."""

    def __init__(self, trainer: "Trainer", shape: StepShape, n_steps: int, shard: Shard | None = None):
        self.trainer, self.shape, self.n_steps, self.shard = trainer, shape, n_steps, shard
        self.eager_reason = ""
        if trainer.device.type != "cuda":
            self.eager_reason = "no CUDA graphs off the card"
        elif shard is not None and not shard.mesh.graphable:
            self.eager_reason = f"{shard.mesh.backend} collectives cannot be captured in a CUDA graph"
        self.graph = None
        self.launches = {}
        self.reserved_bytes = 0  # device memory the capture added to the shared graph pool
        self.timed = []  # (name, start, end) timing events the capture recorded
        self._inputs = ()
        self._draws = self._stats = None

    def _reads(self, ds) -> tuple:
        g = self.trainer.grid
        return (ds, ds.images, ds.xforms, g.occupancy, g.occ_aabb, g.mean_density)

    def prepare(self, ds):
        """Capture the steps into a graph on the card (nothing on the CPU)."""
        tr = self.trainer
        reads = self._reads(ds)
        if self.eager_reason or (self.graph is not None and all(a is b for a, b in zip(reads, self._inputs))):
            return
        self.graph = None
        profiling.count("train.captures")
        with profiling.timed("train.capture") as clock:
            self._capture(ds, reads)
        profiling.add("train.capture_s", clock.ms * 1e-3)

    def _capture(self, ds, reads):
        tr = self.trainer
        dev = tr.device
        self._draws = torch.zeros((self.n_steps, len(DRAW_COLUMNS)), dtype=torch.float64, device=dev)
        self._stats = torch.zeros((self.n_steps, len(STAT_KEYS)), dtype=torch.float64, device=dev)
        # the capture empties the allocator's cache first; measure from there
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        before = kernels.launch_counts()
        graph = torch.cuda.CUDAGraph()
        # under a mesh, other threads (the collectives' watchdog) keep
        # querying the card during the capture
        mode = "global" if self.shard is None else "thread_local"
        try:
            with profiling.capture() as timed, torch.cuda.graph(graph, pool=tr.graph_pool(), capture_error_mode=mode):
                for j in range(self.n_steps):
                    tr.run_step(self.shape, ds, self._draws[j], self._stats[j], shard=self.shard)
        finally:
            after = kernels.launch_counts()
            kernels.set_launch_counts(before)
        self.launches = {k: after[k] - before[k] for k in after}
        self.reserved_bytes = torch.cuda.memory_reserved(dev) - reserved
        tr.capture_reserved_bytes += self.reserved_bytes
        self.graph, self._inputs, self.timed = graph, reads, timed

    def __call__(self, ds, draws: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        """Run the steps with draws (n_steps, 9) into out (n_steps, 6), both on
        the trainer's device."""
        self.prepare(ds)
        if self.graph is None:
            for j in range(self.n_steps):
                self.trainer.run_step(self.shape, ds, draws[j], out[j], shard=self.shard)
            return out
        self._draws.copy_(draws)
        self.graph.replay()
        profiling.replayed(self.timed)
        out.copy_(self._stats)
        kernels.add_launch_counts(self.launches)
        return out


@dataclass
class Trainer:
    """The training model (requires_grad on), its EMA copies, the optimizer
    and the occupancy grid, with the step, the call and the grid update."""

    config: NGPConfig
    model: NGPModel
    ema: list  # EMA copy of each of model.param_list()
    optimizer: Optimizer
    grid: GridState
    aabb: AABB
    rgb_activation: str = "Logistic"  # testbed.h:115
    density_activation: str = "Exponential"  # testbed.h:114
    background_color: tuple = (0.0, 0.0, 0.0)  # sRGB (testbed.h:116)
    color_space: str = "Linear"
    loss_type: str = ""  # defaults to config.loss; runtime-tweakable
    target_batch_size: int = 1 << 18
    # flat sample buffer == the target batch: rays overflowing it are dropped whole
    sample_capacity: int = 1 << 18
    capture_reserved_bytes: int = 0  # device memory the captures so far added to the graph pool
    envmap: EnvmapState | None = None  # the trainable envmap (config.envmap.train)
    mesh: object = None  # parallel/mesh.Mesh -> data-parallel steps, calls and grid updates
    march_counters: MarchCounters | None = None  # train_march's totals on the device, read with a call's stats
    _cache: collections.OrderedDict = field(default_factory=collections.OrderedDict)
    _pool: tuple | None = None

    @staticmethod
    def create(config: NGPConfig, params: dict, device, mesh=None) -> "Trainer":
        """A trainer starting from `params` (copied); EMA = params, zero Adam
        state; a zero envmap when config.envmap.train; data-parallel over
        `mesh` when its size is > 1."""
        model = NGPModel(config.network, device=device).load_params(params).trainable()
        ema = [p.detach().clone() for p in model.param_list()]
        return Trainer(
            config=config,
            model=model,
            ema=ema,
            optimizer=Optimizer(config.optimizer, model.param_list(), ema),
            grid=create_grid_state(config.sampler, device=device),
            aabb=AABB.scene(config.sampler.aabb_scale),
            envmap=create_envmap_state(config.envmap, model.hash_table.device) if config.envmap.train else None,
            mesh=mesh,
            march_counters=MarchCounters(model.hash_table.device),
        )

    @property
    def device(self):
        return self.model.hash_table.device

    def ema_params(self) -> dict:
        """The EMA copies as the dict NGPModel.load_params takes."""
        nd = len(self.model.density_mlp)
        return {"hash_table": self.ema[0], "density_mlp": self.ema[1 : 1 + nd], "rgb_mlp": self.ema[1 + nd :]}

    @torch.no_grad()
    def set_state(self, params: dict, ema: dict | None = None, mu=None, nu=None, count: int = 0, sched_count: int | None = None):
        """Install parameters, EMA copies (default: the parameters) and the
        Adam state ([hash, *density, *rgb] lists and the two counts; default
        zero), in place; drops the captured calls."""
        self.model.load_params(params)
        e = params if ema is None else ema
        for dst, src in zip(self.ema, [e["hash_table"], *e["density_mlp"], *e["rgb_mlp"]], strict=True):
            dst.copy_(src)
        self.optimizer.load_state(mu, nu, count, sched_count)
        self.drop_graphs()

    # ------------------------------------------------------------- the cache
    def _semantic_key(self):
        """Runtime-tweakable attributes a step reads: a change builds a new
        cache entry (ngp_tpu compiles a new step)."""
        return (self.loss_type, self.color_space, tuple(self.background_color), self.rgb_activation, self.density_activation)

    def _cached(self, key, build):
        if key in self._cache:
            self._cache.move_to_end(key)
        else:
            self._cache[key] = build()
            while sum(isinstance(v, TrainCall) for v in self._cache.values()) > GRAPH_CACHE:
                oldest = next(k for k, v in self._cache.items() if isinstance(v, TrainCall))
                del self._cache[oldest]
        return self._cache[key]

    def drop_graphs(self):
        """Forget every cached step and call (and so their graphs)."""
        self._cache.clear()

    def _data_parallel(self) -> bool:
        return self.mesh is not None and self.mesh.size > 1

    def graph_pool(self):
        """The one memory pool every captured call of this trainer shares."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def train_step(self, n_rays: int, capacity: int | None = None, s_pad: int = 1024, n_window: int = 0, s_short: int = 0,
                   n_long: int = 0, n_seg_cap: int = 0):
        """The step of one shape, (ds, draws row, stats row) -> stats row
        (cached by ngp_tpu's key); with a mesh the sharded step of that
        global shape (parallel/mesh.make_dp_train_step)."""
        shape = StepShape(n_rays, capacity or self.sample_capacity, s_pad, n_window, s_short, n_long, n_seg_cap)
        if self._data_parallel():
            from ngp_tpu_torch.parallel.mesh import make_dp_train_step

            build = lambda: make_dp_train_step(self, self.mesh, *shape)  # noqa: E731
        else:
            build = lambda: functools.partial(self.run_step, shape)  # noqa: E731
        return self._cached(("step", *shape, self._semantic_key()), build)

    def _call_key(self, shape: StepShape, n_steps: int) -> tuple:
        return ("call", *shape, n_steps, self._semantic_key())

    def has_call(self, shape: StepShape, n_steps: int) -> bool:
        """Whether train_call of this shape is in the cache (on the card,
        captured: it replays without a new capture)."""
        return self._call_key(StepShape(*shape), n_steps) in self._cache

    def train_call(self, n_rays: int, capacity: int, s_pad: int, n_steps: int, n_window: int = 0, s_short: int = 0,
                   n_long: int = 0, n_seg_cap: int = 0) -> TrainCall:
        """`n_steps` steps of one shape as one call (cached by ngp_tpu's key;
        the GRAPH_CACHE most recent calls are kept); with a mesh the sharded
        call of that global shape (parallel/mesh.make_dp_train_call)."""
        shape = StepShape(n_rays, capacity, s_pad, n_window, s_short, n_long, n_seg_cap)
        key = self._call_key(shape, n_steps)
        if self._data_parallel():
            from ngp_tpu_torch.parallel.mesh import make_dp_train_call

            return self._cached(key, lambda: make_dp_train_call(self, self.mesh, n_rays, capacity, s_pad, n_steps, *shape[3:]))
        return self._cached(key, lambda: TrainCall(self, shape, n_steps))

    # ------------------------------------------------------------------ step
    def draw_background(self, generator: torch.Generator) -> torch.Tensor:
        """The step's sRGB background: random per step when enabled (one
        colour for all rays, ray_marcher.cu:90-93), else the fixed one."""
        if self.config.render.train_with_random_bg_color:
            return torch.rand((3,), generator=generator, dtype=torch.float32)
        return torch.tensor(self.background_color, dtype=torch.float32)

    def draw_table(self, generator: torch.Generator, n_steps: int, shift0: int, n_rays: int) -> np.ndarray:
        """The draw table of a call of n_steps steps, (n_steps, 9) float64 in
        DRAW_COLUMNS order: per step the salts then the background from
        `generator`, the ray shift and the optimizer's (lr, bc1, bc2) row from
        its current counts (which this does not advance)."""
        table = np.empty((n_steps, len(DRAW_COLUMNS)), np.float64)
        hyper = self.optimizer.hyper_rows(n_steps)
        for k in range(n_steps):
            table[k, 0:2] = draw_salts(generator)
            table[k, 3:6] = self.draw_background(generator).numpy()
            table[k, 2] = (shift0 + k * n_rays) % _U32
            table[k, 6:9] = hyper[k]
        return table

    def loss_and_grads(self, ds, n_rays: int, capacity: int, s_pad: int, n_rays_shift, salts, bg_srgb, n_window: int = 0,
                       s_short: int = 0, n_long: int = 0, n_seg_cap: int = 0, n_rays_denom: int = 0, stride_denom: int = 0,
                       index_offset: int = 0):
        """Batch, loss and the gradient of every parameter (no update), and
        with the envmap its step gradient in aux["envmap_grad"]. The salts,
        shift and background may be device tensors (a captured step). A
        data-parallel shard passes the global ray count as n_rays_denom and
        stride_denom and its first global ray as index_offset (n_rays and
        n_long are its own). Inside run_step its work is the step's phases
        step.batch, step.forward and step.backward."""
        cfg = self.config
        scfg = cfg.sampler
        n_rays_denom = n_rays_denom or n_rays
        profiling.phase("step.batch")
        batch = generate_training_batch(
            scfg, self.aabb, ds.images, ds.xforms, ds.focal_length, (0.5, 0.5), self.grid.occupancy, salts, n_rays,
            n_rays_shift, capacity, s_pad, stride_denom=stride_denom, index_offset=index_offset, occ_aabb=self.grid.occ_aabb,
            n_window=n_window, s_short=s_short, n_long=n_long, n_seg_cap=n_seg_cap, counters=self.march_counters,
        )
        bg_linear = srgb_to_linear(torch.as_tensor(bg_srgb, dtype=torch.float32, device=self.device))
        if self.envmap is not None:
            # the plain background composited behind the envmap, per ray
            # (ray_marcher.cu:96-102); a constant of the loss
            env = read_envmap(self.envmap.params, batch.rays_d)
            bg_linear = env[:, :3] + bg_linear * (1.0 - env[:, 3:4])
        rgb_target, bg = compute_rgb_target(batch.rgba, bg_linear, self.color_space, cfg.render.train_in_linear_color)
        rgb_target = rgb_target.detach()
        dt_const = scfg.min_cone_stepsize
        extra = ()
        if batch.layout_long is not None:
            extra = ((
                batch.layout_long,
                batch.dt_pad_long if batch.dt_pad_long is not None else dt_const,
                batch.valid_long,
                rgb_target[batch.sel_long],
                bg[batch.sel_long] if bg.dim() == 2 else bg,
            ),)
        profiling.phase("step.forward")
        rgb_raw, sigma_raw = self.model.rgbsigma_raw(batch.pos, batch.dirs)
        loss, aux = train_loss(
            rgb_raw, sigma_raw, batch.layout,
            batch.dt_pad if batch.dt_pad is not None else dt_const,
            batch.valid_short, rgb_target, bg,
            extra_buckets=extra,
            n_rays_denom=n_rays_denom,
            loss_type=self.loss_type or cfg.loss,
            transmittance_threshold=cfg.render.transmittance_threshold,
            rgb_activation=self.rgb_activation,
            density_activation=self.density_activation,
            mean_density=self.grid.mean_density,
            min_optical_thickness=scfg.min_optical_thickness,
            apply_rgb_activation=apply_rgb_activation,
            apply_density_activation=apply_density_activation,
        )
        profiling.phase("step.backward")
        grads = torch.autograd.grad(loss, self.model.param_list())
        if self.envmap is not None:
            aux["envmap_grad"] = self._envmap_grad(batch, aux, rgb_target, bg, n_rays_denom)
        return batch, loss.detach(), aux, grads

    @torch.no_grad()
    def _envmap_grad(self, batch, aux, rgb_target, bg, n_rays_denom: int) -> torch.Tensor:
        """The step's envmap gradient from the buckets' ray outputs, the long
        bucket's rows scattered back into the batch's ray order."""
        rgb_ray, trans_end, exhausted = aux["bucket_rays"][0]
        valid = batch.valid_short
        if batch.layout_long is not None:
            sel = batch.sel_long
            rgb1, t1, e1 = aux["bucket_rays"][1]
            rgb_ray = rgb_ray.index_copy(0, sel, rgb1)
            trans_end = trans_end.index_copy(0, sel, t1)
            exhausted = exhausted.index_copy(0, sel, e1)
            valid = valid | torch.zeros_like(valid).index_copy(0, sel, batch.valid_long)
        cfg = self.config
        return envmap_gradient(
            self.envmap.params, batch.rays_d, rgb_ray, trans_end, exhausted, valid, rgb_target, bg,
            envmap_loss_type=cfg.envmap.loss or (self.loss_type or cfg.loss),
            train_in_linear_color=cfg.render.train_in_linear_color,
            n_rays_denom=n_rays_denom,
        )

    def run_step(self, shape: StepShape, ds, draws: torch.Tensor, out: torch.Tensor, shard: Shard | None = None) -> torch.Tensor:
        """One optimizer step from a draw-table row (9,) on the device, its
        stats written into out (6,) float64 on the device, the envmap's
        gradient added into its accumulator; nothing syncs with the host or
        copies to the card, so it can be captured. With a `shard` the step is
        a data-parallel rank's: its rays are its slice of the global batch,
        and the gradients (SUM), the envmap's gradient (SUM) and the stats
        (the first three SUM, the last three MAX) are all-reduced over the
        mesh before they are used (ngp_tpu/parallel/mesh.py:186-223).

        Its work is four device phases that partition it (profiling.phases):
        step.batch, step.forward, step.backward (the gradients' all-reduce
        included) and step.optimizer (the update, the envmap's accumulation
        and the stats)."""
        dp = {} if shard is None else {
            "n_rays_denom": shard.n_rays_global, "stride_denom": shard.n_rays_global, "index_offset": shard.index_offset,
        }
        with profiling.phases():
            with torch.enable_grad():
                batch, _, aux, grads = self.loss_and_grads(
                    ds, shape.n_rays, shape.capacity, shape.s_pad, draws[2].to(torch.int64), draws[0:2].to(torch.int64),
                    draws[3:6].to(torch.float32), shape.n_window, shape.s_short, shape.n_long, shape.n_seg_cap, **dp,
                )
            if shard is not None:
                grads = [g.contiguous() for g in grads]
                shard.mesh.all_reduce_(grads, "sum")
                if self.envmap is not None:
                    shard.mesh.all_reduce_([aux["envmap_grad"]], "sum")
            profiling.phase("step.optimizer")
            self.optimizer.apply(grads, draws[6:9].to(torch.float32))
            if self.envmap is not None:
                envmap_accumulate(self.envmap, aux["envmap_grad"])
            stats = (aux["loss_sum"], aux["measured_batch_size"], batch.n_samples, batch.max_ray_count,
                     batch.count_at_split, batch.seg_count_hi)
            stats = torch.stack([s.to(torch.float64) for s in stats])
            if shard is not None:
                shard.mesh.all_reduce_([stats[:3]], "sum")
                shard.mesh.all_reduce_([stats[3:]], "max")
            return out.copy_(stats)

    @torch.no_grad()
    def probe_batch(self, ds, n_probe: int, n_window: int, n_rays_shift: int, salts):
        """Batch generation alone on the current grid: (samples, longest ray,
        p99.5 kept coarse segments) of `n_probe` rays, before truncation and
        drops (ngp_tpu's probe_batch)."""
        b = generate_training_batch(
            self.config.sampler, self.aabb, ds.images, ds.xforms, ds.focal_length, (0.5, 0.5), self.grid.occupancy,
            salts, n_probe, n_rays_shift % _U32, n_probe, 32, occ_aabb=self.grid.occ_aabb, n_window=n_window,
            want_seg_stat=True, counters=self.march_counters,
        )
        probe = torch.stack([b.n_samples, b.max_ray_count, b.seg_count_hi])
        if self._data_parallel():
            # every rank probes the same rays on the same grid; the MAX makes
            # the ranks' controllers read one value whatever happens
            self.mesh.all_reduce_([probe], "max")
        with profiling.span("train.sync.probe"):
            probe = probe.cpu()
        return tuple(int(v) for v in probe)

    # ----------------------------------------------------------- grid update
    @torch.no_grad()
    def grid_densities(self, pos: torch.Tensor) -> torch.Tensor:
        """Density of world positions (N, 3) with the training params
        (testbed.cu:213-217), GRID_CHUNK positions an evaluation."""
        warped = self.aabb.relative_pos(pos)
        return torch.cat(
            [
                apply_density_activation(self.model.density_raw(warped[s : s + GRID_CHUNK])[:, 0], self.density_activation)
                for s in range(0, warped.shape[0], GRID_CHUNK)
            ]
        )

    @torch.no_grad()
    def grid_update(self, i_step: int, salts):
        """Occupancy upkeep, in place into the grid's tensors: sample cells
        (uniform only for the first 256 steps), density inference with the
        training params, scatter-max splat with EMA decay, threshold into the
        bitfield; with a mesh each rank's slice of the cells, the splats
        merged (parallel/mesh.make_dp_grid_update)."""
        scfg = self.config.sampler
        n_total = scfg.n_total_elements
        n_uniform, n_nonuniform = (n_total // 4, n_total // 4) if i_step >= 256 else (n_total, 0)
        if self._data_parallel():
            from ngp_tpu_torch.parallel.mesh import make_dp_grid_update

            self._cached(("grid", n_uniform, n_nonuniform), lambda: make_dp_grid_update(self, self.mesh, n_uniform, n_nonuniform))(salts)
            return
        pos, idx = sample_grid_positions(scfg, self.grid.density, salts, n_uniform, n_nonuniform, self.grid.step)
        self.grid = update_occupancy(scfg, splat_density_ema(scfg, self.grid, idx, self.grid_densities(pos)))


class TrainingLoop:
    """Host-side loop state: the adaptive ray count, the padded widths, the
    occupied window, the kept-segment cap and the training telemetry of one
    dataset."""

    # static-shape ladder {2^k, 3*2^(k-1), 5*2^(k-2)}, as ngp_tpu's
    _LADDER = tuple(
        sorted({1 << k for k in range(3, 19)} | {3 << (k - 1) for k in range(4, 18)} | {5 << (k - 2) for k in range(8, 18)})
    )
    _N_RAYS_LADDER = tuple(v for v in _LADDER if 256 <= v <= (1 << 18))

    def __init__(self, trainer: Trainer, dataset, generator: torch.Generator):
        self.trainer = trainer
        self.dataset = dataset
        self.generator = generator
        self.n_rays_per_batch = 1 << 12  # testbed.h:141
        self.capacity = trainer.sample_capacity
        self.s_pad = self._quantize_s_pad(trainer.config.sampler.maximum_marching_steps, self.n_rays_per_batch)
        self.n_rays_total = 0
        self.i_step = 0
        self.loss_scalar = float("nan")
        self.measured_batch_size = trainer.target_batch_size
        self.measured_batch_size_before_compaction = trainer.target_batch_size
        self.training_prep_ms = 0.0
        self.training_ms = 0.0
        # occupied-window length in lattice steps, sized from the grid's
        # occupied box after each grid update
        self.n_window = 0
        self._last_shape = None
        # two-bucket composite: the n_rays/4 longest rays go to the wide
        # bucket, s_short covers the rest (count_at_split stat, 25 % headroom)
        self.s_short = 0
        self._s_short_shrink_votes = 0
        # two-level march: kept-segment capacity from the seg_count_hi stat;
        # 0 is the full-window march
        self.n_seg_cap = 0
        self._seg_est = None
        self._seg_shrink_votes = 0
        # per-ray sample estimate; None probes the fresh grid at the next call
        self._per_ray_est = None
        self._probe_next = False
        # steps per captured call under the stochastic backward (ngp_tpu's
        # default); demoted to 1 (per-step) for the rest of the run when a
        # capture runs out of device memory
        self.stochastic_fuse_steps = 8
        self.graphed = False  # the last call replayed captured graphs
        self.eager_reason = ""  # why the last call ran its steps eagerly
        self.demotions = 0

    # --------------------------------------------------- shape choice
    def _choose_shape(self, n_training_steps: int, commit: bool):
        """The next call's CallShape. commit=True applies the
        kept-segment-cap controller's transition (grow fast, shrink after two
        half-size votes, 25 % headroom, ladder rungs); commit=False
        (peek_shape) predicts it without changing anything."""
        n_long = max(self.n_rays_per_batch // 4, 1)
        s_short = self.s_short if 0 < self.s_short < self.s_pad else 0
        # engage the two-level march when the cap undercuts 3/4 of the window
        n_seg_frame = self.n_window // 8
        n_seg_cap_val = self.n_seg_cap
        shrink_votes = self._seg_shrink_votes
        if self._seg_est is not None and self._seg_est > 0:
            need_cap = max(self._seg_est * 1.25, 8)
            want = min(next((v for v in self._LADDER if v >= need_cap), n_seg_frame), n_seg_frame)
            if n_seg_cap_val == 0 or want > n_seg_cap_val or n_seg_cap_val > n_seg_frame:
                n_seg_cap_val = want
                shrink_votes = 0
            elif want <= n_seg_cap_val // 2:
                shrink_votes += 1
                if shrink_votes >= 2:
                    n_seg_cap_val = n_seg_cap_val // 2
                    shrink_votes = 0
            else:
                shrink_votes = 0
        if commit:
            self.n_seg_cap = n_seg_cap_val
            self._seg_shrink_votes = shrink_votes
        n_seg_cap = n_seg_cap_val if 0 < n_seg_cap_val * 8 <= (3 * self.n_window) // 4 else 0
        return CallShape(self.n_rays_per_batch, self.capacity, self.s_pad, self.n_window, s_short, n_long, n_seg_cap,
                         n_training_steps)

    def peek_shape(self, n_training_steps: int = 16):
        """Predict the next call's shape tuple without changing the controllers."""
        return self._choose_shape(n_training_steps, commit=False)

    # ------------------------------------------------- controller persistence
    def controller_state(self) -> dict:
        """The controllers a snapshot carries, so a resume starts at steady shapes."""
        return {
            "n_rays_per_batch": int(self.n_rays_per_batch),
            "s_pad": int(self.s_pad),
            "s_short": int(self.s_short),
            "per_ray_est": float(self._per_ray_est) if self._per_ray_est else 0.0,
            "seg_est": float(self._seg_est) if self._seg_est else 0.0,
        }

    def restore_controller(self, d: dict):
        if not d:
            return
        self.n_rays_per_batch = self._quantize_n_rays(int(d.get("n_rays_per_batch", self.n_rays_per_batch)))
        self.s_pad = self._quantize_s_pad(int(d.get("s_pad", self.s_pad)), self.n_rays_per_batch)
        self.s_short = min(int(d.get("s_short", 0)), self.s_pad)
        per_ray = float(d.get("per_ray_est", 0.0))
        self._per_ray_est = per_ray if per_ray > 0 else None
        seg = float(d.get("seg_est", 0.0))
        self._seg_est = seg if seg > 0 else None

    # --------------------------------------------------------- controllers
    @classmethod
    def _quantize_n_rays(cls, n: int) -> int:
        """Nearest ladder rung in [2^8, 2^18] (cap: testbed.cu:293)."""
        n = max(1 << 8, min(n, 1 << 18))
        return min(cls._N_RAYS_LADDER, key=lambda v: abs(v - n))

    def _quantize_s_pad(self, max_count: int, n_rays: int) -> int:
        """Pow2 padded width covering the longest ray, capped so the padded
        (R, S) tensors stay <= 2^23 slots."""
        max_steps = self.trainer.config.sampler.maximum_marching_steps
        cap = max(32, min(1 << int(np.ceil(np.log2(max_steps))), (1 << 23) // n_rays))
        want = 1 << int(np.ceil(np.log2(max(int(max_count), 32))))
        return min(want, cap)

    def _pick_n_rays(self, per_ray: float, target: int, current: int | None = None) -> int:
        """Ladder rung whose expected batch lands closest to the target:
        undershoot costs full weight, expectation beyond the capacity 0.3x;
        the incumbent rung stays unless a challenger is decisively cheaper."""
        cap = float(self.capacity)

        def cost(n):
            e = n * per_ray
            if e <= target:
                return target - e
            return (min(e, cap) - target) + 0.3 * max(e - cap, 0.0)

        best = min(self._N_RAYS_LADDER, key=cost)
        if current in self._N_RAYS_LADDER and cost(current) <= 1.25 * cost(best) + 0.02 * target:
            return current
        return best

    # ------------------------------------------------------------------ train
    def train(self, n_training_steps: int = 16):
        """One reference train() call: grid prep + n steps + controllers.
        Spans (utils/profiling.py): train.prep (training_prep_ms) holds
        train.grid_update (timed on the device), the occupied box's readback
        train.sync.grid_box and train.probe; train.steps (training_ms) holds
        train.capture and the stats' readback train.sync.stats. Counters:
        train.calls, train.graphed_calls and, for a call that ran its steps
        eagerly, train.eager.<cause>; at train.sync.stats the batch march's
        sampling.training.MARCH_COUNTERS (train.batch.points,
        train.batch.samples.mip<k>, ...) of the call's steps and probe."""
        tr, ds, gen = self.trainer, self.dataset, self.generator
        scfg = tr.config.sampler
        profiling.count("train.calls")
        with profiling.timed("train.prep") as prep:
            salts = draw_salts(gen)
            with profiling.span("train.grid_update", device=True):
                tr.grid_update(self.i_step, salts)
            # size the lattice window from the fresh occupied box (the grid holds
            # for the call's steps); the readback doubles as the prep sync
            with profiling.span("train.sync.grid_box"):
                box = tr.grid.occ_aabb.cpu().numpy()
            diag = float(np.linalg.norm(box[1] - box[0]))
            need = int(np.ceil(diag / scfg.min_cone_stepsize)) + 2
            self.n_window = min(n_lattice_points(scfg), max(128, 128 << int(np.ceil(np.log2(max(need / 128, 1))))))
            # while the two-level march is off, a periodic probe keeps the
            # segment estimate fresh so it engages once the grid thins out
            # (the arithmetic lattice only: the cone lattice has no coarse pass)
            if (scfg.cone_angle_constant == 0.0 and self.n_seg_cap == 0 and self.i_step > 0
                    and (self.i_step // n_training_steps) % 16 == 0):
                self._probe_next = True
            if self._per_ray_est is None or self._probe_next:
                # size n_rays / s_pad from the grid this call marches; the probe
                # peeks at the generator's next salts without consuming them
                n_probe = 1 << 10
                peek = torch.Generator().set_state(gen.get_state())
                with profiling.span("train.probe"):
                    ns, mrc, msc = tr.probe_batch(ds, n_probe, self.n_window, self.n_rays_total, draw_salts(peek))
                if msc > 0:
                    self._seg_est = float(msc)
                per_ray = ns / n_probe
                if per_ray > 0:
                    self.n_rays_per_batch = self._pick_n_rays(per_ray, tr.target_batch_size, self.n_rays_per_batch)
                    self._per_ray_est = per_ray
                    self.s_pad = self._quantize_s_pad(int(mrc * 1.25) + 1, self.n_rays_per_batch)
                    self.s_short = min(self.s_short, self.s_pad) if self.s_short else 0
                self._probe_next = False
        self.training_prep_ms = prep.ms

        with profiling.timed("train.steps") as steps:
            stats = self._steps(n_training_steps)
        self.training_ms = steps.ms

        measured = float(np.mean(stats["measured_batch_size"]))
        measured_bc = float(np.mean(stats["measured_batch_size_before_compaction"]))
        if measured == 0:
            raise RuntimeError("Training generated 0 samples. Aborting training.")
        self.measured_batch_size = measured
        self.measured_batch_size_before_compaction = measured_bc

        target = tr.target_batch_size
        loss_sum = float(np.sum(stats["loss_sum"])) / self.n_rays_per_batch
        self.loss_scalar = loss_sum / n_training_steps * (measured / target)

        # adaptive ray count (testbed.cu:292-293) from the pre-drop samples
        old_n_rays = self.n_rays_per_batch
        per_ray = measured_bc / old_n_rays
        if self._per_ray_est and abs(per_ray - self._per_ray_est) > 0.25 * self._per_ray_est:
            self._probe_next = True  # the grid is still moving: re-probe next call
        self._per_ray_est = per_ray
        self.n_rays_per_batch = self._pick_n_rays(per_ray, target, old_n_rays)
        # padded width: this call's longest ray with 25 % headroom
        max_count = float(np.max(stats["max_ray_count"]))
        self.s_pad = self._quantize_s_pad(int(max_count * 1.25) + 1, self.n_rays_per_batch)
        msc = float(np.max(stats["seg_count_hi"]))
        if msc > 0:
            self._seg_est = msc
        # short-bucket width: the longest ray outside the top bucket with
        # headroom; grow at once, shrink after two half-size votes (without
        # the hysteresis the width flaps and the shape gate never fuses)
        split = float(np.max(stats["count_at_split"]))
        need = min(1 << int(np.ceil(np.log2(max(split * 1.25, 32)))), self.s_pad)
        if self.s_short == 0 or need > self.s_short or self.s_short > self.s_pad:
            self.s_short = need
            self._s_short_shrink_votes = 0
        elif need <= self.s_short // 2:
            self._s_short_shrink_votes += 1
            if self._s_short_shrink_votes >= 2:
                self.s_short = self.s_short // 2
                self._s_short_shrink_votes = 0
        else:
            self._s_short_shrink_votes = 0
        return stats

    def _steps(self, n_training_steps: int) -> dict:
        """The call's steps, graphed where its shape equals the last call's;
        returns its stats, read back in one copy."""
        tr, ds, gen = self.trainer, self.dataset, self.generator
        if self.i_step == 0:
            self.n_rays_total = 0
        shape = self._choose_shape(n_training_steps, commit=True)
        n_rays, capacity, s_pad, n_window, s_short, n_long, n_seg_cap, _ = shape
        # under the stochastic backward ngp_tpu scans `stochastic_fuse_steps`
        # steps a dispatch; graphs only for a shape equal to the last call's
        # or one whose call is cached, so a transient controller shape does
        # not pay a capture and a shape the controllers return to replays
        fuse = n_training_steps
        if tr.model.grid_spec.stochastic_bwd:
            fuse = min(n_training_steps, max(int(self.stochastic_fuse_steps), 0))
        use_fused = ((shape == self._last_shape or tr.has_call(shape[:7], fuse)) and fuse > 1
                     and n_training_steps % max(fuse, 1) == 0)
        cause = None if use_fused else self._eager_cause(shape)
        self._last_shape = shape

        # the call's draws and optimizer rows: one table, one copy to the card
        table = torch.from_numpy(tr.draw_table(gen, n_training_steps, self.n_rays_total, n_rays))
        if tr.device.type == "cuda":
            table = table.pin_memory()
        draws = table.to(tr.device, non_blocking=True)
        out = torch.empty((n_training_steps, len(STAT_KEYS)), dtype=torch.float64, device=tr.device)
        done = 0
        self.graphed = False
        self.eager_reason = "" if use_fused else "a shape unlike the last call's, or one step a call"
        if use_fused:
            call = tr.train_call(n_rays, capacity, s_pad, fuse, n_window, s_short, n_long, n_seg_cap)
            oom = False
            try:
                call.prepare(ds)  # the capture, where device memory can run out
            except torch.cuda.OutOfMemoryError:
                oom = True
            if tr._data_parallel():
                # before any step runs a collective: all ranks demote together
                flag = torch.tensor([float(oom)], device=tr.device)
                tr.mesh.all_reduce_([flag], "max")
                with profiling.span("train.sync.oom_flag"):
                    oom = bool(flag.item())
            if not oom:
                for k in range(0, n_training_steps, fuse):
                    call(ds, draws[k : k + fuse], out[k : k + fuse])
                    done += fuse
                self.graphed = call.graph is not None
                self.eager_reason = call.eager_reason
                cause = None if self.graphed else "no_graph"
            else:
                # a capture ran out of device memory: per-step calls for the rest of the run
                tr.drop_graphs()
                if tr.device.type == "cuda":
                    torch.cuda.empty_cache()
                self.stochastic_fuse_steps = 1
                self.demotions += 1
                self.eager_reason = "a capture ran out of device memory"
                cause = "oom_demoted"
                print(
                    f"TrainingLoop: capturing {fuse} steps of shape {shape[:7]} ran out of device memory; "
                    "training one step a call from now on", file=sys.stderr,
                )
        if done < n_training_steps:
            step = tr.train_step(n_rays, capacity, s_pad, n_window, s_short, n_long, n_seg_cap)
            for k in range(done, n_training_steps):
                step(ds, draws[k], out[k])
        if tr.envmap is not None:
            # the envmap steps once a call on the mean of its steps' gradients
            # (testbed.cu:295-298), after the call's steps, outside any graph
            tr.envmap.n_accum += n_training_steps
            envmap_apply(tr.envmap)
        # one device -> host copy of the call's telemetry (testbed.cu:266-289);
        # the batch march's counters come back beside it, queued before it
        counters = tr.march_counters
        with profiling.span("train.sync.stats"):
            if counters is not None:
                counters.stage()
            host = out.cpu()
        if counters is not None:
            counters.count()
        stats = dict(zip(STAT_KEYS, host.numpy().T, strict=True))
        tr.optimizer.advance(n_training_steps)
        self.i_step += n_training_steps
        self.n_rays_total += n_training_steps * n_rays
        profiling.count("train.graphed_calls" if cause is None else f"train.eager.{cause}")
        return stats

    def _eager_cause(self, shape: tuple) -> str:
        """Why a call of this shape (CallShape's fields) runs its steps
        eagerly: the first call of the loop, the first field that differs
        from the last call's shape, or one step a call (stochastic_fuse_steps
        1 or a step count it does not divide)."""
        if self._last_shape is None:
            return "first_call"
        if shape != self._last_shape:
            return "shape." + next(f for f, a, b in zip(CallShape._fields, shape, self._last_shape, strict=True) if a != b)
        return "one_step"
