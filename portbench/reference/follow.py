"""The plain reference of both kinds of cell, on the frozen plain copy
(portbench/reference/frozen), which imports nothing of the port.

Training, the start: from the benchmark's initial weights and the scene's
files, the reference marks the grid, draws the call's salts, backgrounds and
optimizer rows from the seed as the port's loop draws them (grid salts, then
the call's table), runs the first grid update and follows the call's first
steps at the step shape the port's loop chose (its controllers' integers:
the one thing taken from the port's run). Training, a call of the timed
path: from the port's state where that call began (the density grid, the
leaves, the Adam moments; a reference cannot train thousands of steps
alongside), the reference runs the call's grid update, and apart from it
follows the first steps of the call's last replay with that replay's draw
rows on the port's updated density grid (its occupancy worked out again):
a cell that rounding tips over the threshold would change the steps'
samples, so each stage is held against the reference on its own. Serving: the reference renders the sampled
frames' poses from the renderer's weights and density grid that the port's
training left (the port's state: a served model has no other source) with
the plain renderer. Every product of the heads takes its operands at
`precision` ("float32": the reference; "float8": its control).
"""

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class TrainRecord:
    """What a training run's first steps produced."""

    stats: torch.Tensor  # (n, 6) float64 step stats; column 0 is the loss sum
    grad: list  # the first step's gradient of each leaf, as the optimizer took it
    params0: list  # each leaf before the first step
    params: list  # each leaf after the n-th step
    grid: torch.Tensor  # the density grid after the call's grid update


def set_precision(precision: str):
    from portbench.reference.frozen.ops import mlp

    if precision not in ("float32", "float8"):
        raise ValueError(f"unknown precision {precision!r}")
    mlp.PRECISION["name"] = precision
    mlp.exact_fp32_matmul()


@dataclass
class CallInput:
    """The port's state at a call of the timed path that the reference
    follows from: the grid update's inputs, then the state before the first
    followed step and the draw rows of the followed steps."""

    i_step: int
    salts: list  # the grid update's two salts
    grid_step: int  # the grid's update counter before it
    grid_params: list  # the leaves the grid update evaluates
    grid_density: torch.Tensor  # the density grid before it
    step_density: torch.Tensor  # the density grid the steps ran on: the port's, after its update
    shape: tuple  # the step shape
    draws: torch.Tensor  # (n, 9) float64 draw rows of the followed steps
    params: list  # each leaf before the first followed step
    mu: list  # the Adam moments before it
    nu: list


def gradient_from_moments(mu: list, beta1: float) -> list:
    """A leaf's first gradient from its Adam first moment after one step
    (mu = (1 - beta1) * g from zero)."""
    return [m.detach().double() / (1.0 - beta1) for m in mu]


def gradient_from_moment_step(mu0: list, mu1: list, beta1: float) -> list:
    """A step's gradient, as Adam took it, from its first moment before and
    after (mu1 = beta1 * mu0 + (1 - beta1) * g); zero where the moment did
    not move (the hash table's lazy update skips an entry of zero gradient)."""
    out = []
    for m0, m1 in zip(mu0, mu1, strict=True):
        a, b = m0.detach().double(), m1.detach().double()
        out.append(torch.where(b != a, (b - beta1 * a) / (1.0 - beta1), 0.0))
    return out


def load_dataset(train_json, scale: float, offset, device):
    from portbench.reference.frozen.data.nerf_synthetic import load_nerf_synthetic

    return load_nerf_synthetic(train_json, scale, tuple(offset), device=device)


def _param_dict(leaves: list, n_density: int) -> dict:
    return {"hash_table": leaves[0], "density_mlp": list(leaves[1 : 1 + n_density]),
            "rgb_mlp": list(leaves[1 + n_density :])}


def follow_training(model_doc: dict, train_json, scale: float, offset, params0: dict, seed: int, shape: tuple,
                    n_call_steps: int, n_follow: int, precision: str, device, ds=None) -> TrainRecord:
    from portbench.reference.frozen.grid.occupancy import mark_untrained_grid
    from portbench.reference.frozen.train.trainer import StepShape, Trainer, draw_salts
    from portbench.reference.frozen.utils.config import NGPConfig

    set_precision(precision)
    cfg = NGPConfig.from_json(model_doc)
    tr = Trainer.create(cfg, params0, device)
    tr.loss_type = cfg.loss
    start = [p.detach().clone() for p in tr.model.param_list()]
    ds = load_dataset(train_json, scale, offset, device) if ds is None else ds
    mark = mark_untrained_grid(cfg.sampler, ds.resolution, ds.focal_length, ds.xforms)
    cur = tr.grid.density
    cur.copy_(torch.where(mark < 0, mark, torch.where(cur < 0, 0.0, cur)))
    gen = torch.Generator().manual_seed(seed)
    tr.grid_update(0, draw_salts(gen))
    grid = tr.grid.density.clone()
    step_shape = StepShape(*shape)
    table = torch.from_numpy(tr.draw_table(gen, n_call_steps, 0, step_shape.n_rays)).to(device)
    stats = torch.zeros((n_follow, 6), dtype=torch.float64, device=device)
    grad = None
    for k in range(n_follow):
        tr.run_step(step_shape, ds, table[k], stats[k])
        if k == 0:
            grad = gradient_from_moments(tr.optimizer.mu, cfg.optimizer.adam.beta1)
    params = [p.detach().clone() for p in tr.model.param_list()]
    return TrainRecord(stats=stats, grad=grad, params0=start, params=params, grid=grid)


def follow_call(model_doc: dict, train_json, scale: float, offset, inp: CallInput, precision: str, device,
                ds=None) -> TrainRecord:
    """The reference's grid update and followed steps of a call of the timed
    path, from the port's state where it began (`inp`)."""
    from portbench.reference.frozen.grid.occupancy import create_grid_state, update_occupancy
    from portbench.reference.frozen.train.trainer import StepShape, Trainer
    from portbench.reference.frozen.utils.config import NGPConfig

    set_precision(precision)
    cfg = NGPConfig.from_json(model_doc)
    n_density = cfg.network.density_mlp.n_hidden_layers + 1  # one matrix a layer, no biases
    tr = Trainer.create(cfg, _param_dict(inp.grid_params, n_density), device)
    tr.loss_type = cfg.loss
    tr.grid = create_grid_state(cfg.sampler, device=device)._replace(step=inp.grid_step)
    tr.grid.density.copy_(inp.grid_density)
    tr.grid_update(inp.i_step, inp.salts)
    grid = tr.grid.density.clone()
    tr.grid.density.copy_(inp.step_density)
    tr.grid = update_occupancy(cfg.sampler, tr.grid)
    tr.set_state(_param_dict(inp.params, n_density), mu=inp.mu, nu=inp.nu)
    ds = load_dataset(train_json, scale, offset, device) if ds is None else ds
    n = inp.draws.shape[0]
    stats = torch.zeros((n, 6), dtype=torch.float64, device=device)
    mu1 = None
    for k in range(n):
        tr.run_step(StepShape(*inp.shape), ds, inp.draws[k].to(device), stats[k])
        if k == 0:
            mu1 = [m.detach().clone() for m in tr.optimizer.mu]
    return TrainRecord(stats=stats, grad=gradient_from_moment_step(inp.mu, mu1, cfg.optimizer.adam.beta1),
                       params0=[p.detach().clone() for p in inp.params],
                       params=[p.detach().clone() for p in tr.model.param_list()], grid=grid)


def render_frames(model_doc: dict, params: dict, density: torch.Tensor, scale: float, offset, frames: list,
                  precision: str, device, rendering: dict | None = None) -> list:
    """[(image (H, W, 4) numpy, network samples)] of each (pose, width,
    height, spp, to_srgb) in `frames`, rendered by the plain renderer with
    the rendering-buffer attributes `rendering`."""
    from portbench.reference.frozen.testbed import Testbed

    set_precision(precision)
    tb = Testbed(device=device)
    tb.load_model_config_dict(model_doc)
    tb.set_state(params, density.detach().cpu().numpy(), scale, tuple(offset))
    for key, value in (rendering or {}).items():
        setattr(tb.rendering_buffer, key, value)
    out = []
    for pose, width, height, spp, to_srgb in frames:
        tb.set_nerf_camera_matrix(np.asarray(pose, np.float32))
        img = tb.render(width, height, spp, to_srgb)
        out.append((img, int(tb._renderer.last_frame_samples)))
    return out
