# Frozen copy of ngp_tpu_torch/train/trainer.py at commit ef1215de9ec9, the plain path only: the benchmark's reference.
# Kept: the step, its draws and the grid update of one card. Left out: TrainCall and its CUDA graphs, the
# TrainingLoop and its controllers, the probe, the envmap and the data-parallel shards (no reference path reaches them).
"""Training: one step and the grid update.

Counterpart: ngp_tpu/train/trainer.py:58-79 (compute_rgb_target), :131-278
(the train step: batch -> network forward -> composite loss over the two
buckets -> gradients -> optimizer -> EMA) and :385-436 (grid_update,
uniform-only below step 256).

A step's shapes depend only on the tuple (n_rays, capacity, s_pad,
n_window, s_short, n_long, n_seg_cap): its per-step draws (two salts, the
ray shift, the sRGB background) and its optimizer row (lr, bc1, bc2)
arrive as one float64 row of the call's draw table, and its six stats go
into a row of a call-level buffer. Every random draw comes from a
torch.Generator the caller owns, in ngp_tpu's order of use (grid salts,
then per step salts and background).
"""

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from portbench.reference.frozen.grid.occupancy import GridState, create_grid_state, sample_grid_positions, splat_density_ema, update_occupancy
from portbench.reference.frozen.models.ngp import NGPModel, apply_density_activation, apply_rgb_activation
from portbench.reference.frozen.render.composite import train_loss
from portbench.reference.frozen.sampling.training import generate_training_batch
from portbench.reference.frozen.train.optimizer import Optimizer
from portbench.reference.frozen.utils.aabb import AABB
from portbench.reference.frozen.utils.color import linear_to_srgb, srgb_to_linear
from portbench.reference.frozen.utils.config import NGPConfig

_U32 = 1 << 32
GRID_CHUNK = 1 << 18  # grid positions per density evaluation
# one float64 row of a call's draw table per step (u32 and float32 values are exact)
DRAW_COLUMNS = ("salt0", "salt1", "shift", "bg_r", "bg_g", "bg_b", "lr", "bc1", "bc2")


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


class StepShape(NamedTuple):
    """Everything a step's shapes depend on (ngp_tpu's static jit arguments)."""

    n_rays: int
    capacity: int
    s_pad: int
    n_window: int = 0
    s_short: int = 0
    n_long: int = 0
    n_seg_cap: int = 0


@dataclass
class Trainer:
    """The training model (requires_grad on), its EMA copies, the optimizer
    and the occupancy grid, with the step and the grid update."""

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

    @staticmethod
    def create(config: NGPConfig, params: dict, device) -> "Trainer":
        """A trainer starting from `params` (copied); EMA = params, zero Adam
        state."""
        model = NGPModel(config.network, device=device).load_params(params).trainable()
        ema = [p.detach().clone() for p in model.param_list()]
        return Trainer(
            config=config,
            model=model,
            ema=ema,
            optimizer=Optimizer(config.optimizer, model.param_list(), ema),
            grid=create_grid_state(config.sampler, device=device),
            aabb=AABB.scene(config.sampler.aabb_scale),
        )

    @property
    def device(self):
        return self.model.hash_table.device

    @torch.no_grad()
    def set_state(self, params: dict, ema: dict | None = None, mu=None, nu=None, count: int = 0, sched_count: int | None = None):
        """Install parameters, EMA copies (default: the parameters) and the
        Adam state ([hash, *density, *rgb] lists and the two counts; default
        zero), in place."""
        self.model.load_params(params)
        e = params if ema is None else ema
        for dst, src in zip(self.ema, [e["hash_table"], *e["density_mlp"], *e["rgb_mlp"]], strict=True):
            dst.copy_(src)
        self.optimizer.load_state(mu, nu, count, sched_count)

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
                       s_short: int = 0, n_long: int = 0, n_seg_cap: int = 0):
        """Batch, loss and the gradient of every parameter (no update). The
        salts, shift and background may be device tensors."""
        cfg = self.config
        scfg = cfg.sampler
        batch = generate_training_batch(
            scfg, self.aabb, ds.images, ds.xforms, ds.focal_length, (0.5, 0.5), self.grid.occupancy, salts, n_rays,
            n_rays_shift, capacity, s_pad, occ_aabb=self.grid.occ_aabb, n_window=n_window, s_short=s_short,
            n_long=n_long, n_seg_cap=n_seg_cap,
        )
        bg_linear = srgb_to_linear(torch.as_tensor(bg_srgb, dtype=torch.float32, device=self.device))
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
        rgb_raw, sigma_raw = self.model.rgbsigma_raw(batch.pos, batch.dirs)
        loss, aux = train_loss(
            rgb_raw, sigma_raw, batch.layout,
            batch.dt_pad if batch.dt_pad is not None else dt_const,
            batch.valid_short, rgb_target, bg,
            extra_buckets=extra,
            n_rays_denom=n_rays,
            loss_type=self.loss_type or cfg.loss,
            transmittance_threshold=cfg.render.transmittance_threshold,
            rgb_activation=self.rgb_activation,
            density_activation=self.density_activation,
            mean_density=self.grid.mean_density,
            min_optical_thickness=scfg.min_optical_thickness,
            apply_rgb_activation=apply_rgb_activation,
            apply_density_activation=apply_density_activation,
        )
        grads = torch.autograd.grad(loss, self.model.param_list())
        return batch, loss.detach(), aux, grads

    def run_step(self, shape: StepShape, ds, draws: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        """One optimizer step from a draw-table row (9,) on the device, its
        stats written into out (6,) float64 on the device."""
        with torch.enable_grad():
            batch, _, aux, grads = self.loss_and_grads(
                ds, shape.n_rays, shape.capacity, shape.s_pad, draws[2].to(torch.int64), draws[0:2].to(torch.int64),
                draws[3:6].to(torch.float32), shape.n_window, shape.s_short, shape.n_long, shape.n_seg_cap,
            )
        self.optimizer.apply(grads, draws[6:9].to(torch.float32))
        stats = (aux["loss_sum"], aux["measured_batch_size"], batch.n_samples, batch.max_ray_count, batch.count_at_split,
                 batch.seg_count_hi)
        return out.copy_(torch.stack([s.to(torch.float64) for s in stats]))

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
        bitfield."""
        scfg = self.config.sampler
        n_total = scfg.n_total_elements
        n_uniform, n_nonuniform = (n_total // 4, n_total // 4) if i_step >= 256 else (n_total, 0)
        pos, idx = sample_grid_positions(scfg, self.grid.density, salts, n_uniform, n_nonuniform, self.grid.step)
        self.grid = update_occupancy(scfg, splat_density_ema(scfg, self.grid, idx, self.grid_densities(pos)))
