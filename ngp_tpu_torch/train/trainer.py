"""Training: one step, the grid update and the host-side controllers.

Counterpart: ngp_tpu/train/trainer.py:58-79 (compute_rgb_target), :131-278
(the train step: batch -> network forward -> composite loss -> gradients ->
optimizer -> EMA), :385-436 (grid_update, uniform-only below step 256) and
:439-776 (TrainingLoop: the n_rays ladder and its probe with the >25 %
drift trigger, the s_pad controller, loss_scalar, controller_state /
restore_controller). Differs: PyTorch runs eagerly, so there is no jit
cache, no lax.scan fusion of the 16 steps and no OOM demotion; the flat
batch is one bucket over the whole lattice (no s_short, n_seg_cap or
occupied window: TrainingLoop keeps no controllers for them and skips the
periodic probe that refreshes their estimates); no envmap and no mesh.
Every random draw comes from a torch.Generator the caller owns and enters
the functions that consume it as an argument (`salts`, `bg_srgb`), so tests
can inject ngp_tpu's threefry draws. Gradients come from autograd, and one
`Optimizer.step` (the fused adam_ema kernel per leaf on the card) applies
Adam, the learning rate and the EMA.
"""

import time
from dataclasses import dataclass

import numpy as np
import torch

from ngp_tpu_torch.grid.occupancy import GridState, create_grid_state, sample_grid_positions, splat_density_ema, update_occupancy
from ngp_tpu_torch.models.ngp import NGPModel, apply_density_activation, apply_rgb_activation
from ngp_tpu_torch.render.composite import train_loss
from ngp_tpu_torch.sampling.training import generate_training_batch
from ngp_tpu_torch.train.optimizer import Optimizer
from ngp_tpu_torch.utils.aabb import AABB
from ngp_tpu_torch.utils.color import linear_to_srgb, srgb_to_linear
from ngp_tpu_torch.utils.config import NGPConfig

_U32 = 1 << 32
GRID_CHUNK = 1 << 18  # grid positions per density evaluation


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
    target_batch_size: int = 1 << 18
    # flat sample buffer == the target batch: rays overflowing it are dropped whole
    sample_capacity: int = 1 << 18

    @staticmethod
    def create(config: NGPConfig, params: dict, device) -> "Trainer":
        """A trainer starting from `params` (copied); EMA = params, zero Adam state."""
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

    def ema_params(self) -> dict:
        """The EMA copies as the dict NGPModel.load_params takes."""
        nd = len(self.model.density_mlp)
        return {"hash_table": self.ema[0], "density_mlp": self.ema[1 : 1 + nd], "rgb_mlp": self.ema[1 + nd :]}

    @torch.no_grad()
    def set_state(self, params: dict, ema: dict | None = None, mu=None, nu=None, count: int = 0):
        """Install parameters, EMA copies (default: the parameters) and the
        Adam state ([hash, *density, *rgb] lists; default zero)."""
        self.model.load_params(params)
        e = params if ema is None else ema
        for dst, src in zip(self.ema, [e["hash_table"], *e["density_mlp"], *e["rgb_mlp"]], strict=True):
            dst.copy_(src)
        self.optimizer.load_state(mu, nu, count)

    # ------------------------------------------------------------------ step
    def draw_background(self, generator: torch.Generator) -> torch.Tensor:
        """The step's sRGB background: random per step when enabled (one
        colour for all rays, ray_marcher.cu:90-93), else the fixed one."""
        if self.config.render.train_with_random_bg_color:
            return torch.rand((3,), generator=generator, dtype=torch.float32)
        return torch.tensor(self.background_color, dtype=torch.float32)

    def loss_and_grads(self, ds, n_rays: int, capacity: int, s_pad: int, n_rays_shift: int, salts, bg_srgb):
        """Batch, loss and the gradient of every parameter (no update)."""
        cfg = self.config
        scfg = cfg.sampler
        batch = generate_training_batch(
            scfg, self.aabb, ds.images, ds.xforms, ds.focal_length, (0.5, 0.5), self.grid.occupancy,
            salts, n_rays, n_rays_shift, capacity, s_pad,
        )
        bg_linear = srgb_to_linear(torch.as_tensor(bg_srgb, dtype=torch.float32).to(self.device))
        rgb_target, bg = compute_rgb_target(batch.rgba, bg_linear, self.color_space, cfg.render.train_in_linear_color)
        rgb_raw, sigma_raw = self.model.rgbsigma_raw(batch.pos, batch.dirs)
        loss, aux = train_loss(
            rgb_raw, sigma_raw, batch.layout,
            batch.dt_pad if batch.dt_pad is not None else scfg.min_cone_stepsize,
            batch.ray_valid, rgb_target.detach(), bg,
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

    def step(self, ds, n_rays: int, capacity: int, s_pad: int, n_rays_shift: int, salts, bg_srgb) -> dict:
        """One optimizer step; returns the step's stats as device tensors."""
        batch, loss, aux, grads = self.loss_and_grads(ds, n_rays, capacity, s_pad, n_rays_shift, salts, bg_srgb)
        self.optimizer.step(grads)
        return {
            "loss_sum": aux["loss_sum"],
            "measured_batch_size": aux["measured_batch_size"],
            "measured_batch_size_before_compaction": batch.n_samples,
            "max_ray_count": batch.max_ray_count,
        }

    @torch.no_grad()
    def probe(self, ds, n_probe: int, n_rays_shift: int, salts):
        """Batch generation alone on the current grid: (samples, longest ray)
        of `n_probe` rays, before truncation and drops."""
        b = generate_training_batch(
            self.config.sampler, self.aabb, ds.images, ds.xforms, ds.focal_length, (0.5, 0.5),
            self.grid.occupancy, salts, n_probe, n_rays_shift, n_probe, 32,
        )
        return int(b.n_samples), int(b.max_ray_count)

    # ----------------------------------------------------------- grid update
    @torch.no_grad()
    def grid_update(self, i_step: int, salts):
        """Occupancy upkeep: sample cells (uniform only for the first 256
        steps), density inference with the training params, scatter-max
        splat with EMA decay, threshold into the bitfield."""
        scfg = self.config.sampler
        n_total = scfg.n_total_elements
        n_uniform, n_nonuniform = (n_total // 4, n_total // 4) if i_step >= 256 else (n_total, 0)
        pos, idx = sample_grid_positions(scfg, self.grid.density, salts, n_uniform, n_nonuniform, self.grid.step)
        warped = self.aabb.relative_pos(pos)
        dens = torch.cat(
            [
                apply_density_activation(self.model.density_raw(warped[s : s + GRID_CHUNK])[:, 0], self.density_activation)
                for s in range(0, warped.shape[0], GRID_CHUNK)
            ]
        )
        grid = splat_density_ema(scfg, self.grid, idx, dens)
        self.grid = update_occupancy(scfg, grid)


class TrainingLoop:
    """Host-side loop state: the adaptive ray count, the padded width and
    the training telemetry of one dataset."""

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
        # per-ray sample estimate; None probes the fresh grid at the next call
        self._per_ray_est = None
        self._probe_next = False

    # ------------------------------------------------- controller persistence
    def controller_state(self) -> dict:
        return {
            "n_rays_per_batch": int(self.n_rays_per_batch),
            "s_pad": int(self.s_pad),
            "per_ray_est": float(self._per_ray_est) if self._per_ray_est else 0.0,
        }

    def restore_controller(self, d: dict):
        if not d:
            return
        self.n_rays_per_batch = self._quantize_n_rays(int(d.get("n_rays_per_batch", self.n_rays_per_batch)))
        self.s_pad = self._quantize_s_pad(int(d.get("s_pad", self.s_pad)), self.n_rays_per_batch)
        per_ray = float(d.get("per_ray_est", 0.0))
        self._per_ray_est = per_ray if per_ray > 0 else None

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

    def _sync(self):
        if self.trainer.device.type == "cuda":
            torch.cuda.synchronize(self.trainer.device)

    # ------------------------------------------------------------------ train
    def train(self, n_training_steps: int = 16):
        """One reference train() call: grid prep + n steps + controllers."""
        tr, ds, gen = self.trainer, self.dataset, self.generator
        t0 = time.perf_counter()
        tr.grid_update(self.i_step, draw_salts(gen))
        if self._per_ray_est is None or self._probe_next:
            # size n_rays / s_pad from the grid this call marches; the probe
            # peeks at the generator's next salts without consuming them
            n_probe = 1 << 10
            peek = torch.Generator().set_state(gen.get_state())
            ns, mrc = tr.probe(ds, n_probe, self.n_rays_total, draw_salts(peek))
            per_ray = ns / n_probe
            if per_ray > 0:
                self.n_rays_per_batch = self._pick_n_rays(per_ray, tr.target_batch_size, self.n_rays_per_batch)
                self._per_ray_est = per_ray
                self.s_pad = self._quantize_s_pad(int(mrc * 1.25) + 1, self.n_rays_per_batch)
            self._probe_next = False
        self._sync()
        self.training_prep_ms = (time.perf_counter() - t0) * 1e3

        t0 = time.perf_counter()
        if self.i_step == 0:
            self.n_rays_total = 0
        all_stats = []
        for _ in range(n_training_steps):
            shift = self.n_rays_total
            self.n_rays_total += self.n_rays_per_batch
            salts = draw_salts(gen)
            bg = tr.draw_background(gen)
            all_stats.append(tr.step(ds, self.n_rays_per_batch, self.capacity, self.s_pad, shift % _U32, salts, bg))
            self.i_step += 1
        # one device -> host copy of the call's telemetry (testbed.cu:266-289)
        stats = {k: torch.stack([s[k] for s in all_stats]).cpu().numpy() for k in all_stats[0]}
        self._sync()
        self.training_ms = (time.perf_counter() - t0) * 1e3

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
        return stats
