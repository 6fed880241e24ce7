"""Testbed — the pyngp-shaped facade, on torch: train, save, load, render.

Counterpart: ngp_tpu/testbed.py:30-81 (enums), :83-115 (TrainingBufferView,
RenderingBufferView), :117-180 (Testbed construction and config loading),
:182-207 (load_training_data, with the mark-and-merge of the grid), :209-240
(save_snapshot), :242-304 (load_snapshot), :307-329 (train, with the
runtime-tweakable loss, color space, background and activations) and
:332-436 (fov, set_nerf_camera_matrix, render_frame, render). Differs: the
Testbed runs on an explicit torch device (default "cuda"; it raises when
CUDA is absent instead of falling back to the CPU); parameter init draws
from a torch.Generator on that device and every training draw (grid and
batch salts, the random background) from a CPU torch.Generator seeded from
`seed`; render(spp > 1) always runs exact per-pass frames through
`accumulate` (ngp_tpu's per-pass branch, testbed.py:425-427); the renderer
reads its own model, loaded with the trainer's EMA weights after every
train() call; save_snapshot never serializes the optimizer. Envmaps,
reference-format snapshots and data parallelism are not ported yet.
"""

from dataclasses import dataclass, field

import numpy as np
import torch

from ngp_tpu_torch.data.nerf_synthetic import load_nerf_synthetic
from ngp_tpu_torch.grid.occupancy import GridState, mark_untrained_grid, update_occupancy
from ngp_tpu_torch.models.interop import params_from_numpy, params_to_numpy
from ngp_tpu_torch.models.ngp import NGPModel
from ngp_tpu_torch.ops.mlp import exact_fp32_matmul
from ngp_tpu_torch.render.buffer import accumulate, tonemap
from ngp_tpu_torch.render.renderer import Renderer
from ngp_tpu_torch.train.snapshot import load_snapshot as _load_snapshot
from ngp_tpu_torch.train.snapshot import save_snapshot as _save_snapshot
from ngp_tpu_torch.train.trainer import Trainer, TrainingLoop
from ngp_tpu_torch.utils.camera import focal_length_to_fov, fov_to_focal_length, opengl_to_opencv
from ngp_tpu_torch.utils.config import NGPConfig, load_commented_json


class _StrEnum:
    """pyngp's C++ enums as string-valued classes: each member is its name."""

    @classmethod
    def values(cls):
        return [v for k, v in vars(cls).items() if isinstance(v, str) and not k.startswith("_")]


class Activation(_StrEnum):
    ReLU = "ReLU"
    Logistic = "Logistic"
    Exponential = "Exponential"


# "None" is a Python keyword; pyngp users write getattr(Activation, "None").
setattr(Activation, "None", "None")


class RenderMode(_StrEnum):
    AO = "AO"
    Shade = "Shade"
    Normals = "Normals"
    Depth = "Depth"
    Distance = "Distance"
    Stepsize = "Stepsize"
    Cost = "Cost"


class ColorSpace(_StrEnum):
    Linear = "Linear"
    SRGB = "SRGB"


class TonemapCurve(_StrEnum):
    Identity = "Identity"
    ACES = "ACES"
    Hable = "Hable"
    Reinhard = "Reinhard"


class LossType(_StrEnum):
    L2 = "L2"
    L1 = "L1"
    Mape = "Mape"
    Smape = "Smape"
    SmoothL1 = "SmoothL1"
    LogL1 = "LogL1"
    RelativeL2 = "RelativeL2"


@dataclass
class TrainingBufferView:
    """Read-only training stats (python_api.cu:117-126)."""

    i_step: int = 0
    loss: float = float("nan")
    n_rays_per_batch: int = 0
    measured_batch_size: int = 0
    measured_batch_size_before_compaction: int = 0
    training_prep_ms: float = 0.0
    training_ms: float = 0.0


@dataclass
class RenderingBufferView:
    """Read-write rendering controls (python_api.cu:128-138)."""

    render_mode: str = "Shade"
    tonemap_curve: str = "Identity"
    exposure: float = 0.0
    fov_axis: int = 1
    relative_focal_length: tuple = (1.0, 1.0)
    principal_point: tuple = (0.5, 0.5)
    camera_matrix: np.ndarray = field(default_factory=lambda: np.zeros((3, 4), np.float32))


def resolve_device(device=None) -> torch.device:
    """None means the card; asking for CUDA without one raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return device


class Testbed:
    __test__ = False  # pyngp-parity name; not a pytest suite

    def __init__(self, device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            exact_fp32_matmul()
        self.seed = 43
        self.background_color = [0.0, 0.0, 0.0, 1.0]  # sRGB (testbed.h:116)
        self.color_space = "Linear"
        self.loss_type = "SmoothL1"
        self.density_activation = "Exponential"  # testbed.h:114
        self.rgb_activation = "Logistic"  # testbed.h:115
        self.scene_scale = 1.0
        self.scene_offset = (0.5, 0.5, 0.5)
        self.training_buffer = TrainingBufferView()
        self.rendering_buffer = RenderingBufferView()

        self._config_doc = None
        self.config: NGPConfig | None = None
        self.model: NGPModel | None = None  # the renderer's weights (the EMA copies)
        self._trainer: Trainer | None = None
        self._loop: TrainingLoop | None = None
        self._generator: torch.Generator | None = None
        self._dataset = None
        self._pending_controller = None
        self._renderer: Renderer | None = None
        self._accum = None
        self._spp = 0

    @property
    def grid(self) -> GridState | None:
        return None if self._trainer is None else self._trainer.grid

    @grid.setter
    def grid(self, value: GridState):
        self._trainer.grid = value

    # ------------------------------------------------------------ config/io
    def load_model_config(self, config_path):
        """Parse a json config (or load a .msgpack snapshot) and build the model."""
        path = str(config_path)
        if path.endswith(".msgpack"):
            self.load_snapshot(path)
            return
        self._config_doc = load_commented_json(path)
        self._init_from_doc(self._config_doc)

    def load_model_config_dict(self, doc: dict):
        self._config_doc = dict(doc)
        self._init_from_doc(self._config_doc)

    def _init_from_doc(self, doc):
        self.config = NGPConfig.from_json(doc)
        self.loss_type = self.config.loss
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.model = NGPModel(self.config.network, device=self.device).init(gen)
        self._trainer = Trainer.create(self.config, self.model.params(), self.device)
        self._generator = torch.Generator().manual_seed(self.seed)
        self._renderer = Renderer(
            model=self.model, config=self.config, train_in_linear_color=self.config.render.train_in_linear_color
        )
        self.training_buffer = TrainingBufferView()
        self._loop = None
        self._accum = None

    def set_state(self, params: dict, density_grid, scene_scale=None, scene_offset=None, grid_step: int = 0, ema=None):
        """Install parameters ({hash_table (L, T_pad, F), density_mlp,
        rgb_mlp} tensors) and a density grid; the occupancy bitfield is
        recomputed from the grid (testbed.cu:160). `params` become the
        training parameters and their EMA copies (unless `ema` is given),
        with a fresh Adam state."""
        if scene_scale is not None:
            self.scene_scale = float(scene_scale)
        if scene_offset is not None:
            self.scene_offset = tuple(float(v) for v in scene_offset)
        self._trainer.set_state(params, ema)
        self.model.load_params(self._trainer.ema_params())
        density = torch.as_tensor(np.array(density_grid, np.float32)).to(self.device).reshape(-1)
        grid = self.grid._replace(density=density, step=int(grid_step))
        self.grid = update_occupancy(self.config.sampler, grid)

    def load_snapshot(self, snapshot_path):
        """Load a msgpack snapshot (either package's): training params, EMA
        weights (rendered from), grid, i_step and the loop's controllers."""
        doc, snap = _load_snapshot(snapshot_path)
        self._config_doc = doc
        self._init_from_doc(doc)
        spec = self.model.grid_spec
        self.set_state(
            params_from_numpy(snap["params"], spec), snap["density_grid"], snap["scene_scale"], snap["scene_offset"],
            snap["grid_step"], ema=params_from_numpy(snap["ema_params"], spec),
        )
        self.training_buffer = TrainingBufferView(i_step=int(snap.get("i_step", 0)))
        self._pending_controller = snap.get("controller")

    def save_snapshot(self, snapshot_path):
        """Write an msgpack snapshot that ngp_tpu loads too (its
        serialize_optimizer=False form)."""
        tr = self._trainer
        _save_snapshot(
            snapshot_path,
            self._config_doc or self.config.raw or {},
            params=params_to_numpy(tr.model.params()),
            ema_params=params_to_numpy(tr.ema_params()),
            density_grid=self.grid.density.cpu().numpy(),
            grid_step=self.grid.step,
            i_step=self.training_buffer.i_step,
            scene_scale=self.scene_scale,
            scene_offset=self.scene_offset,
            controller=self._loop.controller_state() if self._loop is not None else None,
        )

    # -------------------------------------------------------------- training
    def load_training_data(self, data_path, scale: float = 0.33, offset=(0.5, 0.5, 0.5)):
        """testbed.cu:95-125: load the dataset onto the device and mark the
        density grid: cells no camera sees become -1 (untrainable), cells
        seen now but untrained before reset to 0, the rest keep their
        density (a snapshot's grid survives)."""
        ds = load_nerf_synthetic(data_path, scale, tuple(offset), device=self.device)
        self._dataset = ds
        self.scene_scale = scale
        self.scene_offset = tuple(offset)
        mark = mark_untrained_grid(self.config.sampler, ds.resolution, ds.focal_length, ds.xforms)
        cur = self.grid.density
        density = torch.where(mark < 0, mark, torch.where(cur < 0, 0.0, cur))
        self.grid = self.grid._replace(density=density)
        self._loop = TrainingLoop(self._trainer, ds, self._generator)
        if self._pending_controller:
            self._loop.restore_controller(self._pending_controller)
            self._pending_controller = None

    def train(self, n_training_steps: int = 16, target_batch_size: int = 1 << 18):
        """One train() call: a grid update and n steps, then the renderer
        takes the new EMA weights."""
        if self._loop is None:
            raise RuntimeError("load_training_data must be called before train()")
        tr = self._trainer
        tr.target_batch_size = target_batch_size
        tr.loss_type = self.loss_type
        tr.color_space = self.color_space
        tr.background_color = tuple(self.background_color[:3])
        tr.density_activation = self.density_activation
        tr.rgb_activation = self.rgb_activation
        lb = self._loop
        lb.i_step = self.training_buffer.i_step
        lb.train(n_training_steps)
        self.model.load_params(tr.ema_params())
        self.training_buffer = TrainingBufferView(
            i_step=lb.i_step,
            loss=lb.loss_scalar,
            n_rays_per_batch=int(lb.n_rays_per_batch),
            measured_batch_size=int(lb.measured_batch_size),
            measured_batch_size_before_compaction=int(lb.measured_batch_size_before_compaction),
            training_prep_ms=lb.training_prep_ms,
            training_ms=lb.training_ms,
        )

    # ------------------------------------------------------------- rendering
    @property
    def fov(self):
        rb = self.rendering_buffer
        return float(focal_length_to_fov(1.0, rb.relative_focal_length[rb.fov_axis]))

    @fov.setter
    def fov(self, val):
        f = float(fov_to_focal_length(1, val))
        self.rendering_buffer.relative_focal_length = (f, f)

    def set_nerf_camera_matrix(self, cam):
        """OpenGL nerf pose -> scene-convention camera (testbed.h:86-88)."""
        cam = np.asarray(cam, np.float32).reshape(3, 4)
        self.rendering_buffer.camera_matrix = opengl_to_opencv(
            cam, self.scene_scale, list(self.scene_offset)
        ).numpy()

    def render_frame(self, width: int, height: int):
        """One spp pass accumulated into the internal buffer (testbed.cu:479)."""
        rb = self.rendering_buffer
        focal = rb.relative_focal_length[rb.fov_axis] * (width if rb.fov_axis == 0 else height)
        self._renderer.density_activation = self.density_activation
        self._renderer.rgb_activation = self.rgb_activation
        frame = self._renderer.render_frame(
            self.grid.occupancy,
            rb.camera_matrix,
            (width, height),
            (focal, focal),
            rb.principal_point,
            self._spp,
            render_mode=rb.render_mode,
            scene_scale=self.scene_scale,
        )
        if self._accum is None or self._accum.shape[:2] != (height, width) or self._spp == 0:
            self._accum = torch.zeros((height, width, 4), dtype=torch.float32, device=self.device)
        self._accum = accumulate(self._accum, frame, self._spp, self.color_space)
        self._spp += 1

    def render(self, width: int, height: int, spp: int = 8, to_srgb: bool = True) -> np.ndarray:
        """spp exact passes -> accumulate -> tonemap -> (H, W, 4) numpy."""
        self._spp = 0
        for _ in range(spp):
            self.render_frame(width, height)
        out = tonemap(
            self._accum,
            self.rendering_buffer.exposure,
            self.background_color,
            self.color_space,
            "SRGB" if to_srgb else "Linear",
            self.rendering_buffer.tonemap_curve,
        )
        return out.cpu().numpy()
