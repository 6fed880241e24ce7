"""Testbed — the serving surface of the pyngp-shaped facade, on torch.

Counterpart: ngp_tpu/testbed.py:30-81 (enums), :96-115
(RenderingBufferView), :117-180 (Testbed construction and config loading),
:242-304 (load_snapshot) and :332-436 (fov, set_nerf_camera_matrix,
render_frame, render). Differs: the Testbed runs on an explicit torch device
(default "cuda"; it raises when CUDA is absent instead of falling back to the
CPU), parameter init draws from a torch.Generator, and render(spp > 1) always
runs exact per-pass frames through `accumulate` (ngp_tpu's per-pass branch,
testbed.py:425-427). Training, snapshot saving, envmaps and data parallelism
are not ported yet.
"""

from dataclasses import dataclass, field

import numpy as np
import torch

from ngp_tpu_torch.grid.occupancy import GridState, create_grid_state, update_occupancy
from ngp_tpu_torch.models.interop import params_from_numpy
from ngp_tpu_torch.models.ngp import NGPModel
from ngp_tpu_torch.ops.mlp import exact_fp32_matmul
from ngp_tpu_torch.render.buffer import accumulate, tonemap
from ngp_tpu_torch.render.renderer import Renderer
from ngp_tpu_torch.train.snapshot import load_snapshot as _load_snapshot
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
        self.density_activation = "Exponential"  # testbed.h:114
        self.rgb_activation = "Logistic"  # testbed.h:115
        self.scene_scale = 1.0
        self.scene_offset = (0.5, 0.5, 0.5)
        self.rendering_buffer = RenderingBufferView()

        self._config_doc = None
        self.config: NGPConfig | None = None
        self.model: NGPModel | None = None
        self.grid: GridState | None = None
        self._renderer: Renderer | None = None
        self._accum = None
        self._spp = 0

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
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.model = NGPModel(self.config.network, device=self.device).init(gen)
        self.grid = create_grid_state(self.config.sampler, device=self.device)
        self._renderer = Renderer(
            model=self.model, config=self.config, train_in_linear_color=self.config.render.train_in_linear_color
        )
        self._accum = None

    def set_state(self, params: dict, density_grid, scene_scale=None, scene_offset=None, grid_step: int = 0):
        """Install parameters ({hash_table (L, T_pad, F), density_mlp,
        rgb_mlp} tensors) and a density grid; the occupancy bitfield is
        recomputed from the grid (testbed.cu:160)."""
        if scene_scale is not None:
            self.scene_scale = float(scene_scale)
        if scene_offset is not None:
            self.scene_offset = tuple(float(v) for v in scene_offset)
        self.model.load_params(params)
        density = torch.as_tensor(np.array(density_grid, np.float32)).to(self.device).reshape(-1)
        grid = self.grid._replace(density=density, step=int(grid_step))
        self.grid = update_occupancy(self.config.sampler, grid)

    def load_snapshot(self, snapshot_path):
        """Load an ngp_tpu msgpack snapshot and render from its EMA weights."""
        doc, snap = _load_snapshot(snapshot_path)
        self._config_doc = doc
        self._init_from_doc(doc)
        params = params_from_numpy(snap["ema_params"], self.model.grid_spec)
        self.set_state(
            params, snap["density_grid"], snap["scene_scale"], snap["scene_offset"], snap["grid_step"]
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
