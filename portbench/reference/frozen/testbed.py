# Frozen copy of ngp_tpu_torch/testbed.py at commit ef1215de9ec9, the plain path only: the benchmark's reference.
# Kept: the rendering facade (config, set_state, camera, render). Left out: training, snapshots, the envmap and
# the data-parallel mesh (the reference trains through train/trainer.py and reads no snapshot).
"""Testbed — the pyngp-shaped facade, on torch: the rendering half.

Counterpart: ngp_tpu/testbed.py:30-81 (enums), :83-115
(RenderingBufferView), :117-180 (construction and config loading) and
:332-436 (fov, fov_xy, set_nerf_camera_matrix, render_frame, render).
render(spp > 1) takes ngp_tpu's batched branch: one frame of all the passes
from one cover march (Shade sharing one network evaluation per cover
point), when the renderer can batch them and the colour space is linear or
sRGB; otherwise the passes run one by one through `accumulate`.
"""

from dataclasses import dataclass, field

import numpy as np
import torch

from portbench.reference.frozen.grid.occupancy import GridState, create_grid_state, update_occupancy
from portbench.reference.frozen.models.ngp import NGPModel
from portbench.reference.frozen.ops.mlp import exact_fp32_matmul
from portbench.reference.frozen.render.buffer import accumulate, tonemap
from portbench.reference.frozen.render.renderer import Renderer
from portbench.reference.frozen.utils.camera import focal_length_to_fov, fov_to_focal_length, opengl_to_opencv
from portbench.reference.frozen.utils.config import NGPConfig
from portbench.reference.frozen.utils.device import resolve_device


class _StrEnum:
    """pyngp's C++ enums as string-valued classes: each member is its name."""

    @classmethod
    def values(cls):
        return [v for k, v in vars(cls).items() if isinstance(v, str) and not k.startswith("_")]


class RenderMode(_StrEnum):
    AO = "AO"
    Shade = "Shade"
    Normals = "Normals"
    Depth = "Depth"
    Distance = "Distance"
    Stepsize = "Stepsize"
    Cost = "Cost"


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


class Testbed:
    __test__ = False  # pyngp-parity name; not a pytest suite

    def __init__(self, device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            exact_fp32_matmul()
        self.background_color = [0.0, 0.0, 0.0, 1.0]  # sRGB (testbed.h:116)
        self.color_space = "Linear"
        self.density_activation = "Exponential"  # testbed.h:114
        self.rgb_activation = "Logistic"  # testbed.h:115
        self.scene_scale = 1.0
        self.scene_offset = (0.5, 0.5, 0.5)
        self.rendering_buffer = RenderingBufferView()
        self.config: NGPConfig | None = None
        self.model: NGPModel | None = None  # the renderer's weights
        self.grid: GridState | None = None
        self._renderer: Renderer | None = None
        self._accum = None
        self._spp = 0

    def load_model_config_dict(self, doc: dict):
        self.config = NGPConfig.from_json(dict(doc))
        self.model = NGPModel(self.config.network, device=self.device)
        self.grid = create_grid_state(self.config.sampler, device=self.device)
        self._renderer = Renderer(model=self.model, config=self.config,
                                  train_in_linear_color=self.config.render.train_in_linear_color)
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
        self.grid.density.copy_(torch.as_tensor(np.array(density_grid, np.float32)).reshape(-1))
        self.grid = update_occupancy(self.config.sampler, self.grid._replace(step=int(grid_step)))

    # ------------------------------------------------------------- rendering
    @property
    def fov(self):
        rb = self.rendering_buffer
        return float(focal_length_to_fov(1.0, rb.relative_focal_length[rb.fov_axis]))

    @fov.setter
    def fov(self, val):
        f = float(fov_to_focal_length(1, val))
        self.rendering_buffer.relative_focal_length = (f, f)

    @property
    def fov_xy(self):
        rb = self.rendering_buffer
        return tuple(float(focal_length_to_fov(1.0, f)) for f in rb.relative_focal_length)

    @fov_xy.setter
    def fov_xy(self, val):
        self.rendering_buffer.relative_focal_length = tuple(float(fov_to_focal_length(1, v)) for v in val)

    def set_nerf_camera_matrix(self, cam):
        """OpenGL nerf pose -> scene-convention camera (testbed.h:86-88)."""
        cam = np.asarray(cam, np.float32).reshape(3, 4)
        self.rendering_buffer.camera_matrix = opengl_to_opencv(
            cam, self.scene_scale, list(self.scene_offset)
        ).numpy()

    def _frame(self, width: int, height: int, spp: int, **kw) -> torch.Tensor:
        """The renderer's frame at spp index `spp` from the current camera,
        mode and activations, the weights and the grid."""
        rb = self.rendering_buffer
        focal = rb.relative_focal_length[rb.fov_axis] * (width if rb.fov_axis == 0 else height)
        self._renderer.density_activation = self.density_activation
        self._renderer.rgb_activation = self.rgb_activation
        return self._renderer.render_frame(
            self.grid.occupancy,
            rb.camera_matrix,
            (width, height),
            (focal, focal),
            rb.principal_point,
            spp,
            render_mode=rb.render_mode,
            scene_scale=self.scene_scale,
            occ_aabb=self.grid.occ_aabb,
            **kw,
        )

    def render_frame(self, width: int, height: int):
        """One spp pass accumulated into the internal buffer (testbed.cu:479)."""
        frame = self._frame(width, height, self._spp)
        if self._accum is None or self._accum.shape[:2] != (height, width) or self._spp == 0:
            self._accum = torch.zeros((height, width, 4), dtype=torch.float32, device=self.device)
        self._accum = accumulate(self._accum, frame, self._spp, self.color_space)
        self._spp += 1

    def render(self, width: int, height: int, spp: int = 8, to_srgb: bool = True) -> np.ndarray:
        """python_api.cu:22-46: spp passes -> accumulate -> tonemap -> (H, W, 4)
        numpy. When the renderer can batch them (can_batch_spp) the spp passes
        are one frame from one cover march, which returns the accumulated
        buffer (the mean `accumulate` computes); otherwise the passes run one
        by one through `accumulate`, as the reference's loop does."""
        self._spp = 0
        cs = self.color_space.lower()
        if spp > 1 and cs in ("linear", "srgb") and self._renderer.can_batch_spp():
            self._accum = self._frame(width, height, 0, n_spp=spp, accum_space=cs)
            self._spp = spp
        else:
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
