"""Which training batches the kernels of csrc/train_batch.cu generate: a card
step with the occupied box and a window of whole segments that lat_pad's
int16 ordinals hold, on every lattice (the packed march's, the cascades', the
cone's); no occupied box, too long a lattice, too many cascades and CPU
tensors take the plain path. The kernels themselves run only on the card
(tests/test_torch_train_batch_cuda.py)."""

import numpy as np
import pytest
import torch

from ngp_tpu_torch.grid import occupancy as occ_mod
from ngp_tpu_torch.ops import kernels
from ngp_tpu_torch.sampling import training
from ngp_tpu_torch.sampling.lattice import n_lattice_points
from ngp_tpu_torch.utils import profiling
from ngp_tpu_torch.utils.aabb import AABB
from ngp_tpu_torch.utils.config import NGPConfig

torch.set_num_threads(2)

BOX = torch.tensor([[0.3, 0.3, 0.3], [0.7, 0.7, 0.7]])
CUDA = torch.device("cuda")  # a device object only: no card is touched


def _sampler(**kw):
    return NGPConfig.from_json({"samlper": kw}).sampler


@pytest.mark.parametrize(
    "sampler,occ_aabb,n_window,device,takes",
    [
        ({}, BOX, 1152, CUDA, True),  # base.json at the training cells' window
        ({}, BOX, 0, CUDA, True),  # the whole lattice
        ({"grid_size": 32, "maximum_marching_steps": 256}, BOX, 0, CUDA, True),  # the tests' TINY sampler
        ({"cone_angle_constant": 0.004}, BOX, 0, CUDA, True),  # the cone lattice
        ({"aabb_scale": 2}, BOX, 0, CUDA, True),  # a march over cascades
        ({"aabb_scale": 16, "cone_angle_constant": 1 / 256}, BOX, 1664, CUDA, True),  # ngp-aabb16-oadd
        ({"aabb_scale": 16, "cone_angle_constant": 1 / 256}, BOX, 512, CUDA, True),  # the cone ignores the window
        ({"aabb_scale": 16}, BOX, 2048, CUDA, True),  # cascades on the arithmetic lattice
        ({"aabb_scale": 32}, BOX, 0, CUDA, False),  # a 32,896-point lattice: past lat_pad's int16
        ({"aabb_scale": 256, "cone_angle_constant": 1 / 256}, BOX, 0, CUDA, False),  # 9 cascades
        ({"aabb_scale": 16, "cone_angle_constant": 1 / 256}, None, 0, CUDA, False),  # the cone without the box
        ({}, None, 0, CUDA, False),  # no occupied box: no window start
        ({}, BOX, 1100, CUDA, False),  # a window of part segments
        ({}, BOX, 1152, torch.device("cpu"), False),  # CPU tensors
    ],
)
def test_batch_kernels_take(sampler, occ_aabb, n_window, device, takes):
    assert training.batch_kernels_take(_sampler(**sampler), occ_aabb, n_window, device) is takes


def test_batch_kernels_registered():
    """The source builds with the other kernels and both launch counters are
    kept (a graph replay adds them)."""
    assert "train_batch" in kernels.SOURCES
    assert (kernels.CSRC / "train_batch.cu").exists()
    assert {"train_march", "train_emit"} <= set(kernels.LAUNCH_COUNTERS)
    assert {"train_march", "train_emit"} <= set(kernels.launch_counts())


def test_kernel_wrappers_refuse_cpu_tensors():
    cfg = _sampler()
    occ = torch.zeros((cfg.n_cascades, cfg.grid_size, cfg.grid_size, cfg.grid_size), dtype=torch.bool)
    r = torch.zeros((4,))
    with pytest.raises(ValueError):
        training.train_march(cfg, AABB.scene(1), occ, torch.zeros((4, 3)), torch.ones((4, 3)), r,
                             torch.zeros((4,), dtype=torch.int64), r > 0, 1152, 96, 512, True)


def test_cpu_batch_takes_plain_path():
    """A base.json batch on CPU tensors runs the plain path: no kernel launch,
    and train.batch.plain (a card step's count) stays unchanged."""
    cfg = _sampler()
    g = cfg.grid_size
    dens = np.zeros((cfg.n_cascades, g, g, g), np.float32)
    dens[0, 48:80, 40:88, 56:72] = 1.0
    state = occ_mod.create_grid_state(cfg, device="cpu")._replace(density=torch.from_numpy(dens.reshape(-1)))
    state = occ_mod.update_occupancy(cfg, state)
    xforms = torch.tensor([[[1.0, 0.0, 0.0, 0.5], [0.0, 1.0, 0.0, 0.5], [0.0, 0.0, 1.0, -1.5]]])
    images = torch.rand((1, 16, 16, 4)).to(torch.float16)
    keys = ("launches.train_march", "launches.train_emit", "train.batch.plain")
    before = {k: profiling.get(k) for k in keys}
    batch = training.generate_training_batch(
        cfg, AABB.scene(1), images, xforms, (20.0, 20.0), (0.5, 0.5), state.occupancy, [7, 11], 64, 0, 1 << 12, 256,
        occ_aabb=state.occ_aabb, n_window=n_lattice_points(cfg), n_seg_cap=48,
    )
    assert {k: profiling.get(k) for k in keys} == before
    assert int(batch.n_samples) > 0 and int(batch.seg_count_hi) > 0


@pytest.mark.parametrize("grid_size,n_cells", [(128, 40), (128, 400), (64, 25)])
def test_pooled_occupancy_one_axis_at_a_time(grid_size, n_cells):
    """The batch's pooled super-grid, pooled one axis at a time, equals the
    (8 + 2 * HALO)^3 any-pool at stride 8, on sparse grids whose cells sit on
    every offset from a superblock's edge."""
    cfg = _sampler(grid_size=grid_size)
    rng = np.random.default_rng(grid_size + n_cells)
    occ = torch.zeros((cfg.n_cascades, grid_size, grid_size, grid_size), dtype=torch.bool)
    cells = rng.integers(0, grid_size, (n_cells, 3))
    cells[: n_cells // 2, rng.integers(0, 3)] = rng.integers(0, grid_size // 8, n_cells // 2) * 8 + np.arange(n_cells // 2) % 8
    occ[rng.integers(0, cfg.n_cascades, n_cells), cells[:, 0], cells[:, 1], cells[:, 2]] = True
    w = occ_mod.POOL + 2 * occ_mod.HALO
    want = torch.nn.functional.max_pool3d(occ.to(torch.float32)[:, None], w, stride=occ_mod.POOL, padding=occ_mod.HALO)
    got = occ_mod.pooled_occupancy(cfg, occ)
    assert 0 < int(got.sum()) < got.numel()
    assert torch.equal(got, want[:, 0] > 0)
