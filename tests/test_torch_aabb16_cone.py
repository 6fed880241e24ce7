"""instant-NGP's large-scene NeRF (aabb_scale 16: five cascaded occupancy
grids; cone stepping dt = t/256) on the port, on the CPU at a small size:
the plain training batch against an independent float64 march written from
the published description (portbench/reference/cone_march.py), the
benchmark's cell aabb16-oadd-train-800 loaded and rehearsed against the
frozen plain reference (loss, gradients, change and grid), and the batch
march's counters (sampling.training.MARCH_COUNTERS) kept and read with a
call's stats. The kernels' batch against the plain one, bit for bit, is a
card test (tests/test_torch_train_batch_cuda.py)."""

import importlib

import numpy as np
import pytest
import torch

from ngp_tpu_torch.grid import occupancy as occ_mod
from ngp_tpu_torch.sampling import training
from ngp_tpu_torch.sampling.lattice import n_lattice_points
from ngp_tpu_torch.utils import profiling
from ngp_tpu_torch.utils.aabb import AABB
from ngp_tpu_torch.utils.config import NGPConfig
from portbench.harness import scene
from portbench.harness.cell import run_cell
from portbench.harness.spec import load_benchmark, load_cell, load_reader
from portbench.reference import cone_march
from portbench.tests.tiny import merge, shrink, tiny_cell

CELL = "aabb16-oadd-train-800"
SEED = 2**31 + 29  # above 32 signed bits, as a run's seed may be
# the cell's sampler at the tests' grid size: aabb_scale and the cone kept
SAMPLER = {"aabb_scale": 16, "cone_angle_constant": 1 / 256, "grid_size": 32, "maximum_marching_steps": 256}


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _sampler(**kw):
    return NGPConfig.from_json({"samlper": {**SAMPLER, **kw}}).sampler


def _grid(cfg, seed=4):
    """Occupancy after update_occupancy of soft blobs in cascade 0 and of
    random boxes in every outer cascade, so rays cross occupied cells of each."""
    g = cfg.grid_size
    rng = np.random.default_rng(seed)
    ax = (np.arange(g) + 0.5) / g
    z, y, x = np.meshgrid(ax, ax, ax, indexing="ij")
    dens = np.zeros((cfg.n_cascades, g, g, g), np.float32)
    for _ in range(3):
        c = rng.uniform(0.35, 0.65, 3)
        dens[0] += np.exp(-(((x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2) / 0.01)).astype(np.float32)
    for k in range(1, cfg.n_cascades):
        for _ in range(4):
            lo = rng.integers(0, g - 6, 3)
            w = rng.integers(2, 6, 3)
            dens[k, lo[2] : lo[2] + w[2], lo[1] : lo[1] + w[1], lo[0] : lo[0] + w[0]] = 1.0  # axes (z, y, x)
    state = occ_mod.create_grid_state(cfg, device="cpu")._replace(density=torch.from_numpy(dens.reshape(-1)))
    return occ_mod.update_occupancy(cfg, state)


def _scene(n_images=6, size=24):
    """Cameras at radii 3-7 around the scene (inside the 16-wide box) looking at it."""
    from ngp_tpu_torch.data.synthetic import look_at_pose
    from ngp_tpu_torch.utils.camera import opengl_to_opencv

    poses = []
    for k in range(n_images):
        phi = 2.4 * k
        eye = (3.0 + 0.8 * k) * np.array([np.cos(phi) * 0.8, np.sin(phi) * 0.8, 0.3 + 0.5 * np.sin(1.3 * k)])
        poses.append(look_at_pose(eye))
    xforms = opengl_to_opencv(np.stack(poses), 1.0, [0.5, 0.5, 0.5])
    images = torch.rand((n_images, size, size, 4), generator=torch.Generator().manual_seed(1)).to(torch.float16)
    focal = 0.5 * size / np.tan(0.5 * 0.6911112070083618)
    return images, xforms, (focal, focal)


def test_plain_batch_against_independent_march(monkeypatch):
    """The port's plain batch at the cell's sampler (grid 32) against the
    float64 march of the published description: every ray's sample count
    equal and every sample within 1e-5 of the reference's position, except
    rays with a point within 1e-5 of a face between cells of unlike
    occupancy (or of the box, or of a cascade change in dt)."""
    cfg = _sampler()
    assert cfg.n_cascades == 5
    state = _grid(cfg)
    images, xforms, focal = _scene()
    aabb = AABB.scene(cfg.aabb_scale)
    seen = {}
    plain_count = training.count_samples

    def spy(cfg_, aabb_, occ, o, d, startt, **kw):
        seen.update(o=o, d=d, startt=startt, kw=kw)
        return plain_count(cfg_, aabb_, occ, o, d, startt, **kw)

    monkeypatch.setattr(training, "count_samples", spy)
    n_rays, max_steps = 384, cfg.maximum_marching_steps
    batch = training.generate_training_batch(
        cfg, aabb, images, xforms, focal, (0.5, 0.5), state.occupancy, [0x9E3779B9, 4321], n_rays, 77,
        n_rays * max_steps, max_steps, occ_aabb=state.occ_aabb, n_window=0)
    assert seen["kw"]["n_window"] == n_lattice_points(cfg) and not bool(seen["kw"]["k0"].any())
    ref = cone_march.march(seen["o"].numpy(), seen["d"].numpy(), seen["startt"].numpy(), state.occupancy.numpy(),
                           cfg.aabb_scale, cfg.cone_angle_constant, cfg.min_cone_stepsize, cfg.max_cone_stepsize,
                           max_steps)
    lay = batch.layout
    counts, base = lay.counts.numpy(), lay.base.numpy()
    lo, diag = np.asarray(aabb.lo, np.float64), np.asarray(aabb.hi, np.float64) - np.asarray(aabb.lo, np.float64)
    world = lo + batch.pos.numpy().astype(np.float64) * diag
    clear = ~ref["ambiguous"]
    assert clear.sum() > 0.8 * n_rays and ref["counts"][clear].sum() > 1000
    mips = {int(m) for r in np.nonzero(clear)[0] for m in ref["cascades"][r]}
    assert len(mips) >= 3, mips  # the samples lie in several cascades
    np.testing.assert_array_equal(counts[clear], ref["counts"][clear])
    for r in np.nonzero(clear & (counts > 0))[0]:
        got = world[base[r] : base[r] + counts[r]]
        np.testing.assert_allclose(got, ref["samples"][r], rtol=0, atol=1e-5)


def test_cell_loads():
    cell = load_cell(CELL)
    model = cell.config["model"]
    cfg = NGPConfig.from_json(model)
    assert (cfg.sampler.aabb_scale, cfg.sampler.cone_angle_constant, cfg.sampler.n_cascades) == (16, 1 / 256, 5)
    assert n_lattice_points(cfg.sampler) == 1664
    assert cfg.network.encoding.scale == pytest.approx(2 ** (11 / 15), rel=1e-5)
    base = load_cell("oadd-train-800")
    # base.json's widths and the oadd cell's scene and traffic
    assert merge(base.config["model"], {"samlper": model["samlper"], "network": {"encoding": model["network"]["encoding"]}}) == model
    assert {k: v for k, v in model["network"]["encoding"].items() if k != "per_level_scale"} == base.config["model"]["network"]["encoding"]
    assert cell.config["scene"] == base.config["scene"] and cell.traffic == base.traffic
    assert cell.chips == 1 and set(cell.limits) == set(base.limits)
    assert {m["name"] for m in cell.end_to_end} == {"train_step_ms", "setup_s"}
    names = {m["name"] for m in cell.per_layer}
    assert {"march_points_per_sample.train", "train_march_roofline", "batch_gen_ms.train", "mfu.train"} <= names
    # every training layer's metric that the base training cells report
    assert {m["name"] for m in base.per_layer} <= names
    bench = load_benchmark()
    entry = next(c for c in bench["configs"] if c["name"] == "ngp-aabb16-oadd")
    assert entry["source"] == cell.config["source"] and entry["reduced"] == cell.config["reduced"]


def test_cone_reference_imports_neither_jax_nor_the_port():
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(cone_march))
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    mods |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert mods == {"numpy"}


def _tiny(name=CELL):
    cell = tiny_cell(name)
    cell.config = merge(cell.config, {"model": {"samlper": SAMPLER}})
    return cell


def test_cell_rehearsal(tmp_path_factory, monkeypatch):
    """The cell end to end at a tiny size on the CPU (the port's plain paths),
    held against the frozen reference: `correct` under the cell's limits, and
    false when half of each step's batch is left out."""
    from portbench.calibrate import half_batch

    monkeypatch.setattr(scene, "SCENE_CACHE", tmp_path_factory.getbasetemp() / "portbench_scene")
    cell = _tiny()
    assert NGPConfig.from_json(cell.config["model"]).sampler.n_cascades == 5
    out = run_cell(cell, SEED, 0.5, False, 0.0, device="cpu", tweak=shrink)
    assert out["correct"], out["checks"]
    assert {"train_step_ms", "setup_s"} <= set(out["metrics"])
    with half_batch():
        out = run_cell(_tiny(), SEED, 0.5, False, 0.0, device="cpu", tweak=shrink)
    assert not out["correct"], out["checks"]


def test_march_counters_registered():
    names = training.MARCH_COUNTERS
    assert names[:3] == ("train.batch.rays", "train.batch.lat_slots", "train.batch.points")
    assert names[3:] == tuple(f"train.batch.samples.mip{k}" for k in range(training.MAX_CASCADES))
    c = training.MarchCounters("cpu")
    assert c.totals.dtype == torch.int64 and tuple(c.totals.shape) == (len(names),)
    before = profiling.counters()
    c.totals[2] += 40
    c.totals[3 + 4] += 7
    c.stage()
    c.count()
    c.stage()
    c.count()  # nothing new: nothing added
    after = profiling.counters()
    assert after.get("train.batch.points", 0) - before.get("train.batch.points", 0) == 40
    assert after.get("train.batch.samples.mip4", 0) - before.get("train.batch.samples.mip4", 0) == 7


def test_counter_readers(monkeypatch):
    """The cell's new metrics read the counters of the traced calls' records,
    and nothing where the port has none (the parent)."""
    from portbench.harness.cell import Run
    from portbench.harness.trace import Trace

    recs = [{"kind": "train", "counters": {"train.batch.points": 900, "train.batch.samples.mip0": 200,
                                           "train.batch.samples.mip3": 100, "train.batch.rays": 1000,
                                           "train.batch.lat_slots": 256000, "launches.train_march": 2}}]
    monkeypatch.setattr(profiling, "records", lambda kind=None: recs)
    run = Run(cell=load_cell(CELL), device_name="NVIDIA H100 80GB HBM3", peaks=(3.35e12, 989e12))
    run.traced_calls = [{"ms": 1.0, "graphed": True, "measured": 1.0, "steps": 16}]
    run.trace = Trace(ops=[("void (anonymous namespace)::train_march_kernel<2>(March)", 0.0, 1e-4)], start=0.0, end=1.0)
    assert load_reader("march_points_per_sample.train")(run) == pytest.approx(3.0)
    want = 100.0 * (1000 * 61 + 2 * 256000 + 2 * 5 * 128**3) / 3.35e12 / 1e-4
    assert load_reader("train_march_roofline")(run) == pytest.approx(want)
    recs[0]["counters"] = {"launches.train_march": 2}
    assert load_reader("march_points_per_sample.train")(run) is None
    assert load_reader("train_march_roofline")(run) is None


@pytest.mark.parametrize("cell, grids, cone", [(CELL, 5, True), ("oadd-train-800", 1, False),
                                               ("tcnn-train-800", 1, False)])
def test_roofline_bytes_follow_the_port_lattice(cell, grids, cone):
    """train_march_roofline charges each launch the occupancy of the cascades
    the port's lattice reads (cascade 0 alone on base.json's packed lattice,
    all five at aabb_scale 16) and the cone anchors only on the cone lattice."""
    model = load_cell(cell).config["model"]
    march_bytes = importlib.import_module("portbench.metrics.train_march_roofline").march_bytes
    assert march_bytes(model, 1000, 256000, 3) == 1000 * (45 + 16 * cone) + 2 * 256000 + 3 * grids * 128**3


def test_cell_control_fails(tmp_path_factory, monkeypatch):
    """Under the cell's limits the reference at float8 operands (the control)
    is not `correct` where the port is, at the tiny size."""
    from portbench.calibrate import train_readings
    from portbench.reference import compare

    monkeypatch.setattr(scene, "SCENE_CACHE", tmp_path_factory.getbasetemp() / "portbench_scene")
    cell = _tiny()
    readings = train_readings(cell, SEED, "cpu", control=True, fault=False, tweak=shrink)
    assert compare.judge(readings["program"], cell.limits)[0], readings["program"]
    assert not compare.judge(readings["control"], cell.limits)[0], readings["control"]
