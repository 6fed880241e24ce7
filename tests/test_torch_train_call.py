"""Port parity for the training call as ngp_tpu runs it: train_loss with the
long bucket, one step at a bucketed shape against ngp_tpu's jitted
train_step, train_call(fuse) against fuse single steps, the shape
controllers against ngp_tpu's TrainingLoop, the OOM demotion, and the
controllers carried through snapshots in both directions."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_tpu.grid import occupancy as j_occ
from ngp_tpu.models.ngp import apply_density_activation as j_dens_act
from ngp_tpu.models.ngp import apply_rgb_activation as j_rgb_act
from ngp_tpu.render.composite import train_loss as j_train_loss
from ngp_tpu.sampling.lattice import n_lattice_points as j_nlat
from ngp_tpu.sampling.training import generate_training_batch as j_gen
from ngp_tpu.testbed import Testbed as JTestbed
from ngp_tpu.train.trainer import Trainer as JTrainer
from ngp_tpu.train.trainer import TrainingLoop as JLoop
from ngp_tpu.utils.config import NGPConfig as JCfg
from ngp_tpu_torch import Testbed
from ngp_tpu_torch.data.synthetic import look_at_pose, write_synthetic_dataset
from ngp_tpu_torch.models.interop import grid_from_numpy, opt_state_to_leaves, params_from_numpy, params_to_numpy
from ngp_tpu_torch.models.ngp import NGPModel
from ngp_tpu_torch.models.ngp import apply_density_activation as t_dens_act
from ngp_tpu_torch.models.ngp import apply_rgb_activation as t_rgb_act
from ngp_tpu_torch.ops.hash_encoding import HashGridSpec
from ngp_tpu_torch.render.composite import train_loss as t_train_loss
from ngp_tpu_torch.sampling.training import generate_training_batch as t_gen
from ngp_tpu_torch.train import trainer as t_trainer
from ngp_tpu_torch.train.trainer import STAT_KEYS
from ngp_tpu_torch.train.trainer import Trainer as TTrainer
from ngp_tpu_torch.train.trainer import TrainingLoop as TLoop
from ngp_tpu_torch.utils.aabb import AABB as TAABB
from ngp_tpu_torch.utils.camera import opengl_to_opencv
from ngp_tpu_torch.utils import profiling
from ngp_tpu_torch.utils.config import NGPConfig as TCfg

torch.set_num_threads(2)

# tests/test_end_to_end.py:19-27
TINY = {
    "samlper": {"aabb_scale": 1, "grid_size": 32, "maximum_marching_steps": 256},
    "network": {
        "encoding": {"n_levels": 8, "log2_hashmap_size": 14, "base_resolution": 16, "desired_resolution": 256},
        "network": {"n_neurons": 64, "n_hidden_layers": 1},
        "dir_encoding": {"degree": 4},
        "rgb_network": {"n_neurons": 64, "n_hidden_layers": 2},
    },
}
# a bucketed shape with the window and the two-level march on
N_RAYS, CAPACITY, S_PAD, SHIFT = 512, 1 << 14, 256, 1000
SHAPE = dict(s_short=32, n_long=128, n_seg_cap=16)


def _density(cfg, seed):
    g = cfg.grid_size
    rng = np.random.default_rng(seed)
    ax = (np.arange(g) + 0.5) / g
    z, y, x = np.meshgrid(ax, ax, ax, indexing="ij")
    dens = np.zeros((cfg.n_cascades, g, g, g), np.float32)
    for _ in range(3):
        c = rng.uniform(0.35, 0.65, 3)
        dens[0] += 3.0 * np.exp(-(((x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2) / 0.01)).astype(np.float32)
    return dens.reshape(-1)


def _dataset(n=4, h=24, w=32, seed=0):
    rng = np.random.default_rng(seed)
    poses = [look_at_pose(4.0 * np.array([np.cos(2.4 * k) * 0.8, np.sin(2.4 * k) * 0.8, 0.6])) for k in range(n)]
    xforms = opengl_to_opencv(np.stack(poses), 0.33, [0.5, 0.5, 0.5]).numpy()
    images = rng.uniform(0, 1, (n, h, w, 4)).astype(np.float16)
    return images, xforms, (40.0, 40.0)


def _n_window(cfg, box):
    """ngp_tpu's TrainingLoop sizing of the window (trainer.py:629-635)."""
    diag = float(np.linalg.norm(box[1] - box[0]))
    need = int(np.ceil(diag / cfg.min_cone_stepsize)) + 2
    return min(j_nlat(cfg), max(128, 128 << int(np.ceil(np.log2(max(need / 128, 1))))))


def _port_trainer(tc, params, dens, seed=3):
    """A CPU trainer at `params` with seeded Adam moments (counts 37 / 36)."""
    spec = HashGridSpec.create(tc.network.encoding)
    tr = TTrainer.create(tc, params_from_numpy(params, spec), "cpu")
    gen = torch.Generator().manual_seed(seed)
    mu = [torch.randn(p.shape, generator=gen) * 1e-3 for p in tr.optimizer.params]
    nu = [torch.rand(p.shape, generator=gen) * 1e-5 for p in tr.optimizer.params]
    tr.set_state(params_from_numpy(params, spec), None, mu, nu, 37, 36)
    tr.grid = grid_from_numpy(tc.sampler, dens, 0, device="cpu")
    return tr


def _jax_params(jc, seed=7):
    p = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), JTrainer.create(jc).init_state(seed).params)
    p["hash_table"] = p["hash_table"] * np.float32(1e3)  # trained magnitudes: the heads see a real encoding
    return p


def test_train_loss_with_the_long_bucket_equals_jax():
    """train_loss over a bucketed batch (short bucket + extra_buckets), the
    loss, its stats and the gradients of the flat network outputs, within
    1e-6 relative of ngp_tpu's."""
    jc, tc = JCfg.from_json(TINY), TCfg.from_json(TINY)
    dens = _density(jc.sampler, 1)
    jg = j_occ.update_occupancy(jc.sampler, j_occ.create_grid_state(jc.sampler)._replace(density=jnp.asarray(dens)))
    images, xforms, focal = _dataset()
    key = jax.random.PRNGKey(5)
    kw = dict(n_window=_n_window(jc.sampler, np.asarray(jg.occ_aabb)), **SHAPE)
    jb = j_gen(jc.sampler, JTrainer.create(jc).aabb, jnp.asarray(images), jnp.asarray(xforms), focal, (0.5, 0.5), jg.occupancy,
               key, N_RAYS, jnp.uint32(SHIFT), CAPACITY, j_nlat(jc.sampler), S_PAD, occ_aabb=jg.occ_aabb, **kw)
    tg = grid_from_numpy(tc.sampler, dens, 0, device="cpu")
    salts = torch.from_numpy(np.asarray(jax.random.bits(key, (2,), jnp.uint32)).astype(np.int64))
    tb = t_gen(tc.sampler, TAABB.scene(1), torch.from_numpy(images), torch.from_numpy(xforms),
               focal, (0.5, 0.5), tg.occupancy, salts, N_RAYS, SHIFT, CAPACITY, S_PAD, occ_aabb=tg.occ_aabb, **kw)
    assert jb.layout_long is not None and tb.layout_long is not None

    rng = np.random.default_rng(6)
    rgb_raw = rng.normal(size=(CAPACITY, 3)).astype(np.float32)
    sigma_raw = rng.normal(size=(CAPACITY,)).astype(np.float32) + 1.0
    target = rng.uniform(size=(N_RAYS, 3)).astype(np.float32)
    bg = np.array([0.2, 0.5, 0.7], np.float32)
    common = dict(n_rays_denom=N_RAYS, loss_type="SmoothL1", transmittance_threshold=jc.render.transmittance_threshold,
                  rgb_activation="Logistic", density_activation="Exponential", min_optical_thickness=1e9)
    dt = jc.sampler.min_cone_stepsize

    def j_loss(r, s):
        extra = ((jb.layout_long, dt, jb.valid_long, jnp.asarray(target)[jb.sel_long], jnp.asarray(bg)),)
        return j_train_loss(r, s, jb.layout, dt, jb.valid_short, jnp.asarray(target), jnp.asarray(bg), extra_buckets=extra,
                            mean_density=jnp.float32(0.0), apply_rgb_activation=j_rgb_act, apply_density_activation=j_dens_act, **common)

    (jl, jaux), (jgr, jgs) = jax.value_and_grad(j_loss, argnums=(0, 1), has_aux=True)(jnp.asarray(rgb_raw), jnp.asarray(sigma_raw))
    tr_, ts_ = (torch.from_numpy(x).requires_grad_(True) for x in (rgb_raw, sigma_raw))
    tt = torch.from_numpy(target)
    extra = ((tb.layout_long, dt, tb.valid_long, tt[tb.sel_long], torch.from_numpy(bg)),)
    tl, taux = t_train_loss(tr_, ts_, tb.layout, dt, tb.valid_short, tt, torch.from_numpy(bg), extra_buckets=extra,
                            mean_density=torch.tensor(0.0), apply_rgb_activation=t_rgb_act, apply_density_activation=t_dens_act,
                            **common)
    tgr, tgs = torch.autograd.grad(tl, (tr_, ts_))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    np.testing.assert_allclose(float(taux["loss_sum"]), float(jaux["loss_sum"]), rtol=1e-6)
    assert int(taux["measured_batch_size"]) == int(jaux["measured_batch_size"]) > 0
    np.testing.assert_allclose(tgr.numpy(), np.asarray(jgr), rtol=1e-6, atol=1e-6 * float(np.abs(np.asarray(jgr)).max()))
    np.testing.assert_allclose(tgs.numpy(), np.asarray(jgs), rtol=1e-6, atol=1e-6 * float(np.abs(np.asarray(jgs)).max()))


def _port_params(tc):
    return NGPModel(tc.network, device="cpu").init(torch.Generator().manual_seed(0)).params()


@pytest.mark.parametrize("stochastic", [True, False])
def test_step_at_a_bucketed_shape_equals_jax_train_step(stochastic):
    """One port step against ngp_tpu's jitted train_step from the same
    parameters, Adam state, grid and draws (JAX's salts and background
    injected): the loss within 1e-6 relative, the integer stats equal, each
    MLP matrix's update within 2e-2 relative L2 (test_torch_trainer.py's
    gradient tolerance). The hash table: under jit XLA contracts the flat
    positions' o + t*d into fused multiply-adds in about half the lanes
    (25,550 of 49,152 measured on this batch), an ulp away from the eager
    op-by-op positions the port equals bit for bit
    (test_torch_training_batch_shapes.py); the stochastic deposit hashes
    those bits, so there the drawn corners differ and only the count of
    moved entries per level is held (within 2 %); with the exact deposit
    ngp_tpu sums in bf16 (ROADMAP queue 3, note e), where a few sums cancel
    to zero and leave their entry unmoved (14 of 262,144 measured): at most
    1e-4 of the moved flags differ and the update is within 2e-2."""
    doc = {**TINY, "network": {**TINY["network"], "encoding": {**TINY["network"]["encoding"], "stochastic_corner_backward": stochastic}}}
    jc, tc = JCfg.from_json(doc), TCfg.from_json(doc)
    assert HashGridSpec.create(tc.network.encoding).stochastic_bwd == stochastic
    p0 = _jax_params(jc)
    dens = _density(jc.sampler, 1)
    images, xforms, focal = _dataset()
    tr = _port_trainer(tc, p0, dens)

    jtr = JTrainer.create(jc)
    st = jtr.init_state(7)
    leaves = opt_state_to_leaves(tr.optimizer.state(), len(tr.model.density_mlp))
    opt = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(st.opt_state), [jnp.asarray(x) for x in leaves])
    jgrid = j_occ.update_occupancy(jc.sampler, j_occ.create_grid_state(jc.sampler)._replace(density=jnp.asarray(dens)))
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    st = st._replace(params=jp, ema_params=jax.tree_util.tree_map(jnp.copy, jp), opt_state=opt, grid=jgrid, rng=jax.random.PRNGKey(11))
    n_window = _n_window(jc.sampler, np.asarray(jgrid.occ_aabb))
    _, k_batch, k_bg = jax.random.split(st.rng, 3)
    salts = np.asarray(jax.random.bits(k_batch, (2,), jnp.uint32)).astype(np.float64)
    bg = np.asarray(jax.random.uniform(k_bg, (3,)), np.float64)
    step = jtr.train_step(N_RAYS, CAPACITY, S_PAD, n_window, **SHAPE)
    new, j_stats = step(st, jnp.asarray(images), jnp.asarray(xforms), jnp.asarray(focal), jnp.uint32(SHIFT))
    j_stats = jax.device_get(j_stats)
    want = jax.tree_util.tree_map(np.asarray, new.params)

    ds = SimpleNamespace(images=torch.from_numpy(images), xforms=torch.from_numpy(xforms), focal_length=focal)
    row = torch.from_numpy(np.concatenate([salts, [SHIFT], bg, tr.optimizer.hyper_rows(1)[0]]))
    out = torch.zeros(len(STAT_KEYS), dtype=torch.float64)
    tr.train_step(N_RAYS, CAPACITY, S_PAD, n_window, **SHAPE)(ds, row, out)
    stats = dict(zip(STAT_KEYS, out.tolist(), strict=True))
    np.testing.assert_allclose(stats["loss_sum"], float(j_stats["loss_sum"]), rtol=1e-6)
    for k in STAT_KEYS[1:]:
        assert stats[k] == int(j_stats[k]), k
    assert stats["seg_count_hi"] > 0 and stats["count_at_split"] > 0

    got = params_to_numpy(tr.model.params())
    for name in ("density_mlp", "rgb_mlp"):
        for a, b, c in zip(got[name], want[name], p0[name], strict=True):
            rel = np.linalg.norm(a - b) / np.linalg.norm(b - c)
            assert rel < 2e-2, f"{name}: relative L2 error of the update {rel}"
    a, b, c = got["hash_table"], want["hash_table"], p0["hash_table"]  # (L, F, T_pad)
    moved_t, moved_j = a != c, b != c
    if stochastic:
        per_t, per_j = moved_t.sum(axis=(1, 2)), moved_j.sum(axis=(1, 2))
        np.testing.assert_allclose(per_t, per_j, rtol=2e-2)
    else:
        assert (moved_t != moved_j).mean() <= 1e-4, int((moved_t != moved_j).sum())
        rel = np.linalg.norm(a - b) / np.linalg.norm(b - c)
        assert rel < 2e-2, f"hash table: relative L2 error of the update {rel}"


def test_train_call_equals_single_steps():
    """train_call(fuse=4) with a call's draw table equals four train_step
    calls with the same rows: parameters, EMA, moments and stats (atol 0)."""
    jc, tc = JCfg.from_json(TINY), TCfg.from_json(TINY)
    p0, dens = _jax_params(jc), _density(jc.sampler, 2)
    images, xforms, focal = _dataset(seed=1)
    ds = SimpleNamespace(images=torch.from_numpy(images), xforms=torch.from_numpy(xforms), focal_length=focal)
    a, b = _port_trainer(tc, p0, dens), _port_trainer(tc, p0, dens)
    n_window = _n_window(tc.sampler, a.grid.occ_aabb.numpy())
    table = torch.from_numpy(a.draw_table(torch.Generator().manual_seed(4), 4, SHIFT, N_RAYS))
    assert torch.equal(table, torch.from_numpy(b.draw_table(torch.Generator().manual_seed(4), 4, SHIFT, N_RAYS)))
    out_a = torch.zeros((4, len(STAT_KEYS)), dtype=torch.float64)
    out_b = torch.zeros_like(out_a)
    call = a.train_call(N_RAYS, CAPACITY, S_PAD, 4, n_window, **SHAPE)
    assert a.train_call(N_RAYS, CAPACITY, S_PAD, 4, n_window, **SHAPE) is call  # cached by ngp_tpu's key
    call(ds, table, out_a)
    assert call.graph is None  # no graphs on the CPU
    step = b.train_step(N_RAYS, CAPACITY, S_PAD, n_window, **SHAPE)
    for k in range(4):
        step(ds, table[k], out_b[k])
    assert torch.equal(out_a, out_b) and bool((out_a[:, 1] > 0).all())
    for x, y in zip([*a.model.param_list(), *a.ema, *a.optimizer.mu, *a.optimizer.nu],
                    [*b.model.param_list(), *b.ema, *b.optimizer.mu, *b.optimizer.nu], strict=True):
        assert torch.equal(x.detach(), y.detach())
    # the semantic key: a runtime change builds a new entry
    a.loss_type = "L2"
    assert a.train_call(N_RAYS, CAPACITY, S_PAD, 4, n_window, **SHAPE) is not call


def _loops():
    jc, tc = JCfg.from_json(TINY), TCfg.from_json(TINY)
    jl = JLoop(JTrainer.create(jc), None)
    tl = TLoop(TTrainer.create(tc, _port_params(tc), "cpu"), None, torch.Generator())
    return jl, tl


CONTROLLER = ("n_rays_per_batch", "s_pad", "n_window", "s_short", "n_seg_cap", "_seg_est", "_seg_shrink_votes")


@pytest.mark.parametrize(
    "state",
    [
        dict(n_rays_per_batch=4096, s_pad=256, n_window=512, s_short=64, n_seg_cap=0, _seg_est=None, _seg_shrink_votes=0),
        dict(n_rays_per_batch=6144, s_pad=128, n_window=512, s_short=32, n_seg_cap=0, _seg_est=9.0, _seg_shrink_votes=0),
        dict(n_rays_per_batch=8192, s_pad=256, n_window=256, s_short=256, n_seg_cap=24, _seg_est=20.0, _seg_shrink_votes=0),
        dict(n_rays_per_batch=3072, s_pad=512, n_window=1152, s_short=0, n_seg_cap=96, _seg_est=30.0, _seg_shrink_votes=1),
        dict(n_rays_per_batch=512, s_pad=64, n_window=128, s_short=16, n_seg_cap=40, _seg_est=7.0, _seg_shrink_votes=0),
    ],
)
def test_shape_choice_and_controllers_equal_jax(state):
    """_choose_shape (committing and not), peek_shape and the kept-segment
    votes over a run of seg estimates, then controller_state /
    restore_controller, against ngp_tpu's TrainingLoop from the same state."""
    jl, tl = _loops()
    for loop in (jl, tl):
        for k, v in state.items():
            setattr(loop, k, v)
    assert tl.peek_shape(16) == jl.peek_shape(16)
    for seg_est in (None, 30.0, 12.0, 5.0, 5.0, 5.0, 60.0, 2.0):
        if seg_est is not None:
            jl._seg_est = tl._seg_est = seg_est
        assert tl.peek_shape(16) == jl.peek_shape(16)
        assert tl._choose_shape(16, commit=True) == jl._choose_shape(16, commit=True)
        assert [getattr(tl, k) for k in CONTROLLER] == [getattr(jl, k) for k in CONTROLLER]
    assert tl.controller_state() == jl.controller_state()
    saved = {**jl.controller_state(), "s_short": 4096, "n_rays_per_batch": 5000}
    jl2, tl2 = _loops()
    jl2.restore_controller(saved)
    tl2.restore_controller(saved)
    assert tl2.controller_state() == jl2.controller_state()
    assert [getattr(tl2, k) for k in CONTROLLER] == [getattr(jl2, k) for k in CONTROLLER]


def _tiny_loop(train_json):
    tb = Testbed(device="cpu")
    tb.load_model_config_dict(TINY)
    tb._trainer.sample_capacity = 1 << 13
    tb.load_training_data(train_json)
    return tb


def test_oom_during_a_capture_demotes_to_per_step(tmp_path, monkeypatch):
    """A capture that runs out of device memory (monkeypatched) demotes the
    loop to per-step calls for the rest of the run, counted and shown in the
    training buffer, and the calls' results equal a run that was per-step
    from the start."""
    train_json, _ = write_synthetic_dataset(tmp_path, n_train=4, n_test=1, width=24, height=24, device="cpu")
    per_step = _tiny_loop(train_json)
    per_step._loop.stochastic_fuse_steps = 1
    for _ in range(3):
        per_step.train(8, 1 << 12)
    assert not per_step.training_buffer.demoted

    def capture_oom(self, ds):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")

    monkeypatch.setattr(t_trainer.TrainCall, "prepare", capture_oom)
    demoted = _tiny_loop(train_json)
    shapes = []
    for _ in range(3):
        shapes.append(demoted._loop.peek_shape(8))
        demoted.train(8, 1 << 12)
    assert shapes[1] == shapes[0] or shapes[2] == shapes[1], shapes  # the gate let a call try graphs
    assert demoted._loop.demotions == 1 and demoted._loop.stochastic_fuse_steps == 1
    assert demoted.training_buffer.demoted and not demoted.training_buffer.graphed
    assert demoted.training_buffer.loss == per_step.training_buffer.loss
    for x, y in zip(demoted._trainer.model.param_list(), per_step._trainer.model.param_list(), strict=True):
        assert torch.equal(x.detach(), y.detach())


def _new_counts(tb, n_calls: int, prefix: str) -> list:
    """The counters under `prefix` that each of n_calls train(8, 2**12) calls added."""
    out = []
    for _ in range(n_calls):
        before = profiling.counters()
        tb.train(8, 1 << 12)
        after = profiling.counters()
        out.append(sorted(k for k in after if k.startswith(prefix) and after[k] != before.get(k, 0)))
    return out


def test_a_shape_whose_call_is_cached_runs_through_it(tmp_path, monkeypatch):
    """A call whose shape differs from the last call's runs eagerly (its
    cause named) unless the trainer holds a cached call of that shape: then
    it runs through that call, a replay on the card (off the card the call's
    steps, counted as no_graph), with no wait for the shape to repeat."""
    train_json, _ = write_synthetic_dataset(tmp_path, n_train=4, n_test=1, width=24, height=24, device="cpu")
    tb = _tiny_loop(train_json)
    tb.train(8, 1 << 12)
    loop, tr = tb._loop, tb._trainer
    a = loop._last_shape
    b = a._replace(s_pad=2 * a.s_pad)
    shapes = [a, b, a, b, b]
    monkeypatch.setattr(loop, "_choose_shape", lambda n, commit: shapes.pop(0) if commit else shapes[0])
    causes = _new_counts(tb, 5, "train.eager.")
    assert causes == [["train.eager.no_graph"], ["train.eager.shape.s_pad"], ["train.eager.no_graph"],
                      ["train.eager.shape.s_pad"], ["train.eager.no_graph"]]
    assert tr.has_call(a[:7], 8) and tr.has_call(b[:7], 8) and not tr.has_call(a[:7], 4)
    tr.drop_graphs()
    assert not tr.has_call(a[:7], 8)


@pytest.mark.parametrize("cone, probes", [(0.0, 1), (1 / 256, 0)])
def test_the_periodic_segment_probe_skips_the_cone_lattice(tmp_path, monkeypatch, cone, probes):
    """Every 16th call with the two-level march off probes the grid for its
    segment estimate on the arithmetic lattice; the cone lattice has no
    coarse pass, so no periodic probe re-picks its shape."""
    train_json, _ = write_synthetic_dataset(tmp_path, n_train=4, n_test=1, width=24, height=24, device="cpu")
    tb = Testbed(device="cpu")
    tb.load_model_config_dict({**TINY, "samlper": {**TINY["samlper"], "cone_angle_constant": cone}})
    tb._trainer.sample_capacity = 1 << 13
    tb.load_training_data(train_json)
    tb.train(8, 1 << 12)
    loop, tr = tb._loop, tb._trainer
    seen = []
    probe = tr.probe_batch
    monkeypatch.setattr(tr, "probe_batch", lambda *a, **kw: seen.append(1) or probe(*a, **kw))
    tb.training_buffer.i_step, loop.n_seg_cap, loop._probe_next = 16 * 8, 0, False
    tb.train(8, 1 << 12)
    assert len(seen) == probes


def test_controllers_survive_snapshots_both_ways(tmp_path):
    """s_short and seg_est (with the rest of the controllers) go through a
    snapshot saved by either package and come back in the other's loop."""
    train_json, _ = write_synthetic_dataset(tmp_path, n_train=2, n_test=1, width=16, height=16, device="cpu")
    tb = _tiny_loop(train_json)
    tb._loop.s_short, tb._loop._seg_est, tb._loop._per_ray_est = 64, 12.5, 30.0
    tb.save_snapshot(str(tmp_path / "port.msgpack"))
    jt = JTestbed()
    jt.load_snapshot(str(tmp_path / "port.msgpack"))
    jt.load_training_data(train_json)
    assert (jt._loop.s_short, jt._loop._seg_est, jt._loop._per_ray_est) == (64, 12.5, 30.0)
    assert jt._loop.controller_state() == tb._loop.controller_state()

    jt._loop.s_short, jt._loop._seg_est = 32, 7.25
    jt.save_snapshot(str(tmp_path / "jax.msgpack"))
    tb2 = Testbed(device="cpu")
    tb2.load_snapshot(str(tmp_path / "jax.msgpack"))
    tb2.load_training_data(train_json)
    assert (tb2._loop.s_short, tb2._loop._seg_est) == (32, 7.25)
    assert tb2._loop.controller_state() == jt._loop.controller_state()
