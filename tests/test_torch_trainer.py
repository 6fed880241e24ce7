"""Port parity for the training path as a whole: one Trainer step from a
training state carried over from ngp_tpu (loss, gradients, visited hash
rows), a snapshot the port saves and ngp_tpu loads, and the port's Testbed
training the TINY config of tests/test_end_to_end.py on the procedural scene."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ngp_tpu.models.ngp import apply_density_activation as j_dens_act
from ngp_tpu.models.ngp import apply_rgb_activation as j_rgb_act
from ngp_tpu.grid import occupancy as j_occ
from ngp_tpu.render.composite import train_loss as j_train_loss
from ngp_tpu.sampling.lattice import n_lattice_points as j_nlat
from ngp_tpu.sampling.training import generate_training_batch as j_gen
from ngp_tpu.train.optimizer import create_optimizer, ema_update
from ngp_tpu.train.snapshot import load_snapshot as j_load_snapshot
from ngp_tpu.train.trainer import Trainer as JTrainer
from ngp_tpu.train.trainer import compute_rgb_target as j_rgb_target
from ngp_tpu.utils.color import srgb_to_linear as j_srgb_to_linear
from ngp_tpu.utils.config import NGPConfig as JCfg
from ngp_tpu_torch import Testbed
from ngp_tpu_torch.data.synthetic import write_synthetic_dataset
from ngp_tpu_torch.models.interop import grid_from_numpy, training_state_from_numpy
from ngp_tpu_torch.ops.hash_encoding import HashGridSpec
from ngp_tpu_torch.train.trainer import Trainer as TTrainer
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


def _tree(params, scale_table=1.0):
    out = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), params)
    out["hash_table"] = out["hash_table"] * np.float32(scale_table)
    return out


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


def _images_and_poses(n=4, h=24, w=32, seed=0):
    from ngp_tpu_torch.data.synthetic import look_at_pose
    from ngp_tpu_torch.utils.camera import opengl_to_opencv

    rng = np.random.default_rng(seed)
    poses = [look_at_pose(4.0 * np.array([np.cos(2.4 * k) * 0.8, np.sin(2.4 * k) * 0.8, 0.6])) for k in range(n)]
    xforms = opengl_to_opencv(np.stack(poses), 0.33, [0.5, 0.5, 0.5]).numpy()
    images = rng.uniform(0, 1, (n, h, w, 4)).astype(np.float16)
    return images, xforms, (40.0, 40.0)


def _spec(tc):
    return HashGridSpec.create(tc.network.encoding)


@pytest.mark.parametrize("loss", ["SmoothL1", "L2"])
def test_trainer_step_from_jax_state_matches(loss):
    doc = {**TINY, "loss": {"otype": loss}}
    jc, tc = JCfg.from_json(doc), TCfg.from_json(doc)
    jtr = JTrainer.create(jc)
    state = jtr.init_state(7)
    # hash entries at trained magnitudes, so the heads see a real encoding
    params = _tree(state.params, scale_table=1e3)
    dens = _density(jc.sampler, 1)
    images, xforms, focal = _images_and_poses()
    n_rays, capacity, s_pad, shift = 512, 1 << 14, 256, 1000

    # --- ngp_tpu: the body of Trainer._train_step_fn, gradients exposed
    jgrid = j_occ.update_occupancy(jc.sampler, j_occ.create_grid_state(jc.sampler)._replace(density=jnp.asarray(dens)))
    _, k_batch, k_bg = jax.random.split(jax.random.PRNGKey(11), 3)
    salts = np.asarray(jax.random.bits(k_batch, (2,), jnp.uint32)).tolist()
    bg_srgb = jax.random.uniform(k_bg, (3,))
    batch = j_gen(
        jc.sampler, jtr.aabb, jnp.asarray(images), jnp.asarray(xforms), focal, (0.5, 0.5), jgrid.occupancy, k_batch,
        n_rays, jnp.uint32(shift), capacity, j_nlat(jc.sampler), s_pad,
    )
    target, bg = j_rgb_target(batch.rgba, j_srgb_to_linear(bg_srgb), "Linear", jc.render.train_in_linear_color)

    def loss_fn(p):
        rgb_raw, sigma_raw = jtr.model.rgbsigma_raw(p, batch.pos, batch.dirs, remat_heads=False)
        return j_train_loss(
            rgb_raw, sigma_raw, batch.layout, jc.sampler.min_cone_stepsize, batch.valid_short, jax.lax.stop_gradient(target), bg,
            n_rays_denom=n_rays, loss_type=loss, transmittance_threshold=jc.render.transmittance_threshold,
            rgb_activation="Logistic", density_activation="Exponential", mean_density=jgrid.mean_density,
            min_optical_thickness=jc.sampler.min_optical_thickness, apply_rgb_activation=j_rgb_act,
            apply_density_activation=j_dens_act,
        )

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    (j_loss, _), j_grads = jax.value_and_grad(loss_fn, has_aux=True)(jp)
    tx = create_optimizer(jc.optimizer)
    upd, _ = tx.update(j_grads, tx.init(jp), jp)
    j_moved = np.asarray(optax.apply_updates(jp, upd)["hash_table"]) != params["hash_table"]

    # --- the port, from the carried-over state and the same draws
    zeros = jax.tree_util.tree_map(np.zeros_like, params)
    st = training_state_from_numpy(params, _tree(ema_update(state.params, jp, 0.95)), zeros, zeros, 0, _spec(tc))
    tr = TTrainer.create(tc, st["params"], "cpu")
    tr.set_state(st["params"], st["ema"], st["mu"], st["nu"], st["count"])
    tr.grid = grid_from_numpy(tc.sampler, dens, 0)
    tr.loss_type = loss
    ds = SimpleNamespace(images=torch.from_numpy(images), xforms=torch.from_numpy(xforms), focal_length=focal)
    _, t_loss, _, t_grads = tr.loss_and_grads(ds, n_rays, capacity, s_pad, shift, salts, torch.from_numpy(np.array(bg_srgb)))

    assert float(j_loss) > 0
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-4)
    j_leaves = [j_grads["hash_table"]] + list(j_grads["density_mlp"]) + list(j_grads["rgb_mlp"])
    for k, (got, want) in enumerate(zip(t_grads, j_leaves, strict=True)):
        got = got.numpy().transpose(0, 2, 1) if k == 0 else got.numpy()
        want = np.asarray(want)
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel < 2e-2, f"leaf {k}: relative L2 error {rel}"

    # one optimizer step: the lazy hash leaf moves exactly on the rows both visit
    before = tr.model.hash_table.detach().clone()
    tr.optimizer.step(t_grads)
    assert tr.optimizer.count == 1
    t_moved = (tr.model.hash_table.detach() != before).numpy().transpose(0, 2, 1)
    np.testing.assert_array_equal(t_moved.any(axis=1), j_moved.any(axis=1))


def test_snapshot_saved_by_port_loads_in_ngp_tpu(tmp_path):
    tb = Testbed(device="cpu")
    tb.load_model_config_dict(TINY)
    gen = torch.Generator().manual_seed(5)
    params = tb.model.params()
    params = {
        "hash_table": torch.rand(params["hash_table"].shape, generator=gen),
        "density_mlp": [torch.randn(w.shape, generator=gen) for w in params["density_mlp"]],
        "rgb_mlp": [torch.randn(w.shape, generator=gen) for w in params["rgb_mlp"]],
    }
    ema = {k: ([w * 0.5 for w in v] if isinstance(v, list) else v * 0.5) for k, v in params.items()}
    dens = _density(tb.config.sampler, 2)
    tb.set_state(params, dens, scene_scale=0.4, scene_offset=(0.5, 0.4, 0.5), grid_step=9, ema=ema)
    path = tmp_path / "port.msgpack"
    tb.save_snapshot(path)

    _, snap = j_load_snapshot(path)
    for key, tree in (("params", params), ("ema_params", ema)):
        got = snap[key]
        np.testing.assert_array_equal(np.asarray(got["hash_table"]), tree["hash_table"].numpy().transpose(0, 2, 1))
        for name in ("density_mlp", "rgb_mlp"):
            for a, b in zip(got[name], tree[name], strict=True):
                np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(np.asarray(snap["density_grid"]), dens)
    assert snap["grid_step"] == 9 and snap["scene_scale"] == pytest.approx(0.4)

    tb2 = Testbed(device="cpu")  # and the port reads it back: the EMA is what it renders
    tb2.load_snapshot(path)
    assert torch.equal(tb2.model.hash_table, ema["hash_table"])
    assert torch.equal(tb2._trainer.model.hash_table.detach(), params["hash_table"])


def test_testbed_loss_falls_on_tiny(tmp_path):
    train_json, _ = write_synthetic_dataset(tmp_path, n_train=6, n_test=1, width=32, height=32)
    tb = Testbed(device="cpu")
    tb.load_model_config_dict(TINY)
    tb._trainer.sample_capacity = 1 << 14
    tb.load_training_data(train_json)
    tb.train(16, 1 << 13)
    first = tb.training_buffer.loss
    for _ in range(5):
        tb.train(16, 1 << 13)
    assert tb.training_buffer.i_step == 96
    assert np.isfinite(tb.training_buffer.loss) and tb.training_buffer.loss < first
    assert tb.training_buffer.n_rays_per_batch >= 256
