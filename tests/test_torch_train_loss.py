"""Port parity: the losses and train_loss (value and gradient) against
ngp_tpu's, through jax.value_and_grad, for every loss type."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_tpu.models.ngp import apply_density_activation as j_dens_act
from ngp_tpu.models.ngp import apply_rgb_activation as j_rgb_act
from ngp_tpu.ops import layout as j_lay
from ngp_tpu.ops import losses as j_losses
from ngp_tpu.render.composite import composite_rays as j_composite
from ngp_tpu.render.composite import train_loss as j_train_loss
from ngp_tpu_torch.models.ngp import apply_density_activation as t_dens_act
from ngp_tpu_torch.models.ngp import apply_rgb_activation as t_rgb_act
from ngp_tpu_torch.ops import layout as t_lay
from ngp_tpu_torch.ops import losses as t_losses
from ngp_tpu_torch.render.composite import composite_rays as t_composite
from ngp_tpu_torch.render.composite import train_loss as t_train_loss

torch.set_num_threads(2)

LOSSES = ("L2", "RelativeL2", "L1", "Mape", "Smape", "SmoothL1", "LogL1")


@pytest.mark.parametrize("loss_type", LOSSES)
def test_loss_pairs_match_jax(loss_type):
    rng = np.random.default_rng(0)
    target = rng.uniform(0, 1, (500, 3)).astype(np.float32)
    pred = (target + rng.normal(size=target.shape) * np.where(rng.random(target.shape) < 0.5, 0.02, 0.5)).astype(np.float32)
    jv, jg = j_losses.loss_and_gradient(jnp.asarray(target), jnp.asarray(pred), loss_type)
    tv, tg = t_losses.loss_and_gradient(torch.from_numpy(target), torch.from_numpy(pred), loss_type)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-7)
    if loss_type in ("RelativeL2", "Mape", "Smape"):
        return  # the reference's gradient holds the normalising factor constant
    # the closed-form gradient is the derivative of the value
    p = torch.from_numpy(pred).requires_grad_(True)
    (auto,) = torch.autograd.grad(t_losses.loss_value(torch.from_numpy(target), p, loss_type).sum(), p)
    np.testing.assert_allclose(auto.numpy(), tg.numpy(), rtol=1e-5, atol=1e-6)


def test_unknown_loss_raises():
    with pytest.raises(ValueError):
        t_losses.loss_value(torch.zeros(3), torch.zeros(3), "Huber")


def _layout(rng, R=160, C=1400, S=24):
    counts = np.minimum(rng.integers(0, 40, R), S)
    counts[rng.random(R) < 0.15] = 0
    valid = counts > 0
    res = np.where(valid, counts, 0)
    base = np.cumsum(res) - res
    valid &= base + res <= C
    jl = j_lay.build_layout(jnp.asarray(base, jnp.int32), jnp.asarray(counts, jnp.int32), jnp.asarray(valid), C, S)
    tl = t_lay.build_layout(torch.from_numpy(base), torch.from_numpy(counts), torch.from_numpy(valid), C, S)
    return jl, tl, valid


def test_composite_rays_matches_jax():
    rng = np.random.default_rng(1)
    R, S = 64, 20
    rgb = rng.uniform(0, 1, (R, S, 3)).astype(np.float32)
    sigma = rng.exponential(30.0, (R, S)).astype(np.float32)
    counts = rng.integers(0, S + 1, R)
    valid = np.arange(S)[None, :] < counts[:, None]
    bg = np.array([0.2, 0.5, 0.9], np.float32)
    j = j_composite(jnp.asarray(rgb), jnp.asarray(sigma), 0.01, jnp.asarray(valid), jnp.asarray(counts, jnp.int32), jnp.asarray(bg), 1e-4)
    t = t_composite(torch.from_numpy(rgb), torch.from_numpy(sigma), 0.01, torch.from_numpy(valid), torch.from_numpy(counts), torch.from_numpy(bg), 1e-4)
    np.testing.assert_allclose(t.rgb_ray.numpy(), np.asarray(j.rgb_ray), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t.trans_end.numpy(), np.asarray(j.trans_end), rtol=1e-5, atol=1e-7)
    for name in ("include", "n_included", "exhausted"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)), err_msg=name)


@pytest.mark.parametrize("loss_type", LOSSES)
@pytest.mark.parametrize("variant", ["default", "exp_rgb_thin_grid_dt_pad"])
def test_train_loss_value_and_grad_match_jax(loss_type, variant):
    rng = np.random.default_rng(len(loss_type) + len(variant))
    jl, tl, ray_valid = _layout(rng)
    C, (R, S) = jl.ray_ids.shape[0], jl.pad_valid.shape
    rgb_raw = rng.normal(size=(C, 3)).astype(np.float32)
    sigma_raw = rng.normal(1.0, 2.0, C).astype(np.float32)
    target = rng.uniform(0, 1, (R, 3)).astype(np.float32)
    bg = rng.uniform(0, 1, 3).astype(np.float32)
    exp_rgb = variant != "default"
    dt = rng.uniform(0.002, 0.02, (R, S)).astype(np.float32) if exp_rgb else 0.0125
    kw = dict(
        n_rays_denom=R + 7,
        loss_type=loss_type,
        transmittance_threshold=1e-4,
        rgb_activation="Exponential" if exp_rgb else "Logistic",
        density_activation="Exponential",
        min_optical_thickness=0.01,
    )
    mean_density = np.float32(0.004 if exp_rgb else 0.5)

    def j_fn(rgb, sig):
        return j_train_loss(
            rgb, sig, jl, jnp.asarray(dt) if exp_rgb else dt, jnp.asarray(ray_valid), jnp.asarray(target), jnp.asarray(bg),
            mean_density=jnp.asarray(mean_density), apply_rgb_activation=j_rgb_act, apply_density_activation=j_dens_act, **kw,
        )

    (j_loss, j_aux), (j_grgb, j_gsig) = jax.value_and_grad(j_fn, argnums=(0, 1), has_aux=True)(jnp.asarray(rgb_raw), jnp.asarray(sigma_raw))
    t_rgb = torch.from_numpy(rgb_raw).requires_grad_(True)
    t_sig = torch.from_numpy(sigma_raw).requires_grad_(True)
    t_loss, t_aux = t_train_loss(
        t_rgb, t_sig, tl, torch.from_numpy(dt) if exp_rgb else dt, torch.from_numpy(ray_valid), torch.from_numpy(target),
        torch.from_numpy(bg), mean_density=torch.tensor(mean_density), apply_rgb_activation=t_rgb_act,
        apply_density_activation=t_dens_act, **kw,
    )
    t_grgb, t_gsig = torch.autograd.grad(t_loss, (t_rgb, t_sig))
    assert float(j_loss) > 0
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)
    np.testing.assert_allclose(float(t_aux["loss_sum"]), float(j_aux["loss_sum"]), rtol=1e-5)
    assert int(t_aux["measured_batch_size"]) == int(j_aux["measured_batch_size"])
    for got, want in ((t_grgb, j_grgb), (t_gsig, j_gsig)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
