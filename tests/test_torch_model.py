"""Port parity: NGPModel.density_raw / rgbsigma_raw on ngp_tpu's own init,
carried across with params_from_numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_tpu.models.ngp import NGPModel as JModel
from ngp_tpu.models.ngp import apply_density_activation as j_dens_act
from ngp_tpu.utils.config import NGPConfig as JCfg
from ngp_tpu_torch.models.interop import params_from_numpy
from ngp_tpu_torch.models.ngp import NGPModel as TModel
from ngp_tpu_torch.models.ngp import apply_density_activation as t_dens_act
from ngp_tpu_torch.utils.config import NGPConfig as TCfg

torch.set_num_threads(2)

# bf16 operands: the same fp32 sums in another order can flip one bf16 ulp of
# a hidden activation (tests/test_fused_mlp.py's tolerances)
RTOL, ATOL = 2e-2, 3e-2


def _doc(width, activation="ReLU"):
    return {
        "network": {
            "encoding": {"n_levels": 4, "log2_hashmap_size": 12, "base_resolution": 8, "desired_resolution": 64},
            "network": {"n_neurons": width, "n_hidden_layers": 1, "activation": activation},
            "rgb_network": {"n_neurons": width, "n_hidden_layers": 2},
        }
    }


def _models(doc, seed):
    jm = JModel.create(JCfg.from_json(doc).network)
    jp = jax.tree_util.tree_map(np.array, jm.init(jax.random.PRNGKey(seed)))
    # push the density channel up so sigma is not ~1 everywhere
    jp["density_mlp"][-1][:, 0] = np.abs(jp["density_mlp"][-1][:, 0]) + 0.3
    tm = TModel.create(TCfg.from_json(doc).network)
    tm.load_params(params_from_numpy(jp, tm.grid_spec))
    return jm, jp, tm


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return pos, ((d + 1.0) * 0.5).astype(np.float32)


@pytest.mark.parametrize("width", [16, 32])
def test_model_matches_jax(width):
    doc = _doc(width)
    jm, jp, tm = _models(doc, 1)
    pos, dirs = _inputs(777, 2)
    jpi = jax.jit(jm.prepare_inference)(jax.tree_util.tree_map(jnp.asarray, jp))

    j_rgb, j_sig = jax.jit(lambda p: jm.rgbsigma_raw(p, pos, dirs))(jpi)
    t_rgb, t_sig = tm.rgbsigma_raw(torch.from_numpy(pos), torch.from_numpy(dirs))
    np.testing.assert_allclose(t_rgb.numpy(), np.asarray(j_rgb), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t_sig.numpy(), np.asarray(j_sig), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        t_dens_act(t_sig).numpy(), np.asarray(j_dens_act(j_sig)), rtol=RTOL, atol=ATOL
    )

    j_dens = jax.jit(lambda p: jm.density_raw(p, pos))(jpi)
    t_dens = tm.density_raw(torch.from_numpy(pos))
    np.testing.assert_allclose(t_dens.numpy(), np.asarray(j_dens), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t_dens[:, 0].numpy(), t_sig.numpy(), rtol=RTOL, atol=ATOL)


def test_unfused_config_takes_the_chain():
    """A head the kernel does not take (logistic hidden activation) runs the
    mlp_apply chain and still matches ngp_tpu."""
    doc = _doc(16, activation="Logistic")
    jm, jp, tm = _models(doc, 3)
    pos, dirs = _inputs(129, 4)
    j_rgb, j_sig = jax.jit(lambda p: jm.rgbsigma_raw(p, pos, dirs))(jax.tree_util.tree_map(jnp.asarray, jp))
    t_rgb, t_sig = tm.rgbsigma_raw(torch.from_numpy(pos), torch.from_numpy(dirs))
    assert tm._fused is None
    np.testing.assert_allclose(t_rgb.numpy(), np.asarray(j_rgb), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t_sig.numpy(), np.asarray(j_sig), rtol=RTOL, atol=ATOL)


def test_params_from_numpy_layouts_and_init_shapes():
    doc = _doc(16)
    jm, jp, tm = _models(doc, 5)
    legacy = dict(jp, hash_table=jp["hash_table"].transpose(0, 2, 1))
    a = params_from_numpy(jp, tm.grid_spec)["hash_table"]
    b = params_from_numpy(legacy, tm.grid_spec)["hash_table"]
    assert torch.equal(a, b) and a.shape == (4, tm.grid_spec.padded_size, 2)
    with pytest.raises(ValueError):
        params_from_numpy(dict(jp, hash_table=np.zeros((4, 3, 5), np.float32)), tm.grid_spec)

    fresh = TModel.create(TCfg.from_json(doc).network).init(torch.Generator().manual_seed(0))
    for name, p in fresh.named_parameters():
        assert p.shape == dict(tm.named_parameters())[name].shape
    assert float(fresh.hash_table.abs().max()) <= 1e-4
    assert fresh.n_params() == sum(int(np.asarray(x).size) for x in jax.tree_util.tree_leaves(jp))
