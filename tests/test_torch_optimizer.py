"""Port parity: the optimizer (adam_ema_plain under Optimizer) against
ngp_tpu's create_optimizer + ema_update, and lr_factor."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ngp_tpu.train.optimizer import create_optimizer, ema_update
from ngp_tpu.train.optimizer import lr_factor as j_lr_factor
from ngp_tpu.utils.config import NGPConfig as JCfg
from ngp_tpu_torch.train import optimizer as t_opt
from ngp_tpu_torch.utils.config import NGPConfig as TCfg

torch.set_num_threads(2)

# decay_start crossed inside the 3 steps: the schedule's count 0, 1, 2
DOC = {"optimizer": {"otype": "Ema", "decay": 0.95, "nested": {"otype": "ExponentialDecay", "decay_start": 1, "decay_interval": 1, "decay_base": 0.33, "nested": {"otype": "Adam", "learning_rate": 1e-2, "beta1": 0.9, "beta2": 0.99, "epsilon": 1e-15, "l2_reg": 1e-6}}}}


def test_lr_factor_matches_jax():
    cfg_j, cfg_t = JCfg.from_json({}).optimizer, TCfg.from_json({}).optimizer
    for step in (0, 19999, 20000, 29999, 30000, 55555):
        assert t_opt.lr_factor(step, cfg_t) == np.float32(j_lr_factor(step, cfg_j))


def test_optimizer_three_steps_match_jax():
    cfg_j, cfg_t = JCfg.from_json(DOC).optimizer, TCfg.from_json(DOC).optimizer
    rng = np.random.default_rng(0)
    L, F, T = 4, 2, 256
    table = rng.uniform(-1e-4, 1e-4, (L, F, T)).astype(np.float32)
    mlps = [rng.normal(size=s).astype(np.float32) * 0.1 for s in ((8, 16), (16, 16), (32, 16), (16, 16), (16, 3))]
    jp = {"hash_table": jnp.asarray(table), "density_mlp": [jnp.asarray(w) for w in mlps[:2]], "rgb_mlp": [jnp.asarray(w) for w in mlps[2:]]}
    tx = create_optimizer(cfg_j)
    js = tx.init(jp)
    je = jax.tree_util.tree_map(jnp.copy, jp)

    tparams = [torch.from_numpy(table.transpose(0, 2, 1).copy())] + [torch.from_numpy(w.copy()) for w in mlps]
    tema = [p.clone() for p in tparams]
    opt = t_opt.Optimizer(cfg_t, tparams, tema)

    visited_any = np.zeros((L, F, T), bool)
    for step in range(3):
        gt = rng.normal(size=(L, F, T)).astype(np.float32) * 1e-3
        gt[:, :, rng.random(T) < 0.6] = 0.0  # most rows unvisited (lazy)
        visited_any |= gt != 0
        gm = [rng.normal(size=w.shape).astype(np.float32) * 1e-2 for w in mlps]
        jg = {"hash_table": jnp.asarray(gt), "density_mlp": [jnp.asarray(g) for g in gm[:2]], "rgb_mlp": [jnp.asarray(g) for g in gm[2:]]}
        upd, js = tx.update(jg, js, jp)
        jp = optax.apply_updates(jp, upd)
        je = ema_update(je, jp, cfg_j.ema_decay)
        opt.step([torch.from_numpy(gt.transpose(0, 2, 1).copy())] + [torch.from_numpy(g) for g in gm])

    assert opt.count == 3
    j_leaves = [jp["hash_table"]] + jp["density_mlp"] + jp["rgb_mlp"]
    j_ema = [je["hash_table"]] + je["density_mlp"] + je["rgb_mlp"]
    adam = js[1]
    j_mu = [adam.mu["hash_table"]] + adam.mu["density_mlp"] + adam.mu["rgb_mlp"]
    j_nu = [adam.nu["hash_table"]] + adam.nu["density_mlp"] + adam.nu["rgb_mlp"]
    for k, (p, e, m, v) in enumerate(zip(j_leaves, j_ema, j_mu, j_nu, strict=True)):
        tr = (lambda t: t.numpy().transpose(0, 2, 1)) if k == 0 else (lambda t: t.numpy())
        for got, want in ((opt.params[k], p), (opt.ema[k], e), (opt.mu[k], m), (opt.nu[k], v)):
            np.testing.assert_allclose(tr(got), np.asarray(want), rtol=1e-6, atol=1e-12)
    # rows no step visited are bit-equal to the start (params) / decayed (ema)
    untouched = ~visited_any
    np.testing.assert_array_equal(tparams[0].numpy().transpose(0, 2, 1)[untouched], table[untouched])
    np.testing.assert_array_equal(opt.mu[0].numpy().transpose(0, 2, 1)[untouched], 0.0)
    np.testing.assert_array_equal(tema[0].numpy().transpose(0, 2, 1)[untouched], np.asarray(je["hash_table"])[untouched])


@pytest.mark.parametrize("lazy,l2", [(True, 0.0), (False, 1e-6)])
def test_plain_matches_the_pallas_formula(lazy, l2):
    """adam_ema_plain against mb22_optfuse's optax_style formula (the Pallas
    kernel's reference) on a table with ~4 % of elements visited."""
    rng = np.random.default_rng(1)
    n = 1 << 14
    g = np.where(rng.random(n) < 0.04, rng.normal(size=n) * 0.01, 0.0).astype(np.float32)
    m, v, p, e = (rng.normal(size=n).astype(np.float32) * s for s in (1e-3, 1e-4, 1e-2, 1e-2))
    v = np.abs(v)
    lr, bc1, bc2 = np.float32(1e-2), np.float32(1 - 0.9**10), np.float32(1 - 0.99**10)
    gg = g + np.float32(l2) * p if l2 else g
    vis = gg != 0 if lazy else np.ones(n, bool)
    nm = np.where(vis, np.float32(0.9) * m + np.float32(0.1) * gg, m)
    nv = np.where(vis, np.float32(0.99) * v + np.float32(1 - 0.99) * gg * gg, v)
    upd = np.where(vis, (nm / bc1) / (np.sqrt(nv / bc2) + np.float32(1e-15)), 0.0).astype(np.float32)
    np_ = p - lr * upd
    ne = np.float32(0.95) * e + np.float32(1 - 0.95) * np_
    t = [torch.from_numpy(x.copy()) for x in (g, m, v, p, e)]
    t_opt.adam_ema(*t, lr=lr, bc1=bc1, bc2=bc2, b1=0.9, b2=0.99, eps=1e-15, decay=0.95, l2=l2, lazy=lazy)
    for got, want in zip(t[1:], (nm, nv, np_, ne), strict=True):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-12)
