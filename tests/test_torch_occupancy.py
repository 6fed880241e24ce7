"""Port parity: update_occupancy, occupied_aabb and occupancy_lookup, exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_tpu.grid import occupancy as j_occ
from ngp_tpu.utils.config import NGPConfig as JCfg
from ngp_tpu_torch.grid import occupancy as t_occ
from ngp_tpu_torch.utils.config import NGPConfig as TCfg

torch.set_num_threads(2)


def blob_density(cfg, seed, n_blobs=3, empty=False):
    """(n_cascades * G^3,) density in the linear x + G*y + G^2*z layout: a few
    Gaussian blobs in cascade 0 plus sparse noise and untrained (-1) cells."""
    g = cfg.grid_size
    rng = np.random.default_rng(seed)
    dens = np.zeros((cfg.n_cascades, g, g, g), np.float32)  # (c, z, y, x)
    if not empty:
        ax = (np.arange(g) + 0.5) / g
        z, y, x = np.meshgrid(ax, ax, ax, indexing="ij")
        for _ in range(n_blobs):
            c = rng.uniform(0.25, 0.75, 3)
            r2 = ((x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2) / rng.uniform(0.004, 0.02)
            dens[0] += rng.uniform(0.5, 2.0) * np.exp(-r2).astype(np.float32)
        dens[1:] = np.where(rng.random((cfg.n_cascades - 1, g, g, g)) < 0.002, 0.5, 0.0)
    dens = dens.reshape(-1)
    dens[rng.random(dens.size) < 0.05] = -1.0
    return dens


@pytest.mark.parametrize("case", ["blobs", "aabb_scale_4", "empty"])
def test_update_occupancy_exact(case):
    doc = {"samlper": {"grid_size": 32, "aabb_scale": 4 if case == "aabb_scale_4" else 1}}
    jc, tc = JCfg.from_json(doc).sampler, TCfg.from_json(doc).sampler
    dens = blob_density(jc, 11, empty=case == "empty")

    js = j_occ.update_occupancy(jc, j_occ.create_grid_state(jc)._replace(density=jnp.asarray(dens)))
    ts = t_occ.update_occupancy(tc, t_occ.create_grid_state(tc)._replace(density=torch.from_numpy(dens)))
    np.testing.assert_array_equal(ts.occupancy.numpy(), np.asarray(js.occupancy))
    np.testing.assert_allclose(float(ts.mean_density), float(js.mean_density), rtol=1e-6)
    np.testing.assert_array_equal(ts.occ_aabb.numpy(), np.asarray(js.occ_aabb))
    np.testing.assert_array_equal(
        t_occ.occupied_aabb(tc, ts.occupancy).numpy(), np.asarray(j_occ.occupied_aabb(jc, js.occupancy))
    )
    if case != "empty":
        assert ts.occupancy[0].any()

    rng = np.random.default_rng(12)
    pos = rng.uniform(-1.8, 2.8, (4096, 3)).astype(np.float32)
    pos[:64] = np.round(pos[:64] * 32) / 32  # exactly on cell faces
    mip_j = j_occ.mip_from_pos(jnp.asarray(pos), jc.n_cascades)
    mip_t = t_occ.mip_from_pos(torch.from_numpy(pos), tc.n_cascades)
    np.testing.assert_array_equal(mip_t.numpy(), np.asarray(mip_j))
    np.testing.assert_array_equal(
        t_occ.occupancy_lookup(tc, ts.occupancy, torch.from_numpy(pos), mip_t).numpy(),
        np.asarray(j_occ.occupancy_lookup(jc, js.occupancy, jnp.asarray(pos), mip_j)),
    )
