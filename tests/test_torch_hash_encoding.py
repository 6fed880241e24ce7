"""Port parity: HashGridSpec and the oadd forward (direct 8-corner gather) vs
ngp_tpu's packed oct-table encode."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_tpu.ops import hash_encoding as j_hash
from ngp_tpu.utils.config import HashEncodingConfig as JCfg
from ngp_tpu_torch.models.interop import hash_table_from_numpy
from ngp_tpu_torch.ops import hash_encoding as t_hash
from ngp_tpu_torch.utils.config import HashEncodingConfig as TCfg

torch.set_num_threads(2)

SMALL = dict(n_levels=4, log2_hashmap_size=12, base_resolution=8, desired_resolution=64.0)


@pytest.mark.parametrize(
    "kw", [{}, SMALL, dict(n_levels=6, n_features_per_level=4, log2_hashmap_size=10, base_resolution=4)]
)
def test_spec_equal(kw):
    a = j_hash.HashGridSpec.create(JCfg(**kw))
    b = t_hash.HashGridSpec.create(TCfg(**kw))
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for l in range(a.n_levels):
        assert j_hash._oct_offsets(a, l) == t_hash.oct_offsets(b, l)


def _positions(rng, n):
    """Random points plus the box faces, corners and cells at the dense
    levels' upper clamp (x*scale + 0.5 >= res - 1)."""
    pos = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    faces = rng.uniform(0.0, 1.0, (64, 3)).astype(np.float32)
    faces[np.arange(64), rng.integers(0, 3, 64)] = rng.choice([0.0, 1.0], 64)
    corners = np.array([[(k >> d) & 1 for d in range(3)] for k in range(8)], np.float32)
    near_top = 1.0 - rng.uniform(0.0, 0.02, (32, 3)).astype(np.float32)
    return np.concatenate([pos, faces, corners, near_top])


def _ray_ordered(rng, n_rays, n_per_ray):
    """Ray-major positions, as a render or training batch lies: consecutive
    samples sqrt(3)/1024 apart along one ray (base.json's step), so at the
    coarse levels neighbouring samples share cells."""
    d = rng.normal(size=(n_rays, 1, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = (np.arange(n_per_ray) * np.sqrt(3.0) / 1024)[None, :, None]
    return (rng.uniform(0.25, 0.75, (n_rays, 1, 3)) + t * d).reshape(-1, 3).astype(np.float32)


@pytest.mark.parametrize("kw", [SMALL, dict(n_levels=5, log2_hashmap_size=11, base_resolution=6, desired_resolution=200.0)])
@pytest.mark.parametrize("layout", ["opt", "legacy"])
@pytest.mark.parametrize("positions", ["edges", "rays"])
def test_oadd_forward_matches_packed(kw, layout, positions):
    spec_j = j_hash.HashGridSpec.create(JCfg(**kw))
    spec_t = t_hash.HashGridSpec.create(TCfg(**kw))
    assert any(spec_j.dense) and not all(spec_j.dense)
    rng = np.random.default_rng(3)
    table = rng.uniform(-1.0, 1.0, (spec_j.n_levels, spec_j.n_features, spec_j.padded_size)).astype(np.float32)
    pos = _positions(rng, 1000) if positions == "edges" else _ray_ordered(rng, 16, 128)

    ref = np.asarray(
        jax.jit(lambda t, p: j_hash.hash_encode_packed(j_hash.pack_inference_tables(t, spec_j), p, spec_j))(
            jnp.asarray(table), jnp.asarray(pos)
        )
    )
    given = table if layout == "opt" else table.transpose(0, 2, 1)
    out = t_hash.hash_encode(hash_table_from_numpy(given, spec_t), torch.from_numpy(pos), spec_t).numpy()
    # fp32, differing only in the order of the 8-corner sum
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_other_variants_raise():
    spec = t_hash.HashGridSpec.create(TCfg(**SMALL, hash_variant="xadd"))
    table = torch.zeros((spec.n_levels, spec.padded_size, spec.n_features))
    with pytest.raises(NotImplementedError):
        t_hash.hash_encode(table, torch.zeros((4, 3)), spec)
