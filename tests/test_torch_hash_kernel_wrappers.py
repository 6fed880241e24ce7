"""The hash-grid kernels' wrappers without a card: the level constants they
pass to the kernels, their device dispatch and the corner-row pairings the
kernels rely on. Imports torch, numpy and ngp_tpu_torch only, and needs no
nvcc."""

import ctypes
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from ngp_tpu_torch.ops import hash_encoding as he
from ngp_tpu_torch.ops.kernels import launch_counts
from ngp_tpu_torch.utils.config import HashEncodingConfig, NGPConfig, load_commented_json

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
# the TINY encoding of tests/test_end_to_end.py (dense and hash levels)
TINY = {"n_levels": 8, "log2_hashmap_size": 14, "base_resolution": 16, "desired_resolution": 256}


def _base_spec():
    doc = load_commented_json(ROOT / "experiment/nerf_synthetic/config/base.json")
    return he.HashGridSpec.create(NGPConfig.from_json(doc).network.encoding)


@pytest.mark.parametrize("name", ["base.json", "TINY"])
def test_level_constants_carry_the_spec(name):
    spec = _base_spec() if name == "base.json" else he.HashGridSpec.create(HashEncodingConfig(**TINY))
    lc = he.level_constants(spec)
    assert ctypes.sizeof(lc) == 4 * (6 * he.MAX_LEVELS + 8 * he.MAX_LEVELS + 2)  # csrc/hash_grid.cuh's layout
    assert (lc.n_levels, lc.variant) == (spec.n_levels, he.VARIANTS.index(spec.variant))
    for l in range(spec.n_levels):
        sy, sz, offs = he.oct_offsets(spec, l)
        assert lc.scale[l] == torch.tensor(spec.scales[l], dtype=torch.float32).item()
        assert (lc.res[l], bool(lc.dense[l]), lc.size[l]) == (spec.resolutions[l], spec.dense[l], spec.sizes[l])
        assert (lc.sy[l], lc.sz[l], list(lc.offs[l])) == (sy, sz, offs)
    assert all(x == 0 for x in lc.size[spec.n_levels :])
    assert he.level_constants(spec) is lc  # built once per spec
    if name == "TINY":
        assert any(spec.dense) and not all(spec.dense)


def _args(spec, n, device):
    table = torch.zeros((spec.n_levels, spec.padded_size, spec.n_features), device=device)
    pos = torch.zeros((n, 3), device=device)
    g = torch.zeros((n, spec.n_output_dims), device=device)
    return table, pos, g


# the exact scatter keeps its case name from when it was oadd-only
@pytest.mark.parametrize("op", ["hash_encode", pytest.param("hash_bwd_exact", id="hash_bwd_oadd"), "hash_bwd_oadd_stochastic"])
def test_other_devices_raise(op):
    """A tensor on another device (meta) raises instead of taking the plain
    version, and launches nothing."""
    spec = he.HashGridSpec.create(HashEncodingConfig(**TINY))
    table, pos, g = _args(spec, 16, "meta")
    before = (launch_counts()["hash_encode_fwd"], launch_counts()["hash_encode_bwd_exact"], launch_counts()["hash_encode_bwd_stochastic"])
    with pytest.raises(ValueError, match="cuda or cpu"):
        if op == "hash_encode":
            he.hash_encode(table, pos, spec)
        else:
            getattr(he, op)(pos, spec, g)
    assert (launch_counts()["hash_encode_fwd"], launch_counts()["hash_encode_bwd_exact"], launch_counts()["hash_encode_bwd_stochastic"]) == before


def test_cpu_tensors_take_the_plain_versions():
    spec = he.HashGridSpec.create(HashEncodingConfig(**TINY))
    gen = torch.Generator().manual_seed(0)
    table = torch.rand((spec.n_levels, spec.padded_size, spec.n_features), generator=gen)
    pos = torch.rand((300, 3), generator=gen)
    g = torch.randn((300, spec.n_output_dims), generator=gen)
    assert torch.equal(he.hash_encode(table, pos, spec), he.hash_encode_plain(table, pos, spec))
    assert torch.equal(he.hash_bwd_exact(pos, spec, g), he.hash_bwd_exact_plain(pos, spec, g))
    assert torch.equal(he.hash_bwd_oadd_stochastic(pos, spec, g), he.hash_bwd_oadd_stochastic_plain(pos, spec, g))


def test_kernel_wrappers_check_their_inputs():
    """The CUDA wrappers reject what the kernels do not take before loading
    anything (these run no kernel)."""
    spec = he.HashGridSpec.create(HashEncodingConfig(**TINY))
    table, pos, g = _args(spec, 16, "cpu")
    with pytest.raises(ValueError, match="table"):
        he.hash_encode_cuda(table[:, :-1], pos, spec)
    with pytest.raises(ValueError, match="contiguous"):
        he.hash_encode_cuda(table, torch.zeros((3, 16)).T, spec)
    with pytest.raises(ValueError, match="g must be"):
        he.hash_bwd_exact_cuda(pos, spec, g[:, :-1])
    with pytest.raises(ValueError, match="float32"):
        he.hash_bwd_oadd_stochastic_cuda(pos.double(), spec, g)
    wide = he.HashGridSpec.create(HashEncodingConfig(**dict(TINY, n_features_per_level=3)))
    with pytest.raises(ValueError, match="features per level"):
        he.hash_encode_cuda(*_args(wide, 4, "cpu")[:2], wide)


# small specs of the sweep: (n_levels, features, log2_hashmap_size, base_resolution, desired_resolution)
SWEEP = [(4, 2, 12, 8, 64), (5, 1, 11, 6, 200), (6, 4, 10, 4, 128), (8, 8, 13, 16, 512), (3, 2, 8, 2, 32), (7, 2, 15, 16, 1024)]


def _spec(name):
    if name == "base.json":
        return _base_spec()
    if name == "TINY":
        return he.HashGridSpec.create(HashEncodingConfig(**TINY))
    n_levels, f, log2, base, desired = SWEEP[int(name)]
    return he.HashGridSpec.create(
        HashEncodingConfig(
            n_levels=n_levels, n_features_per_level=f, log2_hashmap_size=log2, base_resolution=base,
            desired_resolution=desired,
        )
    )


def _pair_positions(seed):
    """Uniform points, the box's faces and corners, points just under 1 (the
    dense levels' upper clamp) and ray-ordered samples (64 rays of 64 points
    sqrt(3)/1024 apart, as the render and training batches lie)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, 1.0, (2000, 3))
    faces = rng.uniform(0.0, 1.0, (256, 3))
    faces[np.arange(256), rng.integers(0, 3, 256)] = rng.choice([0.0, 1.0], 256)
    corners = np.array([[(k >> d) & 1 for d in range(3)] for k in range(8)], np.float64)
    near_top = 1.0 - rng.uniform(0.0, 0.02, (64, 3))
    d = rng.normal(size=(64, 1, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = rng.uniform(0.25, 0.75, (64, 1, 3)) + (np.arange(64) * np.sqrt(3.0) / 1024)[None, :, None] * d
    return torch.from_numpy(np.concatenate([pos, faces, corners, near_top, rays.reshape(-1, 3)]).astype(np.float32))


def _level_rows(pos, spec):
    """(N, L, 8) rows of each level's own table (not the flattened one)."""
    rows = he.corner_rows(pos, spec)
    return rows - (torch.arange(spec.n_levels) * spec.padded_size)[None, :, None]


@pytest.mark.parametrize("name", ["base.json", "TINY", *(str(i) for i in range(len(SWEEP)))])
def test_corner_pairs_are_adjacent_rows(name):
    """Corners k and k|1 read rows r and (r + 1) mod size, which the kernels'
    paired loads rely on; on a dense level the pair never wraps."""
    spec = _spec(name)
    r = _level_rows(_pair_positions(7), spec)
    size = torch.tensor(spec.sizes)[None, :, None]
    assert ((r >= 0) & (r < size)).all()
    assert torch.equal(r[..., 1::2], (r[..., 0::2] + 1) % size)
    dense = torch.tensor(spec.dense)
    assert (r[:, dense, 0::2] + 1 < size[:, dense]).all()
    if not name.isdigit():
        assert dense.any() and not dense.all()  # both kinds of level are among the cases


def test_hash_level_pairs_wrap_at_the_last_row():
    """Uniform positions put some hash level's pair at r = size - 1, whose
    second row is row 0 (the kernels load such a pair row by row)."""
    spec = _spec("TINY")
    pos = torch.from_numpy(np.random.default_rng(5).uniform(0.0, 1.0, (1 << 15, 3)).astype(np.float32))
    r = _level_rows(pos, spec)
    size = torch.tensor(spec.sizes)[None, :, None]
    at_end = r[..., 0::2] == size - 1
    assert at_end.sum() > 4
    assert not at_end[:, torch.tensor(spec.dense)].any()
    assert (r[..., 1::2][at_end] == 0).all()


# the exact scatter's deposit units: at F <= 2 two flat rows {2u, 2u + 1} of
# the (L * T_pad, F) gradient, so corners k and k|1 share one deposit where
# their rows differ only in bit 0 (or are one row); the rules below say where
PAIR_SPECS = ["base.json", "TINY", *(str(i) for i in range(len(SWEEP)))]


def _variant_rows(name, variant):
    """The spec, the pair positions, their (N, L, 8) level rows and (N, L)
    cell base x under `variant`, from the plain cell math."""
    spec = dataclasses.replace(_spec(name), variant=variant)
    pos = _pair_positions(7)
    base, _ = he._grid_coords(pos, he._level_constants(spec, pos.device))
    return spec, _level_rows(pos, spec), base[..., 0]


@pytest.mark.parametrize("name", PAIR_SPECS)
def test_xadd_corner_pairs_are_adjacent_rows(name):
    """xadd: corners k and k|1 read rows r and (r + 1) mod size, and every
    level starts on an even flat row (T_pad even)."""
    spec, r, _ = _variant_rows(name, "xadd")
    size = torch.tensor(spec.sizes)[None, :, None]
    assert spec.padded_size % 2 == 0
    assert torch.equal(r[..., 1::2], (r[..., 0::2] + 1) % size)


@pytest.mark.parametrize("name", PAIR_SPECS)
def test_tcnn_hash_level_pairs_differ_in_bit_0(name):
    """tcnn on a hash level (its size a power of two): at an even base x,
    corners k and k|1 read rows h and h ^ 1."""
    spec, r, x = _variant_rows(name, "tcnn")
    hashed = ~torch.tensor(spec.dense)
    assert hashed.any()
    assert all(s & (s - 1) == 0 for s, d in zip(spec.sizes, spec.dense, strict=True) if not d)
    r0, r1 = r[:, hashed, 0::2], r[:, hashed, 1::2]
    even = (x[:, hashed] % 2 == 0)[..., None].expand_as(r0)
    assert even.any() and (~even).any()
    assert torch.equal(r1[even], r0[even] ^ 1)


@pytest.mark.parametrize("name", PAIR_SPECS)
def test_tcnn_dense_level_pairs_are_adjacent_or_clamped(name):
    """tcnn on a dense level: corners k and k|1 read rows r and r + 1, and
    one row exactly where x clamps at res - 1 (or below 0)."""
    spec, r, x = _variant_rows(name, "tcnn")
    dense = torch.tensor(spec.dense)
    res = torch.tensor(spec.resolutions)[dense]
    r0, r1 = r[:, dense, 0::2], r[:, dense, 1::2]
    clamped = ((x[:, dense] >= res - 1) | (x[:, dense] < 0))[..., None].expand_as(r0)
    assert torch.equal(r1 == r0, clamped)
    assert torch.equal(r1[~clamped], r0[~clamped] + 1)
    if not name.isdigit():
        assert clamped.any()  # the clamp is among the cases
