"""Port parity: the PNG codec against PIL, the procedural scene against
ngp_tpu's numpy original, and load_nerf_synthetic against ngp_tpu's loader."""

import json

import numpy as np
import pytest
import torch
from PIL import Image

from ngp_tpu.data import nerf_synthetic as j_ns
from ngp_tpu.data import synthetic as j_syn
from ngp_tpu_torch.data import nerf_synthetic as t_ns
from ngp_tpu_torch.data import synthetic as t_syn
from ngp_tpu_torch.data.png import read_png, write_png

torch.set_num_threads(2)


def _image(seed, h=37, w=53):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    # smooth regions so PIL's adaptive filtering picks every filter type
    ramp = (np.add.outer(np.arange(h), np.arange(w)) * 3 % 256).astype(np.uint8)
    base[: h // 2, :, 0] = ramp[: h // 2]
    base[:, : w // 3, 1] = 200
    return base


@pytest.mark.parametrize("mode", ["RGBA", "RGB", "L", "LA"])
def test_png_decode_matches_pil(tmp_path, mode):
    img = Image.fromarray(_image(1), "RGBA").convert(mode)
    path = tmp_path / f"x_{mode}.png"
    img.save(path, optimize=True)
    want = np.asarray(Image.open(path).convert("RGBA"))
    np.testing.assert_array_equal(read_png(path), want)


def test_png_decode_every_filter(tmp_path):
    """Rows written with each of the five filters by PIL's adaptive encoder
    and by hand decode to the same pixels."""
    import struct
    import zlib

    px = _image(2, 9, 11).astype(np.int32)
    h, w, _ = px.shape
    rows = []
    prev = np.zeros(w * 4, np.int32)
    for y in range(h):
        cur = px[y].reshape(-1)
        kind = y % 5
        left = np.concatenate([np.zeros(4, np.int32), cur[:-4]])
        up_left = np.concatenate([np.zeros(4, np.int32), prev[:-4]])
        pred = [0, left, prev, (left + prev) >> 1, None][kind]
        if kind == 4:
            p = left + prev - up_left
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - up_left)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, up_left))
        rows.append(bytes([kind]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = cur

    def chunk(k, b):
        return struct.pack(">I", len(b)) + k + b + struct.pack(">I", zlib.crc32(k + b))

    path = tmp_path / "filters.png"
    path.write_bytes(
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(b"".join(rows)))
        + chunk(b"IEND", b"")
    )
    np.testing.assert_array_equal(read_png(path), px.astype(np.uint8))
    np.testing.assert_array_equal(np.asarray(Image.open(path).convert("RGBA")), px.astype(np.uint8))


def test_png_write_reads_back_in_pil(tmp_path):
    px = _image(3)
    write_png(tmp_path / "w.png", px)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "w.png").convert("RGBA")), px)
    np.testing.assert_array_equal(read_png(tmp_path / "w.png"), px)


def test_ground_truth_matches_numpy_original():
    pose = j_syn._look_at_pose([1.5, -2.5, 2.8])
    want = j_syn.render_ground_truth(pose, 40, 32, 0.69, n_steps=96)
    got = t_syn.render_ground_truth(pose, 40, 32, 0.69, n_steps=96).numpy()
    np.testing.assert_array_equal(t_syn.look_at_pose([1.5, -2.5, 2.8]), pose)
    assert want[..., 3].max() > 0.5
    # float32 exp differs between numpy and torch by an ulp at most
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    u8_got, u8_want = t_syn.to_rgba8(got), t_syn.to_rgba8(want)
    assert np.abs(u8_got.astype(int) - u8_want.astype(int)).max() <= 1


def test_load_nerf_synthetic_matches_jax(tmp_path):
    train_json, test_json = t_syn.write_synthetic_dataset(tmp_path, n_train=3, n_test=1, width=24, height=20)
    doc = json.loads(train_json.read_text())
    assert len(doc["frames"]) == 3 and (tmp_path / "test" / "r_0.png").exists()
    want = j_ns.load_nerf_synthetic(train_json)
    got = t_ns.load_nerf_synthetic(train_json)
    assert got.images.dtype == torch.float16 and got.images.shape == (3, 20, 24, 4)
    np.testing.assert_array_equal(got.images.numpy(), np.asarray(want.images))
    np.testing.assert_array_equal(got.xforms.numpy(), np.asarray(want.xforms))
    assert got.focal_length == want.focal_length and got.resolution == want.resolution

    rng = np.random.default_rng(0)
    xy = rng.uniform(-0.1, 1.1, (500, 2)).astype(np.float32)
    idx = rng.integers(0, 3, 500)
    np.testing.assert_array_equal(
        t_ns.read_rgba(got.images, torch.from_numpy(xy), torch.from_numpy(idx)).numpy(),
        np.asarray(j_ns.read_rgba(want.images, xy, idx)),
    )
