"""8-bit PNG reading and writing with the standard library's zlib.

Port-only: ngp_tpu decodes PNGs with its prebuilt native loader or PIL
(ngp_tpu/data/nerf_synthetic.py:40-89) and writes them with PIL
(ngp_tpu/data/synthetic.py:171,197); the port needs neither. The reader
takes non-interlaced 8-bit greyscale, grey+alpha, RGB and RGBA images with
any of the five row filters (0-4) and returns RGBA, as PIL's
convert("RGBA") does; the writer emits RGBA with filter 0 on every row.
"""

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples per pixel


def _chunks(data: bytes):
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        yield kind, data[pos + 8 : pos + 8 + length]
        pos += 12 + length


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: bytes, width: int, height: int, bpp: int) -> np.ndarray:
    stride = width * bpp
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    out = np.zeros((height, stride), np.int32)
    prev = np.zeros(stride, np.int32)
    for y in range(height):
        kind, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if kind == 0:
            cur = line
        elif kind == 1:  # Sub: running sum per channel along the row
            cur = np.cumsum(line.reshape(width, bpp), axis=0).reshape(-1) & 0xFF
        elif kind == 2:  # Up
            cur = (line + prev) & 0xFF
        elif kind in (3, 4):  # Average, Paeth: sequential over pixels
            cur = np.zeros(stride, np.int32)
            left = np.zeros(bpp, np.int32)
            up_left = np.zeros(bpp, np.int32)
            for x in range(0, stride, bpp):
                up = prev[x : x + bpp]
                pred = (left + up) >> 1 if kind == 3 else _paeth(left, up, up_left)
                left = (line[x : x + bpp] + pred) & 0xFF
                cur[x : x + bpp] = left
                up_left = up
        else:
            raise ValueError(f"unknown PNG row filter {kind}")
        out[y] = cur
        prev = cur
    return out.astype(np.uint8).reshape(height, width, bpp)


def read_png(path) -> np.ndarray:
    """(H, W, 4) uint8 RGBA of an 8-bit, non-interlaced PNG."""
    with open(path, "rb") as f:
        data = f.read()
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(f"{path}: only non-interlaced 8-bit grey/RGB(A) PNGs are read (depth {depth}, type {ctype})")
    px = _unfilter(zlib.decompress(b"".join(idat)), width, height, _CHANNELS[ctype])
    if ctype == 6:
        return px
    alpha = np.full((height, width, 1), 255, np.uint8)
    if ctype == 2:
        return np.concatenate([px, alpha], axis=-1)
    grey = np.repeat(px[..., :1], 3, axis=-1)
    return np.concatenate([grey, px[..., 1:] if ctype == 4 else alpha], axis=-1)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def write_png(path, rgba: np.ndarray):
    """Write an (H, W, 4) uint8 array as an RGBA PNG (filter 0 rows)."""
    rgba = np.ascontiguousarray(rgba, np.uint8)
    if rgba.ndim != 3 or rgba.shape[2] != 4:
        raise ValueError(f"expected (H, W, 4) uint8, got {rgba.shape}")
    h, w, _ = rgba.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgba.reshape(h, w * 4)], axis=1)
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))
