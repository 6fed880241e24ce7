"""Low-discrepancy (shuffled scrambled Sobol) sampling on torch tensors.

Counterpart: ngp_tpu/utils/qmc.py:34-94,163-172 (sobol, reverse_bits,
nested_uniform_scramble, ld_random_val, ld_random_val_2d,
ld_random_pixel_offset), bit-exact. Differs in representation: torch has no
full uint32 arithmetic, so every uint32 value lives in an int64 tensor and is
masked to 32 bits after each multiply, add and shift. Multiplies by a 32-bit
constant are split in 16-bit halves so no int64 product can overflow. The
direction-sampling helpers (qmc.py:101-160) are not ported: the render path
does not use them.
"""

import numpy as np
import torch

_MASK = 0xFFFFFFFF

_DIRECTIONS_DIM1 = [0x80000000 >> i for i in range(32)]


def _sobol_dim2_directions():
    v = [0] * 32
    v[0] = 1 << 31
    v[1] = 3 << 30
    for i in range(2, 32):
        v[i] = v[i - 2] ^ (v[i - 2] >> 2) ^ v[i - 1]
    return [x & _MASK for x in v]


_DIRECTIONS = (_DIRECTIONS_DIM1, _sobol_dim2_directions())

_U32_SCALE = float(1.0 / (1 << 32))


def _u32(x, device=None) -> torch.Tensor:
    """Python int / numpy / tensor -> int64 tensor holding uint32 values."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device or x.device, dtype=torch.int64) & _MASK
    return torch.as_tensor(np.asarray(x, np.uint32).astype(np.int64), device=device)


def mul32(a: torch.Tensor, c) -> torch.Tensor:
    """(a * c) mod 2^32 for a and c in [0, 2^32): c a Python int or a tensor
    (split in 16-bit halves so no int64 product overflows)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _MASK


def sobol(index: torch.Tensor, dim: int) -> torch.Tensor:
    """Sobol sample `index` along dimension dim (0 or 1), as uint32-in-int64."""
    out = torch.zeros_like(index)
    for b, v in enumerate(_DIRECTIONS[dim]):
        out = out ^ (((index >> b) & 1) * v)
    return out


def reverse_bits(x: torch.Tensor) -> torch.Tensor:
    x = ((x & 0xAAAAAAAA) >> 1) | ((x & 0x55555555) << 1)
    x = ((x & 0xCCCCCCCC) >> 2) | ((x & 0x33333333) << 2)
    x = ((x & 0xF0F0F0F0) >> 4) | ((x & 0x0F0F0F0F) << 4)
    x = ((x & 0xFF00FF00) >> 8) | ((x & 0x00FF00FF) << 8)
    return ((x >> 16) | (x << 16)) & _MASK


def _laine_karras(x: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    x = (x + seed) & _MASK
    x = x ^ mul32(x, 0x6C50B47C)
    x = x ^ mul32(x, 0xB82F1E52)
    x = x ^ mul32(x, 0xC7AFE638)
    x = x ^ mul32(x, 0x8D22F6E6)
    return x


def nested_uniform_scramble(x: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    return reverse_bits(_laine_karras(reverse_bits(x), seed))


def _hash_combine(seed: torch.Tensor, v: int) -> torch.Tensor:
    return seed ^ ((v + ((seed << 6) & _MASK) + (seed >> 2)) & _MASK)


def _to_unit(x: torch.Tensor) -> torch.Tensor:
    # uint32 -> float32 rounds to nearest even (as XLA's convert), then the
    # exact power-of-two scale: 0xFFFFFFFF maps to 1.0
    return x.to(torch.float32) * _U32_SCALE


def _index_seed(index, seed):
    """Both as broadcast uint32-in-int64 tensors on the device of whichever
    of them is a tensor (the CPU when neither is)."""
    dev = next((x.device for x in (index, seed) if isinstance(x, torch.Tensor)), None)
    return torch.broadcast_tensors(_u32(index, dev), _u32(seed, dev))


def ld_random_val(index, seed, dim: int = 0) -> torch.Tensor:
    """Low-discrepancy value in [0, 1] per (index, seed), broadcast."""
    index, seed = _index_seed(index, seed)
    index = nested_uniform_scramble(index, seed)
    return _to_unit(nested_uniform_scramble(sobol(index, dim), _hash_combine(seed, dim)))


def ld_random_val_2d(index, seed) -> torch.Tensor:
    index, seed = _index_seed(index, seed)
    index = nested_uniform_scramble(index, seed)
    vals = [_to_unit(nested_uniform_scramble(sobol(index, d), _hash_combine(seed, d))) for d in (0, 1)]
    return torch.stack(vals, dim=-1)


def ld_random_pixel_offset(spp: int) -> torch.Tensor:
    """Per-spp sub-pixel jitter in [0,1)^2, constant across pixels (CPU (2,)):
    fract(0.5 - ld2(0) + ld2(spp)); spp=0 gives exactly 0.5."""
    base = ld_random_val_2d(0, 0xDEADBEEF)
    cur = ld_random_val_2d(int(spp), 0xDEADBEEF)
    off = 0.5 - base + cur
    return off - torch.floor(off)
