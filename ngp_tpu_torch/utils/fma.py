"""Fused multiply-add with one float32 rounding.

Counterpart: none in ngp_tpu as code; XLA contracts `a * b + c` into a fused
multiply-add when it compiles ngp_tpu's lattice positions and hash-grid
coordinates. The port computes those sums through this helper so that the
same inputs land on the same lattice points and grid cells: the product of
two float32 values is exact in float64 and the float64 sum is rounded once
more to float32 (a double rounding that can differ from a true fma only when
the float64 sum sits exactly on a float32 tie).
"""

import torch


def fma(a, b, c) -> torch.Tensor:
    """float32(a * b + c) with the product unrounded; tensors broadcast, and
    python floats are taken as float32 values."""
    a, b, c = (x.to(torch.float64) if isinstance(x, torch.Tensor) else float(torch.tensor(x, dtype=torch.float32)) for x in (a, b, c))
    return (a * b + c).to(torch.float32)


def dot_fma(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis of a * b as XLA's CPU dot compiles a short
    contraction: the first product rounded, each later one added by a fused
    multiply-add, in order."""
    acc = a[..., 0] * b[..., 0]
    for k in range(1, a.shape[-1]):
        acc = fma(a[..., k], b[..., k], acc)
    return acc


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (torch's CPU sqrt may be an ulp
    off; the float64 root rounded once to float32 is exact)."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)
