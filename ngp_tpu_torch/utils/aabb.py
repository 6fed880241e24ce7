"""Axis-aligned bounding box ops on torch tensors.

Counterpart: ngp_tpu/utils/aabb.py:16-61 (AABB.scene, contains, relative_pos,
ray_intersect). Differs only in that the box constants are built on the
device of the tensor they meet instead of being jnp constants.

The scene box is the unit cube inflated by aabb_scale around its center
(reference internal/sampler/occupancy_sampler.cu:605-607).
"""

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class AABB:
    """Static (python-level) bounding box; lo/hi are float tuples."""

    lo: tuple
    hi: tuple

    @staticmethod
    def scene(aabb_scale: float) -> "AABB":
        r = 0.5 * aabb_scale
        return AABB((0.5 - r,) * 3, (0.5 + r,) * 3)

    def lo_t(self, like: torch.Tensor) -> torch.Tensor:
        return torch.tensor(self.lo, dtype=torch.float32, device=like.device)

    def hi_t(self, like: torch.Tensor) -> torch.Tensor:
        return torch.tensor(self.hi, dtype=torch.float32, device=like.device)

    def diag_t(self, like: torch.Tensor) -> torch.Tensor:
        # float32(hi - lo) computed in float64 on the host, as the JAX diag
        return torch.tensor([h - l for h, l in zip(self.hi, self.lo)], dtype=torch.float32, device=like.device)

    def contains(self, pos: torch.Tensor) -> torch.Tensor:
        """pos: (..., 3) -> bool (...,)."""
        return torch.all((pos >= self.lo_t(pos)) & (pos <= self.hi_t(pos)), dim=-1)

    def relative_pos(self, pos: torch.Tensor) -> torch.Tensor:
        return (pos - self.lo_t(pos)) / self.diag_t(pos)

    def ray_intersect(self, o: torch.Tensor, d: torch.Tensor):
        """Slab test. o, d: (..., 3). Returns (tmin, tmax) with tmin clamped >= 0;
        where the ray misses the box, tmin > tmax."""
        inv_d = 1.0 / d
        t0 = (self.lo_t(o) - o) * inv_d
        t1 = (self.hi_t(o) - o) * inv_d
        tmin = torch.amax(torch.minimum(t0, t1), dim=-1)
        tmax = torch.amin(torch.maximum(t0, t1), dim=-1)
        return torch.clamp(tmin, min=0.0), tmax
