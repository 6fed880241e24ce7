# Frozen copy of ngp_tpu_torch/utils/aabb.py at commit ef1215de9ec9, the plain path only: the benchmark's reference.
"""Axis-aligned bounding box ops on torch tensors.

Counterpart: ngp_tpu/utils/aabb.py:16-61 (AABB.scene, contains, relative_pos,
ray_intersect) and :64-90 (warp_position, unwarp_position, warp_direction,
unwarp_direction, warp_dt, unwarp_dt). Differs only in that the box constants
are tensors on the device of the tensor they meet, built once per value and
device and kept (a training step captured in a CUDA graph may copy nothing
to the card), instead of jnp constants.

The scene box is the unit cube inflated by aabb_scale around its center
(reference internal/sampler/occupancy_sampler.cu:605-607).
"""

import functools
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
        return _constant(self.lo, like.device)

    def hi_t(self, like: torch.Tensor) -> torch.Tensor:
        return _constant(self.hi, like.device)

    def diag_t(self, like: torch.Tensor) -> torch.Tensor:
        # float32(hi - lo) computed in float64 on the host, as the JAX diag
        return _constant(tuple(h - l for h, l in zip(self.hi, self.lo)), like.device)

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


@functools.lru_cache(maxsize=64)
def _constant(values: tuple, device: torch.device) -> torch.Tensor:
    """A float32 (3,) constant on `device`, made once (callers must not write to it)."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def warp_position(pos: torch.Tensor, aabb: AABB) -> torch.Tensor:
    """AABB-relative position in [0,1]^3 (common_device.h:347-351)."""
    return aabb.relative_pos(pos)


def unwarp_position(pos: torch.Tensor, aabb: AABB) -> torch.Tensor:
    return aabb.lo_t(pos) + pos * aabb.diag_t(pos)


def warp_direction(d: torch.Tensor) -> torch.Tensor:
    """Unit direction -> [0,1]^3 (common_device.h:375-377)."""
    return (d + 1.0) * 0.5


def unwarp_direction(d: torch.Tensor) -> torch.Tensor:
    return d * 2.0 - 1.0


def warp_dt(dt, min_cone_stepsize: float, n_cascades: int):
    """dt -> [0,1] over [min, min * 2^(n_cascades-1)] (common_device.h:395-398)."""
    max_stepsize = min_cone_stepsize * (1 << (n_cascades - 1))
    return (dt - min_cone_stepsize) / (max_stepsize - min_cone_stepsize)


def unwarp_dt(dt, min_cone_stepsize: float, n_cascades: int):
    max_stepsize = min_cone_stepsize * (1 << (n_cascades - 1))
    return dt * (max_stepsize - min_cone_stepsize) + min_cone_stepsize
