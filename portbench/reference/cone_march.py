"""A plain march of rays over cascaded occupancy grids with exponential
stepping, written from instant-NGP's description (Mueller et al.,
arXiv:2201.05989, Appendix E, "NeRF"; the source's occupancy_sampler.cu
calc_dt, mip_from_pos, mip_from_dt), independent of the port's lattice code:
numpy in float64, one step of every live ray at a time.

- Grid k of the K cascades covers [0.5 - 2^(k-1), 0.5 + 2^(k-1)]^3 with G^3
  cells; the scene box is [0.5 - s/2, 0.5 + s/2]^3 for aabb_scale s.
- A ray starts at t0 and steps t <- t + clamp(c * t, dt_min, dt_max) while
  its point o + t d is inside the scene box; the first point outside ends it.
- A point's cascade: the smallest grid that holds it (the exponent of
  max |p - 0.5|), raised to the one whose cells are about the step's size
  where the step spans half a finest cell or more (the exponent of
  dt * 2 G).
- A point is a sample where its cell in that cascade is occupied; a ray
  takes at most `max_samples` samples.

`ambiguous` marks the rays with a point within `tol` of a cell face that
separates cells of unlike occupancy (after a cascade change too), of the
scene box's face, or with a step within a relative `tol` of a cascade change
in dt: there a float32 march may land on the other side.
"""

import numpy as np


def _exponent(x: np.ndarray) -> np.ndarray:
    """frexp's exponent: x = f 2^e with f in [0.5, 1)."""
    return np.frexp(x)[1]


def cascade(pos: np.ndarray, dt: np.ndarray, grid: int, n_cascades: int) -> np.ndarray:
    """(N,) cascade of points pos (N, 3) marched with steps dt (N,)."""
    maxval = np.max(np.abs(pos - 0.5), axis=-1)
    mip = np.clip(_exponent(maxval) + 1, 0, n_cascades - 1)
    scaled = dt * 2.0 * grid
    dt_mip = np.clip(_exponent(scaled), 0, n_cascades - 1)
    return np.where(scaled < 1.0, mip, np.maximum(mip, dt_mip))


def occupied(occupancy: np.ndarray, pos: np.ndarray, mip: np.ndarray) -> np.ndarray:
    """(N,) occupancy (K, G, G, G), axes (k, x, y, z), of each point's cell in cascade mip."""
    g = occupancy.shape[-1]
    u = (pos - 0.5) / np.exp2(mip)[:, None] + 0.5
    cell = np.clip(np.floor(u * g).astype(np.int64), 0, g - 1)
    return occupancy[mip, cell[:, 0], cell[:, 1], cell[:, 2]]


def march(o, d, t0, occupancy, aabb_scale: float, cone_angle_constant: float, dt_min: float, dt_max: float,
          max_samples: int, tol: float = 1e-5) -> dict:
    """The march of rays (o (R, 3), d (R, 3), t0 (R,)) over `occupancy`:
    {"samples": a list of (n_r, 3) float64 sample positions per ray, in march
    order, "cascades": a list of their (n_r,) cascades, "counts": (R,),
    "ambiguous": (R,) bool (see the module's doc)}."""
    o, d, t = (np.asarray(x, np.float64) for x in (o, d, t0))
    occupancy = np.asarray(occupancy, bool)
    k, g = occupancy.shape[0], occupancy.shape[-1]
    lo, hi = 0.5 - 0.5 * aabb_scale, 0.5 + 0.5 * aabb_scale
    n = o.shape[0]
    samples, cascades = [[] for _ in range(n)], [[] for _ in range(n)]
    counts = np.zeros(n, np.int64)
    ambiguous = np.zeros(n, bool)
    live = np.ones(n, bool)
    offsets = tol * np.concatenate([np.eye(3), -np.eye(3)])
    while live.any():
        r = np.nonzero(live)[0]
        pos = o[r] + t[r, None] * d[r]
        inside = np.all((pos >= lo) & (pos <= hi), axis=-1)
        near_box = np.any(np.minimum(np.abs(pos - lo), np.abs(pos - hi)) < tol, axis=-1)
        ambiguous[r[near_box]] = True
        live[r[~inside]] = False
        r, pos = r[inside], pos[inside]
        dt = np.clip(cone_angle_constant * t[r], dt_min, dt_max)
        mip = cascade(pos, dt, g, k)
        occ = occupied(occupancy, pos, mip)
        # a cascade change within tol of dt, a cell of unlike occupancy within tol of the point
        for f in (1.0 - tol, 1.0 + tol):
            ambiguous[r[cascade(pos, dt * f, g, k) != mip]] = True
        for off in offsets:
            moved = pos + off
            ambiguous[r[occupied(occupancy, moved, cascade(moved, dt, g, k)) != occ]] = True
        take = occ & (counts[r] < max_samples)
        for i, p, m in zip(r[take], pos[take], mip[take]):
            samples[i].append(p)
            cascades[i].append(m)
        counts[r[take]] += 1
        t[r] += dt
    return {"samples": [np.asarray(s, np.float64).reshape(-1, 3) for s in samples],
            "cascades": [np.asarray(m, np.int64) for m in cascades], "counts": counts, "ambiguous": ambiguous}
