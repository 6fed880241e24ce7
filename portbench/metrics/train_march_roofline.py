"""train_march_roofline: the least time of the traced calls' train_march launches, the bytes they must move
(march_bytes) over the card's memory rate, over the kernel's device time in the trace, in %. Rays and lat_pad slots
come from the port's train_march counters (train.batch.rays, train.batch.lat_slots), launches from
launches.train_march, each summed over the traced calls' records; the cascades a launch reads from the port's own
config loader and lattice rule. None where the port has no such counters."""

from portbench.harness.spans import records
from portbench.harness.trace import kernel_base


def march_bytes(model: dict, rays: int, lat_slots: int, launches: int) -> float:
    """Each read once and each written once: a ray's o, d (12 B each), startt (4), k0 (8), hits (1), its cone
    anchors (16 B, cone lattice only) and its count (8); 2 B a lat_pad slot (s_pad a ray); and a launch's
    occupancy grid (1 B a cell) of every cascade its lattice reads: cascade 0 alone on the packed lattice, else
    each of the sampler's cascades. The coarse pass's pooled grid and segment counts (under 0.1 % of it) are left
    out."""
    from ngp_tpu_torch.sampling import training
    from ngp_tpu_torch.utils.config import NGPConfig

    cfg = NGPConfig.from_json(model).sampler
    mode = training.march_mode(cfg)
    grids = 1 if mode == training.PACKED else cfg.n_cascades
    return rays * (45 + 16 * (mode == training.CONE)) + 2 * lat_slots + launches * grids * cfg.grid_size**3


def read(run):
    if not run.traced_calls or run.trace is None or not run.trace.ops or not run.peaks[0]:
        return None
    totals = {}
    for r in records("train"):
        for name in ("train.batch.rays", "train.batch.lat_slots", "launches.train_march"):
            totals[name] = totals.get(name, 0) + r["counters"].get(name, 0)
    if not totals.get("train.batch.rays") or not totals.get("launches.train_march"):
        return None
    spent = run.trace.device_s(lambda name: kernel_base(name) == "train_march_kernel")
    least = march_bytes(run.model, totals["train.batch.rays"], totals["train.batch.lat_slots"],
                        totals["launches.train_march"]) / run.peaks[0]
    return 100.0 * least / spent if spent > 0 else None
