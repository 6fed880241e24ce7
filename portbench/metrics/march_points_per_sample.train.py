"""march_points_per_sample.train: the lattice points whose occupancy the training batch's march read over the samples
it kept, in the traced calls (the port's train_march counters train.batch.points and train.batch.samples.mip<k>, read
with each call's stats); None where the port has no such counters."""

from portbench.harness.spans import records


def read(run):
    if not run.traced_calls:
        return None
    points = samples = 0
    for r in records("train"):
        for name, n in r["counters"].items():
            if name == "train.batch.points":
                points += n
            elif name.startswith("train.batch.samples.mip"):
                samples += n
    return points / samples if points and samples else None
