"""samples_per_point.serve: the window's network samples over the lattice points its march tested."""


def read(run):
    points = sum(f["points"] for f in run.frames)
    return sum(f["samples"] for f in run.frames) / points if points else None
