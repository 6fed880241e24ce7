"""host_syncs.serve: host<->device synchronisations a traced frame, the mean of the port's
render.host_syncs counter over the traced frames' request records."""

from portbench.harness.spans import records


def read(run):
    recs = [r for r in records("render") if "render.host_syncs" in r["counters"]]
    if not run.traced_frames or not recs:
        return None
    return sum(r["counters"]["render.host_syncs"] for r in recs) / len(recs)
