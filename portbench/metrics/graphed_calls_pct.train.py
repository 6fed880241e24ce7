"""graphed_calls_pct.train: the share of the window's train() calls that replayed CUDA graphs (training_buffer.graphed)."""


def read(run):
    return 100.0 * sum(c["graphed"] for c in run.calls) / len(run.calls) if run.calls else None
