"""mfu.train: the heads' FLOPs of the samples the window trained (forward and
backward, roofline.mlp_flops; hash and SH arithmetic left out) over the
window's seconds, over the card's bf16 tensor peak, in %."""

from portbench.harness.roofline import mlp_flops


def read(run):
    if not run.calls or not run.peaks[1]:
        return None
    samples = sum(c["steps"] * c["measured"] for c in run.calls)
    return 100.0 * samples * mlp_flops(run.model, trained=True) / run.window_s / run.peaks[1]
