"""mfu.serve: the heads' forward FLOPs of the window's network samples
(roofline.mlp_flops) over the window's seconds, over the card's bf16 tensor
peak, in %."""

from portbench.harness.roofline import mlp_flops


def read(run):
    if not run.frames or not run.peaks[1]:
        return None
    samples = sum(f["samples"] for f in run.frames)
    return 100.0 * samples * mlp_flops(run.model, trained=False) / run.window_s / run.peaks[1]
