"""optimizer_ms.train: device ms a training step of the optimizer: adam_ema on every leaf, the envmap's accumulation and the stats
(the port's step.optimizer phase, timed by the CUDA events captured in the call's graph), the mean over the
steps that the traced graphed calls timed (spans.graphed_step_ms)."""

from portbench.harness.spans import graphed_step_ms


def read(run):
    return graphed_step_ms("step.optimizer") if run.traced_calls else None
