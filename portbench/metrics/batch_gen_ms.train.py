"""batch_gen_ms.train: device ms a training step of batch generation: rays, the march, the row sort, the target and the background
(the port's step.batch phase, timed by the CUDA events captured in the call's graph), the mean over the
steps that the traced graphed calls timed (spans.graphed_step_ms)."""

from portbench.harness.spans import graphed_step_ms


def read(run):
    return graphed_step_ms("step.batch") if run.traced_calls else None
