"""backward_ms.train: device ms a training step of the backward: the gradients of every leaf and the envmap's
(the port's step.backward phase, timed by the CUDA events captured in the call's graph), the mean over the
steps that the traced graphed calls timed (spans.graphed_step_ms)."""

from portbench.harness.spans import graphed_step_ms


def read(run):
    return graphed_step_ms("step.backward") if run.traced_calls else None
