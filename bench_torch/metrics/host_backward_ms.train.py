"""host_backward_ms.train (ms): the mean host wall time a training step
spends in autograd's backward (the camera and the proposal stage), from the
program's span `trainer.step.backward` over the traced steps. None where the
program enters no such span."""


def read(ctx, outcome):
    tr = outcome.trace
    if tr is None:
        return None
    seconds, n = tr.span_stats("trainer.step.backward")
    return 1e3 * seconds / outcome.window["trace_steps"] if n else None
