"""host_k4_ms.train (ms): the mean host wall time a training step spends in
the flagship train kernel's call (weight packing, workspaces, launch, the
gradients handed to the parameters), from the program's span
`trainer.step.k4` over the traced steps. None where the program enters no
such span."""


def read(ctx, outcome):
    tr = outcome.trace
    if tr is None:
        return None
    seconds, n = tr.span_stats("trainer.step.k4")
    return 1e3 * seconds / outcome.window["trace_steps"] if n else None
