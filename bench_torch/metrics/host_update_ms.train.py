"""host_update_ms.train (ms): the mean host wall time a training step spends
in its update (the non-finite guard, Adam, the occupancy refresh), from the
program's span `trainer.step.update` over the traced steps. None where the
program enters no such span."""


def read(ctx, outcome):
    tr = outcome.trace
    if tr is None:
        return None
    seconds, n = tr.span_stats("trainer.step.update")
    return 1e3 * seconds / outcome.window["trace_steps"] if n else None
