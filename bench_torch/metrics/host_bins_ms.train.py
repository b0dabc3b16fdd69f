"""host_bins_ms.train (ms): the mean host wall time a training step spends
making its fine bins (the proposal stage and its resample, the grid, or the
stratified draw), from the program's span `trainer.step.bins` over the
traced steps. None where the program enters no such span."""


def read(ctx, outcome):
    tr = outcome.trace
    if tr is None:
        return None
    seconds, n = tr.span_stats("trainer.step.bins")
    return 1e3 * seconds / outcome.window["trace_steps"] if n else None
