"""host_bins_ms.serve (ms): the host wall time a served view spends making
its chunks' fine bins (the proposal stage and its resample, the grid, or the
equidistant bins), from the program's span `render.bins` over the traced
views, per view. None where the program enters no such span."""


def read(ctx, outcome):
    tr = outcome.trace
    if tr is None:
        return None
    seconds, n = tr.span_stats("render.bins")
    return 1e3 * seconds / outcome.window["trace_views"] if n else None
