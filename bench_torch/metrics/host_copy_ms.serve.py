"""host_copy_ms.serve (ms): the host wall time a served view spends copying
its chunks' rgb to the host (each copy waits for the chunk's kernels), from
the program's span `render.to_host` over the traced views, per view. None
where the program enters no such span."""


def read(ctx, outcome):
    tr = outcome.trace
    if tr is None:
        return None
    seconds, n = tr.span_stats("render.to_host")
    return 1e3 * seconds / outcome.window["trace_views"] if n else None
