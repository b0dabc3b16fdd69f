"""host_step_ms.train (ms): the mean host wall time of one iteration's
calls into the trainer's batch gather and step function, from the
harness's spans `trainer.batch` and `trainer.step` in the traced steps (no
sync inside them)."""


def read(ctx, outcome):
    tr = outcome.trace
    if tr is None:
        return None
    step_s, n = tr.span_stats("trainer.step")
    batch_s, _ = tr.span_stats("trainer.batch")
    return 1e3 * (step_s + batch_s) / n if n else None
