"""train_mfu (%): the model FLOPs the window trained (6 a weight a sample,
the family's `macs_per_ray`, from the sizes) over the window's seconds and
the peak of the configuration's precision (`peaks.py`). Source: the host
clock around the window and the harness's count of steps."""
from bench_torch import model_work, peaks


def read(ctx, outcome):
    w = outcome.window
    if not w.get("steps"):
        return None
    flops = model_work.train_flops_per_ray(ctx.cell.config) * w["rays"]
    return 100.0 * flops / w["seconds"] / peaks.FLOP_PER_S[ctx.cell.config["precision"]]
