"""k2_roofline (%): K2's bound over the traced views' rays (`bounds/
flagship_render.py` at the cell's fine samples and precision) over the
device time of K2 in the trace. Nothing when the trace holds no K2."""
from bench_torch import peaks
from bench_torch.bounds import flagship_render
from bench_torch.reference import barf as ref


def read(ctx, outcome):
    tr = outcome.trace
    if tr is None:
        return None
    seconds, launches = tr.kernel_seconds(flagship_render.KERNELS)
    if not launches:
        return None
    model = ctx.cell.config["model"]
    rays = outcome.window["rays_per_view"] * outcome.window["trace_views"]
    flops, nbytes = flagship_render.work(rays, model["samples"],
                                         ref.macs_per_sample(model)["radiance"])
    ms, _ = peaks.bound_ms(nbytes, flops, ctx.cell.config["precision"])
    return 100.0 * ms * 1e-3 / seconds
