"""k4_roofline (%): K4's bound over the traced steps' rays (`bounds/
flagship_train.py` at the cell's fine samples and precision) over the
device time of K4's kernels in the trace. Nothing when the trace holds no
K4 kernel."""
from bench_torch import peaks
from bench_torch.bounds import flagship_train
from bench_torch.reference import barf as ref


def read(ctx, outcome):
    tr = outcome.trace
    if tr is None:
        return None
    seconds, launches = tr.kernel_seconds(flagship_train.KERNELS)
    main, _ = tr.kernel_seconds(flagship_train.KERNELS[:2])
    if not launches or not main:
        return None
    model = ctx.cell.config["model"]
    rays = outcome.window["batch"] * outcome.window["trace_steps"]
    flops, nbytes = flagship_train.work(rays, model["samples"],
                                        ref.macs_per_sample(model)["radiance"])
    ms, _ = peaks.bound_ms(nbytes, flops, ctx.cell.config["precision"])
    return 100.0 * ms * 1e-3 / seconds
