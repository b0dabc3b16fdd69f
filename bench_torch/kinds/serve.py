"""Serving traffic: a closed loop of one caller rendering whole views
through the serving entry's `render_views.render_image`, one after another.

Set-up builds the configuration from the entry's flags
(`<entry>.build_config`) and the parameters as `render_views` does, loads
the weights of the configuration's reference family into them, computes
every test view's rays from the scene's test poses, draws the gauge (the similarity from the ground-truth
frame into the model's, which `render_views` computes once per checkpoint)
and the order of the views from `--seed`, and renders one view to warm up.
The window renders views in that order, cycling, until `--seconds` have
passed; each view is timed from the call until its rgb is on the host. A
traced run then profiles `trace_views` more views with the harness's spans
around the calls into the model and the ray transform.
"""
from __future__ import annotations

import gc
import statistics
import time
from typing import Dict

import numpy as np
import torch

from bench_torch import harness, scene
from bench_torch import trace as tracing
from bench_torch.reference.common import exact_fp32, so3_exp, sub_seed

# the kind builds the entry's configuration (`<entry>.build_config`) into the
# BARF system's parameters (`systems/barf`) and serves them through
# `render_views`: it drives the entries of a family that has the reference
# view and states that the program serves its entries so
FAMILY_FUNCTION = "render_view"
SERVED_THROUGH = "render_views"


def drives(family) -> bool:
    return (hasattr(family, FAMILY_FUNCTION)
            and getattr(family, "SERVED_THROUGH", None) == SERVED_THROUGH)


ENTRIES = tuple(e for f in harness.families() if drives(f) for e in f.ENTRIES)


def draw_gauge(seed: int, device):
    """(R, t, c): a rotation of ~0.15 rad about a random axis, a shift of
    ~0.15 and a scale of ~1 +- 0.05, from the seed."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 2))
    z = torch.randn(7, generator=gen, device=device)
    R = so3_exp(0.15 * z[:3])
    return R, (0.15 * z[3:6])[None, :], 1.0 + 0.05 * z[6]


def _spans(render_views):
    """Wrap the renderer's calls into the model and the ray transform in
    harness spans; returns the undo."""
    sys_mod, cal_mod = render_views.barf_sys, render_views.calibration
    forward, transform = sys_mod.forward, cal_mod.validation_transform_rays

    def forward_span(*a, **k):
        with tracing.span("render.forward"):
            return forward(*a, **k)

    def transform_span(*a, **k):
        with tracing.span("render.transform"):
            return transform(*a, **k)

    sys_mod.forward, cal_mod.validation_transform_rays = forward_span, transform_span

    def undo():
        sys_mod.forward, cal_mod.validation_transform_rays = forward, transform

    return undo


def run(ctx: harness.Context) -> harness.Outcome:
    cfg_file, traffic = ctx.cell.config, ctx.cell.traffic
    family = harness.family_module(cfg_file)
    model, size = cfg_file["model"], cfg_file["scene"]["image_size"]
    cuda = torch.device(ctx.device).type == "cuda"
    from nerf_experiments_tpu_torch.experiments import render_views
    from nerf_experiments_tpu_torch.systems import barf as barf_sys

    root = scene.ensure(cfg_file["scene"], images=("train",), poses=(traffic["split"],),
                        device=ctx.device)
    entry = harness.entry_module(cfg_file)
    args = entry.parse_args(list(cfg_file["flags"]) + [
        "--scene_path", root, "--seed", str(ctx.seed), "--device", str(ctx.device)])
    harness.log(f"scene ready at {harness.elapsed(ctx.t_start):.2f} s")
    cfg, dm = entry.build_config(args)
    params = barf_sys.init(torch.Generator().manual_seed(args.seed), cfg).to(ctx.device)
    weights = family.draw_weights(family.param_shapes(model, dm.n_training_images), ctx.seed,
                                  ctx.device)
    harness.load_weights(params, weights)
    origs, dirs, pixel_width = scene.view_rays(root, traffic["split"], size)
    gauge = draw_gauge(ctx.seed, ctx.device)
    a_pos, a_dir = float(model["levels_pos"]), float(model["levels_dir"])  # every level on
    order = np.random.default_rng(sub_seed(ctx.seed, 3)).permutation(len(origs))
    chunk = int(traffic["chunk"])
    undo_fault = ctx.fault(render_views) if ctx.fault is not None else None

    def render(i):
        return render_views.render_image(params, cfg, origs[i], dirs[i], gauge, pixel_width,
                                         chunk, ctx.device, a_pos, a_dir)

    render(order[-1])  # warm-up: every chunk shape of a view
    if cuda:
        torch.cuda.synchronize()
    setup_s = harness.elapsed(ctx.t_start)

    done, view_ms, outputs = 0, [], {}
    t0 = time.perf_counter()
    while True:
        i = int(order[done % len(order)])
        ts = time.perf_counter()
        rgb = render(i)  # on the host: the view is complete
        te = time.perf_counter()
        view_ms.append((te - ts) * 1e3)
        outputs[done] = (i, rgb)
        done += 1
        if te - t0 >= ctx.seconds:
            break
    window_s = time.perf_counter() - t0
    q = statistics.quantiles(view_ms, n=20) if len(view_ms) > 1 else view_ms * 19
    harness.log(f"set-up {setup_s:.2f} s; window {window_s:.3f} s, {done} views; view ms "
                f"min {min(view_ms):.2f} p5 {q[0]:.2f} median {q[9]:.2f} p95 {q[18]:.2f} "
                f"max {max(view_ms):.2f}")

    held = {}
    if ctx.trace:
        undo = _spans(render_views)
        try:
            with tracing.traced(held):
                for k in range(traffic["trace_views"]):
                    with tracing.span("render.view"):
                        render(int(order[(done + k) % len(order)]))
        finally:
            undo()
    if undo_fault is not None:
        undo_fault()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    failed = sum(not np.isfinite(rgb).all() for _, rgb in outputs.values())
    # the sample the check compares, drawn from the seed among the finished views
    pick = np.random.default_rng(sub_seed(ctx.seed, 4)).choice(
        done, size=min(done, traffic["check_views"]), replace=False)
    check = {"weights": weights, "gauge": gauge,
             "views": [(outputs[int(k)][0], outputs[int(k)][1]) for k in sorted(pick)],
             "origs": origs, "dirs": dirs, "chunk": chunk}
    del params, outputs
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    rays = done * origs.shape[1]
    e2e = {"render_rays_per_s": rays / window_s, "setup_s": setup_s,
           "render_view_ms_p95": statistics.quantiles(view_ms, n=100, method="inclusive")[94]
           if len(view_ms) > 1 else view_ms[0]}
    return harness.Outcome(
        end_to_end=e2e, attempted=done, failed=int(failed),
        window={"seconds": window_s, "views": done, "rays": rays,
                "rays_per_view": origs.shape[1], "trace_views": traffic["trace_views"]},
        check=check, trace=held.get("trace"), memory_peak_bytes=peak)


def compare(ctx: harness.Context, check: dict, control: str = None) -> Dict[str, float]:
    """The widest gap of a served colour channel, and the root mean square
    gap, over the sampled views, against the reference rendering the same
    rays with the same weights and gauge."""
    model = ctx.cell.config["model"]
    family = harness.family_module(ctx.cell.config)
    dev = check["gauge"][0].device
    widest, sq, n = 0.0, 0.0, 0
    with exact_fp32():
        for i, served in check["views"]:
            o = torch.as_tensor(check["origs"][i], device=dev)
            d = torch.as_tensor(check["dirs"][i], device=dev)
            r = family.render_view(check["weights"], model, o, d, check["gauge"],
                                   check["chunk"])
            got = (torch.as_tensor(served, device=dev) if control is None else
                   family.render_view(check["weights"], model, o, d, check["gauge"],
                                      check["chunk"], control))
            gap = (got - r).double()
            widest = max(widest, float(gap.abs().max()))
            sq += float((gap ** 2).sum())
            n += gap.numel()
    return {"rgb_max_gap": widest, "rgb_rms_gap": (sq / max(n, 1)) ** 0.5}
