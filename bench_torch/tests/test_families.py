"""A second reference family, Instant-NGP (`reference/ingp.py`), taken by the
harness through new files alone: its configuration (`small.INGP_CONFIG`) and
cell in a copy of BENCHMARK.json resolve, run through `harness.execute` on
the CPU at the small size with `correct` true, and its faults and control
come out not correct. The port's step is held to the reference leaf by
leaf."""
import types

import pytest
import torch

from bench_torch import faults, harness
from bench_torch.kinds import train as train_kind
from bench_torch.reference import barf, ingp
from bench_torch.reference.common import exact_fp32, set_flags
from bench_torch.tests.small import (INGP_CELL, INGP_CONFIG, INGP_LIMITS, INGP_NAME, context,
                                     ingp_bench, small_cell)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_an_ingp_cell_resolves_by_new_files(tmp_path):
    c = harness.resolve(INGP_CELL, ingp_bench(tmp_path))
    assert harness.family_module(c.config) is ingp
    assert c.traffic["kind"] == "train" and "run_3d_ingp" in harness.kind_module("train").ENTRIES
    assert {"train_rays_per_s", "setup_s"} <= {m["name"] for m in c.end_to_end}
    assert c.per_layer


def test_a_kind_drives_an_entry_only_where_the_family_has_its_function(tmp_path):
    """The reference has no served view, so the serve kind refuses the entry
    with the kind's message."""
    bench = ingp_bench(tmp_path)
    bench["workloads"].append({"name": f"{INGP_NAME}.serve", "config": INGP_NAME,
                               "traffic": "serve", "chips": 1, "why": "views"})
    assert "run_3d_ingp" not in harness.kind_module("serve").ENTRIES
    with pytest.raises(ValueError, match="the 'serve' kind drives the entries .*run_3d_ingp"):
        harness.resolve(f"{INGP_NAME}.serve", bench)


def test_serve_drives_only_families_served_through_render_views():
    """A reference view alone is not enough: the serve kind builds the BARF
    system's parameters and renders them through `render_views`, so the
    family has to state that the program serves its entries so."""
    serve = harness.kind_module("serve")
    assert serve.drives(barf) and not serve.drives(ingp)
    view_only = types.SimpleNamespace(ENTRIES=("run_mip_nerf",), render_view=barf.render_view)
    assert not serve.drives(view_only)
    view_only.SERVED_THROUGH = "render_views"
    assert serve.drives(view_only)
    assert serve.ENTRIES == barf.ENTRIES


def test_one_family_an_entry():
    entries = [e for f in harness.families() for e in f.ENTRIES]
    assert len(entries) == len(set(entries))
    with pytest.raises(ValueError, match="garf_main"):
        harness.family_module({"entry": "garf_main"})


def test_macs_per_ray_at_the_papers_grid():
    """Density 32-64-64-65 and colour 88-32-3 a sample, 64 + 128 samples."""
    assert ingp.macs_per_ray(INGP_CONFIG["model"]) == (
        (32 * 64 + 64 * 64 + 64 * 65) + (88 * 32 + 32 * 3)) * 192


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_small_ingp_cell_is_correct(weight_decay, tmp_path):
    """Also with the entry's `--weight_decay` (AdamW's decoupled decay of the
    nets), large enough that the reference without it fails."""
    c = small_cell(INGP_CELL, ingp_bench(tmp_path), INGP_LIMITS)
    c.config["flags"] = set_flags(c.config["flags"], {"--weight_decay": weight_decay})
    c.config["model"]["optim"]["weight_decay"] = weight_decay
    line = harness.execute(context(c))
    assert line["correct"] is True, line["check"]
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "check"]


@pytest.mark.parametrize("fault", sorted(faults.BY_KIND["train"]))
def test_ingp_fault_is_not_correct(fault, tmp_path):
    c = small_cell(INGP_CELL, ingp_bench(tmp_path), INGP_LIMITS)
    line = harness.execute(context(c, fault=faults.BY_KIND["train"][fault]))
    assert line["correct"] is False, line["check"]


def test_ingp_control_is_not_correct(tmp_path):
    c = small_cell(INGP_CELL, ingp_bench(tmp_path), INGP_LIMITS)
    ctx = context(c)
    kind = harness.kind_module("train")
    numbers = kind.compare(ctx, kind.run(ctx).check, control=c.config["control"])
    ok, check = harness.judge(numbers, c.limits)
    assert not ok, check


def test_port_ingp_step_against_the_reference(tmp_path):
    """Three steps of `run_3d_ingp`'s plain step on the CPU from the family's
    weights, against `reference/ingp.py` on the same batches and draws: each
    step's loss, every leaf's first gradient and every leaf's change."""
    c = small_cell(INGP_CELL, ingp_bench(tmp_path), INGP_LIMITS)
    ctx = context(c, seed=2**31 + 7)
    _, exp, weights = train_kind.build(ctx, str(tmp_path / "out"))
    trainer, state, start = exp.trainer, exp.state, exp.state.step
    rec = train_kind._Recorder(trainer, ingp)
    state = train_kind._fit_to(trainer, state, start + 1)
    grads = train_kind._first_grads(state)
    state = train_kind._fit_to(trainer, state, start + 3)
    rec.restore()
    model = c.config["model"]
    with exact_fp32():
        r = ingp.train_steps(weights, model, [train_kind.replay(k, ingp, model)
                                              for k in rec.calls], start)
    # float32 sums in another order: the loss to a few ulps (equal on nine
    # seeds tried)
    for got, want in zip([k["loss"] for k in rec.calls], r["losses"]):
        assert abs(got - want) <= 1e-6 * abs(want), (got, want)
    for name, p in state.params.named_parameters():
        g, gr = grads[name].double(), r["grad"][name].double()
        # the gradient to float32 rounding of sums over the batch's samples,
        # and of Adam's first moment over (1 - beta1): 4e-8-7e-8 of the
        # worst leaf's norm on nine seeds
        assert float((g - gr).norm()) <= 1e-6 * float(gr.norm()) + 1e-30, name
        change, cr = (p.detach() - weights[name]).double(), r["change"][name].double()
        # eps 1e-15 makes Adam's first update lr sign(g) wherever g is not
        # all but 0, so each element of a leaf's change is held to a
        # thousandth of the learning rate, where a sign that the rounding
        # flipped moves it by 2 lr: the readings are one or two float32 ulps
        # of a weight (4e-9-1.5e-8) on nine seeds
        assert float((change - cr).abs().max()) <= 1e-3 * model["optim"]["lr_stop"], name
