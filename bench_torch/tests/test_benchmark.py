"""CPU checks of BENCHMARK.json and the files it names.

    python -m pytest bench_torch/tests -q
"""
import ast
import os
import re
import subprocess
import sys

import pytest

from bench_torch import harness
from bench_torch.reference import barf as ref
from bench_torch.tests.small import family_configs, train_cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench_torch"]
    assert BENCH["command"][1].startswith("bench_torch/")
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits: 2 + 14 x 24 runs, compiles, 1200 s spare
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        names.append(w["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        names.append(m["name"])
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
        names.append(m["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for text in [c["source"] for c in BENCH["configs"]] + [x["why"] for x in
                                                           BENCH["configs"] + BENCH["workloads"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = harness.resolve(cell)
    kind = harness.kind_module(c.traffic["kind"])
    assert all(hasattr(kind, a) for a in ("FAMILY_FUNCTION", "ENTRIES", "run", "compare"))
    family = harness.family_module(c.config)
    assert c.config["entry"] in kind.ENTRIES and hasattr(family, kind.FAMILY_FUNCTION)
    assert c.limits, f"no limits/{cell}.json"
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert hasattr(harness.metric_reader(m["name"]), "read")
        assert m["moves"] in e2e


@pytest.mark.parametrize("family, config", family_configs())
def test_config_flags_agree_with_model(family, config):
    """The entry's flags and the sizes the reference reads are one
    configuration, in full and as `small` cuts it for the CPU tests."""
    fam = harness.family_module(config)
    assert fam.__name__.endswith("." + family)
    for cfg in (config, fam.small(config)):
        fam.check_flags(harness.entry_module(cfg).parse_args(cfg["flags"]), cfg)
    assert set(config["reduced"]) <= set(config)
    assert config["control"] in fam.CONTROLS


def test_an_entry_the_kind_does_not_drive_is_refused(tmp_path):
    """A configuration runs under a traffic mix only where the mix's kind
    drives the configuration's entry."""
    import copy
    import json

    bench = copy.deepcopy(BENCH)
    cell = bench["workloads"][0]
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    data = harness.load_json(os.path.join(harness.ROOT, conf["file"]))
    data["entry"] = "garf_main"
    conf["file"] = str(tmp_path / "other.json")
    (tmp_path / "other.json").write_text(json.dumps(data))
    with pytest.raises(ValueError, match="garf_main"):
        harness.resolve(cell["name"], bench)


@pytest.mark.parametrize("family, cell", train_cells())
def test_reference_leaves_are_the_programs(family, cell, tmp_path):
    """The family's weights fit the program's parameters leaf for leaf, in
    its ranges (the camera at zero, every other leaf drawn), and the seed
    fixes them."""
    import torch

    from bench_torch.kinds import train as train_kind
    from bench_torch.tests.small import context, small_cell

    c = small_cell(*cell(tmp_path))
    fam = harness.family_module(c.config)
    ctx = context(c)
    _, exp, w = train_kind.build(ctx, str(tmp_path / "out"))
    shapes = fam.param_shapes(c.config["model"], exp.dm.n_training_images)
    assert {n: tuple(p.shape) for n, p in exp.state.params.named_parameters()} == dict(shapes)
    assert all(float(v.abs().max()) == 0 for k, v in w.items() if k.startswith("camera."))
    assert all(bool(torch.isfinite(v).all()) and float(v.abs().max()) > 0
               for k, v in w.items() if not k.startswith("camera."))
    again = fam.draw_weights(shapes, ctx.seed, "cpu")
    assert all(torch.equal(again[k], w[k]) for k in shapes), "the seed does not fix the weights"


def test_north_star_macs_per_sample():
    north = harness.load_json(os.path.join(harness.ROOT, "bench_torch/configs/barf_northstar_s32.json"))
    assert ref.macs_per_sample(north["model"]) == {"radiance": 658944, "proposal": 11200}


def test_no_card_no_result():
    """Without a CUDA card the command exits non-zero and prints no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "bench_torch/run.py", "--workload", CELLS[0],
                           "--seed", str(2**31 + 11), "--seconds", "1", "--trace", "0"],
                          cwd=harness.ROOT, capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode != 0
    assert not proc.stdout.strip()


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    """A reference module imports torch, a few of the standard library's
    modules and its sibling references: nothing of the program, JAX or
    chip_smoke."""
    ref_dir = os.path.join(harness.BENCH_DIR, "reference")
    for f in os.listdir(ref_dir):
        if f.endswith(".py"):
            for mod in _imports(os.path.join(ref_dir, f)):
                assert (mod.split(".")[0] in ("torch", "math", "collections", "typing",
                                              "contextlib", "copy", "__future__")
                        or mod.startswith("bench_torch.reference")), (f, mod)


def test_harness_reaches_no_jax():
    """No module the harness imports, and none the program imports under
    it, is JAX, the JAX package or chip_smoke."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from bench_torch import harness, scene, trace, faults, calibrate, peaks, model_work\n"
        "from bench_torch.kinds import train, serve\n"
        "import bench_torch.run\n"
        "from nerf_experiments_tpu_torch.experiments import run_barf, run_3d_ingp, render_views\n"
        "harness.families()\n"
        "for m in [m['name'] for m in harness.benchmark()['per_layer']]:\n"
        "    harness.metric_reader(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'jaxlib'\n"
        "       or m == 'nerf_experiments_tpu' or m.startswith('nerf_experiments_tpu.')\n"
        "       or m == 'chip_smoke']\n"
        "print(bad); sys.exit(1 if bad else 0)\n" % harness.ROOT)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
