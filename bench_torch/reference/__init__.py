"""Plain PyTorch references, one module a family of configurations; they
import nothing of the program under test (`common.py` holds what families
share).

A family module declares `ENTRIES`, the program's entries
(`experiments/<entry>.py`) whose configurations it models; one family
models an entry. The harness finds it by the configuration's `entry`
(`harness.family_module`), and a kind of traffic drives an entry exactly
when its family has the kind's function (`kinds/<kind>.py`,
`FAMILY_FUNCTION`) and meets what else the kind states (`serve`: the
family's `SERVED_THROUGH`). A family has:

* `CONTROLS`: the precisions below the configuration's that its reference
  can compute in, for the control (`config["control"]`);
* `param_shapes(model, n_images)`: every leaf's name, as the program's
  parameters name it, and shape;
* `draw_weights(shapes, seed, device)`: every leaf from the run's seed, on
  the device;
* `BATCH_KEYS` and `step_draws(model, batch, generator)`: what a check step
  records of its batch, and what the step draws from its generator, given a
  generator at the step's starting state;
* `train_steps(weights, model, batches, start_count, precision)`: the
  reference's steps, for the `train` kind;
* `render_view(weights, model, origs, dirs, gauge, chunk, precision)` and
  `SERVED_THROUGH = "render_views"`: a served view, and the statement that
  the program serves the entries' views through `render_views` from the
  BARF system's parameters, for the `serve` kind;
* `macs_per_ray(model)`: the multiply-adds of one ray, for the MFU readers;
* `check_flags(args, config)`: ValueError where the entry's flags and the
  sizes the reference reads disagree;
* `small(config)`: the configuration cut to a size the CPU runs in seconds,
  for the harness's tests.
"""
