"""One module a kind of traffic (`"kind"` in `traffic/<mix>.json`):
`run(ctx)` and `compare(ctx, check, control=None)`, as `harness.py` says."""
