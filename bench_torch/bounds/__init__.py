"""One module a kernel: `work(rays, samples, macs) -> (flops, bytes)`, the
operations and the bytes its launches need over `rays` rays of `samples`
samples through a net of `macs` multiply-adds a sample. Both are linear in
the rays, so the work of many launches is the work of their rays together."""
