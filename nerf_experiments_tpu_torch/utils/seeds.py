"""Seed mixing: the port's analog of `jax.random.fold_in`, shared by the
trainer (a generator a step) and the systems (sub-streams of a step, such as
the occupancy refresh's jitter)."""
from __future__ import annotations

_MASK63 = (1 << 63) - 1


def mix_seed(*values: int) -> int:
    """A 63-bit seed from integers (SplitMix64 over them): the port's
    `fold_in`."""
    x = 0x9E3779B97F4A7C15
    for v in values:
        x = (x ^ (int(v) & 0xFFFFFFFFFFFFFFFF)) * 0xBF58476D1CE4E5B9 & 0xFFFFFFFFFFFFFFFF
        x = (x ^ (x >> 31)) * 0x94D049BB133111EB & 0xFFFFFFFFFFFFFFFF
        x ^= x >> 29
    return x & _MASK63
