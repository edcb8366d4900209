"""Explicit random streams.

A phase's draws come from a per-iteration generator seeded by
`fold_in(seed, i)`, so iteration i of a phase draws the same numbers
whether the phase runs in one call or is continued across several (the
role `jax.random.fold_in(key, iter0 + i)` plays in the JAX package).
"""

from __future__ import annotations

import torch

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def fold_in(seed: int, data: int) -> int:
    """A new 63-bit seed from (seed, data)."""
    return _splitmix64(_splitmix64(seed & _MASK64) ^ (data & _MASK64)) >> 1


def generator(seed: int, device="cpu") -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


class SeedStream:
    """Host-side source of fresh seeds (the driver's `_next_key`)."""

    def __init__(self, seed: int):
        self._seed = seed
        self._n = 0

    def next(self) -> int:
        self._n += 1
        return fold_in(self._seed, self._n)
