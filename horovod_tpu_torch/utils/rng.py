"""Counter-based random streams: splitmix64 over int64 tensors.

Two's-complement wrap-around; ``>>`` on int64 is arithmetic, so logical
shifts mask. Every stream of the port that the reference draws from
``jax.random`` (the sampler, MNIST's dropout, the wire compressors'
stochastic rounding) hashes its counters through :func:`splitmix64` on the
tensor's own device, so it needs no host synchronisation and can be
captured in a CUDA graph; the bits are the same on every device.
"""

from __future__ import annotations

import torch


def i64(c: int) -> int:
    """An unsigned 64-bit constant as the int64 with the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


GOLDEN = i64(0x9E3779B97F4A7C15)
MIX1 = i64(0xBF58476D1CE4E5B9)
MIX2 = i64(0x94D049BB133111EB)


def srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 ``x`` by ``s`` bits."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    """The splitmix64 finalizer of ``x + golden``, elementwise."""
    z = x + GOLDEN
    z = (z ^ srl(z, 30)) * MIX1
    z = (z ^ srl(z, 27)) * MIX2
    return z ^ srl(z, 31)
