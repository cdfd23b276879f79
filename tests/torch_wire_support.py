"""Shared by the wire-compression parity tests (``test_torch_compression.py``,
``test_torch_strategy.py``): the same rounding noise fed to both packages.

The reference draws its stochastic-rounding noise from ``jax.random`` and
the port from its own splitmix64 stream (``ops/compression.py::_uniform``),
so a bit-for-bit comparison feeds both the same array instead: numpy noise
keyed by (call index within the step, rank, shape). On the JAX side a
shim replaces ``horovod_tpu.ops.compression``'s module-level ``jax`` for
the duration of a ``with`` block, its ``random.uniform`` returning the
table row of the calling rank (``lax.axis_index`` inside ``hvd.spmd``,
rank 0 outside); nothing in the JAX package changes. On the port side
:class:`PortNoise` replaces ``_uniform`` in the rank's process. Both
sides count calls from the start of each step function (``reset``).

Kept free of JAX imports at the top: the spawned ranks import it.
"""

from __future__ import annotations

import contextlib
import types

import numpy as np

WORLD = 4


def fed_noise(call: int, rank: int, shape) -> np.ndarray:
    """The noise of call ``call`` on rank ``rank``: uniform [0, 1) fp32."""
    rs = np.random.RandomState(7919 * call + 104729 * rank + 17)
    return rs.random_sample(tuple(shape)).astype(np.float32)


class PortNoise:
    """A stand-in for the port's ``compression._uniform`` on one rank."""

    def __init__(self, rank: int) -> None:
        self.rank = rank
        self.calls = 0

    def reset(self) -> None:
        self.calls = 0

    def __call__(self, x, ctx):
        import torch

        call = self.calls
        self.calls += 1
        return torch.from_numpy(fed_noise(call, self.rank, x.shape)).to(
            x.device)


def install_port_noise(rank: int) -> PortNoise:
    from horovod_tpu_torch.ops import compression as tcomp

    fed = PortNoise(rank)
    tcomp._uniform = fed
    return fed


class JaxNoise:
    """The JAX side's call counter (``reset`` at the start of a step)."""

    def __init__(self, traced: bool) -> None:
        self.traced = traced
        self.calls = 0

    def reset(self) -> None:
        self.calls = 0


@contextlib.contextmanager
def jax_noise(traced: bool = True):
    """Within the block, ``horovod_tpu.ops.compression`` draws its noise
    from :func:`fed_noise`; yields the counter."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from horovod_tpu.core.state import AXIS_NAME
    from horovod_tpu.ops import compression as jcomp

    fed = JaxNoise(traced)

    def uniform(key, shape, dtype=jnp.float32):
        call = fed.calls
        fed.calls += 1
        if not fed.traced:
            return jnp.asarray(fed_noise(call, 0, shape))
        table = np.stack([fed_noise(call, r, shape) for r in range(WORLD)])
        return jnp.asarray(table)[lax.axis_index(AXIS_NAME)]

    shim = types.SimpleNamespace(
        random=types.SimpleNamespace(uniform=uniform,
                                     fold_in=jax.random.fold_in,
                                     PRNGKey=jax.random.PRNGKey))
    real = jcomp.jax
    jcomp.jax = shim
    try:
        yield fed
    finally:
        jcomp.jax = real
