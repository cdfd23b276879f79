"""Weights from the seed, made on the device in a few large calls.

A family's reference module gives each tensor of the state dict as
``(name, shape, kind, arg)`` (``init_spec``); :func:`make` draws every
``lecun`` tensor from one truncated normal, every ``normal`` tensor from
one normal and every ``uniform`` one from one uniform, all from one
generator on the device seeded with the seed, and fills the constants.
Both the program and the reference load these tensors.
"""

from __future__ import annotations

import math

import torch

_TRUNC_STD = .87962566103423978  # std of N(0, 1) truncated at +-2


def make(spec, seed: int, device) -> dict[str, torch.Tensor]:
    """Float32 tensors by name, the same for the same ``seed`` on every
    device of one kind."""
    g = torch.Generator(device=device).manual_seed(seed)
    out: dict[str, torch.Tensor] = {}
    for kind in ("lecun", "normal", "uniform"):
        rows = [r for r in spec if r[2] == kind]
        total = sum(math.prod(r[1]) for r in rows)
        if not total:
            continue
        flat = torch.empty(total, dtype=torch.float32, device=device)
        if kind == "lecun":
            torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0,
                                        generator=g)
        elif kind == "normal":
            flat.normal_(generator=g)
        else:
            flat.uniform_(generator=g)
        at = 0
        for name, shape, _, arg in rows:
            n = math.prod(shape)
            t = flat[at:at + n].view(shape)
            at += n
            if kind == "lecun":
                t = t * (math.sqrt(1.0 / arg) / _TRUNC_STD)
            elif kind == "normal":
                t = t * arg
            else:
                t = arg[0] + (arg[1] - arg[0]) * t
            out[name] = t
    for name, shape, kind, arg in spec:
        if kind == "const":
            out[name] = torch.full(shape, float(arg), dtype=torch.float32,
                                   device=device)
    return {name: out[name] for name, *_ in spec}
