"""The control's lower precision: operands rounded to a narrower type before
each product, the products and everything else in float32.

The configurations compute in bfloat16, so the control rounds to fp8
(e4m3, each tensor scaled so that its largest magnitude maps to the
type's largest finite value, 448), the step below. The rounding is a
straight-through function: the backward pass takes the gradient as if the
operand had not been rounded, so only the forward operands (and what the
backward reads of them) carry the lower precision.
"""

from __future__ import annotations

import torch

FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        scale = FP8_MAX / x.detach().abs().amax().clamp_min(1e-30)
        return (x * scale).to(FP8).to(x.dtype) / scale

    @staticmethod
    def backward(ctx, g):
        return g


def cast(x):
    """The rounding a reference model applies to each product's operands
    in the control: to fp8 e4m3, straight through in backward."""
    return _Round.apply(x)
