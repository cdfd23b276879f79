"""mfu.tokens: the whole step's share of the card's bf16 peak over the
profiled slice: the step's FLOPs counted from its shapes (``work.py``: 6 x
the matmul parameters x the tokens, plus causal attention at 3.5x its
forward) x the slice's steps, over the slice's length on the device (CUDA
events at its first step's start and its last step's end). Moves
``tokens_per_s_per_gpu``."""

from hvdbench import work


def read(t):
    if t.unit != "tokens" or not t.events or not t.slice_s:
        return None
    return 100.0 * t.work["flops"] * t.steps / t.slice_s / work.BF16_FLOPS
