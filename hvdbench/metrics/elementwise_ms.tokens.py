"""elementwise_ms.tokens: device ms a step of the elementwise and the
copy/cast kernels (``trace.category``, a copy of
``tools/profile_torch_step.py``'s table): the LM's norms, rotary,
GELU, residual adds, loss chunks and casts. Moves
``tokens_per_s_per_gpu``."""

from hvdbench import trace

KINDS = ("elementwise", "copy_and_cast")


def read(t):
    if t.unit != "tokens" or not t.events:
        return None
    return t.per_step_ms(t.device_us(lambda n: trace.category(n) in KINDS))
