"""nccl_ms.tokens: device ms a step of NCCL's collective kernels, summed
(a kernel stays resident while it waits for its peers, so this counts
waiting too). Nothing to read where no collective kernel ran (one rank).
Moves ``tokens_per_s_per_gpu``."""

from hvdbench import trace


def read(t):
    us = t.device_us(trace.is_comm)
    if t.unit != "tokens" or not us:
        return None
    return t.per_step_ms(us)
