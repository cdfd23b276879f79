"""adamw_roofline: kernel A1 (the AdamW update) against its roofline: the
update's required bytes (20 a parameter with bf16 moments, and 8 a
tensor for its step count, ``work.adamw_bytes``) at 3.35 TB/s over the
device time of the kernels named below. Moves
``tokens_per_s_per_gpu``."""

from hvdbench import trace, work

KERNELS = ("adamw_kernel",)


def read(t):
    us = t.device_us(trace.named(*KERNELS))
    if "adamw_bytes" not in t.work or not us:
        return None
    return 100.0 * t.work["adamw_bytes"] / work.HBM_BYTES * t.steps \
        * 1e6 / us
