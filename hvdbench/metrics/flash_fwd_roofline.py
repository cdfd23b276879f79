"""flash_fwd_roofline: kernel B3 (causal attention forward) against its
roofline: the step's attention-forward FLOPs (two products over the
visible pairs in every layer, ``work.flash_fwd_flops``) at 989 TFLOP/s
over the device time of the kernels named below. Moves
``tokens_per_s_per_gpu``."""

from hvdbench import trace, work

KERNELS = ("flash_fwd_kernel",)


def read(t):
    us = t.device_us(trace.named(*KERNELS))
    if "flash_fwd_flops" not in t.work or not us:
        return None
    return 100.0 * t.work["flash_fwd_flops"] / work.BF16_FLOPS * t.steps \
        * 1e6 / us
