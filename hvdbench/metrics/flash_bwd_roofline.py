"""flash_bwd_roofline: kernel B4 (causal attention backward) against its
roofline: the step's attention-backward FLOPs (2.5x the forward's,
``work.flash_bwd_flops``) at 989 TFLOP/s over the device time of the
kernels named below. Moves ``tokens_per_s_per_gpu``."""

from hvdbench import trace, work

KERNELS = ("flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel")


def read(t):
    us = t.device_us(trace.named(*KERNELS))
    if "flash_bwd_flops" not in t.work or not us:
        return None
    return 100.0 * t.work["flash_bwd_flops"] / work.BF16_FLOPS * t.steps \
        * 1e6 / us
