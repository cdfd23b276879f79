"""The step profiler (``tools/profile_torch_step.py``): its device-time sums.

A GPU user annotation (the range ``torch.optim`` opens around
``Optimizer.step``) carries the device time of the kernels inside it; the
sums leave it out, or those kernels count twice and the device's busy share
exceeds 1. cuBLAS's Hopper GEMMs (``nvjet_*``) are matrix products.
"""

import importlib.util
import pathlib
from types import SimpleNamespace

import pytest
import torch

PATH = pathlib.Path(__file__).resolve().parents[1] / "tools" / \
    "profile_torch_step.py"


@pytest.fixture(scope="module")
def tool():
    spec = importlib.util.spec_from_file_location("profile_torch_step", PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _event(name, us, device=True, annotation=False):
    return SimpleNamespace(
        name=name, self_device_time_total=us, is_user_annotation=annotation,
        device_type=(torch.autograd.DeviceType.CUDA if device
                     else torch.autograd.DeviceType.CPU))


def test_user_annotations_and_host_events_are_left_out(tool):
    events = [_event("flash_fwd_kernel<128>", 5.0),
              _event("flash_fwd_kernel<128>", 7.0),
              _event("Optimizer.step#AdamW.step", 100.0, annotation=True),
              _event("aten::mm", 50.0, device=False),
              _event("idle", 0.0)]
    assert tool.kernel_times(events) == {"flash_fwd_kernel<128>": [12.0, 2]}


@pytest.mark.parametrize("name,category", [
    ("void (anonymous namespace)::flash_bwd_dq_kernel<128, bf16>",
     "flash_attention"),
    ("void (anonymous namespace)::channel_sums_kernel<bf16, 8>",
     "bn_channel_sums"),
    ("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT", "conv_and_matmul"),
    ("sm90_xmma_fprop_implicit_gemm_bf16", "conv_and_matmul"),
    ("void at::native::vectorized_elementwise_kernel<4>", "elementwise"),
])
def test_categories(tool, name, category):
    assert tool._category(name) == category
