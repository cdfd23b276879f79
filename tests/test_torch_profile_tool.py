"""The step profiler (``tools/profile_torch_step.py``): its device-time sums.

A GPU user annotation (the range ``torch.optim`` opens around
``Optimizer.step``) carries the device time of the kernels inside it; the
sums leave it out, or those kernels count twice and the device's busy share
exceeds 1. cuBLAS's Hopper GEMMs (``nvjet_*``) are matrix products.
"""

import importlib.util
import pathlib
import re
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
    ("void (anonymous namespace)::flash_fwd_kernel<128, __nv_bfloat16>("
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "(anonymous namespace)::FwdArgs)", "flash_attention"),
    ("void (anonymous namespace)::flash_bwd_dkdv_kernel<128, float>("
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "(anonymous namespace)::BwdArgs)", "flash_attention"),
    ("void (anonymous namespace)::channel_sums_kernel<bf16, 8>",
     "bn_channel_sums"),
    ("void (anonymous namespace)::channel_sums_ring_kernel<__nv_bfloat16, "
     "8, true>(__nv_bfloat16 const*, float*, unsigned long long*, long long, "
     "int, int, int)", "bn_channel_sums"),
    ("void (anonymous namespace)::channel_sums_ring_kernel<float, 1, false>",
     "bn_channel_sums"),
    ("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT", "conv_and_matmul"),
    ("sm90_xmma_fprop_implicit_gemm_bf16", "conv_and_matmul"),
    ("void at::native::vectorized_elementwise_kernel<4>", "elementwise"),
])
def test_categories(tool, name, category):
    assert tool._category(name) == category


CSRC = pathlib.Path(__file__).resolve().parents[1] / "horovod_tpu_torch" / \
    "csrc"


@pytest.mark.parametrize("source", sorted(p.name for p in CSRC.glob("*.cu")))
def test_every_port_kernel_has_its_category(tool, source):
    """Each ``__global__`` kernel of the port's sources falls in one of the
    tool's own categories, whatever its template arguments."""
    text = (CSRC / source).read_text()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                       r"\s*)?(\w+)\s*\(", text)
    assert len(names) == text.count("__global__"), (source, names)
    own = {cat for cat, _ in tool._OWN}
    for name in names:
        assert tool._category(f"void (anonymous namespace)::{name}<128, "
                              f"float>(int)") in own, name
