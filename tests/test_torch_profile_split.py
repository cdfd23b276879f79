"""The step profiler's split of the device time by region of the step and of
the elementwise and copy/cast kernels op by op
(``tools/profile_torch_step.py::op_times``), on synthetic profiler events:
a kernel counts under the CPU op whose ``kernels`` hold it, in that op's
region — ``optimizer`` under the ``Optimizer.step`` range, ``backward``
under the autograd engine, else ``rest`` — and the port's AdamW kernel
A1 is a category of its own.
"""

import importlib.util
import pathlib
from types import SimpleNamespace

import pytest
import torch

PATH = pathlib.Path(__file__).resolve().parents[1] / "tools" / \
    "profile_torch_step.py"
CPU = torch.autograd.DeviceType.CPU


@pytest.fixture(scope="module")
def tool():
    spec = importlib.util.spec_from_file_location("profile_torch_step", PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _op(name, parent=None, kernels=()):
    return SimpleNamespace(
        name=name, cpu_parent=parent, device_type=CPU,
        is_user_annotation=False,
        kernels=[SimpleNamespace(name=k, device=0, duration=us)
                 for k, us in kernels])


def test_kernels_split_by_region_and_op(tool):
    step = _op("Optimizer.step#AdamW.step",
               kernels=[("void (anonymous namespace)::adamw_kernel(...)",
                         1000.0)])
    opt_mul = _op("aten::mul", step,
                  [("vectorized_elementwise_kernel<4, MulFunctor>", 30.0)])
    engine = _op("autograd::engine::evaluate_function: MulBackward0")
    bwd_mul = _op("aten::mul", _op("MulBackward0", engine),
                  [("vectorized_elementwise_kernel<4, MulFunctor>", 7.0),
                   ("vectorized_elementwise_kernel<4, MulFunctor>", 5.0)])
    fwd_cast = _op("aten::_to_copy", _op("aten::to"),
                   [("unrolled_elementwise_kernel<copy_>", 11.0)])
    fwd_mm = _op("aten::mm", None, [("nvjet_tst_128x256", 200.0)])
    annotation = SimpleNamespace(name="ProfilerStep", cpu_parent=None,
                                 device_type=CPU, is_user_annotation=True,
                                 kernels=[SimpleNamespace(
                                     name="elementwise", device=0,
                                     duration=99.0)])
    events = [step, opt_mul, engine, bwd_mul, fwd_cast, fwd_mm, annotation]
    regions, ops = tool.op_times(events)
    assert regions == {"optimizer": 1030.0, "backward": 12.0,
                       "rest": 211.0}
    assert ops == {"optimizer/aten::mul": [30.0, 1],
                   "backward/aten::mul": [12.0, 2],
                   "rest/aten::_to_copy": [11.0, 1]}


def test_a1_is_a_category_of_its_own(tool):
    assert tool._category(
        "void (anonymous namespace)::adamw_kernel((anonymous namespace)::Rec "
        "const*, int*, int, long long, (anonymous namespace)::Hyper)"
    ) == "adamw"
