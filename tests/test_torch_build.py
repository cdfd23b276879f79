"""The port's CUDA build (``horovod_tpu_torch/ops/_build.py``) and what its
flash-attention sources are made of, checked on this CPU-only host (no
``nvcc`` here: nothing is compiled).

* A library's path hashes its ``.cu`` source, every ``csrc`` header
  (``*.cuh``) and the flags, so an edited header is never served a stale
  library.
* The compile command targets Hopper's ``sm_90a`` (``wgmma`` and
  ``setmaxnreg`` exist only there).
* B3 and both B4 kernels are built from TMA loads behind mbarriers and
  ``wgmma``; no ``mma.sync`` kernel is left.
* B1 is one kernel launch a call, fed by 1-D bulk copies into an mbarrier
  ring and combined across blocks after an integer grid barrier of a
  cooperative launch; no BatchNorm source uses a float atomic.
"""

import pathlib
import re

import pytest

from horovod_tpu_torch.ops import _build

SOURCES = {
    "k.cu": '#include <cuda_runtime.h>\n#include "common.cuh"\nint k;\n',
    "j.cu": "int j;\n",
    "common.cuh": '#pragma once\n#include "inner.cuh"\nint c;\n',
    "inner.cuh": "#pragma once\nint i;\n",
    "other.cuh": "#pragma once\nint o;\n",
}


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    for name, text in SOURCES.items():
        (tmp_path / name).write_text(text)
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    return tmp_path


@pytest.mark.parametrize("edited",
                         ["k.cu", "common.cuh", "inner.cuh", "other.cuh"])
def test_editing_the_source_or_a_header_changes_the_path(csrc, edited):
    before = _build.library_path("k")
    (csrc / edited).write_text((csrc / edited).read_text() + "int x;\n")
    assert _build.library_path("k") != before


def test_adding_a_header_changes_the_path(csrc):
    before = _build.library_path("k")
    (csrc / "new.cuh").write_text("#pragma once\n")
    assert _build.library_path("k") != before


def test_editing_another_source_keeps_the_path(csrc):
    before = _build.library_path("k")
    (csrc / "j.cu").write_text("int changed;\n")
    assert _build.library_path("k") == before


def test_flags_change_the_path(csrc, monkeypatch):
    before = _build.library_path("k")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-g",))
    assert _build.library_path("k") != before


def test_compile_cmd_targets_sm90a(monkeypatch):
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    cmd = _build._compile_cmd("flash_fwd", "/tmp/out.so")
    i = cmd.index("arch=compute_90a,code=sm_90a")
    assert cmd[i - 1] == "-gencode"
    assert "-shared" in cmd and cmd[cmd.index("-o") + 1] == "/tmp/out.so"
    assert cmd[-1].endswith("csrc/flash_fwd.cu")


def _read(rel):
    with open(f"{_build.CSRC}/{rel}") as f:
        return f.read()


@pytest.mark.parametrize("name", ["flash_fwd", "flash_bwd"])
def test_flash_sources_share_the_common_header(name):
    includes = re.findall(r'^#include "([^"]+)"', _read(f"{name}.cu"), re.M)
    assert includes == ["flash_common.cuh"]


def _kernel_body(source, name):
    """The text of ``__global__`` kernel ``name`` up to the next top-level
    template or namespace line."""
    start = source.index(f" {name}(")
    assert "__global__" in source[source.rfind("template", 0, start):start]
    end = re.compile(r"^(template|\}  // namespace)", re.M).search(
        source, start)
    return source[start:end.start()]


@pytest.mark.parametrize("source,kernel", [
    ("flash_fwd.cu", "flash_fwd_kernel"),
    ("flash_bwd.cu", "flash_bwd_dkdv_kernel"),
    ("flash_bwd.cu", "flash_bwd_dq_kernel"),
])
def test_flash_kernels_are_tma_and_wgmma(source, kernel):
    """Each kernel loads its tiles by TMA into a ring guarded by mbarriers,
    multiplies with wgmma from shared memory and from registers, and moves
    registers between its warpgroups."""
    body = _kernel_body(_read(source), kernel)
    for call in ("::load(", "mbar_arrive_tx(", "mbar_wait(&full[",
                 "mbar_wait(&empty[", "mbar_arrive(&empty[", "::ss(",
                 "::rs(", "wgmma_commit()", "set_max_regs_dec<",
                 "set_max_regs_inc<"):
        assert call in body, (kernel, call)


def test_flash_ptx_is_hopper_ptx():
    common = _read("flash_common.cuh")
    for ptx in ("wgmma.mma_async.sync.aligned", "cp.async.bulk.tensor.4d",
                "mbarrier.try_wait.parity", "mbarrier.arrive.expect_tx",
                "setmaxnreg.inc", "setmaxnreg.dec", "wgmma.fence",
                "wgmma.wait_group"):
        assert ptx in common, ptx


def test_no_mma_sync_kernel_is_left():
    for path in pathlib.Path(_build.CSRC).iterdir():
        assert "mma.sync" not in path.read_text(), path.name


def test_b1_entry_launches_one_kernel():
    """B1's C entry dispatches to one launch of one kernel and nothing else
    (no second pass, no memset)."""
    src = _read("bn_sums.cu")
    entry = src[src.index("int hvd_channel_sums("):]
    assert entry.count("::launch(") == 6  # one per (dtype, load) instance
    assert src.count("cudaLaunchKernelEx(") == 1 and "<<<" not in src
    assert "cudaMemset" not in src and "finalize" not in entry
    assert re.findall(r"__global__\s+void\s+__launch_bounds__\([^)]*\)\s*"
                      r"(\w+)\(", src) == ["channel_sums_ring_kernel"]


@pytest.mark.parametrize("source", ["batchnorm.cu", "bn_sums.cu"])
def test_batchnorm_sources_use_no_float_atomics(source):
    """Every atomic of the BatchNorm kernels is on B1's 64-bit integer
    grid-barrier word; no float is added atomically (the sums keep one
    order, so their bits)."""
    src = _read(source)
    for op in ("atomicAdd_block", "atomicAdd_system", "red.global",
               "cp.reduce.async", "atom.global.add.f32"):
        assert op not in src, op
    assert re.findall(r"atomic\w+\(([^,]+),", src) == (
        ["bar", "bar"] if source == "bn_sums.cu" else [])
    if source == "bn_sums.cu":
        assert "unsigned long long* __restrict__ bar" in src
        assert "grid_barrier(tile_bar, gx, gen)" in src


def test_b1_kernel_is_a_bulk_copy_ring_with_a_grid_combine():
    """B1 streams whole rows by 1-D bulk copies into a ring behind full and
    empty mbarriers, writes one partial row a block, meets the grid at a
    barrier (a cooperative launch keeps every block resident) and adds the
    partial rows, each block a slice of the channels, in row order."""
    src = _read("bn_sums.cu")
    body = _kernel_body(src, "channel_sums_ring_kernel")
    for call in ("bulk_load(", "mbar_arrive_tx(&full[", "mbar_wait(&full[",
                 "mbar_wait(&empty[", "mbar_arrive(&empty[", "grid_barrier(",
                 "__ldcg(p + q * stride)"):
        assert call in body, call
    assert ("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            in src)
    assert "attr.id = cudaLaunchAttributeCooperative;" in src
    assert "attr.val.cooperative = 1;" in src
    assert '#include "flash_common.cuh"' in src
    barrier = src[src.index("void grid_barrier("):src.index("// B1. Block")]
    assert "__trap()" in barrier and "__shfl_xor_sync(" in body
