"""Port parity: the tensor-fusion bucket plan of ``horovod_tpu_torch`` must
equal ``horovod_tpu``'s exactly (indices, dtypes, bytes), and packing
through the flat buffer must round-trip every tensor."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import fusion as jfusion
from horovod_tpu_torch.ops import exchange as texchange
from horovod_tpu_torch.ops import fusion as tfusion

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16),
          (jnp.int32, torch.int32), (jnp.float16, torch.float16)]
MB = 1024 * 1024


def _leaves(seed, n, big):
    """Random leaf list: shapes up to ~16M elements when ``big`` (so the
    64 MB threshold splits), mixed dtypes with runs of equal dtype."""
    rng = np.random.RandomState(seed)
    jl, tl = [], []
    k = 0
    for _ in range(n):
        if rng.rand() < 0.3:
            k = rng.randint(len(DTYPES))
        jd, td = DTYPES[k]
        ndim = rng.randint(1, 4)
        top = 256 if big else 16
        shape = tuple(int(s) for s in rng.randint(1, top, size=ndim))
        jl.append(jax.ShapeDtypeStruct(shape, jd))
        tl.append(torch.empty(shape, dtype=td, device="meta"))
    return jl, tl


@pytest.mark.parametrize("threshold", [0, 1, 4096, 64 * MB])
@pytest.mark.parametrize("seed", range(4))
def test_plan_matches_jax(seed, threshold):
    jl, tl = _leaves(seed, n=40, big=threshold == 64 * MB)
    want = jfusion.plan_buckets_py(jl, threshold)
    got = tfusion.plan_buckets_py(tl, threshold)
    assert [b.indices for b in got] == [b.indices for b in want]
    assert [str(b.dtype).removeprefix("torch.") for b in got] == \
        [np.dtype(b.dtype).name for b in want]
    assert [b.total_bytes for b in got] == [b.total_bytes for b in want]
    if threshold == 0:
        assert all(len(b.indices) == 1 for b in got)


def test_fused_apply_round_trips_in_place():
    """Each bucket is packed, passed once to the collective and unpacked
    into the original tensors, strided (channels_last) ones included."""
    g = torch.Generator().manual_seed(0)
    leaves = [torch.randn(3, 4, generator=g),
              torch.randn(2, 3, 5, 5, generator=g).to(
                  memory_format=torch.channels_last),
              torch.randn(7, generator=g).to(torch.bfloat16),
              torch.randn(6, generator=g)]
    before = [t.clone() for t in leaves]
    plan = texchange.plan_exchange(leaves, 1024, mode="enum")
    buckets = plan.buckets
    assert list(buckets) == tfusion.plan_buckets(leaves, 1024)
    calls = []

    def collective(flat, b):
        calls.append((b, flat.numel()))
        return flat * 2

    tfusion.fused_apply_(leaves, plan, collective,
                         [f"b{i}" for i in range(len(buckets))])
    assert [n for _, n in calls] == [b.elems for b in buckets]
    assert len(calls) == len(buckets) == 3
    for t, t0 in zip(leaves, before):
        torch.testing.assert_close(t, t0 * 2, rtol=0, atol=0)
    assert leaves[1].is_contiguous(memory_format=torch.channels_last)
