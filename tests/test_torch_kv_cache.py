"""The port's paged KV cache against the JAX package's
(``horovod_tpu_torch/serving/kv_cache.py`` vs ``horovod_tpu/serving/
kv_cache.py``).

* The refcounted ``BlockPool``: the same operation script (alloc, acquire,
  release, truncate, the refused double frees and foreign blocks) drives
  both pools; every return value, every error (type and message) and the
  allocator state after every operation (free list in order, refcounts)
  must be equal. The scripts are those of ``tests/test_serving.py``'s
  ``TestBlockPool``, ``TestBlockPoolSharing`` and ``TestBlockPoolTruncate``.
* ``quantize_kv``/``dequantize_kv``: payloads and bf16 scales bit-identical
  to JAX's for int8_block and int4, on scaled normals, exact zeros and
  values on the rounding ties; dequantized values equal.
* Pool shapes and dtypes, bytes per token, blocks per byte budget and the
  resolve errors: equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from horovod_tpu.serving import kv_cache as jkv
from horovod_tpu_torch.serving import kv_cache as tkv

from horovod_tpu.models import transformer as jt
from horovod_tpu_torch.models import transformer as tt


def _cfgs(dtype="fp32", **kw):
    base = dict(vocab_size=128, num_layers=2, num_heads=4, num_kv_heads=2,
                embed_dim=64, mlp_dim=128, max_seq_len=64)
    base.update(kw)
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return (jt.TransformerConfig(dtype=jdt, **base),
            tt.TransformerConfig(dtype=tdt, **base))


# -- BlockPool: one script, two pools ----------------------------------------

# Each op: (method, *args). ("table", i) names the i-th table returned by an
# earlier alloc (both sides hand out the same ids, so one value serves both).
SCRIPTS = {
    "alloc_free_roundtrip": (
        (9, 4), [("alloc", 3), ("alloc", 5), ("check",), ("free", 0),
                 ("check",), ("free", 1), ("alloc", 9), ("alloc", 8),
                 ("check",)]),
    "all_or_nothing": (
        (5, 4), [("alloc", 3), ("alloc", 2), ("alloc", 1), ("alloc", 0),
                 ("check",)]),
    "double_and_null_free": (
        (4, 2), [("alloc", 2), ("free", 0), ("free_ids", [1]),
                 ("free_ids", [0]), ("free_ids", [7]), ("check",)]),
    "acquire_release_refcounts": (
        (5, 4), [("alloc", 2), ("acquire", 0), ("release", 0),
                 ("release", 0), ("check",), ("acquire_ids", [1]),
                 ("acquire_ids", [0])]),
    "no_premature_reuse": (
        (3, 4), [("alloc", 2), ("acquire", 0), ("release", 0),
                 ("alloc", 1), ("release", 0), ("alloc", 2), ("check",)]),
    "truncate_tail_release": (
        (12, 4), [("alloc", 5), ("truncate", 0, 9), ("check",),
                  ("truncate", 0, 8), ("truncate", 0, 0), ("check",)]),
    "truncate_shared_tail_survives": (
        (12, 4), [("alloc", 4), ("acquire_slice", 0, 3, 4),
                  ("truncate", 0, 12), ("check",)]),
    "truncate_shared_partial_cow": (
        (12, 4), [("alloc", 3), ("acquire_slice", 0, 1, 2),
                  ("truncate", 0, 6), ("check",)]),
    "truncate_refusals": (
        (12, 4), [("alloc", 3), ("truncate", 0, 4), ("truncate_stale", 0, 4),
                  ("truncate", 0, 9), ("truncate_ids", [1, 0], 4),
                  ("truncate", 0, -1), ("check",)]),
    "truncate_cow_needs_a_free_block": (
        (3, 4), [("alloc", 2), ("acquire_slice", 0, 1, 2),
                 ("truncate", 0, 6), ("check",)]),
}


def _run(pool, ops):
    """Apply ``ops`` to ``pool``; the trace of (result, error, state)."""
    tables, trace = [], []
    for op in ops:
        name, args = op[0], op[1:]
        try:
            if name == "alloc":
                got = pool.alloc(*args)
                if got is not None:
                    tables.append(got)
                res = got
            elif name in ("free", "release", "acquire"):
                res = getattr(pool, name)(tables[args[0]])
            elif name in ("free_ids", "acquire_ids"):
                res = getattr(pool, name[:-4])(list(args[0]))
            elif name == "acquire_slice":
                res = pool.acquire(tables[args[0]][args[1]:args[2]])
            elif name == "truncate":
                res = pool.truncate(tables[args[0]], args[1])
            elif name == "truncate_stale":
                res = pool.truncate(list(tables[args[0]]) + [99], args[1])
            elif name == "truncate_ids":
                res = pool.truncate(list(args[0]), args[1])
            elif name == "check":
                res = pool.check_invariants()
            err = None
        except Exception as e:  # the refusals are part of the contract
            res, err = None, (type(e).__name__, str(e))
        trace.append((name, res, err, list(pool._free), dict(pool._refs),
                      [list(t) for t in tables], pool.num_used,
                      pool.num_shared))
    return trace


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_block_pool_script_matches_jax(script):
    (nb, bs), ops = SCRIPTS[script]
    want = _run(jkv.BlockPool(nb, bs), ops)
    got = _run(tkv.BlockPool(nb, bs), ops)
    assert got == want


def test_fragmentation_and_padded_table_match_jax():
    for mod in (jkv, tkv):
        pool = mod.BlockPool(num_blocks=64, block_size=8)
        a, b = pool.alloc(3), pool.alloc(2)
        pool.acquire(a[:2])
        tables = [a, a[:2] + b]
        lens = [23, 9 + 16]
        if mod is jkv:
            want = (pool.internal_fragmentation([1, 7, 8, 9, 23]),
                    pool.internal_fragmentation(lens, tables),
                    mod.padded_table([3, 7, 1], 5).tolist())
        else:
            got = (pool.internal_fragmentation([1, 7, 8, 9, 23]),
                   pool.internal_fragmentation(lens, tables),
                   mod.padded_table([3, 7, 1], 5).tolist())
    assert got == want
    with pytest.raises(ValueError, match="max_blocks_per_seq"):
        tkv.padded_table([1, 2, 3], 2)
    for args in ((1, 4), (4, 0)):
        with pytest.raises(ValueError) as je:
            jkv.BlockPool(*args)
        with pytest.raises(ValueError) as te:
            tkv.BlockPool(*args)
        assert str(te.value) == str(je.value)


# -- quantization: bit-identical to JAX --------------------------------------

def _kv_inputs():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((5, 7, 2, 16))
         * rng.uniform(0.01, 10, size=(5, 7, 2, 1))).astype(np.float32)
    x[0, 0] = 0.0                            # all-zero head vectors
    x[0, 1, 0] = np.float32(1e-9)            # below the scale floor
    # Rounding ties: integers and half-integers of a power-of-two unit.
    x[1, :, 0] = (np.arange(-8, 8) * 0.5).astype(np.float32)
    x[1, :, 1] = (np.arange(16) - 7.5).astype(np.float32) * 4
    return x


@pytest.mark.parametrize("kvd", ["int8_block", "int4"])
def test_quantize_kv_bit_identical_to_jax(kvd):
    x = _kv_inputs()
    jw, ju = jkv.quantize_kv(jnp.asarray(x), kvd)
    tw, tu = tkv.quantize_kv(torch.from_numpy(x), kvd)
    assert tw.dtype == torch.int8 and tu.dtype == torch.bfloat16
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    # bf16 scale bits, compared as integers
    np.testing.assert_array_equal(
        tu.view(torch.int16).numpy(),
        np.asarray(ju).view(np.int16))
    jd = jkv.dequantize_kv(jw, ju, kvd)
    td = tkv.dequantize_kv(tw, tu, kvd)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_quantize_kv_from_bf16_bit_identical_to_jax():
    x = _kv_inputs()
    xb = torch.from_numpy(x).to(torch.bfloat16)
    for kvd in ("int8_block", "int4"):
        jw, ju = jkv.quantize_kv(jnp.asarray(x).astype(jnp.bfloat16), kvd)
        tw, tu = tkv.quantize_kv(xb, kvd)
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(tu.view(torch.int16).numpy(),
                                      np.asarray(ju).view(np.int16))


def test_int4_packer_matches_jax():
    """Every nibble pair in [-7, 7]² packs and unpacks as the reference's
    ``Int4Compressor._pack``/``_unpack`` does."""
    from horovod_tpu.ops.compression import Int4Compressor

    v = np.arange(-7, 8, dtype=np.int8)
    pairs = np.stack(np.meshgrid(v, v), -1).reshape(1, -1)   # (1, 450)
    want = np.asarray(Int4Compressor._pack(jnp.asarray(pairs)))
    got = tkv.int4_pack(torch.from_numpy(pairs))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tkv.int4_unpack(got).numpy(),
        np.asarray(Int4Compressor._unpack(jnp.asarray(want))))
    assert tkv.INT4_QCAP == Int4Compressor.QCAP


# -- pool layout and accounting ----------------------------------------------

@pytest.mark.parametrize("kvd", [None, "fp32", "bf16", "int8_block", "int4"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_pools_and_bytes_match_jax(kvd, dtype):
    jcfg, tcfg = _cfgs(dtype)
    jp = jkv.make_kv_pools(jcfg, 5, 8, kvd)
    tp = tkv.make_kv_pools(tcfg, 5, 8, kvd, device="cpu")
    assert [tuple(p.shape) for p in tp] == [tuple(p.shape) for p in jp]
    names = {torch.float32: "float32", torch.bfloat16: "bfloat16",
             torch.int8: "int8"}
    assert [names[p.dtype] for p in tp] == [str(p.dtype) for p in jp]
    assert all(int(p.count_nonzero()) == 0 for p in tp)
    assert (tkv.resolve_kv_dtype(kvd, tcfg.dtype)
            == jkv.resolve_kv_dtype(kvd, jcfg.dtype))
    assert (tkv.kv_bytes_per_token(tcfg, kvd)
            == jkv.kv_bytes_per_token(jcfg, kvd))
    budget = jkv.kv_bytes_per_block(jcfg, 8, "fp32") * 9
    assert (tkv.num_blocks_for_bytes(tcfg, 8, kvd, budget)
            == jkv.num_blocks_for_bytes(jcfg, 8, kvd, budget))


def test_resolve_and_budget_errors_match_jax():
    jcfg, tcfg = _cfgs()
    cases = [(lambda m, c, dt: m.resolve_kv_dtype("int8", dt)),
             (lambda m, c, dt: m.num_blocks_for_bytes(c, 8, "fp32", 16)),
             (lambda m, c, dt: m.make_kv_pools(
                 c._replace(embed_dim=60, num_heads=4), 2, 8, "int4"))]
    for case in cases:
        with pytest.raises(Exception) as je:
            case(jkv, jcfg, jnp.float32)
        with pytest.raises(Exception) as te:
            case(tkv, tcfg, torch.float32)
        assert type(te.value).__name__ == type(je.value).__name__
        assert str(te.value) == str(je.value)
    with pytest.raises(Exception, match="has none"):
        tkv.resolve_kv_dtype("model", torch.float16)
