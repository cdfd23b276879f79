"""The serving engine's prefill/decode split over two subset groups
(``horovod_tpu_torch/serving/engine.py``) against the JAX package's split
engine, ``transformer.generate`` and the port's unsplit engine, on the CPU.

* A lone ``prefill_group`` or ``decode_group`` raises the reference's
  ``ValueError`` text byte for byte.
* One spawned 2-rank gloo world (``hvd.init([[0], [1]])``: group 1 leads at
  rank 0, group 2 at rank 1) runs ``tools/serve_bench_torch.py::
  split_rank`` over the cases below, each rank building
  ``Engine(prefill_group=1, decode_group=2)``: rank 0 is the prefill rank
  and answers admissions in ``serve_prefill()``, rank 1 the decode rank.
  Its greedy tokens equal, bit for bit:
  - ``transformer.generate`` and the JAX package's split engine under
    ``hvd.init([[0, 1, 2, 3], [4, 5, 6, 7]])``, ``prefill_group=1,
    decode_group=2`` (``tests/test_serving.py``'s test, built here);
  - the port's unsplit engine on the same inputs, with a shared prefix
    (prefix hits), a pool small enough to preempt and recompute, an
    ``int8_block`` pool, ``speculate=2`` (the draft's prefill stays on the
    decode rank) and a journaled run whose decode-side engine is abandoned
    mid-batch and a new engine pair ``recover()``s it.
* Each rank captures its own forwards (prefill rank: ``prefill`` and
  ``first``; decode rank: ``decode``), one admission records the same
  ``collective-permute`` rows on both ranks, a page the prefill rank lacks
  is shipped (and one left unshipped changes the tokens), a rank that
  leads both groups serves unsplit and moves nothing, an idle rank and the
  prefill rank refuse ``submit``, and the split's two halves in one
  process (``loopback_split``, what ``chip_smoke.py`` phase 25 (c) runs on
  one card) equal the two-rank split.

The LM is ``tools/serve_bench_torch.py``'s smoke config in fp32, its
weights a numpy-seeded flax tree carried across with ``from_flax_params``.
"""

import numpy as np
import pytest
import torch

from horovod_tpu_torch import serving
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.serving import engine as tengine
from horovod_tpu_torch.serving import kv_cache as tkv

from tools import serve_bench_torch as sbt
from torch_lm_support import numpy_params

BASE = dict(block_size=8, max_batch=2, max_prompt_len=40)


def _tokens(n, seed, vocab=512):
    return np.random.RandomState(seed).randint(0, vocab, n).astype(
        np.int32).tolist()


SHARED = _tokens(16, 99)
PROMPTS = [_tokens(5, 1), _tokens(5, 2)]  # one shape: one JAX compile
PREFIXED = [SHARED + _tokens(n, 10 + n) for n in (3, 7, 5, 9)]

# name -> case (``tools/serve_bench_torch.py``'s case format).
CASES = {
    "base": dict(engine=dict(block_size=8, max_batch=2, max_prompt_len=16),
                 prompts=PROMPTS, max_new=8, record=True),
    "shared_prefix": dict(engine=dict(BASE, prefix_cache=True),
                          prompts=PREFIXED, batches=2, max_new=10),
    "preempt": dict(engine=dict(BASE, num_blocks=8), prompts=PREFIXED,
                    max_new=10),
    "int8_block": dict(engine=dict(BASE, prefix_cache=True,
                                   kv_dtype="int8_block"),
                       prompts=PREFIXED, batches=2, max_new=10),
    "speculate": dict(engine=dict(BASE, speculate=2), prompts=PREFIXED,
                      max_new=10),
    "recover": dict(engine=BASE, prompts=PREFIXED, max_new=10, interrupt=3),
    "ship": dict(engine=dict(BASE, prefix_cache=True), prompts=PREFIXED,
                 batches=2, max_new=10, forget=True),
    "same_lead": dict(engine=dict(block_size=8, max_batch=2,
                                  max_prompt_len=16),
                      prompts=PROMPTS, max_new=8, record=True,
                      groups=(0, 1)),
}
UNSPLIT_CASES = ("shared_prefix", "preempt", "int8_block", "speculate",
                 "recover")


@pytest.fixture(scope="module")
def lm():
    """(JAX config, flax params, port config, port model on the CPU)."""
    from tools import serve_bench as jsb

    jcfg = jsb.tiny_config()
    params = numpy_params(jcfg)
    tcfg = sbt.tiny_config()
    model = tt.Transformer(tcfg)
    model.load_state_dict(tt.from_flax_params(params))
    return jcfg, params, tcfg, model


@pytest.fixture(scope="module")
def world(lm, tmp_path_factory):
    from horovod_tpu_torch.run import run

    _, _, tcfg, model = lm
    cases = [dict(case, name=name) for name, case in CASES.items()]
    workdir = str(tmp_path_factory.mktemp("split"))
    return run(sbt.split_rank, 2, device="cpu",
               args=(tcfg, model.state_dict(), cases, workdir, "cpu"),
               timeout=240)


@pytest.fixture(scope="module")
def unsplit(lm, tmp_path_factory):
    _, _, tcfg, model = lm
    workdir = str(tmp_path_factory.mktemp("unsplit"))
    return {name: sbt.unsplit_case(tcfg, model, dict(case, name=name),
                                   workdir, "cpu")
            for name, case in CASES.items() if name != "same_lead"}


def _sequences(case, outputs):
    """Each request's prompt + output, in submit order (request ids count
    from 0 in submit order)."""
    return [np.asarray(p + outputs[i], np.int32)
            for i, p in enumerate(case["prompts"])]


# -- the texts -----------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(prefill_group=1),
                                dict(decode_group=2)],
                         ids=["prefill_group", "decode_group"])
def test_a_lone_group_raises_the_references_text(lm, kw):
    from horovod_tpu import serving as jserving

    jcfg, params, tcfg, model = lm
    with pytest.raises(ValueError) as want:
        jserving.Engine(jcfg, params, **kw)
    with pytest.raises(ValueError) as got:
        serving.Engine(tcfg, model, device="cpu", **kw)
    assert str(got.value) == str(want.value)
    assert "together" in str(got.value)


def test_no_serving_text_cites_an_unported_item():
    import inspect

    for mod in (tengine, serving):
        src = inspect.getsource(mod)
        assert "NotImplementedError" not in src
        assert "item 14" not in src


# -- the two-rank world ------------------------------------------------------------


def test_the_ranks_take_their_roles(world):
    pre, dec = world[0]["base"], world[1]["base"]
    assert (pre["role"], dec["role"]) == ("prefill", "decode")
    for r in (pre, dec):
        assert (r["prefill_rank"], r["decode_rank"]) == (0, 1)
    # The counterpart of the reference's prefill device != decode device.
    assert pre["prefill_rank"] != pre["decode_rank"]
    assert pre["served"] == dec["split"]["admissions"] == 1
    assert "decode rank (1)" in pre["refusal"]
    assert "serve_prefill" in pre["refusal"]


def test_the_split_equals_generate_and_the_jax_split_engine(lm, world,
                                                             unsplit):
    import horovod_tpu as jhvd
    import jax
    import jax.numpy as jnp
    from horovod_tpu import serving as jserving
    from horovod_tpu.models import transformer as jt

    jcfg, params, _, _ = lm
    case = CASES["base"]
    jparams = jax.tree.map(jnp.asarray, params)
    want = [np.asarray(jt.generate(jcfg, jparams, jnp.asarray(
        np.asarray(p, np.int32)[None]), max_new_tokens=case["max_new"]))[0]
        for p in case["prompts"]]
    jhvd.shutdown()
    jhvd.init([[0, 1, 2, 3], [4, 5, 6, 7]])
    try:
        eng = jserving.Engine(jcfg, jparams, prefill_group=1,
                              decode_group=2, **case["engine"])
        assert eng._prefill_device != eng._decode_device
        jsplit = eng.generate_batch(
            [np.asarray(p, np.int32) for p in case["prompts"]],
            case["max_new"])
    finally:
        jhvd.shutdown()
    got = _sequences(case, world[1]["base"]["outputs"])
    ref = _sequences(case, unsplit["base"]["outputs"])
    for g, w, j, r in zip(got, want, jsplit, ref):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, np.asarray(j))
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("name", UNSPLIT_CASES)
def test_the_split_equals_the_unsplit_engine(world, unsplit, name):
    dec, ref = world[1][name], unsplit[name]
    assert dec["role"] == "decode" and ref["role"] == "serve"
    assert len(dec["outputs"]) == len(CASES[name]["prompts"])
    assert dec["outputs"] == ref["outputs"]
    stats = dec["stats"]
    if name in ("shared_prefix", "int8_block"):
        assert stats["prefix_hit_tokens"] > 0
        assert stats["prefix_hit_tokens"] == ref["stats"]["prefix_hit_tokens"]
    if name == "preempt":
        assert stats["preemptions"] > 0
        assert stats["preemptions"] == ref["stats"]["preemptions"]
    if name == "speculate":
        # The draft's prefill stays on the decode rank.
        assert dec["captures"] == {} and dec["decode_traces"] == 0
        assert world[0][name]["prefill_traces"] == 1
    if name == "recover":
        assert dec["recovered"] >= 1
        assert dec["recovered"] == ref["recovered"]
        assert world[0][name]["served"] >= 2  # both sessions answered


def test_each_rank_captures_its_own_forwards(world, unsplit):
    pre, dec = world[0]["base"], world[1]["base"]
    assert (pre["prefill_traces"], pre["decode_traces"]) == (1, 0)
    assert (dec["prefill_traces"], dec["decode_traces"]) == (0, 1)
    ref = unsplit["base"]
    assert (ref["prefill_traces"], ref["decode_traces"]) == (1, 1)


def test_one_admission_records_the_same_rows_on_both_ranks(world):
    pre, dec = world[0]["base"], world[1]["base"]
    assert pre["rows"] == dec["rows"]
    mb, bps, pmax = 2, 8, 16  # slots, blocks a sequence, prompt bound
    meta = mb * bps + 4 * mb + mb * pmax + dec["split"]["pages_written"]
    page = tkv.page_bytes(tkv.make_kv_pools(
        sbt.tiny_config(), 2, 8, "fp32", device="cpu"))
    assert dec["rows"] == [
        ("collective-permute", "s64", [8]),         # the header
        ("collective-permute", "s64", [meta]),      # segments and block ids
        ("collective-permute", "u8",                # first tokens, pages
         [mb * 8 + dec["split"]["pages_written"] * page]),
        ("collective-permute", "s64", [8])]         # the close
    assert dec["split"]["pages_shipped"] == 0
    assert dec["split"]["bytes_received"] == dec["rows"][2][2][0]


def test_a_page_the_prefill_rank_lacks_is_shipped(world, unsplit):
    dec = world[1]["ship"]
    assert dec["split"]["pages_shipped"] > 0
    assert world[0]["ship"]["split"]["pages_shipped"] \
        == dec["split"]["pages_shipped"]
    assert dec["outputs"] == unsplit["shared_prefix"]["outputs"]
    # Without forgetting, the prefill rank holds every shared page.
    assert world[1]["shared_prefix"]["split"]["pages_shipped"] == 0


def test_one_rank_leading_both_groups_serves_unsplit(world, unsplit):
    lead, other = world[0]["same_lead"], world[1]["same_lead"]
    assert lead["role"] == "serve" and other["role"] == "idle"
    assert lead["prefill_rank"] == lead["decode_rank"] == 0
    assert lead["rows"] == [] and lead["split"]["admissions"] == 0
    assert lead["outputs"] == unsplit["base"]["outputs"]
    assert "leads neither" in other["refusal"]


# -- the two halves in one process --------------------------------------------------


def _halves(tcfg, model, engine_kw, speculate=0):
    kw = dict(engine_kw, device="cpu")
    prefill = serving.Engine(tcfg, model, **kw)
    decode = serving.Engine(tcfg, model, speculate=speculate, **kw)
    tengine.loopback_split(prefill, decode)
    return prefill, decode


def test_the_loopback_halves_equal_the_two_rank_split(lm, world):
    _, _, tcfg, model = lm
    case = CASES["ship"]
    prefill, decode = _halves(tcfg, model, case["engine"])
    outputs = {}
    for batch in (case["prompts"][:2], case["prompts"][2:]):
        if outputs:
            decode._remote_valid.clear()
        for p in batch:
            decode.submit(np.asarray(p, np.int32), case["max_new"])
        for done in decode.run_until_idle():
            outputs[done.request_id] = list(done.output)
    assert outputs == world[1]["ship"]["outputs"]
    assert decode.split_stats == world[1]["ship"]["split"]
    assert prefill.split_stats == world[0]["ship"]["split"]
    assert (prefill.prefill_trace_count, prefill.decode_trace_count,
            decode.prefill_trace_count, decode.decode_trace_count) \
        == (1, 0, 0, 1)


def _wiped_between_rounds(lm, claim_held: bool):
    """The shared-prefix case on the two halves, the prefill engine's pool
    zeroed between its two rounds (a copy that lost every page); the
    decode engine then knows it (``claim_held`` False: it ships the shared
    pages) or claims every page is still held (the planted fault)."""
    _, _, tcfg, model = lm
    case = CASES["shared_prefix"]
    prefill, decode = _halves(tcfg, model, case["engine"])
    outputs = {}
    for batch in (case["prompts"][:2], case["prompts"][2:]):
        if outputs:
            for pool in prefill._pools:
                pool.zero_()
            decode._remote_valid = (set(range(decode.pool.num_blocks))
                                    if claim_held else set())
        for p in batch:
            decode.submit(np.asarray(p, np.int32), case["max_new"])
        for done in decode.run_until_idle():
            outputs[done.request_id] = list(done.output)
    return outputs, decode.split_stats


def test_shipped_pages_restore_a_copy_that_lost_them(lm, unsplit):
    outputs, stats = _wiped_between_rounds(lm, claim_held=False)
    assert stats["pages_shipped"] > 0
    assert outputs == unsplit["shared_prefix"]["outputs"]


def test_a_stale_page_left_unshipped_changes_the_tokens(lm, unsplit):
    """The planted fault the split's page tracking exists for."""
    outputs, stats = _wiped_between_rounds(lm, claim_held=True)
    assert stats["pages_shipped"] == 0
    assert outputs != unsplit["shared_prefix"]["outputs"]


def test_loopback_refuses_engines_of_other_shapes(lm):
    _, _, tcfg, model = lm
    a = serving.Engine(tcfg, model, device="cpu", **BASE)
    b = serving.Engine(tcfg, model, device="cpu",
                       **dict(BASE, block_size=16))
    with pytest.raises(ValueError, match="block_size"):
        tengine.loopback_split(a, b)


@pytest.mark.parametrize("kv_dtype", tkv.KV_DTYPES)
def test_pages_pack_and_unpack_bit_for_bit(lm, kv_dtype):
    tcfg = lm[2]
    gen = torch.Generator().manual_seed(0)
    src = tkv.make_kv_pools(tcfg, 6, 8, kv_dtype, device="cpu")
    for p in src:
        if p.dtype.is_floating_point:
            p.copy_(torch.randn(p.shape, generator=gen))
        else:
            p.copy_(torch.randint(-128, 128, p.shape, generator=gen))
    dst = tkv.make_kv_pools(tcfg, 6, 8, kv_dtype, device="cpu")
    ids = torch.tensor([4, 1, 3])
    buf = tkv.pack_pages(src, ids)
    assert buf.dtype == torch.uint8
    assert buf.numel() == 3 * tkv.page_bytes(src) \
        == 3 * tkv.kv_bytes_per_block(tcfg, 8, kv_dtype)
    tkv.unpack_pages(dst, ids, buf)
    for s, d in zip(src, dst):
        assert torch.equal(s[:, ids].view(torch.uint8),
                           d[:, ids].view(torch.uint8))
        assert not d[:, [0, 2, 5]].any()


def test_a_page_the_decode_rank_writes_is_no_longer_held(lm):
    """The prefill rank's copy holds what it wrote; the decode step's
    write at position 13 (block 1 of a 13-token prompt, block size 8)
    makes that page stale there, and block 0 stays held."""
    _, _, tcfg, model = lm
    _, decode = _halves(tcfg, model, BASE)
    req = decode.submit(np.asarray(PREFIXED[0][:13], np.int32), 4)
    decode.step()  # the admission's prefill, then one decode token
    b0, b1 = (int(b) for b in decode._tables[req.slot, :2])
    assert decode.split_stats["pages_written"] == 2
    assert b0 in decode._remote_valid and b1 not in decode._remote_valid
