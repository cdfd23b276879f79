"""Checkpoint and resume (``horovod_tpu_torch/training/checkpoint.py``,
``Trainer.restore``, ``fit(resume=)``) against the JAX package's
``horovod_tpu/training/checkpoint.py``.

* The manifest of a payload is the reference's, byte for byte.
* ``verify_epoch`` and ``latest_epoch`` give the reference's verdicts and
  warnings on the same scenarios (a torn epoch, a corrupt CRC, a missing or
  unreadable manifest, a missing payload), and ``agree_epochs`` its
  agreement on any per-rank sets (hypothesis). The payloads differ in
  format on purpose (``.pt`` here, ``.msgpack`` there; ROADMAP §C), so each
  package scans a directory of its own with the same bytes and damage, and
  texts are compared with the directory and the extension normalized.
* One spawned 2-rank gloo world (module-scoped) checks the resume protocol:
  rank-local directories with disjoint epochs raise the reference's error,
  a rank behind the other draws its warning and both resume at the epoch
  every rank holds; a shared directory whose newest epoch is torn resumes
  one epoch back on both ranks, and the resumed 2-rank run ends bit for bit
  where the uninterrupted run ends; a process outside the trainer's group
  is refused.
* ``fit(resume=, initial_epoch=)`` is refused; each function of the sharded
  convention round-trips in a one-rank world (``tests/test_torch_fsdp.py``
  holds it against four ranks).

The spawned children import this module, so JAX is imported only inside
the parent-side functions.
"""

import io
import json
import os
import warnings

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from horovod_tpu_torch.training import checkpoint as tck

EPOCHS = 3
STEPS = 2


# -- the 2-rank world ------------------------------------------------------------

def _trainer(seed: int):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops.optim import AdamW

    g = torch.Generator().manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.BatchNorm1d(8),
                                torch.nn.Tanh(), torch.nn.Linear(8, 1))
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    return hvd.Trainer(model, lambda m, b: (m(b[0]) - b[1]).square().mean(),
                       AdamW(model.parameters(), 1e-2, weight_decay=0.1))


def _batches(rank: int):
    g = torch.Generator().manual_seed(100 + rank)
    return [(torch.randn(6, 4, generator=g), torch.randn(6, 1, generator=g))
            for _ in range(STEPS)]


def _final(trainer) -> dict:
    out = {f"model.{k}": v.numpy().copy()
           for k, v in trainer.model.state_dict().items()}
    for i, st_ in trainer.optimizer.state_dict()["state"].items():
        for k, v in st_.items():
            out[f"opt.{i}.{k}"] = v.float().numpy().copy()
    return out


def _messages(fn):
    """``(result or error text, warning texts)`` of ``fn()``."""
    import horovod_tpu_torch as hvd

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            got = fn()
        except hvd.HorovodError as e:
            got = str(e)
    return got, [str(w.message) for w in caught]


def _resume_world(root: str):
    """Target of each spawned rank."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core import resilience

    hvd.init([[0, 1], [0]], device="cpu")
    r = hvd.global_rank()
    out = {}

    # Rank-local directories: disjoint, then rank 1 one epoch behind.
    state = _trainer(0).train_state()
    for case, mine in (("disjoint", {0: [3], 1: [1]}),
                       ("behind", {0: [0, 1, 2], 1: [0, 1]})):
        local = os.path.join(root, case, f"rank{r}")
        for e in mine[r]:
            tck.save(local, state, e)
        out[case] = _messages(lambda: tck.agree_on_resume_epoch(local))
        out[case + "_dir"] = local

    # A shared directory: the uninterrupted run, then run A with epoch 2
    # torn and run B resumed from it, both ranks writing through rank 0.
    full = _trainer(0)
    full.fit(_batches(r), EPOCHS, STEPS, verbose=False,
             callbacks=[hvd.BroadcastGlobalVariablesCallback(0)])
    out["full"] = _final(full)
    shared = os.path.join(root, "shared")
    os.environ["HOROVOD_FAULT_INJECT"] = "torn_write@epoch=2"
    resilience.reset_injector()
    try:
        run_a = _trainer(0)
        run_a.fit(_batches(r), EPOCHS, STEPS, verbose=False,
                  callbacks=[hvd.BroadcastGlobalVariablesCallback(0),
                             hvd.ModelCheckpointCallback(shared)])
    finally:
        del os.environ["HOROVOD_FAULT_INJECT"]
        resilience.reset_injector()
    # Rank 0 writes; run B starts once its last write is done, as a
    # relaunch after a crash does.
    hvd.allreduce(torch.zeros(1), name="run_a_done")
    run_b = _trainer(7)
    resumed_at = []

    class At(hvd.Callback):
        def on_train_begin(self, logs=None):
            resumed_at.append(self.trainer.epoch)

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        run_b.fit(_batches(r), EPOCHS, STEPS, verbose=False,
                  callbacks=[At()], resume=shared)
    out["resumed_at"] = resumed_at[0]
    out["torn_warnings"] = [str(w.message) for w in caught]
    out["resumed"] = _final(run_b)

    # Group 1 is rank 0 alone: rank 1 may not restore its trainer.
    if r == 1:
        t = _trainer(0)
        t.group = 1
        out["memberless"] = _messages(lambda: t.restore(shared))[0]
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from horovod_tpu_torch.run import run

    root = str(tmp_path_factory.mktemp("resume"))
    return run(_resume_world, 2, device="cpu", args=(root,), timeout=120)


def _norm(text: str, *dirs: str) -> str:
    for d in dirs:
        text = text.replace(d, "<dir>")
    return text.replace(".msgpack", ".pt")


def _reference_agreement(monkeypatch, tmp_path, agreed, newest):
    """The reference's agree_on_resume_epoch message when its allgather
    yields ``(agreed, newest)`` (one JAX process cannot disagree with
    itself, so the agreement is stubbed)."""
    from horovod_tpu.training import checkpoint as jck

    monkeypatch.setattr(jck, "_agree_newest_common",
                        lambda *a: (agreed, newest))
    d = str(tmp_path / "ref")
    if agreed >= 0:
        _write_both(d, d + "_t", agreed, b"payload")
    from horovod_tpu.core.state import HorovodError

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            got = jck.agree_on_resume_epoch(d)
        except HorovodError as e:
            got = str(e)
    return (_norm(got, d) if isinstance(got, str) else got,
            [_norm(str(w.message), d) for w in caught])


def test_disjoint_rank_local_epochs_raise_the_reference_error(
        world, monkeypatch, tmp_path):
    want, _ = _reference_agreement(monkeypatch, tmp_path, -1, 3)
    for out in world:
        got, _ = out["disjoint"]
        assert _norm(got, out["disjoint_dir"]) == want


def test_a_rank_behind_rolls_the_group_back_with_the_reference_warning(
        world, monkeypatch, tmp_path):
    want, want_warn = _reference_agreement(monkeypatch, tmp_path, 1, 2)
    assert want == 1
    for out in world:
        got, warns = out["behind"]
        assert got == 1
        assert [_norm(w, out["behind_dir"]) for w in warns] == want_warn


def test_torn_epoch_is_skipped_and_the_resumed_run_is_bit_identical(world):
    for out in world:
        assert out["resumed_at"] == EPOCHS - 1
        assert any("epoch 2" in w and "(torn write)" in w
                   for w in out["torn_warnings"])
        assert set(out["resumed"]) == set(out["full"])
        for k, v in out["full"].items():
            np.testing.assert_array_equal(out["resumed"][k], v, err_msg=k)
    for k in world[0]["full"]:
        np.testing.assert_array_equal(world[0]["resumed"][k],
                                      world[1]["resumed"][k], err_msg=k)


def test_restore_outside_the_group_is_refused_with_the_reference_text(
        world, monkeypatch, tmp_path):
    from types import SimpleNamespace

    from horovod_tpu.core.state import HorovodError
    from horovod_tpu.training import loop as jloop

    monkeypatch.setattr(jloop.hvd, "get_group", lambda g: SimpleNamespace(
        local_member_ranks=lambda: []))
    with pytest.raises(HorovodError) as info:
        jloop.Trainer.restore(SimpleNamespace(sharding="off", params={},
                                              group=1), str(tmp_path))
    assert world[1]["memberless"] == str(info.value)


# -- one process -------------------------------------------------------------------

def _write_both(dj: str, dt: str, epoch: int, data: bytes) -> None:
    """The same payload bytes as epoch ``epoch`` of a reference directory
    ``dj`` (``.msgpack``) and a port directory ``dt`` (``.pt``), each with
    its package's manifest."""
    from horovod_tpu.training import checkpoint as jck

    for d, mod, ext in ((dj, jck, "msgpack"), (dt, tck, "pt")):
        os.makedirs(d, exist_ok=True)
        name = f"checkpoint-{epoch:05d}.{ext}"
        with open(os.path.join(d, name), "wb") as f:
            f.write(data)
        mod._write_manifest(mod._manifest_path(d, epoch), epoch, {name: data})


def test_manifest_bytes_match_the_reference(tmp_path):
    from horovod_tpu.training import checkpoint as jck

    buf = io.BytesIO()
    torch.save({"model": {"w": torch.arange(6.0)}, "epoch": 4}, buf)
    data = buf.getvalue()
    for mod, sub in ((jck, "j"), (tck, "t")):
        os.makedirs(tmp_path / sub)
        mod._write_manifest(str(tmp_path / sub / "m.json"), 4,
                            {"checkpoint-00004.pt": data})
    got = (tmp_path / "t" / "m.json").read_bytes()
    assert got == (tmp_path / "j" / "m.json").read_bytes()
    assert json.loads(got)["files"]["checkpoint-00004.pt"]["size"] == len(data)


def _damage(d: str, ext: str, how: str) -> None:
    path = os.path.join(d, f"checkpoint-00002.{ext}")
    manifest = os.path.join(d, "checkpoint-00002.manifest.json")
    if how == "torn":
        data = open(path, "rb").read()
        open(path, "wb").write(data[:len(data) // 2])
    elif how == "corrupt":
        data = bytearray(open(path, "rb").read())
        data[3] ^= 0xFF
        open(path, "wb").write(bytes(data))
    elif how == "no manifest":
        os.remove(manifest)
    elif how == "unreadable manifest":
        open(manifest, "w").write("{not json")
    elif how == "no payload":
        os.remove(path)


@pytest.mark.parametrize("how", ["intact", "torn", "corrupt", "no manifest",
                                 "unreadable manifest", "no payload"])
def test_verify_and_latest_epoch_match_the_reference(tmp_path, how):
    from horovod_tpu.training import checkpoint as jck

    dj, dt = str(tmp_path / "j"), str(tmp_path / "t")
    for e in range(3):
        _write_both(dj, dt, e, bytes(range(e, 200 + e)))
    _damage(dj, "msgpack", how)
    _damage(dt, "pt", how)
    for crc in (True, False):
        assert (tck.verify_epoch(dt, 2, crc=crc)[0]
                == jck.verify_epoch(dj, 2, crc=crc)[0])
        assert (_norm(tck.verify_epoch(dt, 2, crc=crc)[1], dt)
                == _norm(jck.verify_epoch(dj, 2, crc=crc)[1], dj))
    with warnings.catch_warnings(record=True) as wj:
        warnings.simplefilter("always")
        want = jck.latest_epoch(dj)
    with warnings.catch_warnings(record=True) as wt:
        warnings.simplefilter("always")
        got = tck.latest_epoch(dt)
    assert got == want == (1 if how in ("torn", "corrupt",
                                        "unreadable manifest", "no payload")
                           else 2)
    assert ([_norm(str(w.message), dt) for w in wt]
            == [_norm(str(w.message), dj) for w in wj])
    assert tck.latest_epoch(dt, verify=False) == jck.latest_epoch(
        dj, verify=False)


@pytest.mark.parametrize("how", ["torn", "corrupt"])
def test_loading_a_damaged_epoch_raises_the_reference_error(tmp_path, how):
    from horovod_tpu.core.state import HorovodError
    from horovod_tpu.training import checkpoint as jck

    dj, dt = str(tmp_path / "j"), str(tmp_path / "t")
    for e in range(3):
        _write_both(dj, dt, e, bytes(range(e, 200 + e)))
    _damage(dj, "msgpack", how)
    _damage(dt, "pt", how)
    with pytest.raises(HorovodError) as je:
        jck.load(dj, {}, epoch=2)
    with pytest.raises(tck.HorovodError) as te:
        tck.load(dt, {}, epoch=2)
    assert _norm(str(te.value), dt) == _norm(str(je.value), dj)
    for mod, d in ((jck, dj), (tck, dt)):
        with pytest.raises(FileNotFoundError) as info:
            mod.load(str(tmp_path / "none"), {})
        assert str(info.value) == f"No checkpoints in {tmp_path / 'none'}."


@settings(max_examples=60, deadline=None)
@given(st.lists(st.sets(st.integers(0, 20), max_size=6), min_size=1,
                max_size=4))
def test_agree_epochs_matches_the_reference(per_rank):
    from horovod_tpu.analysis import protocol as jproto
    from horovod_tpu_torch.analysis import protocol as tproto

    assert tproto.agree_epochs(per_rank) == jproto.agree_epochs(per_rank)


def test_torn_write_index_matches_the_reference():
    from horovod_tpu.analysis import protocol as jproto
    from horovod_tpu_torch.analysis import protocol as tproto

    spec = "torn_write@epoch=2;engine_crash@step=1;torn_write@epoch=2"
    tf, jf = tproto.parse_fault_spec(spec), jproto.parse_fault_spec(spec)
    for epoch, consumed in ((2, ()), (2, (0,)), (2, (0, 2)), (1, ()),
                            (None, ())):
        assert (tproto.torn_write_index(tf, epoch, consumed)
                == jproto.torn_write_index(jf, epoch, consumed))


def test_save_and_load_round_trip_with_the_epoch(tmp_path):
    state = {"model": {"w": torch.arange(5, dtype=torch.bfloat16)},
             "optimizer": {"state": {}, "param_groups": []}, "epoch": 0}
    path = tck.save(str(tmp_path), state, 3)
    assert os.path.basename(path) == "checkpoint-00003.pt"
    got = tck.load(str(tmp_path), state)
    assert got["epoch"] == 3
    assert torch.equal(got["model"]["w"], state["model"]["w"])
    assert got["model"]["w"].dtype == torch.bfloat16
    with pytest.raises(tck.HorovodError, match="holds"):
        tck.load(str(tmp_path), {"model": {}})


def test_load_takes_the_reference_group_argument(tmp_path):
    """``load(directory, template, epoch, group)``, the reference's call:
    ``group`` must name a group once hvd.init has run, and places nothing
    (the tensors come back on the CPU; ROADMAP §C)."""
    import horovod_tpu_torch as hvd

    state = {"model": {"w": torch.arange(3.0)}, "epoch": 0}
    tck.save(str(tmp_path), state, 2)
    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        got = tck.load(str(tmp_path), state, 2, 0)
        assert torch.equal(got["model"]["w"], state["model"]["w"])
        assert got["model"]["w"].device.type == "cpu"
        assert tck.load(str(tmp_path), state, epoch=2, group=0,
                        verify=False)["epoch"] == 2
        with pytest.raises(tck.HorovodError, match="Unknown group 3"):
            tck.load(str(tmp_path), state, 2, group=3)
    finally:
        hvd.shutdown()


def test_fit_resume_and_initial_epoch_are_exclusive(tmp_path):
    import horovod_tpu_torch as hvd
    from horovod_tpu.core.state import HorovodError
    from horovod_tpu.training import loop as jloop

    with pytest.raises(HorovodError) as je:
        jloop.Trainer.fit(object(), [], 1, 1, initial_epoch=0,
                          resume=str(tmp_path))
    hvd.init(device="cpu")
    try:
        with pytest.raises(hvd.HorovodError) as te:
            _trainer(0).fit([], 1, 1, initial_epoch=0, resume=str(tmp_path))
    finally:
        hvd.shutdown()
    assert str(te.value) == str(je.value)


def test_resume_from_an_empty_directory_starts_fresh(tmp_path):
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    try:
        t = _trainer(0)
        assert t.restore(str(tmp_path / "none")) == 0
        t.fit(_batches(0), 1, STEPS, verbose=False, initial_epoch=0,
              callbacks=[hvd.ModelCheckpointCallback(str(tmp_path / "c"))])
        assert tck.latest_epoch(str(tmp_path / "c")) == 0
    finally:
        hvd.shutdown()


@pytest.mark.parametrize("fn", ["save_sharded", "load_sharded",
                                "latest_sharded_epoch",
                                "verify_sharded_epoch"])
def test_each_sharded_checkpoint_function_round_trips(tmp_path, fn):
    """A rank's shard file (``checkpoint-NNNNN.shardRRR.pt``) written by
    ``save_sharded`` is found, verified and read back bit for bit."""
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    try:
        d = str(tmp_path)
        state = {"model": {"w": torch.arange(6.0)},
                 "shards": [torch.ones(3, dtype=torch.bfloat16)],
                 "epoch": 0}
        path = tck.save_sharded(d, state, 4)
        if fn == "save_sharded":
            assert os.path.basename(path) == "checkpoint-00004.shard000.pt"
            assert os.path.exists(os.path.join(
                d, "checkpoint-00004.shard000.manifest.json"))
        elif fn == "load_sharded":
            for epoch in (None, 4):
                back = tck.load_sharded(d, state, epoch=epoch)
                assert back["epoch"] == 4
                assert torch.equal(back["model"]["w"], state["model"]["w"])
                assert torch.equal(back["shards"][0], state["shards"][0])
        elif fn == "latest_sharded_epoch":
            assert tck.latest_sharded_epoch(d) == 4
            assert tck.latest_epoch(d) == -1  # a family of its own
        else:
            assert tck.verify_sharded_epoch(d, 4) == (True, "ok")
            assert tck.verify_sharded_epoch(d, 3)[0] is False
    finally:
        hvd.shutdown()


@pytest.mark.parametrize("call", ["three_arguments", "epoch_keyword",
                                  "stacked_tree"])
def test_load_state_takes_train_states_dict_not_stacked_trees(call):
    """``Trainer.load_state(state)`` takes what ``train_state()`` returns
    (an intended divergence: a process is a rank, so there are no
    rank-stacked trees); the reference's ``load_state(params_stacked,
    opt_state_stacked, epoch=0)`` raises a ``TypeError`` naming
    ``train_state()``."""
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    try:
        t = _trainer(0)
        state = t.train_state()
        params = [p.detach().clone() for p in t.model.parameters()]
        with pytest.raises(TypeError, match=r"train_state\(\)"):
            {"three_arguments": lambda: t.load_state(params, {}, 3),
             "epoch_keyword": lambda: t.load_state(params, {}, epoch=3),
             "stacked_tree": lambda: t.load_state(params)}[call]()
        t.load_state(dict(state, epoch=5))
        assert t.epoch == 5
    finally:
        hvd.shutdown()
