"""Port parity for the runtime around the collectives: environment knobs,
the Chrome-trace timeline, and the LR callbacks, ``horovod_tpu_torch``
against ``horovod_tpu``. Everything here is pure host logic, compared
exactly."""

import json
import warnings

import jax
import pytest
import torch

import horovod_tpu as jhvd
import horovod_tpu_torch as hvd
from horovod_tpu.training import callbacks as jcb
from horovod_tpu.utils import env as jenv
from horovod_tpu_torch.training import callbacks as tcb
from horovod_tpu_torch.utils import env as tenv


@pytest.mark.parametrize("raw", [None, "0", "1", "1048576", "67108864",
                                 "-1", "64MB", ""])
def test_fusion_threshold_matches_jax(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv("HOROVOD_FUSION_THRESHOLD", raising=False)
    else:
        monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", raw)
    try:
        want = jenv.fusion_threshold_bytes()
    except ValueError as e:
        with pytest.raises(ValueError) as info:
            tenv.fusion_threshold_bytes()
        assert str(info.value) == str(e)
        return
    assert tenv.fusion_threshold_bytes() == want


@pytest.mark.parametrize("raw", [None, "", "/tmp/t.json"])
def test_timeline_path_matches_jax(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv("HOROVOD_TIMELINE", raising=False)
    else:
        monkeypatch.setenv("HOROVOD_TIMELINE", raw)
    assert tenv.timeline_path() == jenv.timeline_path()


def test_typod_knob_warns():
    env = {"HOROVOD_FUSION_THRESHOLD": "0", "HOROVOD_FUSION_TRESHOLD": "1",
           "HOROVOD_TIMELINE": "x", "OTHER": "y"}
    assert jenv.unknown_horovod_vars(env) == ["HOROVOD_FUSION_TRESHOLD"]
    with pytest.warns(UserWarning, match="HOROVOD_FUSION_TRESHOLD"):
        assert tenv.warn_unknown_env(env) == ["HOROVOD_FUSION_TRESHOLD"]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tenv.warn_unknown_env({"HOROVOD_TIMELINE": "x"})


def test_timeline_records_the_main_path(monkeypatch, tmp_path):
    """A 1-rank CPU world with HOROVOD_TIMELINE set: a named allreduce and
    one DistributedOptimizer step leave the reference's activity names."""
    path = tmp_path / "timeline.json"
    monkeypatch.setenv("HOROVOD_TIMELINE", str(path))
    monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", "0")
    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        hvd.allreduce(torch.ones(3), name="loss")
        model = torch.nn.Linear(4, 2)
        opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                       lr=0.1))
        model(torch.ones(1, 4)).sum().backward()
        opt.step()
    finally:
        hvd.shutdown()
    events = json.loads(path.read_text().rstrip().rstrip(",") + "]")
    rows = {e["pid"]: e["args"]["name"] for e in events
            if e["name"] == "process_name"}
    names = {(rows[e["pid"]], e["name"]) for e in events if e["ph"] == "B"}
    # The native request table names its span as the reference's does,
    # in lower case; the Python path's is NEGOTIATE_ALLREDUCE.
    from horovod_tpu_torch.core import native

    neg = ("NEGOTIATE_allreduce" if native.available()
           else "NEGOTIATE_ALLREDUCE")
    assert ("loss", neg) in names
    assert ("loss", "ALLREDUCE") in names
    # Threshold 0: one bucket per gradient (weight, bias).
    for b in ("DistributedOptimizer.grads.bucket_0",
              "DistributedOptimizer.grads.bucket_1"):
        for act in (neg, "MEMCPY_IN_FUSION_BUFFER",
                    "ALLREDUCE", "MEMCPY_OUT_FUSION_BUFFER"):
            assert (b, act) in names
    assert all(e["ph"] in ("M", "B", "E", "X") for e in events)


class _FakeTrainer:
    """Records what a callback does to the LR and the momentum."""

    def __init__(self, lr):
        self.lr = lr
        self.log = []

    def get_lr(self):
        return self.lr

    def set_lr(self, value):
        self.lr = value
        self.log.append(("lr", value))

    def scale_momentum(self, factor):
        self.log.append(("momentum", factor))


def _drive(cb, epochs=3, steps=4):
    trainer = _FakeTrainer(0.4)
    cb.set_trainer(trainer)
    cb.on_train_begin()
    for epoch in range(epochs):
        cb.on_epoch_begin(epoch)
        for b in range(steps):
            cb.on_batch_begin(b)
            cb.on_batch_end(b, {"loss": 1.0})
        cb.on_epoch_end(epoch, {"loss": 1.0})
    return trainer.log


@pytest.fixture
def size_two(monkeypatch):
    """Group size 2 on both sides: the JAX world over 2 devices, and the
    port's size() patched (its own world here would be 1 process)."""
    jhvd.shutdown()
    jhvd.init(devices=jax.devices()[:2])
    monkeypatch.setattr(tcb._state, "size", lambda group=0: 2)
    yield
    jhvd.shutdown()


@pytest.mark.parametrize("kind", ["warmup", "schedule_staircase",
                                  "schedule_smooth"])
def test_lr_callbacks_match_jax(size_two, kind):
    """The same LR and momentum-correction sequence as the reference."""
    def make(mod):
        if kind == "warmup":
            return mod.LearningRateWarmupCallback(warmup_epochs=2,
                                                  steps_per_epoch=4)
        return mod.LearningRateScheduleCallback(
            lambda e: 0.5 ** e, start_epoch=1, end_epoch=3,
            staircase=kind == "schedule_staircase", steps_per_epoch=4)

    want = _drive(make(jcb))
    got = _drive(make(tcb))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert a == pytest.approx(b, rel=1e-12)
    assert got  # the callback did act


def test_momentum_correction_scales_sgd_buffers():
    model = torch.nn.Linear(3, 1)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    model(torch.ones(2, 3)).sum().backward()
    opt.step()
    trainer = hvd.Trainer.__new__(hvd.Trainer)
    trainer.optimizer = hvd.DistributedOptimizer(opt)
    before = [opt.state[p]["momentum_buffer"].clone()
              for p in model.parameters()]
    trainer.set_lr(0.05)
    trainer.scale_momentum(0.5)
    assert trainer.get_lr() == 0.05
    assert all(g["lr"] == 0.05 for g in opt.param_groups)
    for p, b in zip(model.parameters(), before):
        torch.testing.assert_close(opt.state[p]["momentum_buffer"], b * 0.5)


@pytest.mark.parametrize("groups", [[[0, 0]], [[0, 9]], [[]], [[1, 2], [3]]])
def test_group_specs_match_jax(groups):
    """Group validation and layout: group 0 is the world, user groups
    follow; bad groups raise the reference's message."""
    from horovod_tpu_torch.core import state as tstate

    jhvd.shutdown()
    try:
        jhvd.init(groups)
        want = [tuple(jhvd.get_group(i).ranks)
                for i in range(jhvd.num_groups())]
    except jhvd.HorovodError as e:
        with pytest.raises(hvd.HorovodError) as info:
            tstate._group_specs(groups, 8)
        assert str(info.value) == str(e)
        return
    finally:
        jhvd.shutdown()
    assert tstate._group_specs(groups, 8) == want
