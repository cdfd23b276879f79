"""Port parity for ``hvd.spmd``: the program context, the cross-rank
schedule validation and a program's collectives, ``horovod_tpu_torch``
against ``horovod_tpu``.

* ``ProgramContext.register`` raises the four errors of the JAX package's
  ``TraceContext.register`` byte for byte; ``first_divergence`` and
  ``sched_key`` are the JAX package's.
* One spawned 2-rank gloo world (module-scoped) runs every multi-rank case:
  equal schedules pass; a rank-dependent extra collective raises the
  reference's mismatch text on both ranks; a rank that never submits its
  schedule trips the ``HOROVOD_SCHEDULE_TIMEOUT`` cap (after the stall
  warning), and a coordinator that never answers the
  ``HOROVOD_NEGOTIATION_TIMEOUT`` text; a step with allreduce, allgather,
  broadcast and gather under ``spmd``, three calls, against the JAX
  package's ``hvd.spmd`` on the same per-rank numpy inputs (the traced
  gather gives every member the concatenation); ``trace_count`` and the
  recording anew after a generation bump and after ``Trainer.restore``.
* ``training.sgd``/``training.adam`` against
  ``optax.inject_hyperparams(optax.sgd/adam)`` over 5 steps with ``set_lr``
  between them (atol 1e-6: fp32 on both sides; the optax side runs with the
  suite's x64 mode off, as the JAX package runs); ``set_lr`` on a float learning
  rate raises once the step is recorded.
* Loading the optimizer's state, through the wrapper or into the inner
  optimizer, records the Trainer's step anew; a kernel launch recorded by
  a capture counts at each replay (``ops/launches.py``).

The spawned children import this module, so JAX is imported only inside
the parent-side functions.
"""

import contextlib
import copy
import io
import os

import numpy as np
import pytest
import torch

SHAPE = (3, 4)


def _x(rank, seed=0):
    return (np.random.RandomState(10 * seed + rank).randn(*SHAPE) * 3
            ).astype(np.float32)


def _collective_step(x):
    """The per-rank step both frameworks run: the four collectives."""
    import horovod_tpu_torch as hvd

    return (hvd.allreduce(x, name="ar"), hvd.allgather(x, name="ag"),
            hvd.broadcast(x, root_rank=1, name="bc"),
            hvd.gather(x, root_rank=0, name="ga"))


def _raises(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the text is the result
        return f"{type(e).__name__}: {e}"
    return None


def _schedules(rank):
    """Scenario (schedule validation): equal, then rank 1 one longer."""
    row = ["a", "ALLREDUCE", "float32", [3], 0, -1, []]
    extra = ["b", "BROADCAST", "float32", [2], 0, 1, []]
    return [row], [row] + ([extra] if rank == 1 else [])


def _port_world(ckpt_dir):
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core import multihost as mh
    from horovod_tpu_torch.training.callbacks import ModelCheckpointCallback

    r = int(os.environ["RANK"])
    os.environ["HOROVOD_STALL_CHECK_TIME"] = "0.2"
    hvd.init(device="cpu")
    os.environ.pop("HOROVOD_STALL_CHECK_TIME")
    out = {}
    equal, diverged = _schedules(r)
    out["equal"] = _raises(lambda: mh.validate_schedule("prog/1", equal))
    out["diverged"] = _raises(lambda: mh.validate_schedule("prog/1",
                                                           diverged))
    dist.barrier()
    # Rank 1 never submits; rank 0 gives up after HOROVOD_SCHEDULE_TIMEOUT.
    if r == 0:
        os.environ["HOROVOD_SCHEDULE_TIMEOUT"] = "1"
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out["missing"] = _raises(
                lambda: mh.validate_schedule("lonely/1", equal))
        out["stall_printed"] = buf.getvalue()
        del os.environ["HOROVOD_SCHEDULE_TIMEOUT"]
    dist.barrier()
    # Rank 0 never answers; rank 1 gives up after its negotiation timeout.
    if r == 1:
        os.environ["HOROVOD_NEGOTIATION_TIMEOUT"] = "1"
        out["no_verdict"] = _raises(
            lambda: mh.validate_schedule("unanswered/1", equal))
        del os.environ["HOROVOD_NEGOTIATION_TIMEOUT"]
    dist.barrier()

    step = hvd.spmd(_collective_step)
    calls = [[t.numpy() for t in step(torch.from_numpy(_x(r, seed=s)))]
             for s in range(3)]
    out["calls"] = calls
    out["trace_counts"] = [step.trace_count]
    hvd.bump_generation()
    step(torch.from_numpy(_x(r)))
    out["trace_counts"].append(step.trace_count)
    out["programs_after_bump"] = len(step.programs)
    step(torch.zeros(2, 4))  # another signature: another program
    out["trace_counts"].append(step.trace_count)

    model = torch.nn.Linear(4, 2)
    torch.manual_seed(0)
    torch.nn.init.normal_(model.weight)
    trainer = hvd.Trainer(model, lambda m, b: m(b).pow(2).mean(),
                          hvd.training.sgd(0.1, momentum=0.9))
    data = [torch.from_numpy(_x(r, seed=7 + i)[:, :4]) for i in range(2)]
    trainer.fit(data, epochs=1, steps_per_epoch=2, verbose=False,
                callbacks=[ModelCheckpointCallback(ckpt_dir)])
    dist.barrier()  # rank 0's checkpoint is on disk
    before = trainer._step.trace_count
    trainer.restore(ckpt_dir)
    trainer.train_step(data[0])
    out["restore_trace_counts"] = (before, trainer._step.trace_count,
                                   len(trainer._step.programs))
    return out


def _jax_collective_step(per_rank):
    import jax
    import jax.numpy as jnp

    import horovod_tpu as jhvd

    def step(x):
        return (jhvd.allreduce(x, name="ar"), jhvd.allgather(x, name="ag"),
                jhvd.broadcast(x, root_rank=1, name="bc"),
                jhvd.gather(x, root_rank=0, name="ga"))

    jhvd.shutdown()
    jhvd.init(devices=jax.devices()[:2])
    try:
        prog = jhvd.spmd(step)
        outs = prog(jhvd.rank_stack([jnp.asarray(v) for v in per_rank]))
        return [[np.asarray(o)[r] for o in outs] for r in range(2)]
    finally:
        jhvd.shutdown()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from horovod_tpu_torch.run import run

    ckpt = str(tmp_path_factory.mktemp("spmd_ckpt"))
    return run(_port_world, 2, device="cpu", args=(ckpt,), timeout=240)


# -- the program context and the pure comparisons --------------------------------

REGISTER_CASES = {
    "same": (("t", "ALLREDUCE", "float32", (3,), 0, None),
             ("t", "ALLREDUCE", "float32", (3,), 0, None)),
    "op": (("t", "ALLREDUCE", "float32", (3,), 0, None),
           ("t", "ALLGATHER", "float32", (3,), 0, None)),
    "dtype": (("t", "ALLREDUCE", "float32", (3,), 0, None),
              ("t", "ALLREDUCE", "bfloat16", (3,), 0, None)),
    "shape": (("t", "BROADCAST", "float32", (3,), 0, 1),
              ("t", "BROADCAST", "float32", (3, 1), 0, 1)),
    "root": (("t", "BROADCAST", "float32", (3,), 0, 1),
             ("t", "BROADCAST", "float32", (3,), 0, 0)),
}


@pytest.mark.parametrize("case", sorted(REGISTER_CASES))
def test_register_errors_match_jax(case):
    from horovod_tpu.core.context import TraceContext
    from horovod_tpu_torch.core.context import ProgramContext

    first, second = REGISTER_CASES[case]
    jctx = TraceContext(axis_name="hvd", group_index=0)
    tctx = ProgramContext(group_index=0)
    jctx.register(*first)
    tctx.register(*first)
    want = _raises(lambda: jctx.register(*second))
    got = _raises(lambda: tctx.register(*second))
    assert got == want
    assert (want is None) == (case == "same")
    assert list(tctx.names) == list(jctx.names)


DIVERGENCE_CASES = [
    ([], []),
    ([[1, "a"]], [[1, "a"]]),
    ([[1, "a"], [2]], [[1, "a"], [3]]),
    ([[1]], [[1], ["x"]]),
    ([[1], ["x"]], [[1]]),
    (["a", "b"], ["b", "a"]),
]


@pytest.mark.parametrize("a,b", DIVERGENCE_CASES)
def test_first_divergence_matches_jax(a, b):
    from horovod_tpu.analysis import protocol as jproto
    from horovod_tpu_torch.analysis import protocol as tproto

    assert tproto.first_divergence(a, b) == jproto.first_divergence(a, b)


@pytest.mark.parametrize("gen,tag,epoch", [(0, "step/3", 0),
                                           (4, "grp1/Trainer._one_step/1", 7)])
def test_sched_key_matches_jax(gen, tag, epoch):
    from horovod_tpu.analysis import protocol as jproto
    from horovod_tpu_torch.analysis import protocol as tproto

    assert tproto.sched_key(gen, tag, epoch) == jproto.sched_key(gen, tag,
                                                                 epoch)


def test_program_schedule_rows_take_the_reference_layout():
    from horovod_tpu_torch.core.context import ProgramContext

    ctx = ProgramContext(group_index=0)
    ctx.register("b", "ALLREDUCE", "float32", (6,), 0, members=("x", "y"))
    ctx.register("a", "BROADCAST", "int32", (2, 3), 1, 0)
    assert ctx.schedule() == [["b", "ALLREDUCE", "float32", [6], 0, -1,
                               ["x", "y"]],
                              ["a", "BROADCAST", "int32", [2, 3], 1, 0, []]]


# -- schedule validation across two ranks -----------------------------------------

def test_equal_schedules_pass(world):
    assert [w["equal"] for w in world] == [None, None]


def test_a_rank_dependent_extra_collective_raises_on_both_ranks(world):
    _, diverged = _schedules(1)
    want = (f"HorovodError: Mismatched collective schedules across processes "
            f"for program prog/1: process 0 and process 1 diverge at "
            f"position 1: <end> vs {diverged[1]}. All processes must build "
            f"the same program; check for process-dependent control flow or "
            f"unnamed collectives issued in different orders.")
    assert [w["diverged"] for w in world] == [want, want]


def test_a_rank_that_never_submits_trips_the_schedule_timeout(world):
    assert world[0]["missing"].startswith(
        "HorovodError: Coordinator gave up waiting for process 1's "
        "collective schedule for program lonely/1 after 1 seconds "
        "(HOROVOD_SCHEDULE_TIMEOUT). The process has likely crashed or "
        "structurally diverged")
    assert ("WARNING: process 1 has not submitted its collective schedule "
            "for program lonely/1 after 0 seconds; it may still be "
            "tracing/compiling, or it may have diverged."
            in world[0]["stall_printed"])


def test_a_silent_coordinator_trips_the_negotiation_timeout(world):
    assert world[1]["no_verdict"] == (
        "HorovodError: Timed out waiting for the coordinator's schedule "
        "verdict for program unanswered/1 (HOROVOD_NEGOTIATION_TIMEOUT). "
        "The coordinator may still be waiting on a slower process's trace, "
        "or this process's schedule diverged.")


# -- a program's collectives against the JAX package's hvd.spmd --------------------

@pytest.mark.parametrize("call", [0, 1, 2])
def test_collectives_in_a_program_match_jax_spmd(world, call):
    want = _jax_collective_step([_x(r, seed=call) for r in range(2)])
    for r in range(2):
        got = world[r]["calls"][call]
        assert len(got) == 4
        np.testing.assert_allclose(got[0], want[r][0], rtol=1e-6)
        for g, w in zip(got[1:], want[r][1:]):
            np.testing.assert_array_equal(g, w)
        # The traced gather: every member holds the concatenation.
        np.testing.assert_array_equal(
            got[3], np.concatenate([_x(0, seed=call), _x(1, seed=call)]))


def test_trace_count_and_recording_anew(world):
    for w in world:
        # One program for three calls; a generation bump drops it and
        # records anew; a new signature is one more program.
        assert w["trace_counts"] == [1, 2, 3]
        assert w["programs_after_bump"] == 1
        before, after, programs = w["restore_trace_counts"]
        assert after == before + 1 and programs == 1


# -- the LR builders against optax.inject_hyperparams ------------------------------

LRS = (0.1, 0.05, 0.05, 0.2, 0.01)


class _Params(torch.nn.Module):
    def __init__(self, values):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(values["w"].copy()))
        self.b = torch.nn.Parameter(torch.from_numpy(values["b"].copy()))


def _grads(step):
    rng = np.random.RandomState(50 + step)
    return {"w": rng.randn(3, 4).astype(np.float32),
            "b": rng.randn(4).astype(np.float32)}


def _start():
    rng = np.random.RandomState(9)
    return {"w": rng.randn(3, 4).astype(np.float32),
            "b": rng.randn(4).astype(np.float32)}


OPTIMIZERS = {
    "sgd": (lambda t: t.sgd(LRS[0]), "sgd", {}, ()),
    "sgd_momentum": (lambda t: t.sgd(LRS[0], momentum=0.9), "sgd",
                     {"momentum": 0.9}, ()),
    "sgd_nesterov": (lambda t: t.sgd(LRS[0], momentum=0.9, nesterov=True),
                     "sgd", {"momentum": 0.9, "nesterov": True}, ()),
    # Adam's b1, b2 and eps stay Python floats on the optax side, as in the
    # port, where only the learning rate lives on the device: injected,
    # optax would form 1 − b2 from b2 rounded to fp32, which moves the
    # update by 6e-6 of itself at t = 1 (1 − b2 = 1e-3).
    "adam": (lambda t: t.adam(LRS[0]), "adam", {},
             ("b1", "b2", "eps", "eps_root")),
}


def _optax_run(kind, kw, static):
    import jax
    import optax

    # The JAX package's default precision, fp32 throughout (the suite's x64
    # mode would take Adam's bias corrections in fp64).
    with jax.enable_x64(False):
        return _optax_steps(optax.inject_hyperparams(
            getattr(optax, kind), static_args=static)(
                learning_rate=LRS[0], **kw))


def _optax_steps(opt):
    import jax.numpy as jnp
    import optax

    params = {k: jnp.asarray(v) for k, v in _start().items()}
    state = opt.init(params)
    out = []
    for i, lr in enumerate(LRS):
        state.hyperparams["learning_rate"] = jnp.full_like(
            jnp.asarray(state.hyperparams["learning_rate"]), lr)
        grads = {k: jnp.asarray(v) for k, v in _grads(i).items()}
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        out.append({k: np.asarray(v) for k, v in params.items()})
    return out


@pytest.fixture
def cpu_world():
    import horovod_tpu_torch as hvd

    hvd.shutdown()
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_lr_builders_match_optax_inject_hyperparams(cpu_world, name):
    from horovod_tpu_torch import training

    build, kind, kw, static = OPTIMIZERS[name]
    model = _Params(_start())

    def loss_fn(m, g):  # d(loss)/dp = the batch
        return (m.w * g["w"]).sum() + (m.b * g["b"]).sum()

    trainer = cpu_world.Trainer(model, loss_fn, build(training))
    assert isinstance(trainer.optimizer.param_groups[0]["lr"], torch.Tensor)
    want = _optax_run(kind, kw, static)
    for i, lr in enumerate(LRS):
        trainer.set_lr(lr)
        assert trainer.get_lr() == pytest.approx(lr, rel=1e-7)
        trainer.train_step({k: torch.from_numpy(v)
                            for k, v in _grads(i).items()})
        for k in ("w", "b"):
            np.testing.assert_allclose(getattr(model, k).detach().numpy(),
                                       want[i][k], rtol=0, atol=1e-6,
                                       err_msg=f"step {i} {k}")
    assert trainer._step.trace_count == 1  # one program, LR in a tensor


def test_set_lr_on_a_float_lr_raises_the_reference_text(cpu_world):
    import optax

    from horovod_tpu import training as jtraining
    from horovod_tpu_torch.core.state import HorovodError

    import jax

    import horovod_tpu as jhvd

    jhvd.shutdown()
    jhvd.init(devices=jax.devices()[:1])
    try:
        jt = jtraining.Trainer(lambda p, b: p["w"].sum(), optax.sgd(0.1))
        jt.init_state({"w": np.zeros(2, np.float32)})
        with pytest.raises(Exception) as jinfo:
            jt.set_lr(0.05)
    finally:
        jhvd.shutdown()
    prefix = "LR schedule callbacks need an optimizer built with "
    assert str(jinfo.value).startswith(prefix)

    model = torch.nn.Linear(2, 1)
    trainer = cpu_world.Trainer(model, lambda m, b: m(b).sum(),
                                torch.optim.SGD(model.parameters(), lr=0.1))
    trainer.set_lr(0.05)  # nothing recorded yet: the float may change
    assert trainer.get_lr() == 0.05
    trainer.train_step(torch.ones(3, 2))
    with pytest.raises(HorovodError) as info:
        trainer.set_lr(0.01)
    assert str(info.value).startswith(prefix)
    assert trainer.get_lr() == 0.05


# -- what the port takes of the reference's spmd API ---------------------------------

def test_rank_axis_helpers_take_one_value_a_process(cpu_world):
    x = torch.arange(6.0).reshape(2, 3)
    assert cpu_world.rank_stack([x]) is x
    assert cpu_world.replicate(x) is x
    assert cpu_world.device_put_ranked({"x": x})["x"].device.type == "cpu"
    got = cpu_world.local_values((x, {"y": x + 1}))
    assert len(got) == 1
    np.testing.assert_array_equal(got[0][0], x.numpy())
    np.testing.assert_array_equal(got[0][1]["y"], x.numpy() + 1)
    with pytest.raises(cpu_world.HorovodError,
                       match=r"expected one value per local member rank "
                             r"\(1\), got 2"):
        cpu_world.rank_stack([x, x])


@pytest.mark.parametrize("kw", ["donate_argnums", "replicated_argnums"])
def test_spmd_takes_no_rank_axis_arguments(cpu_world, kw):
    with pytest.raises(TypeError):
        cpu_world.spmd(lambda x: x, **{kw: (0,)})


def test_timeline_spans_of_a_program(monkeypatch, tmp_path):
    import json

    import horovod_tpu_torch as hvd

    path = tmp_path / "timeline.json"
    monkeypatch.setenv("HOROVOD_TIMELINE", str(path))
    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        step = hvd.spmd(lambda x: hvd.allreduce(x * 2, name="grad"))
        for _ in range(3):
            step(torch.ones(3))
    finally:
        hvd.shutdown()
    events = json.loads(path.read_text().rstrip().rstrip(",") + "]")
    rows = {e["pid"]: e["args"]["name"] for e in events
            if e["name"] == "process_name"}
    spans = [(rows[e["pid"]], e["name"], e["ph"]) for e in events
             if e["ph"] in ("B", "E")]
    tag = "_program/test_timeline_spans_of_a_program.<locals>.<lambda>/1"
    assert (tag, "TRACE_AND_COMPILE", "B") in spans
    assert ("grad", "NEGOTIATE_ALLREDUCE", "B") in spans
    # The reference's XLA_<op> spans are GRAPH_<op> here, one pair a run of
    # the recorded program (the two calls after the first).
    assert spans.count(("grad", "GRAPH_ALLREDUCE", "B")) == 2
    assert spans.count(("grad", "GRAPH_ALLREDUCE", "E")) == 2


# -- what recaptures a Trainer's step, and how a capture's launches count -----------

@pytest.mark.parametrize("route", ["wrapper", "inner"])
def test_loading_optimizer_state_records_the_step_anew(cpu_world, route):
    """torch's loader replaces the optimizer's state tensors, which a
    captured step would go on updating: loading through the
    DistributedOptimizer or straight into the inner optimizer records the
    step anew, and the step then reads the loaded state."""
    from horovod_tpu_torch import training

    model = _Params(_start())

    def loss_fn(m, g):
        return (m.w * g["w"]).sum() + (m.b * g["b"]).sum()

    trainer = cpu_world.Trainer(model, loss_fn, training.adam(LRS[0]))
    grads = {k: torch.from_numpy(v) for k, v in _grads(0).items()}
    trainer.train_step(grads)
    saved = copy.deepcopy(trainer.optimizer.state_dict())
    trainer.train_step(grads)
    assert trainer._step.trace_count == 1
    target = (trainer.optimizer if route == "wrapper"
              else trainer.optimizer.optimizer)
    target.load_state_dict(saved)
    assert not trainer._step.programs
    trainer.train_step(grads)
    assert trainer._step.trace_count == 2
    steps = [st["step"] for st in trainer.optimizer.state.values()]
    assert [int(s) for s in steps] == [2, 2]  # one after the loaded 1


@pytest.mark.parametrize("capturing", [False, True])
def test_a_captured_launch_counts_at_each_replay(monkeypatch, capturing):
    """ops/launches.py: a wrapper's launch counts at once, unless a CUDA
    graph is being captured; then it counts once for each replay of the
    graph whose capture collected it, and nowhere else."""
    from horovod_tpu_torch.ops import launches

    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing)
    counts = {"k": 0}
    with launches.recording() as recorded:
        launches.count(counts, "k")
        launches.count(counts, "k")
    launches.count(counts, "k")  # outside a recording
    assert counts["k"] == (0 if capturing else 3)
    assert len(recorded) == (2 if capturing else 0)
    for _ in range(3):
        launches.replayed(recorded)
    assert counts["k"] == (6 if capturing else 3)
