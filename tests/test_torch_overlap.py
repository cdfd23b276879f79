"""The gradient exchange overlapped with backward (``parallel/optimizer.py``:
``zero_grad(set_to_none=False)`` arms the step, post-accumulate-grad hooks
issue each fusion bucket in the plan's order), in one 2-rank gloo world,
and a 4-rank one for a subset group.

* Bit for bit: after 3 steps of a 4-layer MLP, the hooked step (backward
  fires the hooks) equals the unoverlapped one (gradients from
  ``torch.autograd.grad`` added into ``.grad``: no hook fires, so ``step()``
  issues every bucket after backward), parameters and error-feedback
  residuals, for both plans, every wire format, error feedback, both
  fixed decompositions, two channels and a subset group.
* Against the JAX package: the overlapped step's averaged gradients equal
  ``horovod_tpu.allreduce_gradients`` over 2 CPU devices on the same
  local gradients, within the tolerance of ``tests/test_torch_train.py``
  (rtol 1e-4, atol 1e-4 x the tensor's largest magnitude).
* The counterpart of ``tests/test_overlap.py``'s gate, on the MLP at
  ``fusion_threshold=0``: under ``priority`` the first bucket's wire call
  comes before the last hook fires, and a hook fires between two bucket
  calls; under ``enum`` every wire call comes after the last hook.
* Order across ranks: rank 1 runs its two branches' forwards in the other
  order, so its hooks fire in another order; both ranks' recorded wire
  listings are equal, are the plan, and verify with no finding.
* ``.grad`` read between backward and ``step()``: the hooked step's
  gradients are averaged when ``backward()`` returns (the pass's end
  finishes the exchange), equal to the unoverlapped step's after
  ``synchronize()`` and on both ranks.
* Edge cases: an unused parameter's gradient is still reduced; a second
  backward before ``step()`` raises, also one that reaches only parameters
  the first did not; ``set_to_none=True`` stays unarmed; a CPU ``Trainer`` program validates its schedule
  once; ``tools/overlap_torch.py --device cpu --ranks 2 --smoke`` ends with
  equal CRCs in each arm pair.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
WORLD = 2
STEPS = 3
WIDTH = 8
LAYERS = 4
THRESHOLD = 300        # bytes: the MLP's 8 tensors travel in 5 buckets
TOL = 1e-4             # tests/test_torch_train.py's

# name -> DistributedOptimizer knobs of the bit-for-bit cases.
CASES = {
    "enum": dict(schedule="enum"),
    "priority": dict(schedule="priority"),
    **{f"priority/{c}": dict(schedule="priority", compression=c)
       for c in ("bf16", "int8", "int8_block", "int4")},
    "enum/int8_block": dict(schedule="enum", compression="int8_block"),
    "priority/int8/error_feedback": dict(schedule="priority",
                                         compression="int8",
                                         error_feedback=True),
    "enum/int4/error_feedback": dict(schedule="enum", compression="int4",
                                     error_feedback=True),
    "priority/flat": dict(schedule="priority", algo="flat"),
    "priority/rs_ag": dict(schedule="priority", algo="rs_ag"),
    "enum/rs_ag/bf16": dict(schedule="enum", algo="rs_ag",
                            compression="bf16"),
    "priority/channels=2": dict(schedule="priority", channels=2),
}
SUBSET_GROUPS = [[0, 1, 2, 3], [1, 2]]


def _mlp(layers: int = LAYERS, seed: int = 0):
    rng = np.random.RandomState(seed)
    mods = []
    for _ in range(layers):
        lin = torch.nn.Linear(WIDTH, WIDTH)
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(
                rng.randn(WIDTH, WIDTH).astype(np.float32) * 0.5))
            lin.bias.copy_(torch.from_numpy(
                rng.randn(WIDTH).astype(np.float32) * 0.1))
        mods += [lin, torch.nn.Tanh()]
    return torch.nn.Sequential(*mods)


def _batch(rank: int, step: int) -> torch.Tensor:
    rng = np.random.RandomState(100 + 10 * rank + step)
    return torch.from_numpy(rng.randn(4, WIDTH).astype(np.float32))


def _loss(model, x):
    return model(x).pow(2).mean()


def _accumulate(loss, params) -> None:
    """The unoverlapped arm's backward: gradients from autograd.grad,
    added into ``.grad``, which fires no post-accumulate-grad hook."""
    with torch.no_grad():
        for p, g in zip(params, torch.autograd.grad(loss, params)):
            p.grad.add_(g)


def _train(knobs: dict, hooked: bool, group: int = 0) -> dict:
    import horovod_tpu_torch as hvd

    rank = hvd.rank()
    model = _mlp()
    params = list(model.parameters())
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(params, lr=0.1, momentum=0.9), group=group,
        fusion_threshold=THRESHOLD, **knobs)
    for p in params:   # every step armed, the first one too
        p.grad = torch.zeros_like(p)
    for s in range(STEPS):
        opt.zero_grad(set_to_none=False)
        loss = _loss(model, _batch(rank, s))
        if hooked:
            loss.backward()
        else:
            _accumulate(loss, params)
        opt.step()
    return {"params": [p.detach().numpy().copy() for p in params],
            "residual": [r.numpy().copy() for _, r in
                         sorted(opt.residual.items())],
            "hooks": opt.hooks_fired,
            "in_backward": opt.buckets_in_backward}


def _gate(schedule: str) -> dict:
    """The wire calls recorded before each hook fired, and in all, over
    one armed step at ``fusion_threshold=0``."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import wire

    model = _mlp()
    params = list(model.parameters())
    seen: list = []
    with wire.recording() as rec:
        for p in params:
            # Registered before the wrapper's hook, so it runs first.
            p.register_post_accumulate_grad_hook(
                lambda p: seen.append(len(rec.instrs)))
        opt = hvd.DistributedOptimizer(torch.optim.SGD(params, lr=0.1),
                                       schedule=schedule, fusion_threshold=0)
        for p in params:
            p.grad = torch.zeros_like(p)
        opt.zero_grad(set_to_none=False)
        _loss(model, _batch(hvd.rank(), 0)).backward()
        opt.step()
    return {"seen": seen, "calls": len(rec.instrs),
            "buckets": len(opt._allreduce.plan.buckets)}


class _Branches(torch.nn.Module):
    """Two branches of distinct widths; ``swap`` runs their forwards in
    the other order, so autograd reaches their parameters in the other
    order."""

    def __init__(self) -> None:
        super().__init__()
        g = torch.Generator().manual_seed(3)
        self.a = torch.nn.Linear(WIDTH, 6)
        self.b = torch.nn.Linear(WIDTH, 10)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=g) * 0.3)

    def forward(self, x, swap: bool):
        if swap:
            yb = self.b(x).tanh()
            ya = self.a(x).tanh()
        else:
            ya = self.a(x).tanh()
            yb = self.b(x).tanh()
        return ya.sum() * yb.sum()


def _orders() -> dict:
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.analysis import schedule
    from horovod_tpu_torch.ops import wire

    model = _Branches()
    params = list(model.parameters())
    names = {id(p): n for n, p in model.named_parameters()}
    fired: list = []
    for p in params:
        p.register_post_accumulate_grad_hook(
            lambda p: fired.append(names[id(p)]))
    opt = hvd.DistributedOptimizer(torch.optim.SGD(params, lr=0.1),
                                   schedule="priority", fusion_threshold=0)
    for p in params:
        p.grad = torch.zeros_like(p)
    opt.zero_grad(set_to_none=False)
    with wire.recording() as rec:
        model(_batch(hvd.rank(), 0), swap=hvd.rank() == 1).backward()
        opt.step()
    listings = schedule.gather_listings(rec.instrs)
    plan = opt._allreduce.plan
    return {"fired": fired,
            "listing": [(i.opcode, i.element_type, i.shape)
                        for i in rec.instrs],
            "plan": [("all-reduce", "f32", (b.elems,))
                     for b in plan.buckets],
            "findings": [str(f) for f in
                         schedule.verify_listings(listings)],
            "in_backward": opt.buckets_in_backward}


def _edges() -> dict:
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import training
    from horovod_tpu_torch.core import multihost
    from horovod_tpu_torch.ops import wire

    rank = hvd.rank()
    out = {}
    # An unused parameter that holds a gradient: its hook never fires,
    # and the end of backward still reduces it.
    model = _mlp(layers=2)
    spare = torch.nn.Parameter(torch.zeros(5))
    params = list(model.parameters()) + [spare]
    opt = hvd.DistributedOptimizer(torch.optim.SGD(params, lr=0.0),
                                   schedule="priority", fusion_threshold=0)
    for p in params:
        p.grad = torch.zeros_like(p)
    opt.zero_grad(set_to_none=False)
    spare.grad.fill_(float(rank + 1))
    _loss(model, _batch(rank, 0)).backward()
    armed = opt._armed is not None
    opt.step()
    out["unused"] = {"armed": armed, "grad": spare.grad.numpy().copy()}
    # A second backward before step() raises.
    opt.zero_grad(set_to_none=False)
    _loss(model, _batch(rank, 1)).backward()
    try:
        _loss(model, _batch(rank, 2)).backward()
        out["twice"] = None
    except hvd.HorovodError as e:
        out["twice"] = str(e)
    # A backward reaching only parameters the first one did not: the
    # first pass's end finished the exchange, so it raises too.
    branches = _Branches()
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(branches.parameters(), lr=0.1), fusion_threshold=0)
    for p in branches.parameters():
        p.grad = torch.zeros_like(p)
    opt.zero_grad(set_to_none=False)
    x = _batch(rank, 0)
    branches.a(x).tanh().sum().backward()
    try:
        branches.b(x).tanh().sum().backward()
        out["late"] = None
    except hvd.HorovodError as e:
        out["late"] = str(e)
    # set_to_none=True: unarmed, today's exchange after backward.
    got = {}
    for arm in ("none", "hooked"):
        m = _mlp()
        ps = list(m.parameters())
        o = hvd.DistributedOptimizer(torch.optim.SGD(ps, lr=0.1),
                                     schedule="priority",
                                     fusion_threshold=THRESHOLD)
        for p in ps:
            p.grad = torch.zeros_like(p)
        for s in range(STEPS):
            o.zero_grad(set_to_none=arm == "none")
            _loss(m, _batch(rank, s)).backward()
            o.step()
        got[arm] = {"params": [p.detach().numpy().copy() for p in ps],
                    "hooks": o.hooks_fired}
    out["set_to_none"] = got
    # A Trainer program on the CPU: its schedule validated once, its
    # later (armed) calls under the recorded program.
    validated = []
    validate = multihost.validate_schedule

    def counting(*args, **kwargs):
        validated.append(args[0])
        return validate(*args, **kwargs)

    multihost.validate_schedule = counting
    try:
        m = _mlp()
        opt = hvd.DistributedOptimizer(training.SGD(list(m.parameters()),
                                                    0.1),
                                       schedule="priority",
                                       fusion_threshold=THRESHOLD)
        trainer = hvd.Trainer(m, _loss, opt)
        listings = []
        for s in range(STEPS):
            with wire.recording() as rec:
                trainer.train_step(_batch(rank, s))
            listings.append([(i.opcode, i.element_type, i.shape)
                             for i in rec.instrs])
    finally:
        multihost.validate_schedule = validate
    out["trainer"] = {"validated": len(validated),
                      # Each call's wire: the first (validated, unarmed)
                      # and the armed ones after it.
                      "listings": listings,
                      "trace_count": trainer._step.trace_count,
                      "hooks": opt.hooks_fired,
                      "in_backward": opt.buckets_in_backward,
                      "params": [p.detach().numpy().copy()
                                 for p in m.parameters()]}
    return out


def _local_grads() -> list:
    """This rank's local (unexchanged) gradients of step 0."""
    import horovod_tpu_torch as hvd

    model = _mlp()
    params = list(model.parameters())
    grads = torch.autograd.grad(_loss(model, _batch(hvd.rank(), 0)), params)
    return [g.numpy().copy() for g in grads]


def _averaged(schedule: str) -> list:
    """The averaged gradients of one armed, hooked step of the MLP."""
    import horovod_tpu_torch as hvd

    model = _mlp()
    params = list(model.parameters())
    opt = hvd.DistributedOptimizer(torch.optim.SGD(params, lr=0.1),
                                   schedule=schedule, fusion_threshold=0)
    for p in params:
        p.grad = torch.zeros_like(p)
    opt.zero_grad(set_to_none=False)
    _loss(model, _batch(hvd.rank(), 0)).backward()
    opt.synchronize()
    return [p.grad.numpy().copy() for p in params]


def _read_before_step(schedule: str) -> dict:
    """``.grad`` of one armed step read right after ``backward()``
    returns (hooked), and after ``synchronize()`` where no hook fired
    (unoverlapped)."""
    import horovod_tpu_torch as hvd

    out = {}
    for arm in ("hooked", "unoverlapped"):
        model = _mlp()
        params = list(model.parameters())
        opt = hvd.DistributedOptimizer(torch.optim.SGD(params, lr=0.1),
                                       schedule=schedule,
                                       fusion_threshold=THRESHOLD)
        for p in params:
            p.grad = torch.zeros_like(p)
        opt.zero_grad(set_to_none=False)
        loss = _loss(model, _batch(hvd.rank(), 0))
        if arm == "hooked":
            loss.backward()
        else:
            _accumulate(loss, params)
            opt.synchronize()
        out[arm] = [p.grad.numpy().copy() for p in params]
        opt.step()
    return out


def _world() -> dict:
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    out = {"cases": {name: {arm: _train(knobs, arm == "hooked")
                            for arm in ("hooked", "unoverlapped")}
                     for name, knobs in CASES.items()},
           "gate": {s: _gate(s) for s in ("enum", "priority")},
           "orders": _orders(),
           "edges": _edges(),
           "local": _local_grads(),
           "averaged": {s: _averaged(s) for s in ("enum", "priority")},
           "read": {s: _read_before_step(s) for s in ("enum", "priority")}}
    hvd.shutdown()
    return out


def _subset_world() -> dict:
    import horovod_tpu_torch as hvd

    hvd.init(SUBSET_GROUPS, device="cpu")
    out = {arm: _train({"schedule": "priority"}, arm == "hooked", group=1)
           for arm in ("hooked", "unoverlapped")}
    hvd.shutdown()
    return out


@pytest.fixture(scope="module")
def world():
    from horovod_tpu_torch.run import run

    return run(_world, WORLD, device="cpu", timeout=240)


@pytest.fixture(scope="module")
def subset_world():
    from horovod_tpu_torch.run import run

    return run(_subset_world, len(SUBSET_GROUPS[0]), device="cpu",
               timeout=240)


def _equal(a: dict, b: dict) -> None:
    for key in ("params", "residual"):
        assert len(a[key]) == len(b[key])
        for x, y in zip(a[key], b[key]):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_hooked_step_equals_the_unoverlapped_step(world, case):
    for r in world:
        got = r["cases"][case]
        _equal(got["hooked"], got["unoverlapped"])
        # Every parameter's hook fired in each step; no hook fired in the
        # unoverlapped arm, whose buckets all went out in step().
        assert got["hooked"]["hooks"] == STEPS * 2 * LAYERS
        assert got["hooked"]["in_backward"] > 0
        assert got["unoverlapped"]["hooks"] == 0
        if CASES[case].get("error_feedback"):
            assert any(np.any(x != 0) for x in got["hooked"]["residual"])
    for a, b in zip(world[0]["cases"][case]["hooked"]["params"],
                    world[1]["cases"][case]["hooked"]["params"]):
        np.testing.assert_array_equal(a, b)


def test_a_subset_groups_hooked_step_equals_the_unoverlapped_step(
        subset_world):
    for rank, r in enumerate(subset_world):
        _equal(r["hooked"], r["unoverlapped"])
        member = rank in SUBSET_GROUPS[1]
        # Only the group's members arm: the others exchange nothing.
        assert (r["hooked"]["hooks"] > 0) == member
    np.testing.assert_array_equal(subset_world[1]["hooked"]["params"][0],
                                  subset_world[2]["hooked"]["params"][0])


@pytest.mark.parametrize("schedule", ["enum", "priority"])
def test_the_overlapped_average_equals_jax(world, schedule):
    import jax

    import horovod_tpu as jhvd

    stacked = [np.stack([r["local"][k] for r in world])
               for k in range(len(world[0]["local"]))]
    jhvd.shutdown()
    jhvd.init(devices=jax.devices()[:WORLD])
    try:
        want = jhvd.spmd(lambda *gs: jhvd.allreduce_gradients(
            list(gs), fusion_threshold=0, schedule=schedule))(*stacked)
        want = [np.asarray(t) for t in want]
    finally:
        jhvd.shutdown()
    for rank, r in enumerate(world):
        for got, w in zip(r["averaged"][schedule], want):
            w = w[rank]
            scale = float(np.max(np.abs(w))) or 1.0
            np.testing.assert_allclose(got, w, rtol=TOL, atol=TOL * scale)


def test_priority_issues_a_bucket_before_backward_ends(world):
    for r in world:
        g = r["gate"]["priority"]
        assert g["calls"] == g["buckets"] == 2 * LAYERS
        # The first bucket's wire call came before the last hook fired...
        assert g["seen"][-1] > 0, g
        # ...and a hook fired between two bucket calls.
        assert any(0 < n < g["calls"] for n in g["seen"]), g


def test_enum_issues_every_bucket_after_the_last_hook(world):
    for r in world:
        g = r["gate"]["enum"]
        assert g["calls"] == g["buckets"] == 2 * LAYERS
        assert g["seen"] == [0] * (2 * LAYERS), g


def test_every_rank_issues_the_plans_order_whatever_the_hook_order(world):
    orders = [r["orders"] for r in world]
    # The hooks fired in different orders on the two ranks...
    assert orders[0]["fired"] != orders[1]["fired"]
    assert sorted(orders[0]["fired"]) == sorted(orders[1]["fired"])
    # ...and the wire carried the plan's order on both.
    for o in orders:
        assert o["listing"] == o["plan"]
        assert o["findings"] == []
        assert o["in_backward"] > 0
    assert orders[0]["listing"] == orders[1]["listing"]


def test_an_unused_parameter_is_still_reduced_at_step(world):
    for r in world:
        got = r["edges"]["unused"]
        assert got["armed"]
        np.testing.assert_array_equal(
            got["grad"], np.full(5, (1.0 + 2.0) / WORLD, np.float32))


def test_a_second_backward_before_step_raises(world):
    for r in world:
        text = r["edges"]["twice"]
        assert text is not None
        assert "accumulated twice since zero_grad()" in text
        assert "Call step() (or synchronize()) between backward passes" \
            in text


def test_a_backward_after_the_exchange_finished_raises(world):
    for r in world:
        text = r["edges"]["late"]
        assert text is not None
        assert "accumulated after the backward pass that finished the " \
               "exchange" in text
        assert "Call step() (or synchronize()) between backward passes" \
            in text


@pytest.mark.parametrize("schedule", ["enum", "priority"])
def test_grad_is_averaged_when_backward_returns(world, schedule):
    for r in world:
        got = r["read"][schedule]
        for a, b in zip(got["hooked"], got["unoverlapped"]):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(world[0]["read"][schedule]["hooked"],
                    world[1]["read"][schedule]["hooked"]):
        np.testing.assert_array_equal(a, b)


def test_set_to_none_stays_unarmed_and_equals_the_hooked_step(world):
    for r in world:
        got = r["edges"]["set_to_none"]
        assert got["none"]["hooks"] == 0
        assert got["hooked"]["hooks"] == STEPS * 2 * LAYERS
        for a, b in zip(got["none"]["params"], got["hooked"]["params"]):
            np.testing.assert_array_equal(a, b)


def test_a_cpu_trainer_program_validates_its_schedule_once(world):
    for r in world:
        got = r["edges"]["trainer"]
        assert got["validated"] == 1 and got["trace_count"] == 1
        # The first call has no .grad to arm on; the two later ones do.
        assert got["hooks"] == (STEPS - 1) * 2 * LAYERS
        assert got["in_backward"] > 0
        # The armed calls put the validated call's rows on the wire, in
        # its order.
        assert got["listings"][0]
        assert all(x == got["listings"][0] for x in got["listings"][1:])
    for a, b in zip(world[0]["edges"]["trainer"]["params"],
                    world[1]["edges"]["trainer"]["params"]):
        np.testing.assert_array_equal(a, b)


def test_the_tools_cpu_drill_has_equal_crcs():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HOROVOD_")}
    proc = subprocess.run(
        [sys.executable, str(REPO / "tools" / "overlap_torch.py"),
         "--device", "cpu", "--ranks", "2", "--smoke"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["crc_equal"] == {f"{m}/{p}": True
                                 for m in ("lm", "resnet50")
                                 for p in ("enum", "priority")}
    for key, pair in last["rows"].items():
        assert pair["overlapped"]["hooks"] > 0, key
        assert pair["unoverlapped"]["hooks"] == 0, key
        assert pair["unarmed"]["hooks"] == 0, key
