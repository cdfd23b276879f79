"""The sharded modes' exchange overlapped with compute
(``parallel/sharded.py`` on ``parallel/overlap.py``'s mechanism) and the
group families' buckets armed (``parallel/optimizer.py``), in one spawned
4-rank gloo world at ``HOROVOD_TOPOLOGY_SLICES=2`` (fsdp 2 × data 2, so
each reduce-scatter is followed by the cross-data all-reduce), as the
goldens run it, with ``hvd.init([[0, 1], [2, 3]])``: groups 1 and 2 are
two 2-rank groups, so the family ``(1, 2)`` covers the world and ``(1,)``
leaves ranks 2 and 3 in none of its groups.

* Bit for bit: 3 steps of ``Trainer(sharding="zero2"|"zero3")`` (armed
  from the second call: ZeRO-2's and ZeRO-3's reduce-scatters issued by
  post-accumulate-grad hooks, ZeRO-3's gathers left in flight and waited
  for at their reads) equal the same steps unarmed (``zero_grad(
  set_to_none=True)``), losses, shards and parameters, under none, bf16
  and int8_block.
* Against the JAX package: 2 steps (the second armed) of zero2 and zero3
  on integer-valued gradients, which backward yields exactly (the loss is
  ``Σ sum(p_i · g_i)``), equal ``sharded_zero2_optimizer``'s and
  ``Zero3Optimizer``'s over 4 CPU devices on the same inputs, bit for bit
  (as ``tests/test_torch_fsdp.py`` holds the unarmed step), uncompressed
  and under bf16.
* The wire order: rank 1 runs two branches' forwards in the other order,
  so its hooks fire in another order; every rank's recorded listing is
  the unarmed listing with the tensors' reduce rows in reverse gather
  order, the same on every rank, and verifies with no finding.
* The waits: each parameter's gather of an armed zero3 step is waited for
  exactly once, none before the forward (the root's forward pre-hook
  sees none), and a parameter the root holds and reads last (as the LM's
  ``lm_head``) only at its read, after the last block's forward. The
  gathers are asynchronous gloo calls, so a read before its wait could
  see the buffer unwritten.
* A second backward before ``step()`` raises the replicated path's text;
  ZeRO-1 stays unarmed (no hook) and equals the step that zeroes with
  ``set_to_none=True``.
* Families: ``DistributedOptimizer(group=(1, 2))`` and ``(1,)`` armed
  equal their unarmed steps bit for bit (a rank in no family keeps its
  values), and an armed step's averaged gradients equal JAX's
  ``allreduce_gradients`` with the same family.
* ``tools/overlap_torch.py --device cpu --smoke --sharding zero2,zero3``
  ends with equal CRCs in each arm pair.

The spawned children import this module, so JAX is imported only inside
the parent-side functions.
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
WORLD = 4
GROUPS = [[0, 1], [2, 3]]
FAMILIES = {"cover": (1, 2), "partial": (1,)}
STEPS = 3
JAX_STEPS = 2
WIDTH = 8
COMPS = (None, "bf16", "int8_block")
MODES = ("zero2", "zero3")
SHAPES = ((40,), (8,), (12,), (6, 5))    # tests/test_torch_fsdp.py's
JAX_LR = 0.5
NAMES = [f"DistributedOptimizer.grads.{i}" for i in range(len(SHAPES))]


class _Net(torch.nn.Module):
    """The root holds ``inp`` (read first) and ``head`` (enumerated second,
    read last, as the LM's ``lm_head``); two blocks between them."""

    def __init__(self) -> None:
        super().__init__()
        rng = np.random.RandomState(0)
        self.inp = torch.nn.Parameter(torch.from_numpy(
            rng.randn(6, WIDTH).astype(np.float32) * 0.5))
        self.blocks = torch.nn.ModuleList(
            torch.nn.Linear(WIDTH, WIDTH) for _ in range(2))
        self.head = torch.nn.Parameter(torch.from_numpy(
            rng.randn(WIDTH, 5).astype(np.float32) * 0.5))
        with torch.no_grad():
            for b in self.blocks:
                b.weight.copy_(torch.from_numpy(
                    rng.randn(WIDTH, WIDTH).astype(np.float32) * 0.5))
                b.bias.copy_(torch.from_numpy(
                    rng.randn(WIDTH).astype(np.float32) * 0.1))

    def forward(self, x):
        h = torch.tanh(x @ self.inp)
        for b in self.blocks:
            h = torch.tanh(b(h))
        return h @ self.head


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

    def forward(self, x, swap: bool = False):
        if swap:
            yb = self.b(x).tanh()
            ya = self.a(x).tanh()
        else:
            ya = self.a(x).tanh()
            yb = self.b(x).tanh()
        return ya.sum() * yb.sum()


def _loss(model, x):
    return model(x).pow(2).mean()


def _batch(rank: int, step: int, cols: int = 6) -> torch.Tensor:
    rng = np.random.RandomState(100 + 10 * rank + step)
    return torch.from_numpy(rng.randn(4, cols).astype(np.float32))


def _jax_grads(step: int):
    """Per tensor, the (WORLD, *shape) integer-valued gradients."""
    rng = np.random.RandomState(10 + step)
    return [rng.randint(-5, 6, (WORLD,) + s).astype(np.float32)
            for s in SHAPES]


def _jax_params():
    rng = np.random.RandomState(9)
    return [rng.randint(-5, 6, s).astype(np.float32) for s in SHAPES]


# -- the port's world ---------------------------------------------------------


def unarmed(trainer):
    """``trainer``'s step zeroed with ``set_to_none=True``, which arms
    nothing: the step exchanges after backward, as before the overlap."""
    import horovod_tpu_torch as hvd

    opt, model = trainer.optimizer, trainer.model

    def step(x):
        opt.zero_grad(set_to_none=True)
        if trainer.sharding == "zero3":
            full = opt.gather_params()
            with opt.swapped(model, full):
                loss = trainer.loss_fn(model, x)
                loss.backward()
            opt.apply_gradients([t.grad for t in full])
        else:
            loss = trainer.loss_fn(model, x)
            loss.backward()
            opt.step()
        return loss.detach()

    return hvd.spmd(step)


def _trainer(mode: str, comp, model=None, lr=0.1):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.training import loop

    model = _Net() if model is None else model
    params = list(model.parameters())
    opt = hvd.DistributedOptimizer(loop.SGD(params, lr, momentum=0.9),
                                   sharding=mode, compression=comp,
                                   params=params)
    return hvd.Trainer(model, _loss, opt, sharding=mode)


def _arms(rank: int, mode: str, comp) -> dict:
    out = {}
    for arm in ("armed", "unarmed"):
        tr = _trainer(mode, comp)
        run = ((lambda x, tr=tr: tr.train_step(x)[0]) if arm == "armed"
               else unarmed(tr))
        losses = [run(_batch(rank, s)).numpy().copy() for s in range(STEPS)]
        opt = tr.optimizer
        out[arm] = {
            "losses": losses,
            "shards": [s.detach().numpy().copy() for s in opt.shards],
            "params": [p.detach().numpy().copy()
                       for p in tr.model.parameters()],
            "hooks": opt.hooks_fired, "in_backward": opt.buckets_in_backward,
            "waits": getattr(opt, "gather_waits", None),
            "leaves": len(opt.shards)}
    return out


def _holder(params):
    holder = torch.nn.Module()
    for i, p in enumerate(params):
        holder.register_parameter(f"p{i}", p)
    return holder


def _against_jax(rank: int, mode: str, comp) -> dict:
    """JAX_STEPS steps (the first unarmed, then armed) on the integer
    gradients, which backward yields exactly: the final parameters
    (zero2) or shards (zero3)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.training import loop

    params = [torch.nn.Parameter(torch.from_numpy(p.copy()))
              for p in _jax_params()]
    holder = _holder(params)
    opt = hvd.DistributedOptimizer(loop.SGD(params, JAX_LR),
                                   sharding=mode, compression=comp)
    if mode == "zero2":
        def step(*gs):
            opt.zero_grad(set_to_none=False)
            sum((p * g).sum() for p, g in zip(params, gs)).backward()
            opt.step()
            return [p.detach().clone() for p in params]
    else:
        opt.bind(holder)
        opt.init(opt.init_shards())

        def step(*gs):
            opt.zero_grad(set_to_none=False)
            full = opt.gather_params()
            with opt.swapped(holder, full):
                sum((getattr(holder, f"p{i}") * g).sum()
                    for i, g in enumerate(gs)).backward()
            return [s.clone()
                    for s in opt.apply_gradients([t.grad for t in full])]
    prog = hvd.spmd(step)
    for s in range(JAX_STEPS):
        values = prog(*[torch.from_numpy(g[rank].copy())
                        for g in _jax_grads(s)])
    return {"values": [t.numpy() for t in values],
            "hooks": opt.hooks_fired}


def _listing(rec) -> list:
    return [(i.opcode, i.element_type, i.shape) for i in rec.instrs]


def _orders(rank: int, mode: str) -> dict:
    """One unarmed and one armed step of ``_Branches`` (rank 1 swaps its
    branches), each step's wire recorded, and the order the armed step's
    hooks fired in."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.analysis import schedule
    from horovod_tpu_torch.training import loop
    from horovod_tpu_torch.ops import wire

    model = _Branches()
    params = list(model.parameters())
    names = {id(p): n for n, p in model.named_parameters()}
    fired: list = []
    opt = hvd.DistributedOptimizer(loop.SGD(params, 0.1), sharding=mode)
    if mode == "zero3":
        opt.bind(model)
        opt.init(opt.init_shards())
    swap = rank == 1
    x = _batch(rank, 0, cols=WIDTH)

    def step(x):
        opt.zero_grad(set_to_none=False)
        if mode == "zero2":
            model(x, swap).backward()
            opt.step()
            return
        full = opt.gather_params()
        for t, n in zip(full, names.values()):
            t.register_post_accumulate_grad_hook(
                lambda t, n=n: fired.append(n))
        with opt.swapped(model, full):
            model(x, swap).backward()
        opt.apply_gradients([t.grad for t in full])

    if mode == "zero2":
        for p in params:
            p.register_post_accumulate_grad_hook(
                lambda p: fired.append(names[id(p)]))
    prog = hvd.spmd(step)
    listings = []
    for _ in range(2):      # the unarmed first call, then the armed one
        fired.clear()
        with wire.recording() as rec:
            prog(x)
        listings.append(rec)
    return {"fired": list(fired),
            "unarmed": _listing(listings[0]), "armed": _listing(listings[1]),
            "findings": [str(f) for f in schedule.verify_listings(
                schedule.gather_listings(listings[1].instrs), slices=2,
                sharding=mode, fsdp_size=WORLD // 2)],
            "hooks": opt.hooks_fired, "leaves": len(params)}


def _waits(rank: int) -> dict:
    """An armed zero3 step of ``_Net``: the waits each parameter's gather
    took, what the root's forward pre-hook and the last block's forward
    hook saw, and the order of the waits."""
    tr = _trainer("zero3", None)
    opt, model = tr.optimizer, tr.model
    seen = {}

    def snap(key):
        def hook(*_):
            if opt.gathers is not None and opt._full is not None:
                seen[key] = list(opt.gathers.waits)
        return hook

    model.register_forward_pre_hook(snap("root_pre"))
    model.blocks[-1].register_forward_hook(snap("last_block"))
    tr.train_step(_batch(rank, 0))
    tr.train_step(_batch(rank, 1))
    names = [n for n, _ in model.named_parameters()]
    return {"seen": seen, "waits": list(opt.gathers.waits),
            "order": [names[i] for i in opt.gathers.order],
            "total": opt.gather_waits, "names": names}


def _twice(rank: int, mode: str) -> str | None:
    """A second backward before ``step()`` in an armed step."""
    import horovod_tpu_torch as hvd

    tr = _trainer(mode, None)
    opt, model = tr.optimizer, tr.model
    tr.train_step(_batch(rank, 0))      # the unarmed first call
    failed = []

    def step(x):
        opt.zero_grad(set_to_none=False)
        if mode == "zero2":
            _loss(model, x).backward()
            try:
                _loss(model, x).backward()
            except hvd.HorovodError as e:
                failed.append(str(e))
            opt.step()
            return
        full = opt.gather_params()
        with opt.swapped(model, full):
            loss = _loss(model, x)
            loss.backward(retain_graph=True)
            try:
                loss.backward()
            except hvd.HorovodError as e:
                failed.append(str(e))
        opt.apply_gradients([t.grad for t in full])

    hvd.spmd(step)(_batch(rank, 1))
    return failed[0] if failed else None


def _zero1(rank: int) -> dict:
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.training import loop

    out = {}
    for arm in ("trainer", "set_to_none"):
        model = _Net()
        opt = hvd.DistributedOptimizer(
            loop.SGD(list(model.parameters()), 0.1, momentum=0.9),
            sharded=True)
        tr = hvd.Trainer(model, _loss, opt)
        if arm == "trainer":
            run = lambda x, tr=tr: tr.train_step(x)[0]   # noqa: E731
        else:
            def step(x, model=model, opt=opt):
                opt.zero_grad(set_to_none=True)
                loss = _loss(model, x)
                loss.backward()
                opt.step()
                return loss.detach()
            run = hvd.spmd(step)
        losses = [run(_batch(rank, s)).numpy().copy() for s in range(STEPS)]
        out[arm] = {"losses": losses, "hooks": opt.hooks_fired,
                    "armed": opt._armed is not None,
                    "params": [p.detach().numpy().copy()
                               for p in model.parameters()]}
    return out


def _mlp():
    rng = np.random.RandomState(0)
    mods = []
    for _ in range(3):
        lin = torch.nn.Linear(WIDTH, WIDTH)
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(
                rng.randn(WIDTH, WIDTH).astype(np.float32) * 0.5))
            lin.bias.copy_(torch.from_numpy(
                rng.randn(WIDTH).astype(np.float32) * 0.1))
        mods += [lin, torch.nn.Tanh()]
    return torch.nn.Sequential(*mods)


def _family(rank: int, family) -> dict:
    """3 steps of ``DistributedOptimizer(group=family)`` armed (every step
    zeroed with ``set_to_none=False``, the first one too: every parameter
    holds a zeroed ``.grad``) and unarmed; then one armed step's averaged
    gradients and this rank's local ones."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.training import loop

    out = {}
    for arm in ("armed", "unarmed"):
        model = _mlp()
        params = list(model.parameters())
        opt = hvd.DistributedOptimizer(loop.SGD(params, 0.1, momentum=0.9),
                                       group=family, fusion_threshold=300)
        for p in params:
            p.grad = torch.zeros_like(p)

        def step(x, model=model, opt=opt, arm=arm):
            opt.zero_grad(set_to_none=arm == "unarmed")
            loss = _loss(model, x)
            loss.backward()
            opt.step()
            return loss.detach()

        prog = hvd.spmd(step)
        for s in range(STEPS):
            prog(_batch(rank, s, cols=WIDTH))
        out[arm] = {"params": [p.detach().numpy().copy() for p in params],
                    "hooks": opt.hooks_fired,
                    "in_backward": opt.buckets_in_backward}
    model = _mlp()
    params = list(model.parameters())
    x = _batch(rank, 0, cols=WIDTH)
    out["local"] = [g.numpy().copy() for g in torch.autograd.grad(
        _loss(model, x), params)]
    opt = hvd.DistributedOptimizer(loop.SGD(params, 0.1), group=family,
                                   fusion_threshold=0)
    for p in params:
        p.grad = torch.zeros_like(p)

    def averaged(x):
        opt.zero_grad(set_to_none=False)
        _loss(model, x).backward()
        opt.synchronize()
        return [p.grad.clone() for p in params]

    out["averaged"] = [t.numpy() for t in hvd.spmd(averaged)(x)]
    out["averaged_hooks"] = opt.hooks_fired
    return out


def _world() -> dict:
    os.environ["HOROVOD_TOPOLOGY_SLICES"] = "2"
    import horovod_tpu_torch as hvd

    hvd.init(GROUPS, device="cpu")
    r = hvd.rank()
    out = {
        "arms": {(m, c): _arms(r, m, c) for m in MODES for c in COMPS},
        "jax": {(m, c): _against_jax(r, m, c)
                for m in MODES for c in (None, "bf16")},
        "orders": {m: _orders(r, m) for m in MODES},
        "waits": _waits(r),
        "twice": {m: _twice(r, m) for m in MODES},
        "zero1": _zero1(r),
        "family": {k: _family(r, f) for k, f in FAMILIES.items()},
    }
    hvd.shutdown()
    return out


@pytest.fixture(scope="module")
def world():
    from horovod_tpu_torch.run import run

    return run(_world, WORLD, device="cpu", timeout=300)


# -- the JAX side -------------------------------------------------------------


@pytest.fixture(scope="module")
def jhvd():
    import jax

    import horovod_tpu as jhvd

    mp = pytest.MonkeyPatch()
    mp.setenv("HOROVOD_TOPOLOGY_SLICES", "2")
    jhvd.shutdown()
    jhvd.init(GROUPS, devices=jax.devices()[:WORLD])
    yield jhvd
    jhvd.shutdown()
    mp.undo()


@pytest.fixture(scope="module")
def jax_sharded(jhvd):
    """JAX_STEPS steps of the JAX package's zero2 and zero3 on the same
    gradients: the final parameters (zero2) or shards (zero3), stacked
    over the ranks."""
    import jax.numpy as jnp
    import optax

    hvd = jhvd
    p0 = dict(zip(NAMES, _jax_params()))
    out = {}
    for comp in (None, "bf16"):
        opt2 = hvd.DistributedOptimizer(optax.sgd(JAX_LR), sharding="zero2",
                                        compression=comp)
        s2 = opt2.init(p0)

        @hvd.spmd
        def step2(g, p, opt2=opt2, s2=s2):
            new, _ = opt2.update(g, s2, p, fsdp_apply=True)
            return new

        p = hvd.replicate(p0)
        for s in range(JAX_STEPS):
            p = step2(dict(zip(NAMES, _jax_grads(s))), p)
        out[("zero2", comp)] = [np.asarray(p[n]) for n in NAMES]
        opt3 = hvd.DistributedOptimizer(optax.sgd(JAX_LR), sharding="zero3",
                                        compression=comp)
        opt3.bind(p0)
        sh = opt3.init_shards(p0)
        s3 = opt3.init({n: jnp.asarray(v[0]) for n, v in sh.items()})

        @hvd.spmd
        def step3(g, sh, opt3=opt3, s3=s3):
            opt3.gather_params(sh)
            new, _ = opt3.apply_gradients(g, s3, sh)
            return new

        for s in range(JAX_STEPS):
            sh = step3(dict(zip(NAMES, _jax_grads(s))), sh)
        out[("zero3", comp)] = [np.asarray(sh[n]) for n in NAMES]
    return out


@pytest.fixture(scope="module")
def jax_family(jhvd, world):
    """JAX's ``allreduce_gradients`` over each family, on the port's local
    gradients of the family step."""
    out = {}
    for key, family in FAMILIES.items():
        local = [r["family"][key]["local"] for r in world]
        stacked = [np.stack([lo[k] for lo in local])
                   for k in range(len(local[0]))]
        got = jhvd.spmd(lambda *gs, family=family: jhvd.allreduce_gradients(
            list(gs), group=family, fusion_threshold=0))(*stacked)
        out[key] = [np.asarray(t) for t in got]
    return out


# -- the tests -----------------------------------------------------------------


def _equal(a: list, b: list) -> None:
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("comp", COMPS, ids=str)
@pytest.mark.parametrize("mode", MODES)
def test_the_armed_step_equals_the_unarmed_step(world, mode, comp):
    for r in world:
        got = r["arms"][(mode, comp)]
        a, u = got["armed"], got["unarmed"]
        for key in ("losses", "shards", "params"):
            _equal(a[key], u[key])
        # The first call has nothing to arm on; each later one takes one
        # hook a parameter and issues reduce-scatters from backward.
        assert a["hooks"] == (STEPS - 1) * a["leaves"]
        assert a["in_backward"] > 0
        assert u["hooks"] == 0
        if mode == "zero3":
            assert a["waits"] == (STEPS - 1) * a["leaves"]
            assert u["waits"] == 0
    # Every rank ends with the same parameters (zero3's are released).
    _equal(world[0]["arms"][(mode, comp)]["armed"]["params"],
           world[3]["arms"][(mode, comp)]["armed"]["params"])


@pytest.mark.parametrize("comp", (None, "bf16"), ids=str)
@pytest.mark.parametrize("mode", MODES)
def test_the_armed_step_equals_jax(world, jax_sharded, mode, comp):
    want = jax_sharded[(mode, comp)]
    for rank, r in enumerate(world):
        got = r["jax"][(mode, comp)]
        assert got["hooks"] == len(SHAPES)
        for a, b in zip(got["values"], want):
            np.testing.assert_array_equal(a, b[rank])


@pytest.mark.parametrize("mode", MODES)
def test_reduce_scatters_go_in_reverse_gather_order_on_every_rank(world,
                                                                  mode):
    orders = [r["orders"][mode] for r in world]
    # The hooks fired in different orders on ranks 0 and 1...
    assert orders[0]["fired"] != orders[1]["fired"]
    assert sorted(orders[0]["fired"]) == sorted(orders[1]["fired"])
    # ...and the wire carried one order on every rank: the unarmed
    # step's rows, each tensor's reduce-scatter and cross-data all-reduce
    # in reverse gather order.
    unarmed = orders[0]["unarmed"]
    gathers = [row for row in unarmed if row[0] == "all-gather"]
    reduces = [row for row in unarmed if row[0] != "all-gather"]
    assert [row[0] for row in reduces] == (
        ["reduce-scatter", "all-reduce"] * orders[0]["leaves"])
    pairs = [reduces[i:i + 2] for i in range(0, len(reduces), 2)]
    back = [row for pair in reversed(pairs) for row in pair]
    want = gathers + back if mode == "zero3" else back + gathers
    for o in orders:
        assert o["unarmed"] == unarmed
        assert o["armed"] == want
        assert o["findings"] == []
        assert o["hooks"] == o["leaves"]


def test_each_gather_is_waited_for_once_at_its_first_read(world):
    for r in world:
        w = r["waits"]
        n = len(w["names"])
        assert w["waits"] == [1] * n
        assert w["total"] == n
        head = w["names"].index("head")
        # Nothing is waited for before the forward...
        assert w["seen"]["root_pre"] == [0] * n
        # ...the blocks' parameters by the last block's end, and the head,
        # held by the root, enumerated second and read last, only then.
        last = w["seen"]["last_block"]
        assert last[head] == 0
        assert [v for i, v in enumerate(last) if i != head] == [1] * (n - 1)
        assert w["order"][0] == "inp" and w["order"][-1] == "head"


@pytest.mark.parametrize("mode", MODES)
def test_a_second_backward_before_step_raises(world, mode):
    for r in world:
        text = r["twice"][mode]
        assert text is not None
        assert "accumulated twice since zero_grad()" in text
        assert "Call step() (or synchronize()) between backward passes" \
            in text


def test_zero1_stays_unarmed_and_equals_the_set_to_none_step(world):
    for r in world:
        z = r["zero1"]
        assert z["trainer"]["hooks"] == z["set_to_none"]["hooks"] == 0
        assert not z["trainer"]["armed"]
        _equal(z["trainer"]["losses"], z["set_to_none"]["losses"])
        _equal(z["trainer"]["params"], z["set_to_none"]["params"])


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_an_armed_family_step_equals_the_unarmed_one(world, family):
    for rank, r in enumerate(world):
        got = r["family"][family]
        _equal(got["armed"]["params"], got["unarmed"]["params"])
        assert got["unarmed"]["hooks"] == 0
        # 6 tensors a step, every step armed.
        assert got["armed"]["hooks"] == STEPS * 6
        assert got["averaged_hooks"] == 6
        if any(rank in GROUPS[g - 1] for g in FAMILIES[family]):
            assert got["armed"]["in_backward"] > 0
    # The two members of group 1 end equal.
    _equal(world[0]["family"][family]["armed"]["params"],
           world[1]["family"][family]["armed"]["params"])


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_an_armed_family_average_equals_jax(world, jax_family, family):
    want = jax_family[family]
    for rank, r in enumerate(world):
        got = r["family"][family]
        member = any(rank in GROUPS[g - 1] for g in FAMILIES[family])
        for a, w, lo in zip(got["averaged"], want, got["local"]):
            np.testing.assert_array_equal(a, w[rank])
            if not member:
                np.testing.assert_array_equal(a, lo)


def test_the_tools_sharded_cpu_drill_has_equal_crcs():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HOROVOD_")}
    proc = subprocess.run(
        [sys.executable, str(REPO / "tools" / "overlap_torch.py"),
         "--device", "cpu", "--ranks", "2", "--smoke", "--models", "lm",
         "--sharding", "zero2,zero3"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["crc_equal"] == {"lm/zero2": True, "lm/zero3": True}
    for key, pair in last["rows"].items():
        assert pair["overlapped"]["hooks"] > 0, key
        assert pair["unarmed"]["hooks"] == 0, key
