"""Port parity: ZeRO-1/2/3 (``parallel/sharded.py``), the ``data × fsdp``
mesh (``ops/mesh.py``), the FSDP lowerings (``ops/strategy.py``),
``Trainer(sharded=, sharding=)`` and the sharded checkpoint convention
(``training/checkpoint.py``), against ``horovod_tpu``'s.

Pure cases (no world): the mesh's partitions, indices and padding, the
knobs' parsing and ``hvd.init`` checks, and the zero3 plan of the LM that
``chip_smoke.py`` phase 18 pins, against the JAX package's.

One spawned 4-rank gloo world (module-scoped) runs the rest, first under
``HOROVOD_TOPOLOGY_SLICES=2`` (fsdp 2 × data 2, the default multi-host
layout) and then re-discovering the topology under ``=1`` (fsdp 4 × data
1) in the same world; group 1 is ranks 0 and 1 (a power of two, as in
the reference's subset test, so the average divides exactly). The JAX side runs the same
per-rank numpy inputs over 4 CPU devices (``jhvd.init([[0, 1]],
devices=jax.devices()[:4])``, the same env), the stochastic formats fed the
same rounding noise (``tests/torch_wire_support.py``):

* ``lower_fsdp_grad_exchange`` under none, bf16, int8 and int8_block and
  ``lower_fsdp_param_gather``, in both layouts: integer-valued data, bit
  for bit;
* ZeRO-1 on integer-valued gradients (3 steps of SGD(0.25, momentum 0.5)):
  the port's sharded path equals its unsharded path and JAX's
  ``sharded_optimizer``, bit for bit, on the whole group and on the subset
  group (whose non-member holds still) and with a bf16 wire; on random
  gradients sharded and
  unsharded agree within the ring tolerance (3 roundings of Σ|x|); the
  optimizer state is 1/n;
* the 3-step tiny LM of ``tests/test_fsdp.py`` (plain SGD): the port's
  ``off`` (rs_ag or hierarchical, per-tensor buckets), ``zero2`` and
  ``zero3`` losses bit-identical in both layouts, and within ``LM_TOL`` of
  JAX's (XLA and ATen round fp32 matmuls differently);
* bytes held per rank: zero2's state and zero3's parameters plus state at
  most 1/F of the replicated bytes plus the padding slack;
* the live plans of zero2 and zero3 steps: JSON and hash equal to JAX's;
* every refusal of the reference's ``TestRefusals``, text for text;
* ``save_sharded``/``load_sharded``: a zero3 state round trip, a torn
  newest shard falling back one epoch, and both agreement errors.

The spawned children import this module, so JAX is imported only inside
the parent-side functions.
"""

import os
import warnings

import numpy as np
import pytest
import torch

from torch_wire_support import WORLD, install_port_noise, jax_noise

COMPS = (None, "bf16", "int8", "int8_block")
LAYOUTS = ("2", "1")               # HOROVOD_TOPOLOGY_SLICES
EXCHANGE_SHAPES = ((7, 9), (300,), (513,))
ZERO1_SHAPES = {"b1": (3,), "w1": (5, 3), "w2": (3, 2)}   # JAX's leaf order
ZERO1_STEPS = 3
LM_ARCH = dict(vocab_size=97, num_layers=1, num_heads=2, embed_dim=16,
               mlp_dim=32, max_seq_len=16)
LM_STEPS = 3
# Port against JAX on the LM's fp32 losses: the two frameworks round the
# matmuls and the softmax differently (at most 6.3e-7 relative after 3
# steps); the port's own arms are held bit for bit.
LM_TOL = 1e-5
PLAN_SHAPES = ((40,), (8,), (12,), (6, 5))
ARMS = ("off", "zero2", "zero3")


def _int_data(seed, shape, lo=-20, hi=21):
    return np.random.RandomState(seed).randint(lo, hi, shape).astype(
        np.float32)


def _zero1_params():
    rng = np.random.RandomState(5)
    return {k: (rng.randint(-8, 9, s) / 4).astype(np.float32)
            for k, s in ZERO1_SHAPES.items()}


def _zero1_grads(kind="int"):
    """Per step, per leaf, the (WORLD, *shape) gradients."""
    rng = np.random.RandomState(6 if kind == "int" else 7)
    if kind == "int":
        return [{k: rng.randint(-3, 4, (WORLD,) + s).astype(np.float32) * 3
                 for k, s in ZERO1_SHAPES.items()}
                for _ in range(ZERO1_STEPS)]
    return [{k: rng.randn(WORLD, *s).astype(np.float32)
             for k, s in ZERO1_SHAPES.items()} for _ in range(ZERO1_STEPS)]


def _lm_tokens():
    return np.random.RandomState(7).randint(
        0, LM_ARCH["vocab_size"], size=(WORLD, 2, 16)).astype(np.int32)


def _plan_leaves():
    rng = np.random.RandomState(9)
    return [rng.randint(-5, 6, s).astype(np.float32) for s in PLAN_SHAPES]


def _plan_grads():
    rng = np.random.RandomState(10)
    return [rng.randint(-5, 6, (WORLD,) + s).astype(np.float32)
            for s in PLAN_SHAPES]


# -- the port's world ---------------------------------------------------------


def _message(fn):
    import horovod_tpu_torch as hvd

    try:
        fn()
    except (hvd.HorovodError, NotImplementedError, ValueError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def _slices(n: str):
    os.environ["HOROVOD_TOPOLOGY_SLICES"] = n


def _port_exchange(hvd, r, fed):
    from horovod_tpu_torch.core import state
    from horovod_tpu_torch.ops import compression, mesh, strategy, topology

    g = state.get_group(0)
    out = {}
    for layout in LAYOUTS:
        _slices(layout)
        topo = topology.discover(g)
        fmesh = mesh.fsdp_mesh(0)
        xs = [torch.from_numpy(_int_data(31 + i, (WORLD,) + s)[r])
              for i, s in enumerate(EXCHANGE_SHAPES)]

        def prog(*xs):
            fed.reset()
            res = []
            for comp in COMPS:
                c = compression.active(comp or "none")
                for i, x in enumerate(xs):
                    res.append(strategy.lower_fsdp_grad_exchange(
                        x, fmesh, f"x{i}", c, None, g, topo)[0])
            for i, x in enumerate(xs):
                flat, _ = strategy._flatten_pad(x, fmesh.fsdp_size)
                shard = flat.reshape(fmesh.fsdp_size, -1)[
                    fmesh.fsdp_index(r)]
                res.append(strategy.lower_fsdp_param_gather(
                    shard, fmesh, f"x{i}", g, topo))
            return res

        out[layout] = {"mesh": fmesh, "grid": fmesh.grid(0), "values": [
            t.numpy() for t in hvd.spmd(prog)(*xs)]}
    _slices("2")
    return out


def _zero1_run(hvd, r, sharded, grads, group=0, steps=ZERO1_STEPS,
               compression=None):
    from horovod_tpu_torch.training import loop

    p0 = _zero1_params()
    params = [torch.nn.Parameter(torch.from_numpy(p0[k].copy()))
              for k in ZERO1_SHAPES]
    opt = hvd.DistributedOptimizer(
        loop.SGD(params, 0.25, momentum=0.5), sharded=sharded, group=group,
        compression=compression)

    def step(*gs):
        for p, t in zip(params, gs):
            p.grad = t.clone()
        opt.step()
        return [p.detach().clone() for p in params]

    prog = hvd.spmd(step)
    for i in range(steps):
        out = prog(*[torch.from_numpy(grads[i][k][r].copy())
                     for k in ZERO1_SHAPES])
    res = {"params": [t.numpy() for t in out]}
    if sharded:
        # A non-member of a subset group never steps: no state.
        res["state"] = [opt.state[s]["momentum_buffer"].numpy().copy()
                        for s in opt.shards if s in opt.state]
        res["shard_len"] = [b[2] for b in opt._buckets]
    return res


def _zero1_mixed(hvd):
    """The bucket layout of a mixed-dtype parameter list, and a 3-step
    bf16/fp32 run on integer-valued gradients (exact in a bf16 sum, so the
    reduction order does not show) equal sharded and unsharded."""
    from horovod_tpu_torch.training import loop

    out = {}
    for sharded in (False, True):
        g = torch.Generator().manual_seed(3)
        params = [torch.nn.Parameter(torch.randn(s, generator=g).to(dt))
                  for s, dt in (((5,), torch.float32),
                                ((4, 3), torch.bfloat16),
                                ((7,), torch.float32))]
        opt = hvd.DistributedOptimizer(loop.SGD(params, 0.5, momentum=0.9),
                                       sharded=sharded)

        def step(seed, params=params, opt=opt):
            gg = torch.Generator().manual_seed(seed + 10 * hvd.rank())
            for p in params:
                p.grad = torch.randint(-4, 5, p.shape, generator=gg).to(
                    p.dtype)
            opt.step()
            return [p.detach().clone() for p in params]

        prog = hvd.spmd(step)
        for i in range(3):
            res = prog(i)
        out[sharded] = [t.float().numpy() for t in res]
        if sharded:
            out["buckets"] = [(idx, total, n) for idx, total, n
                              in opt._buckets]
    return out


def _zero1_trainer(hvd):
    """Trainer(sharded=True) with a training.adam builder against the
    unsharded Trainer (the reference's smoke test)."""
    from horovod_tpu_torch import training

    rng = np.random.RandomState(3)
    w0 = rng.randn(4, 2).astype(np.float32)
    xs = torch.from_numpy(rng.randn(WORLD, 16, 4).astype(np.float32))
    ys = torch.from_numpy(rng.randn(WORLD, 16, 2).astype(np.float32))
    out = {}
    for sharded in (False, True):
        model = torch.nn.Linear(4, 2, bias=False)
        with torch.no_grad():
            model.weight.copy_(torch.from_numpy(w0.T.copy()))
        tr = hvd.Trainer(model, lambda m, b: ((m(b[0]) - b[1]) ** 2).mean(),
                         training.adam(1e-2), sharded=sharded)
        for _ in range(3):
            tr.train_step((xs[hvd.rank()], ys[hvd.rank()]))
        out[sharded] = model.weight.detach().numpy().copy()
    return out


def _lm_model(state_dict):
    from horovod_tpu_torch.models import transformer as tt

    cfg = tt.TransformerConfig(dtype=torch.float32, **LM_ARCH)
    model = tt.Transformer(cfg)
    model.load_state_dict({k: torch.from_numpy(v.copy())
                           for k, v in state_dict.items()})
    return cfg, model


def _state_bytes(opt) -> int:
    return sum(t.numel() * t.element_size()
               for st in opt.state.values() for t in st.values()
               if isinstance(t, torch.Tensor))


def _lm_runs(hvd, r, state_dict):
    """The 3-step tiny LM under each arm in both layouts (losses), the
    bytes each arm holds (momentum SGD, one step, two hosts), and a zero3
    trainer's state for the checkpoint checks."""
    from horovod_tpu_torch.models import transformer as tt
    from horovod_tpu_torch.training import loop

    tokens = torch.from_numpy(_lm_tokens()[r]).long()
    out = {"losses": {}, "bytes": {}}
    for layout in LAYOUTS:
        _slices(layout)
        for arm in ARMS:
            cfg, model = _lm_model(state_dict)
            if arm == "off":
                os.environ["HOROVOD_ALLREDUCE_ALGO"] = (
                    "hierarchical" if layout == "2" else "rs_ag")
            try:
                tr = hvd.Trainer(model, tt.make_loss_fn(cfg),
                                 loop.SGD(model.parameters(), 0.1),
                                 fusion_threshold=0 if arm == "off" else None,
                                 sharding=arm)
                out["losses"][(layout, arm)] = np.array(
                    [float(tr.train_step(tokens)[0])
                     for _ in range(LM_STEPS)], np.float32)
            finally:
                os.environ.pop("HOROVOD_ALLREDUCE_ALGO", None)
    _slices("2")
    for arm in ARMS:
        cfg, model = _lm_model(state_dict)
        tr = hvd.Trainer(model, tt.make_loss_fn(cfg),
                         loop.SGD(model.parameters(), 0.1, momentum=0.9),
                         sharding=arm)
        tr.train_step(tokens)
        held = sum(p.numel() * p.element_size() for p in model.parameters())
        if arm == "zero3":
            held += sum(s.numel() * s.element_size()
                        for s in tr.optimizer.shards)
        out["bytes"][arm] = (held, _state_bytes(tr.optimizer))
        if arm == "zero3":
            out["fsdp_size"] = tr.optimizer.mesh().fsdp_size
            out["leaves"] = len(list(model.parameters()))
            out["zero3"] = tr
    return out


def _plans(hvd, r):
    """The live plans of a zero2 and a zero3 step over PLAN_SHAPES."""
    from horovod_tpu_torch.ops import exchange
    from horovod_tpu_torch.training import loop

    grads = [torch.from_numpy(g[r].copy()) for g in _plan_grads()]
    out = {}
    for mode in ("zero2", "zero3"):
        params = [torch.nn.Parameter(torch.from_numpy(p.copy()))
                  for p in _plan_leaves()]
        opt = hvd.DistributedOptimizer(loop.SGD(params, 0.5), sharding=mode)
        if mode == "zero2":
            def step(*gs, params=params, opt=opt):
                for p, t in zip(params, gs):
                    p.grad = t.clone()
                opt.step()
                return [p.detach().clone() for p in params]
        else:
            opt.bind(params)
            opt.init(opt.init_shards())

            def step(*gs, opt=opt):
                opt.gather_params()
                return [s.clone() for s in opt.apply_gradients(list(gs))]
        values = hvd.spmd(step)(*grads)
        plan = exchange.last_plan()
        out[mode] = {"json": plan.to_json(), "hash": plan.plan_hash(),
                     "values": [t.numpy() for t in values]}
        if mode == "zero2":
            # The re-shard path: this rank's slices of the new parameters
            # are the shards the step updated.
            out["reshard"] = all(torch.equal(a, b) for a, b in zip(
                opt.shard_params(), opt.shards))
    return out


def _refusals(hvd, tmpdir):
    from horovod_tpu_torch import training
    from horovod_tpu_torch.training import loop

    def sgd():
        return loop.SGD([torch.nn.Parameter(torch.ones(8))], 0.1)

    def opt(**kw):
        return hvd.DistributedOptimizer(sgd(), **kw)

    def trainer(sharding):
        model = torch.nn.Linear(8, 1)
        return hvd.Trainer(model, lambda m, b: m(b).sum(),
                           training.sgd(0.1), sharding=sharding)

    def eager_zero3_gather():
        o = opt(sharding="zero3")
        o.bind()
        o.gather_params(o.init_shards())

    def family():
        o = opt(sharding="zero2", group=[0])
        o.step()

    def subset():
        _slices("1")
        try:
            o = opt(sharding="zero2", group=1)
            hvd.spmd(lambda x: o.step())(torch.ones(1))
        finally:
            _slices("2")

    def elastic():
        os.environ["HOROVOD_ELASTIC"] = "1"
        try:
            trainer("zero2")
        finally:
            del os.environ["HOROVOD_ELASTIC"]

    out = {f"kwarg_{k}": _message(lambda k=k, v=v: opt(sharding="zero2",
                                                        **{k: v}))
           for k, v in (("sparse_algo", "gather"), ("channels", 2),
                        ("cross_compression", "bf16"),
                        ("fusion_threshold", 0), ("algo", "flat"),
                        ("schedule", "enum"))}
    out.update({
        "zero1_conflict": _message(lambda: opt(sharded=True,
                                               sharding="zero3")),
        "error_feedback": _message(lambda: opt(sharding="zero2",
                                               error_feedback=True)),
        "unsummable_zero2": _message(lambda: opt(sharding="zero2",
                                                 compression="int4")),
        "unsummable_zero3": _message(lambda: opt(sharding="zero3",
                                                 compression="int4")),
        "eager_update": _message(lambda: opt(sharding="zero2").step()),
        "eager_zero3_gather": _message(eager_zero3_gather),
        "zero3_unbound": _message(
            lambda: opt(sharding="zero3").init_shards()),
        "zero3_sparse_params": _message(
            lambda: opt(sharding="zero3").bind([hvd.IndexedSlices(
                torch.ones(2, 4), torch.tensor([0, 1]), (8, 4))])),
        "group_family": _message(family),
        "subset_group": _message(subset),
        "trainer_elastic": _message(elastic),
        "trainer_restore": _message(
            lambda: trainer("zero2").restore(str(tmpdir))),
        "trainer_sync_state": _message(lambda: trainer("zero3").sync_state()),
        "zero1_int8": _message(lambda: opt(sharded=True,
                                           compression="int8")),
        "zero1_eager": _message(lambda: opt(sharded=True).step()),
        "zero1_family": _message(lambda: opt(sharded=True, group=[0])),
    })
    return out


def _checkpoints(hvd, r, trainer, tmpdir):
    from horovod_tpu_torch.core import resilience
    from horovod_tpu_torch.training import checkpoint as tck

    out = {}
    shared = os.path.join(tmpdir, "shared")
    state = trainer.train_state()
    out["path"] = os.path.basename(tck.save_sharded(shared, state, 0))
    back = tck.load_sharded(shared, state, epoch=0)
    out["round_trip"] = sorted(back) == sorted(dict(state, epoch=0)) and all(
        torch.equal(a, b) for a, b in zip(
            [t for v in state.values() if isinstance(v, list) for t in v],
            [t for v in back.values() if isinstance(v, list) for t in v]))
    out["shards_equal"] = all(torch.equal(a, b) for a, b in zip(
        state["shards"], back["shards"]))
    out["optimizer_equal"] = all(
        torch.equal(a, b) for k in state["optimizer"]["state"]
        for a, b in zip(state["optimizer"]["state"][k].values(),
                        back["optimizer"]["state"][k].values()))
    before = [s.clone() for s in trainer.optimizer.shards]
    with torch.no_grad():
        for s in trainer.optimizer.shards:
            s.zero_()
    trainer.load_state(back)
    out["load_state"] = all(torch.equal(a, b) for a, b in zip(
        before, trainer.optimizer.shards))
    os.environ["HOROVOD_FAULT_INJECT"] = "torn_write@epoch=1"
    resilience.reset_injector()
    try:
        tck.save_sharded(shared, state, 1)
    finally:
        del os.environ["HOROVOD_FAULT_INJECT"]
        resilience.reset_injector()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out["latest"] = tck.latest_sharded_epoch(shared)
        out["agreed"] = tck.load_sharded(shared, state)["epoch"]
    out["torn_warnings"] = sorted({str(w.message).replace(shared, "<dir>")
                                   for w in caught})
    out["verify_torn"] = tck.verify_sharded_epoch(shared, 1)
    # Rank-local directories with no common epoch, then none at all.
    local = os.path.join(tmpdir, f"local{r}")
    tck.save_sharded(local, state, 5 if r == 0 else 3)
    out["disjoint"] = _message(lambda: tck.load_sharded(local, state))
    empty = os.path.join(tmpdir, f"empty{r}")
    try:
        tck.load_sharded(empty, state)
        out["empty"] = None
    except FileNotFoundError as e:
        out["empty"] = str(e).replace(empty, "<dir>")
    out["dirs"] = (local, empty)
    return out


def _port_world(tmpdir, state_dict):
    _slices("2")
    import horovod_tpu_torch as hvd

    hvd.init([[0, 1]], device="cpu")
    r = hvd.rank()
    fed = install_port_noise(r)
    out = {"exchange": _port_exchange(hvd, r, fed)}
    ints = _zero1_grads("int")
    rand = _zero1_grads("rand")
    out["zero1"] = {
        "off": _zero1_run(hvd, r, False, ints),
        "sharded": _zero1_run(hvd, r, True, ints),
        "subset_off": _zero1_run(hvd, r, False, ints, group=1),
        "subset": _zero1_run(hvd, r, True, ints, group=1),
        "bf16_off": _zero1_run(hvd, r, False, ints, compression="bf16"),
        "bf16": _zero1_run(hvd, r, True, ints, compression="bf16"),
        "rand_off": _zero1_run(hvd, r, False, rand, steps=1),
        "rand": _zero1_run(hvd, r, True, rand, steps=1),
        "mixed": _zero1_mixed(hvd),
        "trainer": _zero1_trainer(hvd),
    }
    lm = _lm_runs(hvd, r, state_dict)
    out["checkpoint"] = _checkpoints(hvd, r, lm.pop("zero3"), tmpdir)
    out["lm"] = lm
    out["plans"] = _plans(hvd, r)
    out["errors"] = _refusals(hvd, tmpdir)
    return out


# -- the JAX side -------------------------------------------------------------


@pytest.fixture(scope="module")
def tmpdir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("fsdp"))


@pytest.fixture(scope="module")
def lm_params():
    """The tiny LM of ``tests/test_fsdp.py``'s ``_lm_setup`` (flax init),
    and the port's state dict of the same weights."""
    import jax
    import jax.numpy as jnp

    from horovod_tpu.models import transformer as jt
    from horovod_tpu_torch.models import transformer as tt

    cfg = jt.TransformerConfig(dtype=jnp.float32, **LM_ARCH)
    params = jax.tree.map(np.asarray, jt.init_params(cfg))
    return cfg, params, {k: v.numpy() for k, v in
                         tt.from_flax_params(params).items()}


@pytest.fixture(scope="module")
def port(tmpdir, lm_params):
    from horovod_tpu_torch.run import run

    return run(_port_world, WORLD, device="cpu", timeout=300,
               args=(tmpdir, lm_params[2]))


@pytest.fixture(scope="module")
def jhvd():
    import jax

    import horovod_tpu as jhvd

    mp = pytest.MonkeyPatch()
    mp.setenv("HOROVOD_TOPOLOGY_SLICES", "2")
    jhvd.shutdown()
    jhvd.init([[0, 1]], devices=jax.devices()[:WORLD])
    yield jhvd, mp
    jhvd.shutdown()
    mp.undo()


def _jax_message(fn):
    from horovod_tpu.core.state import HorovodError

    try:
        fn()
    except (HorovodError, ValueError) as e:
        return f"{type(e).__name__}: {e}"
    return None


@pytest.fixture(scope="module")
def jax_exchange(jhvd):
    from horovod_tpu.ops import compression as jc
    from horovod_tpu.ops import mesh as jmesh
    from horovod_tpu.ops import strategy as js
    from horovod_tpu.ops import topology as jtopo

    hvd, mp = jhvd
    out = {}
    try:
        for layout in LAYOUTS:
            mp.setenv("HOROVOD_TOPOLOGY_SLICES", layout)
            topo = jtopo.discover(hvd.get_group(0))
            fmesh = jmesh.fsdp_mesh(0)
            xs = [_int_data(31 + i, (WORLD,) + s)
                  for i, s in enumerate(EXCHANGE_SHAPES)]
            with jax_noise() as fed:
                def prog(*xs):
                    from jax import lax

                    fed.reset()
                    res = []
                    for comp in COMPS:
                        c = None if comp is None else jc.resolve(comp)
                        for i, x in enumerate(xs):
                            res.append(js.lower_fsdp_grad_exchange(
                                x, fmesh, f"x{i}", c, None, topo=topo)[0])
                    r = lax.axis_index("hvd")
                    for i, x in enumerate(xs):
                        flat, _ = js._flatten_pad(x, fmesh.fsdp_size)
                        shard = flat.reshape(fmesh.fsdp_size, -1)[
                            r % fmesh.fsdp_size]
                        res.append(js.lower_fsdp_param_gather(
                            shard, fmesh, f"x{i}", topo=topo))
                    return res

                grid = np.vectorize(lambda d: d.id)(
                    np.array(fmesh.named_mesh(0).devices))
                out[layout] = {"mesh": fmesh, "grid": grid.tolist(),
                               "values": [np.asarray(t) for t in
                                          hvd.spmd(prog)(*xs)]}
    finally:
        mp.setenv("HOROVOD_TOPOLOGY_SLICES", "2")
    return out


@pytest.fixture(scope="module")
def jax_zero1(jhvd):
    import jax
    import optax

    hvd, _ = jhvd

    def run(grads, group=0, compression=None):
        p0 = _zero1_params()
        opt = hvd.DistributedOptimizer(optax.sgd(0.25, momentum=0.5),
                                       sharded=True, group=group,
                                       compression=compression)

        @hvd.spmd
        def step(p, s, g):
            upd, s = opt.update(g, s, p)
            return optax.apply_updates(p, upd), s

        state = jax.tree.map(
            lambda t: np.broadcast_to(np.asarray(t)[None],
                                      (WORLD,) + np.asarray(t).shape).copy(),
            opt.init(p0))
        params = hvd.replicate(p0)
        for i in range(ZERO1_STEPS):
            params, state = step(params, state, grads[i])
        return ({k: np.asarray(v) for k, v in params.items()},
                [np.asarray(t) for t in jax.tree.leaves(state)
                 if np.asarray(t).ndim == 2])

    ints = _zero1_grads("int")
    return {"whole": run(ints), "subset": run(ints, group=1),
            "bf16": run(ints, compression="bf16")}


@pytest.fixture(scope="module")
def jax_lm(jhvd, lm_params):
    import optax

    from horovod_tpu.models import transformer as jt
    from horovod_tpu.training import loop as jloop

    cfg, params, _ = lm_params
    tr = jloop.Trainer(jt.make_loss_fn(cfg), optax.sgd(0.1),
                       sharding="zero3")
    tr.init_state(params)
    tokens = _lm_tokens()
    return np.stack([np.asarray(tr.train_step(tokens)[0])
                     for _ in range(LM_STEPS)], axis=1)


@pytest.fixture(scope="module")
def jax_plans(jhvd):
    import jax.numpy as jnp
    import optax

    from horovod_tpu.ops import exchange as jex

    hvd, _ = jhvd
    names = [f"DistributedOptimizer.grads.{i}" for i in range(len(
        PLAN_SHAPES))]
    p0 = dict(zip(names, _plan_leaves()))
    grads = dict(zip(names, _plan_grads()))
    out = {}
    opt2 = hvd.DistributedOptimizer(optax.sgd(0.5), sharding="zero2")
    s2 = opt2.init(p0)

    @hvd.spmd
    def step2(g, p):
        new, _ = opt2.update(g, s2, p, fsdp_apply=True)
        return new

    vals = step2(grads, hvd.replicate(p0))
    plan = jex.last_plan()
    out["zero2"] = {"json": plan.to_json(), "hash": plan.plan_hash(),
                    "values": [np.asarray(vals[n]) for n in names]}
    opt3 = hvd.DistributedOptimizer(optax.sgd(0.5), sharding="zero3")
    opt3.bind(p0)
    shards = opt3.init_shards(p0)
    s3 = opt3.init({n: jnp.asarray(v[0]) for n, v in shards.items()})

    @hvd.spmd
    def step3(g, sh):
        opt3.gather_params(sh)
        new, _ = opt3.apply_gradients(g, s3, sh)
        return new

    vals = step3(grads, shards)
    plan = jex.last_plan()
    out["zero3"] = {"json": plan.to_json(), "hash": plan.plan_hash(),
                    "values": [np.asarray(vals[n]) for n in names]}
    return out


@pytest.fixture(scope="module")
def jax_refusals(jhvd, tmpdir):
    import jax.numpy as jnp
    import optax

    from horovod_tpu.ops import sparse as jsparse
    from horovod_tpu.training import loop as jloop

    hvd, mp = jhvd

    def opt(**kw):
        return hvd.DistributedOptimizer(optax.sgd(0.1), **kw)

    def trainer(sharding):
        tr = jloop.Trainer(lambda p, b: jnp.sum(p["w"]), optax.sgd(0.1),
                           sharding=sharding)
        tr.init_state({"w": jnp.ones((8,), jnp.float32)})
        return tr

    params = {"w": jnp.ones((8,), jnp.float32)}

    def eager_update():
        o = opt(sharding="zero2")
        o.update(params, o.init(params), params)

    def eager_zero3_gather():
        o = opt(sharding="zero3")
        o.bind(params)
        o.gather_params(o.init_shards(params))

    def family():
        o = opt(sharding="zero2", group=[0])
        g = {"w": jnp.ones((WORLD, 4), jnp.float32)}
        hvd.spmd(lambda g, s, p: o.update(g, s, p))(
            g, jnp.zeros((WORLD,)), g)

    def subset():
        mp.setenv("HOROVOD_TOPOLOGY_SLICES", "1")
        try:
            o = opt(sharding="zero2", group=1)
            g = {"w": jnp.ones((WORLD, 4), jnp.float32)}
            hvd.spmd(lambda g, s, p: o.update(g, s, p), group=0)(
                g, jnp.zeros((WORLD,)), g)
        finally:
            mp.setenv("HOROVOD_TOPOLOGY_SLICES", "2")

    def elastic():
        mp.setenv("HOROVOD_ELASTIC", "1")
        try:
            jloop.Trainer(lambda p, b: jnp.sum(p["w"]), optax.sgd(0.1),
                          sharding="zero2")
        finally:
            mp.delenv("HOROVOD_ELASTIC")

    def zero1_family():
        o = opt(sharded=True, group=[0])
        hvd.spmd(lambda g, s: o.update(g, s))(
            {"w": jnp.ones((WORLD, 8))},
            {"w": jnp.zeros((WORLD, 2))})

    out = {f"kwarg_{k}": _jax_message(lambda k=k, v=v: opt(sharding="zero2",
                                                            **{k: v}))
           for k, v in (("sparse_algo", "gather"), ("channels", 2),
                        ("cross_compression", "bf16"),
                        ("fusion_threshold", 0), ("algo", "flat"),
                        ("schedule", "enum"))}
    out.update({
        "zero1_conflict": _jax_message(lambda: opt(sharded=True,
                                                   sharding="zero3")),
        "error_feedback": _jax_message(lambda: opt(sharding="zero2",
                                                   error_feedback=True)),
        "unsummable_zero2": _jax_message(lambda: opt(sharding="zero2",
                                                     compression="int4")),
        "unsummable_zero3": _jax_message(lambda: opt(sharding="zero3",
                                                     compression="int4")),
        "eager_update": _jax_message(eager_update),
        "eager_zero3_gather": _jax_message(eager_zero3_gather),
        "zero3_unbound": _jax_message(
            lambda: opt(sharding="zero3").init_shards(params)),
        "zero3_sparse_params": _jax_message(
            lambda: opt(sharding="zero3").bind({"emb": jsparse.IndexedSlices(
                values=jnp.ones((2, 4)), indices=jnp.array([0, 1]),
                dense_shape=(8, 4))})),
        "group_family": _jax_message(family),
        "subset_group": _jax_message(subset),
        "trainer_elastic": _jax_message(elastic),
        "trainer_restore": _jax_message(
            lambda: trainer("zero2").restore(str(tmpdir))),
        "trainer_sync_state": _jax_message(
            lambda: trainer("zero3").sync_state()),
        "zero1_int8": _jax_message(lambda: opt(sharded=True,
                                               compression="int8")),
        "zero1_eager": _jax_message(lambda: opt(sharded=True).update(
            params, opt(sharded=True).init(params))),
        "zero1_family": _jax_message(zero1_family),
    })
    return out


# -- the mesh and the knobs (no world) -----------------------------------------


def test_mesh_partitions_indices_and_padding():
    from horovod_tpu.ops import mesh as jmesh
    from horovod_tpu_torch.ops import mesh as tmesh

    for shape in ((8, 4, 2, 2), (8, 8, 1, 1), (4, 2, 2, 2), (4, 1, 4, 1)):
        j, t = jmesh.FsdpMesh(*shape), tmesh.FsdpMesh(*shape)
        assert t.fsdp_groups() == j.fsdp_groups()
        assert t.data_groups() == j.data_groups()
        assert t.matches_slices() == j.matches_slices()
        assert [(t.fsdp_index(r), t.data_index(r)) for r in range(8)] == \
            [(j.fsdp_index(r), j.data_index(r)) for r in range(8)]
        for n in (1, 10, 255, 256, 1001):
            for m in (1, 8, 256):
                assert t.padded_numel(n, m) == j.padded_numel(n, m)
    t = tmesh.FsdpMesh(group_size=8, fsdp_size=4, data_size=2, num_slices=2)
    assert (t.padded_numel(10), t.padded_numel(10, multiple=8),
            t.shard_len(12)) == (12, 16, 3)
    with pytest.raises(Exception) as te:
        t.shard_len(10)
    with pytest.raises(Exception) as je:
        jmesh.FsdpMesh(8, 4, 2, 2).shard_len(10)
    assert str(te.value) == str(je.value)
    assert tmesh.SHARDING_MODES == jmesh.SHARDING_MODES
    assert (tmesh.DATA_AXIS, tmesh.FSDP_AXIS) == (jmesh.DATA_AXIS,
                                                   jmesh.FSDP_AXIS)


@pytest.mark.parametrize("topo,fsdp", [((8, 1, 8), None), ((8, 2, 4), None),
                                       ((8, 1, 8), 2), ((8, 1, 8), 3),
                                       ((8, 2, 4), 8), ((8, 2, 4), 2),
                                       ((6, 3, 2), None), ((4, 4, 1), None)])
def test_layout_matches_jax_and_refuses_like_it(topo, fsdp):
    """The layout of a topology (group size, slices, ranks a slice) with
    and without an fsdp size; a size that does not divide a slice raises
    the reference's text."""
    from horovod_tpu.ops import mesh as jmesh
    from horovod_tpu.ops import topology as jtopo
    from horovod_tpu_torch.ops import mesh as tmesh
    from horovod_tpu_torch.ops import topology as ttopo

    n, slices, local = topo
    slice_of = tuple(i // local for i in range(n))
    tt = ttopo.Topology(n, slice_of, slices, local, "cpu",
                        *ttopo.seed_links("cpu"))
    jt = jtopo.Topology(group_size=n, slice_of=slice_of, num_slices=slices,
                        local_size=local, device_kind="cpu",
                        ici=jtopo.Link(5.0, 20.0),
                        dcn=jtopo.Link(25.0, 12.5))
    got = want = None
    try:
        got = tmesh.layout(tt, fsdp)
    except Exception as e:
        got = str(e)
    try:
        want = jmesh.layout(jt, fsdp)
    except Exception as e:
        want = str(e)
    if isinstance(want, str):
        assert got == want
    else:
        assert (got.group_size, got.fsdp_size, got.data_size,
                got.num_slices) == (want.group_size, want.fsdp_size,
                                    want.data_size, want.num_slices)


@pytest.mark.parametrize("raw", [None, "", "off", "zero2", " ZERO3 ",
                                 "zeor3", "zero1"])
def test_sharding_knob_parses_like_the_reference(monkeypatch, raw):
    from horovod_tpu.ops import mesh as jmesh
    from horovod_tpu.utils import env as jenv
    from horovod_tpu_torch.ops import mesh as tmesh
    from horovod_tpu_torch.utils import env as tenv

    if raw is None:
        monkeypatch.delenv("HOROVOD_SHARDING", raising=False)
    else:
        monkeypatch.setenv("HOROVOD_SHARDING", raw)

    def outcome(fn):
        try:
            return fn()
        except Exception as e:
            return f"{type(e).__name__}: {e}"

    assert outcome(tenv.sharding_mode) == outcome(jenv.sharding_mode)
    arg = raw if raw is not None else "off"
    assert outcome(lambda: tmesh.resolve_sharding(arg)) == \
        outcome(lambda: jmesh.resolve_sharding(arg))


@pytest.mark.parametrize("raw", [None, "", "4", "1", "three", "0", "-2"])
def test_fsdp_axis_knob_parses_like_the_reference(monkeypatch, raw):
    from horovod_tpu.utils import env as jenv
    from horovod_tpu_torch.utils import env as tenv

    if raw is None:
        monkeypatch.delenv("HOROVOD_FSDP_AXIS_SIZE", raising=False)
    else:
        monkeypatch.setenv("HOROVOD_FSDP_AXIS_SIZE", raw)

    def outcome(fn):
        try:
            return fn()
        except ValueError as e:
            return f"ValueError: {e}"

    assert outcome(tenv.fsdp_axis_size) == outcome(jenv.fsdp_axis_size)


@pytest.fixture
def clean_env(monkeypatch):
    import horovod_tpu_torch as hvd

    for name in list(os.environ):
        if name.startswith("HOROVOD_"):
            monkeypatch.delenv(name)
    hvd.shutdown()
    yield monkeypatch
    hvd.shutdown()


@pytest.mark.parametrize("env", [
    {"HOROVOD_SHARDING": "zeor3"}, {"HOROVOD_FSDP_AXIS_SIZE": "three"},
    {"HOROVOD_FSDP_AXIS_SIZE": "0"},
    {"HOROVOD_ELASTIC": "1", "HOROVOD_SHARDING": "zero2"}],
    ids=["sharding_typo", "axis_typo", "axis_zero", "elastic"])
def test_init_refuses_like_the_reference(clean_env, env):
    """A typo'd knob raises at ``hvd.init`` with the reference's text, and
    elastic with sharding raises the reference's conflict (before the
    port's own refusal of the unported elastic runtime)."""
    import jax

    import horovod_tpu as jhvd
    import horovod_tpu_torch as hvd

    for k, v in env.items():
        clean_env.setenv(k, v)
    with pytest.raises(Exception) as te:
        hvd.init(device="cpu")
    jhvd.shutdown()
    try:
        with pytest.raises(Exception) as je:
            jhvd.init(devices=jax.devices()[:1])
    finally:
        jhvd.shutdown()
    assert type(te.value).__name__ == type(je.value).__name__
    assert str(te.value) == str(je.value)
    assert not hvd.is_initialized()


def test_chip_smoke_pins_the_jax_zero3_plan_hash():
    """``chip_smoke.py`` phase 18(d) holds the zero3 step's plan against
    ``ZERO3_PLAN_HASH``: the JAX package's plan of the LM's gradients (the
    card's leaves and labels, one rank, the fsdp section of zero3) —
    which the port's plan of the same leaves equals."""
    import ast
    import pathlib

    import jax

    from horovod_tpu.ops import exchange as jex
    from horovod_tpu_torch.models import transformer
    from horovod_tpu_torch.ops import mesh as tmesh
    from horovod_tpu_torch.ops import topology as ttopo
    from horovod_tpu_torch.parallel import sharded

    src = (pathlib.Path(__file__).resolve().parents[1]
           / "chip_smoke.py").read_text()
    consts = {}
    for node in ast.parse(src).body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and getattr(node.targets[0], "id", None) == "ZERO3_PLAN_HASH":
            consts["hash"] = ast.literal_eval(node.value)
    cfg = transformer.TransformerConfig(
        vocab_size=32_768, num_layers=8, num_heads=8, num_kv_heads=4,
        embed_dim=1024, mlp_dim=4096, max_seq_len=8192,
        dtype=torch.bfloat16)
    with torch.device("meta"):
        lm = transformer.Transformer(cfg, generator=torch.Generator())
    leaves = [torch.empty(p.shape, dtype=p.dtype, device="meta")
              for p in lm.parameters()]
    labels = [f"{sharded.NAME}.{i}" for i in range(len(leaves))]
    order = tuple(range(len(leaves)))
    kind = "NVIDIA H100 80GB HBM3"
    topo = ttopo.Topology(1, (0,), 1, 1, kind, *ttopo.seed_links(kind))
    t = sharded.fsdp_plan("zero3", leaves, labels, None,
                          tmesh.layout(topo), topo, order)
    names = [str(p.dtype).removeprefix("torch.") for p in leaves]
    jleaves = [jax.ShapeDtypeStruct(tuple(p.shape), n)
               for p, n in zip(leaves, names)]
    j = jex.plan_exchange(jleaves, 0, mode="enum", compression=None,
                          algo=lambda bucket: "rs_ag", labels=labels,
                          world_size=1).with_fsdp(jex.FsdpMeta(
                              mode="zero3", fsdp_size=1, data_size=1,
                              gather_order=order,
                              leaf_bytes=tuple(p.numel() * p.element_size()
                                               for p in leaves),
                              wire_dtypes=tuple(names)))
    assert t.to_json() == j.to_json()
    assert t.plan_hash() == j.plan_hash() == consts["hash"]


# -- the FSDP lowerings ---------------------------------------------------------


@pytest.mark.parametrize("layout", LAYOUTS)
def test_mesh_of_the_world_matches_jax(port, jax_exchange, layout):
    want = jax_exchange[layout]["mesh"]
    for r in range(WORLD):
        got = port[r]["exchange"][layout]["mesh"]
        assert (got.group_size, got.fsdp_size, got.data_size,
                got.num_slices) == (want.group_size, want.fsdp_size,
                                    want.data_size, want.num_slices)
        # The (data, fsdp) grid of ranks is the reference's named mesh's
        # grid of devices (device i is rank i).
        assert port[r]["exchange"][layout]["grid"] == \
            jax_exchange[layout]["grid"]
    assert (want.fsdp_size, want.data_size) == (
        (2, 2) if layout == "2" else (4, 1))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("comp", COMPS + ("gather",), ids=str)
def test_fsdp_lowerings_match_jax(port, jax_exchange, layout, comp):
    """Each rank's reduced shard (or gathered parameter) equals the JAX
    package's, bit for bit, on integer-valued data."""
    k = len(EXCHANGE_SHAPES)
    j0 = (COMPS + ("gather",)).index(comp) * k
    for j in range(j0, j0 + k):
        want = jax_exchange[layout]["values"][j]
        for r in range(WORLD):
            got = port[r]["exchange"][layout]["values"][j]
            assert got.dtype == want[r].dtype, (comp, j)
            np.testing.assert_array_equal(got, want[r], err_msg=f"{r} {j}")


# -- ZeRO-1 ----------------------------------------------------------------------


def test_zero1_equals_unsharded_and_jax_bit_for_bit(port, jax_zero1):
    want, want_state = jax_zero1["whole"]
    for r in range(WORLD):
        z = port[r]["zero1"]
        for i, k in enumerate(ZERO1_SHAPES):
            np.testing.assert_array_equal(z["sharded"]["params"][i],
                                          z["off"]["params"][i])
            np.testing.assert_array_equal(z["sharded"]["params"][i],
                                          want[k][r])
        # One fp32 bucket: the momentum shard is JAX's, row r.
        np.testing.assert_array_equal(z["sharded"]["state"][0],
                                      want_state[0][r])


def test_zero1_subset_group_non_member_holds_still(port, jax_zero1):
    want, _ = jax_zero1["subset"]
    p0 = _zero1_params()
    for r in range(WORLD):
        z = port[r]["zero1"]
        for i, k in enumerate(ZERO1_SHAPES):
            np.testing.assert_array_equal(z["subset"]["params"][i],
                                          want[k][r])
            if r < 2:
                np.testing.assert_array_equal(z["subset"]["params"][i],
                                              z["subset_off"]["params"][i])
            else:
                np.testing.assert_array_equal(z["subset"]["params"][i], p0[k])


def test_zero1_bf16_wire_equals_unsharded_and_jax(port, jax_zero1):
    """``compression="bf16"``: both collectives in bf16 (the gather
    carrying each shard's update); on these exact values, bit for bit."""
    want, _ = jax_zero1["bf16"]
    for r in range(WORLD):
        z = port[r]["zero1"]
        for i, k in enumerate(ZERO1_SHAPES):
            np.testing.assert_array_equal(z["bf16"]["params"][i],
                                          want[k][r])
            np.testing.assert_array_equal(z["bf16"]["params"][i],
                                          z["bf16_off"]["params"][i])


def test_zero1_state_is_one_nth(port):
    total = sum(int(np.prod(s)) for s in ZERO1_SHAPES.values())
    for r in range(WORLD):
        z = port[r]["zero1"]
        assert z["sharded"]["shard_len"] == [-(-total // WORLD)]
        assert [s.shape for s in z["sharded"]["state"]] == \
            [(-(-total // WORLD),)]
        assert [s.shape for s in z["subset"]["state"]] == (
            [(-(-total // 2),)] if r < 2 else [])


def test_zero1_random_data_within_ring_tolerance(port):
    """One step on random gradients: the reduce-scatter and the all-reduce
    sum in different orders (ROADMAP §C), so the parameters agree to
    lr · 3 roundings of Σ|g| over the ranks (averaged), plus one rounding
    of the parameter."""
    g = _zero1_grads("rand")[0]
    p0 = _zero1_params()
    for r in range(WORLD):
        z = port[r]["zero1"]
        for i, k in enumerate(ZERO1_SHAPES):
            a, b = z["rand"]["params"][i], z["rand_off"]["params"][i]
            tol = (0.25 * 3 * 2.0 ** -24 * np.abs(g[k]).sum(0) / WORLD
                   + 2.0 ** -23 * (np.abs(p0[k]) + 1))
            assert np.all(np.abs(a - b) <= tol), (k, np.abs(a - b).max())


def test_zero1_buckets_by_param_group_and_dtype(port):
    """Mixed fp32/bf16 parameters: one bucket a dtype in order of first
    appearance (JAX's ``_zero_buckets`` layout), and 3 steps equal the
    unsharded path on every rank, bit for bit."""
    from horovod_tpu.parallel.optimizer import _zero_buckets

    import jax

    jl = [jax.ShapeDtypeStruct(s, d) for s, d in (((5,), "float32"),
                                                  ((4, 3), "bfloat16"),
                                                  ((7,), "float32"))]
    want = [(idx, total, n) for _, idx, total, n in _zero_buckets(jl, WORLD)]
    for r in range(WORLD):
        mixed = port[r]["zero1"]["mixed"]
        assert [tuple(b) for b in mixed["buckets"]] == \
            [tuple(b) for b in want]
        for a, b in zip(mixed[True], mixed[False]):
            np.testing.assert_array_equal(a, b)


def test_zero1_trainer_with_a_builder_matches_unsharded(port):
    for r in range(WORLD):
        t = port[r]["zero1"]["trainer"]
        np.testing.assert_allclose(t[True], t[False], rtol=1e-5, atol=1e-6)


# -- ZeRO-2/3: the LM, the bytes, the plan -------------------------------------


@pytest.mark.parametrize("layout", LAYOUTS)
def test_lm_losses_bit_identical_across_arms(port, layout):
    for r in range(WORLD):
        losses = port[r]["lm"]["losses"]
        for arm in ARMS[1:]:
            np.testing.assert_array_equal(losses[(layout, arm)],
                                          losses[(layout, "off")])


def test_lm_losses_match_jax(port, jax_lm):
    for r in range(WORLD):
        got = port[r]["lm"]["losses"][("2", "zero3")]
        np.testing.assert_allclose(got, jax_lm[r], rtol=LM_TOL)


def test_bytes_held_per_rank(port):
    """zero2 keeps the optimizer state 1/F a rank and the parameters
    replicated; zero3 keeps parameters and state 1/F (slack: the zero-pad
    of each tensor to a multiple of F, fp32)."""
    for r in range(WORLD):
        lm = port[r]["lm"]
        F, n = lm["fsdp_size"], lm["leaves"]
        assert F == 2
        slack = n * F * 4
        (off_p, off_o), (z2_p, z2_o), (z3_p, z3_o) = (
            lm["bytes"][a] for a in ARMS)
        assert off_o > 0
        assert z2_o <= off_o / F + slack
        assert z2_p == off_p
        assert z3_p + z3_o <= (off_p + off_o) / F + 2 * slack


@pytest.mark.parametrize("mode", ["zero2", "zero3"])
def test_live_plan_and_values_match_jax(port, jax_plans, mode):
    assert all(port[r]["plans"]["reshard"] for r in range(WORLD))
    want = jax_plans[mode]
    assert '"fsdp"' in want["json"]
    for r in range(WORLD):
        got = port[r]["plans"][mode]
        assert got["json"] == want["json"]
        assert got["hash"] == want["hash"]
        for a, b in zip(got["values"], want["values"]):
            np.testing.assert_array_equal(a, b[r])


# -- refusals --------------------------------------------------------------------


REFUSALS = ["kwarg_sparse_algo", "kwarg_channels", "kwarg_cross_compression",
            "kwarg_fusion_threshold", "kwarg_algo", "kwarg_schedule",
            "zero1_conflict", "error_feedback", "unsummable_zero2",
            "unsummable_zero3", "eager_update", "eager_zero3_gather",
            "zero3_unbound", "zero3_sparse_params", "group_family",
            "subset_group", "trainer_elastic", "trainer_restore",
            "trainer_sync_state", "zero1_int8", "zero1_eager",
            "zero1_family"]


@pytest.mark.parametrize("case", REFUSALS)
def test_refusals_are_the_references_text(port, jax_refusals, case):
    want = jax_refusals[case]
    assert want is not None and want.startswith("HorovodError: ")
    for r in range(WORLD):
        assert port[r]["errors"][case] == want


# -- sharded checkpoints --------------------------------------------------------


def test_sharded_checkpoint_round_trips(port):
    for r in range(WORLD):
        ck = port[r]["checkpoint"]
        assert ck["path"] == f"checkpoint-00000.shard{r:03d}.pt"
        assert ck["round_trip"] and ck["shards_equal"]
        assert ck["optimizer_equal"] and ck["load_state"]


def test_a_torn_newest_shard_falls_back_one_epoch(port):
    for r in range(WORLD):
        ck = port[r]["checkpoint"]
        assert ck["latest"] == 0 and ck["agreed"] == 0
        assert ck["torn_warnings"] and all(
            w.startswith("Skipping incomplete sharded checkpoint epoch 1 in "
                         "<dir>: checkpoint-00001.shard")
            and w.endswith("(torn write)") for w in ck["torn_warnings"])
        ok, why = ck["verify_torn"]
        assert not ok and why.endswith("(torn write)")


def test_the_agreement_errors_are_the_references(port):
    """Rank-local directories with no epoch in common raise the
    reference's HorovodError (newest epoch 5, on rank 0), and directories
    with no shard at all its FileNotFoundError."""
    for r in range(WORLD):
        ck = port[r]["checkpoint"]
        local, _ = ck["dirs"]
        assert ck["disjoint"] == (
            f"HorovodError: No sharded checkpoint epoch in {local} is "
            f"loadable on EVERY process (the newest loadable epoch on some "
            f"process is 5). A torn shard from a crashed writer, or a "
            f"process topology change, leaves that process unable to match "
            f"its peers; restore the missing shard or resume from a "
            f"replicated-convention checkpoint.")
        assert ck["empty"] == "No sharded checkpoints in <dir>."
