"""Port parity: sequence parallelism (``parallel/sequence.py``: ring and
Ulysses attention, the zigzag layout) and the LM's ``'ring'``/
``'ulysses'`` paths, against ``horovod_tpu``'s.

One spawned 4-rank gloo world (module-scoped), ``hvd.init([[0, 1], [2, 3],
[0, 1, 2]])``: group 0 is a 4-member ring, group 1 a subset whose
non-members are ranks 2 and 3, the family ``(1, 2)`` two rings side by
side (DP × SP), and group 3 three ranks (for the refusals). The JAX side
runs the same per-rank numpy inputs (float32, made from a seed) over 4 CPU
devices under ``hvd.spmd`` with the same groups:

* ``ring_attention`` — contiguous and zigzag, ``impl='blockwise'`` and
  ``impl='flash'`` (the plain B3/B4 versions on the CPU; the reference's
  Pallas kernels in interpret mode), causal and not, GQA, segment ids, a
  window, ``block_k`` sub-blocking, a subset group and a family: outputs
  and the gradients of q, k and v (from a seeded cotangent) against JAX's
  and against the port's ``local_attention`` over the concatenated
  sequence (a non-member: over its own shard), at the JAX package's own
  tolerances (``tests/test_sequence.py``: 3e-2 forward, 6e-2 gradients);
* ``ulysses_attention`` — the whole group, segment ids, ``attn_fn``, the
  family and the subset group, the same way;
* the zigzag helpers exactly, and every refusal text byte for byte;
* the tiny LM (2 layers, E=64, 4 heads over 2 K/V heads, T=64 a replica,
  float32 config) at 2 DP × 2 SP under ``'ring'``, ``'ring'`` zigzag and
  ``'ulysses'``, weights carried by ``from_flax_params``: each rank's loss
  within 1e-2 relative and its gradients within 3e-2 relative L2 of JAX's
  ``make_loss_fn(cfg, sp_rank)`` (the errors are printed).

The spawned children import this module, so JAX is imported only inside
the parent-side functions.
"""

import numpy as np
import pytest
import torch

WORLD = 4
GROUPS = [[0, 1], [2, 3], [0, 1, 2]]
B, TL, H, D = 2, 16, 4, 16
HKV = 2
FWD_TOL = 3e-2
GRAD_TOL = 6e-2

# name: ring_attention keywords (``gqa``: 2 K/V heads, ``segs``: segment
# ids). Every case runs in one program on each side.
RING_CASES = {
    "block_k_segments": dict(impl="blockwise", block_k=8, gqa=True,
                             segs=True),
    "noncausal": dict(impl="blockwise", causal=False),
    "flash_window": dict(impl="flash", window=20, gqa=True),
    "flash_noncausal_segments": dict(impl="flash", causal=False, segs=True),
    "zigzag_window": dict(impl="blockwise", layout="zigzag", window=20,
                          gqa=True),
    "zigzag_flash_segments": dict(impl="flash", layout="zigzag", segs=True),
    "subset_flash": dict(impl="flash", group=1, gqa=True),
    "subset_zigzag": dict(impl="blockwise", layout="zigzag", group=1),
    "family": dict(impl="blockwise", group=(1, 2), gqa=True),
    "family_zigzag_flash": dict(impl="flash", layout="zigzag",
                                group=(1, 2)),
}
# The JAX side runs this flash case through its flash body (its Pallas
# kernels in interpret mode: seconds a case, 6 s under zigzag) and the
# others through its blockwise body, the same function.
JAX_FLASH = ("flash_window",)
ULYSSES_CASES = {
    "causal": dict(),
    "noncausal_segments": dict(causal=False, segs=True),
    "attn_fn": dict(attn_fn=True),
    "family": dict(group=(1, 2)),
    "subset_segments": dict(group=1, segs=True),
}
LM_ARCH = dict(vocab_size=97, num_layers=2, num_heads=4, num_kv_heads=2,
               embed_dim=64, mlp_dim=128, max_seq_len=64)
LM_T = 64
# Under 'ulysses' the model's sp_group is the family of both SP groups: its
# all-to-alls are registered collectives, and every rank of the program
# must register the same group (a ring's hops are not registered, so each
# rank may name its own group there).
LM_ARMS = {"ring": dict(attention="ring"),
           "zigzag": dict(attention="ring", sp_layout="zigzag"),
           "ulysses": dict(attention="ulysses", sp_group=(1, 2))}
LM_LOSS_TOL = 1e-2
LM_GRAD_TOL = 3e-2


def _inputs():
    """Per-rank (WORLD, ...) float32 q, k, v (MHA and GQA), the output
    cotangent and int32 segment ids (monotone in rank order)."""
    rng = np.random.RandomState(0)

    def n(*shape):
        return (rng.randn(WORLD, *shape) * 0.5).astype(np.float32)

    pos = np.arange(WORLD)[:, None] * TL + np.arange(TL)[None]
    segs = np.broadcast_to((pos // 12)[:, None], (WORLD, B, TL))
    return {"q": n(B, TL, H, D), "k": n(B, TL, H, D), "v": n(B, TL, H, D),
            "kg": n(B, TL, HKV, D), "vg": n(B, TL, HKV, D),
            "g": n(B, TL, H, D), "s": np.ascontiguousarray(segs, np.int32)}


def _case_args(x, kw):
    """(q, k, v, keyword arguments) of one case from the input dict."""
    kw = dict(kw)
    gqa = kw.pop("gqa", False)
    if kw.pop("segs", False):
        kw.update(q_segment_ids=x["s"], kv_segment_ids=x["s"])
    k, v = (x["kg"], x["vg"]) if gqa else (x["k"], x["v"])
    return x["q"], k, v, kw


def _refusal_arrays():
    """The refusal cases' per-rank (WORLD, ...) arrays: the inputs, 3 K/V
    heads for 4 q heads, an odd local length, and 3-dim q/k."""
    x = _inputs()
    return {"q": x["q"], "k": x["k"], "kg": x["kg"], "s": x["s"],
            "k3": np.repeat(x["kg"][..., :1, :], 3, axis=-2),
            "q15": x["q"][:, :, :15], "k15": x["k"][:, :, :15],
            "q3d": x["q"][..., 0], "k3d": x["k"][..., 0]}


def _lm_tokens():
    """Per replica (2), the (B, LM_T) int tokens."""
    return np.random.RandomState(7).randint(
        0, LM_ARCH["vocab_size"], size=(2, B, LM_T)).astype(np.int64)


def _lm_shards(layout):
    """(WORLD, B, LM_T / 2): rank r holds shard r % 2 of replica r // 2."""
    toks = _lm_tokens()
    out = []
    for r in range(WORLD):
        t = toks[r // 2]
        if layout == "zigzag":
            c = LM_T // 4
            i = r % 2
            out.append(np.concatenate([t[:, i * c:(i + 1) * c],
                                       t[:, (3 - i) * c:(4 - i) * c]], 1))
        else:
            out.append(t[:, (r % 2) * LM_T // 2:(r % 2 + 1) * LM_T // 2])
    return np.stack(out)


# -- the port's world ---------------------------------------------------------


def _message(fn):
    import horovod_tpu_torch as hvd

    try:
        fn()
    except (hvd.HorovodError, ValueError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def _vjp_cases(hvd, r, fn, cases):
    """Every case in one program: (out, dq, dk, dv) per case."""
    x = {k: torch.from_numpy(np.ascontiguousarray(v[r]))
         for k, v in _inputs().items()}

    def prog(**x):
        res = {}
        for name, kw in cases.items():
            q, k, v, kw = _case_args(x, kw)
            q, k, v = (t.clone().requires_grad_(True) for t in (q, k, v))
            out = fn(q, k, v, **kw)
            grads = torch.autograd.grad((out * x["g"]).sum(), (q, k, v))
            res[name] = [t.detach().numpy()
                         for t in (out,) + tuple(grads)]
        return res

    return hvd.spmd(lambda *a: prog(**dict(zip(x, a))))(*x.values())


def _ulysses(hvd, q, k, v, attn_fn=False, **kw):
    if attn_fn:
        kw["attn_fn"] = lambda q, k, v: hvd.local_attention(q, k, v,
                                                            causal=False)
    return hvd.ulysses_attention(q, k, v, **kw)


def _lm(hvd, r, state_dict):
    from horovod_tpu_torch.models import transformer as tt

    out = {}
    for arm, kw in LM_ARMS.items():
        own = 1 if r < 2 else 2
        cfg = tt.TransformerConfig(dtype=torch.float32, **LM_ARCH,
                                   **{"sp_group": own, **kw})
        model = tt.Transformer(cfg)
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in state_dict.items()})
        loss_fn = tt.make_loss_fn(cfg, lambda: hvd.rank(own))
        tokens = torch.from_numpy(_lm_shards(kw.get("sp_layout"))[r])

        def step(tokens):
            model.zero_grad()
            loss = loss_fn(model, tokens)
            loss.backward()
            return loss.detach()

        loss = hvd.spmd(step)(tokens)
        out[arm] = {"loss": float(loss), "grads": {
            n: p.grad.numpy().copy() for n, p in model.named_parameters()}}
    return out


def _refusals(hvd):
    from horovod_tpu_torch.models import transformer as tt

    a = {k: torch.from_numpy(np.ascontiguousarray(v[hvd.rank()]))
         for k, v in _refusal_arrays().items()}
    q, k = a["q"], a["k"]

    def ring(q=q, k=k, v=k, **kw):
        return lambda: hvd.spmd(lambda q, k, v: hvd.ring_attention(
            q, k, v, **kw))(q, k, v)

    def uly(q=q, k=k, v=k, **kw):
        return lambda: hvd.spmd(lambda q, k, v: hvd.ulysses_attention(
            q, k, v, **kw))(q, k, v)

    out = {name: _message(fn)
           for name, fn in _ring_refusals(ring, uly, a).items()}
    out["ring_eager"] = _message(lambda: hvd.ring_attention(q, k, k))
    out["ulysses_eager"] = _message(lambda: hvd.ulysses_attention(q, k, k))
    cfg = tt.TransformerConfig(dtype=torch.float32, **LM_ARCH)
    toks = torch.zeros((1, 8), dtype=torch.long)
    model = tt.Transformer(cfg)
    for name, fn in _lm_refusals(
            lambda **kw: tt.Transformer(cfg._replace(**kw)),
            lambda m: m(toks),
            lambda kw, **mk: tt.make_loss_fn(cfg._replace(**kw), **mk)(
                model, toks)).items():
        out[name] = _message(fn)
    return out


def _ring_refusals(ring, uly, a):
    """The refusal cases, the same closures on both sides, over the arrays
    of :func:`_refusal_arrays`."""
    return {
        "ndim": ring(q=a["q3d"], k=a["k3d"], v=a["k3d"]),
        "gqa": ring(k=a["k3"], v=a["k3"]),
        "segments": ring(q_segment_ids=a["s"]),
        "layout": ring(layout="striped"),
        "zigzag_impl": ring(layout="zigzag", impl="xla"),
        "zigzag_block_k": ring(layout="zigzag", block_k=8),
        "zigzag_odd": ring(q=a["q15"], k=a["k15"], v=a["k15"],
                           layout="zigzag"),
        "flash_block_k": ring(impl="flash", block_k=8),
        "impl": ring(impl="xla"),
        "block_k_divides": ring(impl="blockwise", block_k=6),
        "family_empty": ring(group=()),
        "family_unequal": ring(group=(1, 3)),
        "family_overlap": ring(group=(1, 1)),
        "ulysses_segments": uly(kv_segment_ids=a["s"]),
        "ulysses_heads": uly(k=a["kg"], v=a["kg"]),
        "ulysses_divides": uly(group=3),
    }


def _lm_refusals(model, fwd, loss):
    """The LM's refusals: ``model(**config changes)``, ``fwd(model)``,
    ``loss(config changes, **make_loss_fn keywords)``."""
    return {
        "lm_zigzag_local": lambda: fwd(model(sp_layout="zigzag")),
        "lm_zigzag_positions": lambda: fwd(model(attention="ring",
                                                 sp_layout="zigzag")),
        "lm_ulysses_window": lambda: fwd(model(attention="ulysses",
                                               window=4)),
        "lm_unknown": lambda: fwd(model(attention="sparse")),
        "lm_zigzag_fused": lambda: loss(dict(attention="ring",
                                             sp_layout="zigzag"),
                                        sp_rank=lambda: 0, fused_head=True),
        "lm_zigzag_sp_rank": lambda: loss(dict(attention="ring",
                                               sp_layout="zigzag")),
    }


def _ring_program(hvd, r):
    """A ring over each rank's own 2-member group: its schedule (hops are
    not registered, so ranks naming different groups agree), and the ring
    steps run in the forward and in forward + backward (the checkpoint's
    recompute)."""
    from horovod_tpu_torch.parallel import sequence

    x = {k: torch.from_numpy(np.ascontiguousarray(v[r]))
         for k, v in _inputs().items()}
    calls = []
    step = sequence.ring_step

    def counted(*a, **kw):
        calls.append(1)
        return step(*a, **kw)

    sequence.ring_step = counted
    try:
        def fn(q, k, v):
            q = q.clone().requires_grad_(True)
            out = hvd.ring_attention(q, k, v, group=1 if r < 2 else 2,
                                     impl="flash")
            n_fwd = len(calls)
            out.sum().backward()
            return n_fwd

        prog = hvd.spmd(fn)
        n_fwd = prog(x["q"], x["k"], x["v"])
    finally:
        sequence.ring_step = step
    return {"schedule": next(iter(prog.programs.values())).schedule,
            "forward_steps": n_fwd, "steps": len(calls)}


def _port_world(state_dict):
    import horovod_tpu_torch as hvd

    hvd.init(GROUPS, device="cpu")
    r = hvd.rank()
    return {"ring": _vjp_cases(hvd, r, hvd.ring_attention, RING_CASES),
            "program": _ring_program(hvd, r),
            "ulysses": _vjp_cases(hvd, r, lambda *a, **kw: _ulysses(
                hvd, *a, **kw), ULYSSES_CASES),
            "lm": _lm(hvd, r, state_dict),
            "errors": _refusals(hvd)}


# -- the JAX side -------------------------------------------------------------


@pytest.fixture(scope="module")
def lm_params():
    import jax
    import jax.numpy as jnp

    from horovod_tpu.models import transformer as jt
    from horovod_tpu_torch.models import transformer as tt

    cfg = jt.TransformerConfig(dtype=jnp.float32, **LM_ARCH)
    params = jax.tree.map(np.asarray, jt.init_params(cfg))
    return params, {k: v.numpy() for k, v in
                    tt.from_flax_params(params).items()}


@pytest.fixture(scope="module")
def port(lm_params):
    from horovod_tpu_torch.run import run

    return run(_port_world, WORLD, device="cpu", timeout=300,
               args=(lm_params[1],))


@pytest.fixture(scope="module")
def jhvd():
    import jax

    import horovod_tpu as jhvd

    jhvd.shutdown()
    jhvd.init(GROUPS, devices=jax.devices()[:WORLD])
    yield jhvd
    jhvd.shutdown()


def _jax_message(fn):
    from horovod_tpu.core.state import HorovodError

    try:
        fn()
    except (HorovodError, ValueError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def _jax_vjp_cases(jhvd, fn, cases):
    import jax

    x = _inputs()

    def prog(x):
        res = {}
        for name, kw in cases.items():
            q, k, v, kw = _case_args(x, kw)
            if kw.get("impl") == "flash" and name not in JAX_FLASH:
                kw["impl"] = "blockwise"
            out, vjp = jax.vjp(lambda q, k, v: fn(q, k, v, **kw), q, k, v)
            res[name] = (out,) + tuple(vjp(x["g"]))
        return res

    res = jhvd.spmd(prog)(x)
    return {n: [np.asarray(t) for t in ts] for n, ts in res.items()}


@pytest.fixture(scope="module")
def jax_ring(jhvd):
    return _jax_vjp_cases(jhvd, jhvd.ring_attention, RING_CASES)


@pytest.fixture(scope="module")
def jax_ulysses(jhvd):
    def uly(q, k, v, attn_fn=False, **kw):
        if attn_fn:
            kw["attn_fn"] = lambda q, k, v: jhvd.local_attention(
                q, k, v, causal=False)
        return jhvd.ulysses_attention(q, k, v, **kw)

    return _jax_vjp_cases(jhvd, uly, ULYSSES_CASES)


@pytest.fixture(scope="module")
def jax_lm(jhvd, lm_params):
    import jax
    import jax.numpy as jnp

    from horovod_tpu.models import transformer as jt
    from horovod_tpu_torch.models import transformer as tt

    params = lm_params[0]
    out = {}
    for arm, kw in LM_ARMS.items():
        def own():
            return jnp.where(jhvd.rank(2) >= 0, jhvd.rank(2), jhvd.rank(1))

        if kw.get("sp_layout") != "zigzag":
            # One program for both rings: the family (1, 2), the same
            # function as each rank's own group.
            loss_fn = jt.make_loss_fn(
                jt.TransformerConfig(dtype=jnp.float32, **LM_ARCH,
                                     **{"sp_group": (1, 2), **kw}), own)
        else:
            fns = [jt.make_loss_fn(
                jt.TransformerConfig(dtype=jnp.float32, sp_group=g,
                                     **LM_ARCH, **kw),
                lambda g=g: jhvd.rank(g)) for g in (1, 2)]

            def loss_fn(p, toks):
                # Every rank evaluates both groups' programs and keeps its
                # own group's (the reference example's DP × SP selection).
                return jnp.where(jhvd.rank(2) >= 0, fns[1](p, toks),
                                 fns[0](p, toks))

        loss, grads = jhvd.spmd(jax.value_and_grad(loss_fn))(
            jhvd.replicate(params),
            _lm_shards(kw.get("sp_layout")).astype(np.int32))
        grads = jax.tree.map(np.asarray, grads)
        out[arm] = {"loss": np.asarray(loss), "grads": [
            {k: v.numpy() for k, v in tt.from_flax_params(
                jax.tree.map(lambda a: a[r], grads)).items()}
            for r in range(WORLD)]}
    return out


@pytest.fixture(scope="module")
def jax_refusals(jhvd):
    import jax.numpy as jnp

    from horovod_tpu.models import transformer as jt

    a = _refusal_arrays()
    q, k = a["q"], a["k"]

    def ring(q=q, k=k, v=k, **kw):
        return lambda: jhvd.spmd(lambda q, k, v: jhvd.ring_attention(
            q, k, v, **kw))(q, k, v)

    def uly(q=q, k=k, v=k, **kw):
        return lambda: jhvd.spmd(lambda q, k, v: jhvd.ulysses_attention(
            q, k, v, **kw))(q, k, v)

    out = {name: _jax_message(fn)
           for name, fn in _ring_refusals(ring, uly, a).items()}
    out["ring_eager"] = _jax_message(lambda: jhvd.ring_attention(
        q[0], k[0], k[0]))
    out["ulysses_eager"] = _jax_message(lambda: jhvd.ulysses_attention(
        q[0], k[0], k[0]))
    cfg = jt.TransformerConfig(dtype=jnp.float32, **LM_ARCH)
    params = jt.init_params(cfg)
    toks = jnp.zeros((1, 8), jnp.int32)

    def apply(m, **kw):
        return m.apply({"params": params}, toks, **kw)

    for name, fn in _lm_refusals(
            lambda **kw: jt.Transformer(cfg._replace(**kw)),
            apply,
            lambda kw, **mk: jt.make_loss_fn(cfg._replace(**kw), **mk)(
                params, toks)).items():
        out[name] = _jax_message(fn)
    return out


# -- references over the concatenated sequence ------------------------------


def _rings(group, layout):
    """[(ranks in ring order, layout)] of a case; a non-member's ring is
    itself (contiguous: its own shard, attended at rank 0's positions, is
    causal attention over the shard, as long as no window applies)."""
    groups = {0: [[0, 1, 2, 3]], 1: [[0, 1]], (1, 2): [[0, 1], [2, 3]],
              (2, 3): [[2], [3]]}
    rings = [(ranks, layout) for ranks in groups[group]]
    members = {r for ranks, _ in rings for r in ranks}
    return rings + [([r], "contiguous") for r in range(WORLD)
                    if r not in members]


def _join(parts, layout):
    """Concatenate shards (B, T, ...) in sequence order."""
    if layout == "zigzag" and len(parts) > 1:
        halves = [torch.from_numpy(p).chunk(2, dim=1) for p in parts]
        order = [h[0] for h in halves] + [h[1] for h in halves[::-1]]
        return torch.cat(order, dim=1)
    return torch.cat([torch.from_numpy(p) for p in parts], dim=1)


def _split(t, n, layout):
    """Inverse of :func:`_join`: n shards of t."""
    if layout == "zigzag" and n > 1:
        c = t.chunk(2 * n, dim=1)
        return [torch.cat([c[i], c[2 * n - 1 - i]], dim=1).numpy()
                for i in range(n)]
    return [s.numpy() for s in t.chunk(n, dim=1)]


def _local_reference(kw):
    """(WORLD lists of out, dq, dk, dv) from the port's fp32
    ``local_attention`` over each ring's concatenated sequence."""
    from horovod_tpu_torch.parallel.sequence import local_attention

    x = _inputs()
    q, k, v, kw = _case_args(x, kw)
    layout = kw.pop("layout", "contiguous")
    group = kw.pop("group", 0)
    causal = kw.get("causal", True)
    out = [None] * WORLD
    for ranks, lay in _rings(group, layout):
        cat = [_join([a[r] for r in ranks], lay) for a in (q, k, v)]
        cat = [t.requires_grad_(True) for t in cat]
        seg = {}
        if "q_segment_ids" in kw:
            s = _join([x["s"][r] for r in ranks], lay)
            seg = dict(q_segment_ids=s, kv_segment_ids=s)
        o = local_attention(*cat, causal=causal, impl="xla",
                            window=kw.get("window"), **seg)
        g = _join([x["g"][r] for r in ranks], lay)
        grads = torch.autograd.grad((o * g).sum(), cat)
        parts = [_split(t.detach(), len(ranks), lay)
                 for t in (o,) + tuple(grads)]
        for i, r in enumerate(ranks):
            out[r] = [p[i] for p in parts]
    return out


def _close(got, want, what):
    for i, (a, b) in enumerate(zip(got, want)):
        tol = FWD_TOL if i == 0 else GRAD_TOL
        np.testing.assert_allclose(a, b, atol=tol, rtol=tol,
                                   err_msg=f"{what} {('out', 'dq', 'dk', 'dv')[i]}")


# -- the tests ------------------------------------------------------------------


@pytest.mark.parametrize("case", list(RING_CASES))
def test_ring_attention_matches_jax(port, jax_ring, case):
    for r in range(WORLD):
        _close(port[r]["ring"][case], [t[r] for t in jax_ring[case]],
               f"rank {r}")


@pytest.mark.parametrize("case", list(RING_CASES))
def test_ring_attention_matches_local_attention(port, case):
    want = _local_reference(RING_CASES[case])
    for r in range(WORLD):
        _close(port[r]["ring"][case], want[r], f"rank {r}")


@pytest.mark.parametrize("case", ["subset_flash", "subset_zigzag"])
def test_a_non_member_attends_over_its_own_shard(port, case):
    """Ranks 2 and 3 are outside group 1: their output is causal attention
    over their own shard, and their gradients stay their own."""
    want = _local_reference(dict(RING_CASES[case], group=(2, 3),
                                 layout="contiguous"))
    for r in (2, 3):
        _close(port[r]["ring"][case], want[r], f"rank {r}")


@pytest.mark.parametrize("case", list(ULYSSES_CASES))
def test_ulysses_attention_matches_jax(port, jax_ulysses, case):
    for r in range(WORLD):
        _close(port[r]["ulysses"][case], [t[r] for t in jax_ulysses[case]],
               f"rank {r}")


@pytest.mark.parametrize("case", [c for c in ULYSSES_CASES
                                  if c != "attn_fn"])
def test_ulysses_attention_matches_local_attention(port, case):
    want = _local_reference(ULYSSES_CASES[case])
    for r in range(WORLD):
        _close(port[r]["ulysses"][case], want[r], f"rank {r}")


def test_zigzag_helpers_match_jax_exactly():
    import jax.numpy as jnp

    from horovod_tpu.parallel import sequence as js
    from horovod_tpu_torch.parallel import sequence as ts

    x = np.arange(2 * 32 * 3, dtype=np.float32).reshape(2, 32, 3)
    for g in (1, 2, 4):
        got = ts.zigzag_shard(torch.from_numpy(x), g)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(js.zigzag_shard(x, g)))
        np.testing.assert_array_equal(ts.zigzag_unshard(got).numpy(), x)
        for r in range(-1, g):
            np.testing.assert_array_equal(
                ts.zigzag_positions(r, 32 // g, g).numpy(),
                np.asarray(js.zigzag_positions(jnp.int32(r), 32 // g, g)))


@pytest.mark.parametrize("arm", list(LM_ARMS))
def test_the_tiny_lm_matches_jax(port, jax_lm, arm):
    want = jax_lm[arm]
    for r in range(WORLD):
        got = port[r]["lm"][arm]
        loss_err = abs(got["loss"] - float(want["loss"][r])) / abs(
            float(want["loss"][r]))
        num = sum(float(np.sum((got["grads"][n] - w) ** 2))
                  for n, w in want["grads"][r].items())
        den = sum(float(np.sum(w ** 2)) for w in want["grads"][r].values())
        grad_err = (num / den) ** 0.5
        print(f"{arm} rank {r}: loss rel err {loss_err:.2e}, gradient rel "
              f"L2 err {grad_err:.2e}")
        assert set(got["grads"]) == set(want["grads"][r])
        assert loss_err < LM_LOSS_TOL
        assert grad_err < LM_GRAD_TOL


def test_ring_hops_are_not_in_the_schedule(port):
    """The hops are point-to-point, unregistered (the reference registers
    no ppermute): ranks whose rings are different groups validate one
    empty schedule."""
    for rank_out in port:
        assert rank_out["program"]["schedule"] == []


def test_each_ring_step_is_recomputed_in_the_backward(port):
    """Two members, two steps a forward; the backward runs each step again
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``)."""
    for rank_out in port:
        assert rank_out["program"]["forward_steps"] == 2
        assert rank_out["program"]["steps"] == 4


REFUSALS = ("ring_eager", "ulysses_eager", "ndim", "gqa", "segments",
            "layout", "zigzag_impl", "zigzag_block_k", "zigzag_odd",
            "flash_block_k", "impl", "block_k_divides", "family_empty",
            "family_unequal", "family_overlap", "ulysses_segments",
            "ulysses_heads", "ulysses_divides", "lm_zigzag_local",
            "lm_zigzag_positions", "lm_ulysses_window", "lm_unknown",
            "lm_zigzag_fused", "lm_zigzag_sp_rank")


@pytest.mark.parametrize("case", REFUSALS)
def test_refusals_are_the_references_text(port, jax_refusals, case):
    want = jax_refusals[case]
    assert want is not None
    for rank_out in port:
        assert rank_out["errors"][case] == want
