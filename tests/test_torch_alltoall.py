"""Port parity: ``alltoall``, ``reducescatter`` and the group families of
``horovod_tpu_torch`` against ``horovod_tpu``.

One spawned 8-rank gloo world (module-scoped) runs every port-side case
with the groups of ``GROUPS``; the JAX side runs the same per-rank numpy
inputs through ``hvd.init(GROUPS)`` over the 8-device CPU world, eagerly
(per-rank lists) and inside ``hvd.spmd`` (rank-stacked). Group 0 is the
same 8-rank world on both sides. The spawned children import this module
to find their target, so JAX is imported only inside the parent-side
functions.

The inputs are integer-valued float32, so every sum is exact in any order:
every comparison is exact. A rank outside a subset group gets ``None``
(the port's convention; the JAX package's traced collectives hand such a
rank its own block), so only members are compared. Refusals are compared
with the JAX package's messages byte for byte.
"""

import numpy as np
import pytest
import torch

GROUPS = [[0, 1, 2, 3], [4, 5, 6, 7], [0, 2, 4, 6], [1, 3, 5, 7],
          [0, 1, 2], [3, 4, 5, 6, 7], [2, 3]]
WORLD = 8
ROWS = 24  # divisible by 8, 4 and 3


def _members(g):
    return list(range(WORLD)) if g == 0 else GROUPS[g - 1]


def _value(rank, seed=0, rows=ROWS):
    rng = np.random.RandomState(100 * seed + rank)
    return rng.randint(-8, 9, (rows, 3)).astype(np.float32)


def _ints(rank):
    return np.random.RandomState(50 + rank).randint(-20, 20, (ROWS, 2)
                                                    ).astype(np.int32)


# Families run inside a program: op, family, kwargs.
FAMILY_CASES = {
    "ar_12_sum": ("allreduce", (1, 2), dict(average=False)),
    "ar_34_avg": ("allreduce", (3, 4), {}),
    "ar_56_unequal": ("allreduce", (5, 6), {}),
    "ar_7_not_covering": ("allreduce", (7,), {}),
    "ar_1_not_covering_sum": ("allreduce", (1,), dict(average=False)),
    "ag_12": ("allgather", (1, 2), {}),
    "ag_34": ("allgather", (3, 4), {}),
    "a2a_12": ("alltoall", (1, 2), {}),
    "a2a_34": ("alltoall", (3, 4), {}),
    "rs_12": ("reducescatter", (1, 2), {}),
    "rs_34": ("reducescatter", (3, 4), {}),
}

# Families the reference refuses: op, family, rows of the input.
REFUSALS = {
    "ar_empty": ("allreduce", (), ROWS),
    "ar_not_disjoint": ("allreduce", (1, 3), ROWS),
    "ag_not_disjoint": ("allgather", (1, 3), ROWS),
    "ag_unequal": ("allgather", (5, 6), ROWS),
    "ag_not_covering": ("allgather", (7,), ROWS),
    "a2a_not_disjoint": ("alltoall", (3, 5), ROWS),
    "a2a_unequal": ("alltoall", (5, 6), ROWS),
    "a2a_not_covering": ("alltoall", (1,), ROWS),
    "a2a_indivisible": ("alltoall", (1, 2), 6),
    "rs_not_disjoint": ("reducescatter", (2, 6), ROWS),
    "rs_unequal": ("reducescatter", (5, 6), ROWS),
    "rs_not_covering": ("reducescatter", (7,), ROWS),
    "rs_indivisible": ("reducescatter", (3, 4), 6),
}

OPS = ("allreduce", "allgather", "alltoall", "reducescatter")


def _np(t):
    return None if t is None else t.numpy()


def _message(fn):
    import horovod_tpu_torch as hvd

    try:
        fn()
    except hvd.HorovodError as e:
        return str(e)
    return None


def _program_step(x):
    """The per-rank program both frameworks run (group 0)."""
    import horovod_tpu_torch as hvd

    out = {"rs0": hvd.reducescatter(x, name="p_rs0"),
           "a2a0": hvd.alltoall(x, name="p_a2a0"),
           "rs1": hvd.reducescatter(x, group=1, name="p_rs1"),
           "a2a5": hvd.alltoall(x, group=5, name="p_a2a5"),
           "identity": hvd.allgather(hvd.reducescatter(x, name="p_id_rs"),
                                     name="p_id_ag"),
           "allreduce": hvd.allreduce(x, average=False, name="p_ar")}
    for key, (op, fam, kw) in FAMILY_CASES.items():
        out[key] = getattr(hvd, op)(x, group=fam, name=f"f_{key}", **kw)
    return out


def _port_world():
    import horovod_tpu_torch as hvd

    hvd.init(GROUPS, device="cpu")
    r = hvd.global_rank()
    x = torch.from_numpy(_value(r))
    out = {}
    for g in (0, 1, 5):
        out[("rs", g)] = _np(hvd.reducescatter(x, group=g, name=f"rs{g}"))
        out[("a2a", g)] = _np(hvd.alltoall(x, group=g, name=f"a2a{g}"))
    out["rs_bool"] = _np(hvd.reducescatter(x > 4, name="rs_bool"))
    out["rs_int"] = _np(hvd.reducescatter(torch.from_numpy(_ints(r)),
                                          name="rs_int"))
    out["a2a_bool"] = _np(hvd.alltoall(x > 4, name="a2a_bool"))
    out[("identity", "eager")] = (
        _np(hvd.allgather(hvd.reducescatter(x, name="id_rs"),
                          name="id_ag")),
        _np(hvd.allreduce(x, average=False, name="id_ar")))

    step = hvd.spmd(_program_step)
    calls = [step(torch.from_numpy(_value(r, seed=s))) for s in (1, 1, 2)]
    out["program"] = [{k: _np(v) for k, v in c.items()} for c in calls]
    out["schedule"] = next(iter(step.programs.values())).schedule
    out["trace_count"] = step.trace_count

    errors = {}
    for key, (op, fam, rows) in REFUSALS.items():
        xs = torch.from_numpy(_value(r, rows=rows))
        errors[key] = _message(lambda: hvd.spmd(
            lambda t: getattr(hvd, op)(t, group=fam, name=f"bad_{key}"))(xs))
    for op in OPS:
        errors[f"eager_{op}"] = _message(
            lambda: getattr(hvd, op)(x, group=(1, 2)))
    errors["rs_shape"] = _message(lambda: hvd.reducescatter(
        torch.ones((16, 3) if r == 2 else (ROWS, 3)), name="bad_rs_shape"))
    errors["a2a_shape"] = _message(lambda: hvd.alltoall(
        torch.ones((ROWS, 4) if r == 5 else (ROWS, 3)), name="bad_a2a_shape"))
    errors["rs_div"] = _message(lambda: hvd.reducescatter(
        torch.ones(6, 3), name="bad_rs_div"))
    errors["a2a_div"] = _message(lambda: hvd.alltoall(
        torch.ones(4, 3), group=5, name="bad_a2a_div"))
    out["errors"] = errors
    out["after"] = _np(hvd.reducescatter(torch.ones(8), name="after"))
    return out


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    from horovod_tpu_torch.run import run

    return run(_port_world, WORLD, device="cpu", timeout=240)


@pytest.fixture(scope="module")
def jax_side():
    """Every JAX-side result and refusal, computed once."""
    import jax
    import jax.numpy as jnp

    import horovod_tpu as jhvd

    jhvd.shutdown()
    jhvd.init(GROUPS, devices=jax.devices()[:WORLD])
    try:
        res = {}
        xs = [jnp.asarray(_value(r)) for r in range(WORLD)]
        for g in (0, 1, 5):
            mem = [xs[r] for r in _members(g)]
            for op, key in (("reducescatter", "rs"), ("alltoall", "a2a")):
                outs = getattr(jhvd, op)(mem, group=g, name=f"j{key}{g}")
                res[(key, g)] = dict(zip(_members(g),
                                         map(np.asarray, outs)))
        res["rs_bool"] = [np.asarray(o) for o in jhvd.reducescatter(
            [x > 4 for x in xs], name="jrs_bool")]
        res["rs_int"] = [np.asarray(o) for o in jhvd.reducescatter(
            [jnp.asarray(_ints(r)) for r in range(WORLD)], name="jrs_int")]
        res["a2a_bool"] = [np.asarray(o) for o in jhvd.alltoall(
            [x > 4 for x in xs], name="ja2a_bool")]

        def jstep(x):
            out = {"rs0": jhvd.reducescatter(x, name="p_rs0"),
                   "a2a0": jhvd.alltoall(x, name="p_a2a0"),
                   "rs1": jhvd.reducescatter(x, group=1, name="p_rs1"),
                   "a2a5": jhvd.alltoall(x, group=5, name="p_a2a5"),
                   "identity": jhvd.allgather(
                       jhvd.reducescatter(x, name="p_id_rs"),
                       name="p_id_ag"),
                   "allreduce": jhvd.allreduce(x, average=False,
                                               name="p_ar")}
            for key, (op, fam, kw) in FAMILY_CASES.items():
                out[key] = getattr(jhvd, op)(x, group=fam, name=f"f_{key}",
                                             **kw)
            return out

        prog = jhvd.spmd(jstep)
        res["program"] = {}
        for s in (1, 2):
            stacked = jhvd.rank_stack([jnp.asarray(_value(r, seed=s))
                                       for r in range(WORLD)])
            res["program"][s] = {k: np.asarray(v)
                                 for k, v in prog(stacked).items()}

        errors = {}
        for key, (op, fam, rows) in REFUSALS.items():
            stacked = jhvd.rank_stack([jnp.asarray(_value(r, rows=rows))
                                       for r in range(WORLD)])
            with pytest.raises(jhvd.HorovodError) as info:
                jhvd.spmd(lambda t: getattr(jhvd, op)(
                    t, group=fam, name=f"bad_{key}"))(stacked)
            errors[key] = str(info.value)
        for op in OPS:
            with pytest.raises(jhvd.HorovodError) as info:
                getattr(jhvd, op)(xs, group=(1, 2))
            errors[f"eager_{op}"] = str(info.value)
        bad = {
            "rs_shape": ("reducescatter", [jnp.ones((16, 3) if r == 2 else
                                                    (ROWS, 3))
                                           for r in range(WORLD)], 0),
            "a2a_shape": ("alltoall", [jnp.ones((ROWS, 4) if r == 5 else
                                                (ROWS, 3))
                                       for r in range(WORLD)], 0),
            "rs_div": ("reducescatter", [jnp.ones((6, 3))] * WORLD, 0),
            "a2a_div": ("alltoall", [jnp.ones((4, 3))] * 3, 5),
        }
        for key, (op, vals, g) in bad.items():
            with pytest.raises(jhvd.HorovodError) as info:
                getattr(jhvd, op)(vals, group=g, name=f"bad_{key}")
            errors[key] = str(info.value)
        res["errors"] = errors
        return res
    finally:
        jhvd.shutdown()


@pytest.mark.parametrize("op", ["rs", "a2a"])
@pytest.mark.parametrize("g", [0, 1, 5])
def test_eager_matches_jax_and_non_members_get_none(port, jax_side, op, g):
    for r in range(WORLD):
        got = port[r][(op, g)]
        if r in _members(g):
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, jax_side[(op, g)][r])
        else:
            assert got is None


@pytest.mark.parametrize("key", ["rs_bool", "rs_int", "a2a_bool"])
def test_bool_and_int_dtypes_match_jax(port, jax_side, key):
    for r in range(WORLD):
        want = jax_side[key][r]
        assert port[r][key].dtype == want.dtype
        np.testing.assert_array_equal(port[r][key], want)


def test_eager_reducescatter_then_allgather_is_allreduce(port):
    for r in range(WORLD):
        gathered, summed = port[r][("identity", "eager")]
        np.testing.assert_array_equal(gathered, summed)


@pytest.mark.parametrize("key", ["rs0", "a2a0", "rs1", "a2a5", "identity",
                                 "allreduce"] + sorted(FAMILY_CASES))
@pytest.mark.parametrize("call", [0, 2])
def test_program_matches_jax_spmd(port, jax_side, key, call):
    """Inside a program: the collectives, subset groups (members only) and
    group families, on the first call (negotiated) and on a later one."""
    seed = 1 if call == 0 else 2
    want = jax_side["program"][seed][key]
    members = range(WORLD)
    if key == "rs1":
        members = _members(1)
    elif key == "a2a5":
        members = _members(5)
    for r in range(WORLD):
        got = port[r]["program"][call][key]
        if r not in members:
            assert got is None
            continue
        np.testing.assert_array_equal(got, want[r])


def test_program_identity_and_non_member_of_a_family(port):
    """reducescatter + allgather = allreduce in a program, and a rank in no
    group of an allreduce family gets its input back."""
    for r in range(WORLD):
        p = port[r]["program"][0]
        np.testing.assert_array_equal(p["identity"], p["allreduce"])
        if r not in GROUPS[6]:
            np.testing.assert_array_equal(p["ar_7_not_covering"],
                                          _value(r, seed=1))
        if r not in GROUPS[0]:
            np.testing.assert_array_equal(p["ar_1_not_covering_sum"],
                                          _value(r, seed=1))


def test_program_records_once_and_the_schedule_holds_the_family(port):
    for r in range(WORLD):
        assert port[r]["trace_count"] == 1
        for k, v in port[r]["program"][0].items():
            w = port[r]["program"][1][k]
            assert (v is None and w is None) or np.array_equal(v, w), k
        rows = {row[0]: row for row in port[r]["schedule"]}
        assert rows["f_rs_34"] == ["f_rs_34", "REDUCESCATTER", "float32",
                                   [ROWS, 3], [3, 4], -1, []]
        assert rows["f_ar_7_not_covering"][4] == [7]
        assert rows["p_a2a5"][4] == 5


@pytest.mark.parametrize("key", sorted(REFUSALS) + [
    f"eager_{op}" for op in OPS] + ["rs_shape", "a2a_shape", "rs_div",
                                    "a2a_div"])
def test_refusals_match_jax(port, jax_side, key):
    """Every refusal raises the reference's text on every rank that takes
    part (a non-member of the eager subset-group call gets None)."""
    want = jax_side["errors"][key]
    for r in range(WORLD):
        got = port[r]["errors"][key]
        if key == "a2a_div" and r not in _members(5):
            assert got is None
        else:
            assert got == want, (r, got, want)


def test_the_world_survives_refusals(port):
    for r in range(WORLD):
        np.testing.assert_array_equal(port[r]["after"], [8.0])
