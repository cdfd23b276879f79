"""The port's artifact verifiers (``analysis/schedule.py``'s verifier
layer, ``analysis/hlo.py``'s parser, ``analysis/report.py``) against the
JAX package's, finding for finding, on the CPU.

* ``verify_exchange_artifact`` and ``verify_tuned_config`` on the lint
  corpus (``bad_elastic_dropped_rank.exchange.json``,
  ``bad_tuned_config.tuned.json``; the tuned config in the port's schema
  and level names for the port, whose verifier refuses the TPU artifact
  itself), and the other corpus files the copied layer reads (HLO dumps,
  schedule listings, the serve journal).
* Pairs the port writes (``ExchangeSchedule.save`` + ``TunedConfig.save``)
  against the same pairs the JAX package writes, clean and under
  mutations: a hash mismatch, an impossible world, an unknown knob, a
  corrupt field, knob values without a lowering, a plan that disagrees
  with its knobs, a missing sibling.
"""

import json
import pathlib

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
CORPUS = REPO / "tests" / "lint_corpus"
LEVEL = {"nvlink": "ici", "ib": "dcn"}
PORT_SCHEMA = "horovod_tpu_torch/tuned-config/v1"


def _rows(findings, path=None, to=None):
    """Findings as comparable rows (a path replaced where the two sides'
    files differ in place only)."""
    out = []
    for f in findings:
        row = (f.rule, f.path, f.line, f.message)
        if path is not None:
            row = tuple(x.replace(path, to) if isinstance(x, str) else x
                        for x in row)
        out.append(row)
    return out


def _verifiers():
    from horovod_tpu.analysis import schedule as jsched
    from horovod_tpu_torch.analysis import schedule as tsched

    return jsched, tsched


def _as_port_tuned(text: str) -> str:
    """A JAX-package tuned config in the port's schema and level names."""
    d = json.loads(text)
    d["schema"] = PORT_SCHEMA
    d["constants"] = {({v: k for k, v in LEVEL.items()}).get(k, k): v
                      for k, v in d["constants"].items()}
    return json.dumps(d, indent=1, sort_keys=True)


def test_the_exchange_corpus_artifact_matches_jax():
    jsched, tsched = _verifiers()
    path = str(CORPUS / "bad_elastic_dropped_rank.exchange.json")
    text = open(path).read()
    want = jsched.verify_exchange_artifact(text, path)
    got = tsched.verify_exchange_artifact(text, path)
    assert _rows(got) == _rows(want) and want
    assert [str(f) for f in got] == [str(f) for f in want]


def test_the_tuned_corpus_artifact_matches_jax(tmp_path):
    jsched, tsched = _verifiers()
    src = CORPUS / "bad_tuned_config.tuned.json"
    want = jsched.verify_tuned_config(src.read_text(), str(src))
    # The port's copy beside the same sibling, in the port's layout.
    path = tmp_path / "bad_tuned_config.tuned.json"
    path.write_text(_as_port_tuned(src.read_text()))
    (tmp_path / "bad_elastic_dropped_rank.exchange.json").write_text(
        (CORPUS / "bad_elastic_dropped_rank.exchange.json").read_text())
    got = tsched.verify_tuned_config(path.read_text(), str(path))
    assert _rows(got, str(path), str(src)) == _rows(want)
    assert [f.rule for f in got] == ["HVD103"]


def test_the_port_refuses_a_tpu_tuned_config():
    _, tsched = _verifiers()
    src = CORPUS / "bad_tuned_config.tuned.json"
    [f] = tsched.verify_tuned_config(src.read_text(), str(src))
    assert (f.rule, f.line) == ("HVD103", 1)
    assert f.message == (
        f"TunedConfig schema mismatch: expected {PORT_SCHEMA!r}, got "
        f"'horovod_tpu/tuned-config/v1' — a stale artifact layout is "
        f"refused, never field-guessed.")


CORPUS_FILES = sorted(p.name for p in CORPUS.iterdir()
                      if p.name.endswith((".hlo", ".sched.json",
                                          ".journal.json")))


@pytest.mark.parametrize("name", CORPUS_FILES)
def test_the_other_corpus_artifacts_match_jax(name):
    jsched, tsched = _verifiers()
    path = str(CORPUS / name)
    text = open(path).read()
    fn = ("verify_hlo_text" if name.endswith(".hlo") else
          "verify_sched_listing" if name.endswith(".sched.json")
          else "verify_journal_artifact")
    want = getattr(jsched, fn)(text, path)
    got = getattr(tsched, fn)(text, path)
    assert _rows(got) == _rows(want) and want


def test_the_rule_catalog_is_the_references():
    from horovod_tpu.analysis import report as jr
    from horovod_tpu_torch.analysis import report as tr

    assert tr.RULES == jr.RULES
    f = [tr.Finding("HVD103", "a.json", 1, "m"),
         tr.Finding("HVD101", "b.hlo", 3, "n")]
    g = [jr.Finding("HVD103", "a.json", 1, "m"),
         jr.Finding("HVD101", "b.hlo", 3, "n")]
    assert tr.render(f) == jr.render(g)


def test_the_hlo_parser_is_the_references():
    from horovod_tpu.analysis import hlo as jh
    from horovod_tpu_torch.analysis import hlo as th

    for name in ("bad_phase_shape.hlo", "bad_wire_dtype.hlo",
                 "bad_replica_groups.hlo", "bad_phase_wire_dtype.hlo"):
        text = (CORPUS / name).read_text()
        got = [tuple(vars(i).values()) for i in th.extract_schedule(text)]
        want = [tuple(vars(i).values()) for i in jh.extract_schedule(text)]
        assert got == want and got
        assert th.parse_expectations(text) == jh.parse_expectations(text)


# -- pairs the port writes ---------------------------------------------------------

KNOBS = {"HOROVOD_ALLREDUCE_ALGO": "hierarchical",
         "HOROVOD_COMPRESSION": "int8",
         "HOROVOD_EXCHANGE_SCHEDULE": "priority",
         "HOROVOD_FUSION_THRESHOLD": 1 << 16,
         "HOROVOD_MAX_CHANNELS": 2,
         "HOROVOD_SERVE_SPECULATE": 3,
         "HOROVOD_SHARDING": "zero2",
         "HOROVOD_FSDP_AXIS_SIZE": 2,
         "HOROVOD_SPARSE_DENSITY_THRESHOLD": 0.25}
SIZES = (1 << 16, 3000, 1 << 15, 900, 1 << 14)


def _pair(side: str, directory: pathlib.Path, knobs: dict) -> pathlib.Path:
    """``side``'s package writes the plan of ``knobs`` over SIZES (8 ranks,
    2 hosts) and the tuned config naming it; returns the config's path."""
    import jax

    if side == "jax":
        from horovod_tpu.ops import compression as comp
        from horovod_tpu.ops import exchange as ex
        from horovod_tpu.ops import topology as top
        from horovod_tpu.tune import TunedConfig
        leaves = [jax.ShapeDtypeStruct((n,), "float32") for n in SIZES]
        constants = {"ici": {"alpha_us": 5.0, "gbps": 20.0}}
    else:
        from horovod_tpu_torch.ops import compression as comp
        from horovod_tpu_torch.ops import exchange as ex
        from horovod_tpu_torch.ops import topology as top
        from horovod_tpu_torch.tune import TunedConfig
        leaves = [torch.empty(n, device="meta") for n in SIZES]
        constants = {"nvlink": {"alpha_us": 5.0, "gbps": 20.0}}
    topo = top.Topology(8, (0,) * 4 + (1,) * 4, 2, 4, "cpu",
                        *top.seed_links("cpu"))
    plan = ex.plan_exchange(
        leaves, KNOBS["HOROVOD_FUSION_THRESHOLD"],
        mode=KNOBS["HOROVOD_EXCHANGE_SCHEDULE"],
        compression=comp.resolve(KNOBS["HOROVOD_COMPRESSION"]),
        algo=KNOBS["HOROVOD_ALLREDUCE_ALGO"],
        labels=[f"g.{i}" for i in range(len(SIZES))], topo=topo,
        max_channels=KNOBS["HOROVOD_MAX_CHANNELS"])
    directory.mkdir()
    plan.save(str(directory / "pod.exchange.json"))
    config = TunedConfig(
        device_kind="cpu", world_size=8, num_slices=2, constants=constants,
        knobs=knobs, exchange_artifact="pod.exchange.json",
        exchange_plan_hash=plan.plan_hash(), compute_window_ms=2.5,
        predicted_exposed_ms={"default": 1.5, "tuned": 0.5})
    return pathlib.Path(config.save(str(directory / "pod.tuned.json")))


def _edit(knobs=None, **fields):
    def apply(d):
        d.update(fields)
        if knobs is not None:
            d["knobs"].update(knobs)
        return d
    return apply


MUTATIONS = {
    "clean": None,
    "hash_mismatch": _edit(exchange_plan_hash="12345678"),
    "impossible_world": _edit(world_size=6, num_slices=4),
    "zero_world": _edit(world_size=0),
    "unknown_knob": _edit({"HOROVOD_FUSION_TRESHOLD": 1}),
    "corrupt_field": _edit(world_size="eight"),
    "no_knobs": lambda d: {k: v for k, v in d.items() if k != "knobs"},
    "auto_algo": _edit({"HOROVOD_ALLREDUCE_ALGO": "auto"}),
    "hierarchical_one_slice": _edit({"HOROVOD_ALLREDUCE_ALGO":
                                     "hierarchical"}, num_slices=1),
    "bad_values": _edit({"HOROVOD_COMPRESSION": "int3",
                         "HOROVOD_COMPRESSION_CROSS_SLICE": "fp8",
                         "HOROVOD_EXCHANGE_SCHEDULE": "eager",
                         "HOROVOD_FUSION_THRESHOLD": -5,
                         "HOROVOD_MAX_CHANNELS": True,
                         "HOROVOD_SERVE_SPECULATE": -1,
                         "HOROVOD_SHARDING": "zero4",
                         "HOROVOD_FSDP_AXIS_SIZE": 3,
                         "HOROVOD_SPARSE_DENSITY_THRESHOLD": 1.5}),
    "mode_and_threshold_disagree": _edit({"HOROVOD_EXCHANGE_SCHEDULE":
                                          "enum",
                                          "HOROVOD_FUSION_THRESHOLD":
                                          1 << 20}),
    "missing_sibling": _edit(exchange_artifact="gone.exchange.json"),
}


@pytest.mark.parametrize("mutation", sorted(MUTATIONS))
def test_pairs_the_port_writes_verify_like_jax(tmp_path, mutation):
    jsched, tsched = _verifiers()
    paths = {side: _pair(side, tmp_path / side, dict(KNOBS))
             for side in ("jax", "port")}
    assert (json.loads(paths["port"].read_text())["exchange_plan_hash"]
            == json.loads(paths["jax"].read_text())["exchange_plan_hash"])
    edit = MUTATIONS[mutation]
    if edit is not None:
        for p in paths.values():
            p.write_text(json.dumps(edit(json.loads(p.read_text()))))
    want = jsched.verify_tuned_config(paths["jax"].read_text(),
                                      str(paths["jax"]))
    got = tsched.verify_tuned_config(paths["port"].read_text(),
                                     str(paths["port"]))
    got_rows = _rows(got, str(tmp_path / "port"), str(tmp_path / "jax"))
    assert got_rows == _rows(want)
    assert (want == []) == (mutation == "clean")
    # A pair verified before it is written (hvd.tune's order) reads the
    # sibling's text from the caller.
    if mutation in ("clean", "hash_mismatch"):
        sibling = (tmp_path / "port" / "pod.exchange.json").read_text()
        assert _rows(tsched.verify_tuned_config(
            paths["port"].read_text(), str(paths["port"]),
            exchange_text=sibling)) == _rows(got)


@pytest.mark.parametrize("edit", [
    {"wire_bits": 4},           # int4 bits: no gather form on the cross hop
    {"indices": [0, 0]}],       # a leaf summed twice
    ids=["hvd105_phase_shape", "hvd103_leaf_twice"])
def test_a_mutated_plan_verifies_like_jax(tmp_path, edit):
    """The sibling's own findings surface once the config records its
    hash."""
    import zlib

    jsched, tsched = _verifiers()
    rows = {}
    for side in ("jax", "port"):
        cfg = _pair(side, tmp_path / side, dict(KNOBS))
        ex_path = cfg.parent / "pod.exchange.json"
        plan = json.loads(ex_path.read_text())
        plan["buckets"][0].update(edit)
        ex_path.write_text(json.dumps(plan, indent=1, sort_keys=True))
        canonical = json.dumps(plan, sort_keys=True, separators=(",", ":"))
        d = json.loads(cfg.read_text())
        d["exchange_plan_hash"] = \
            f"{zlib.crc32(canonical.encode()) & 0xFFFFFFFF:08x}"
        cfg.write_text(json.dumps(d))
        mod = jsched if side == "jax" else tsched
        rows[side] = _rows(mod.verify_tuned_config(cfg.read_text(),
                                                   str(cfg)),
                           str(tmp_path / side), str(tmp_path / "jax"))
    assert rows["port"] == rows["jax"] and rows["jax"]
