"""The port's two exchange tools against the JAX package's
(``tools/cost_model.py``, ``tools/allreduce_bench.py``).

* ``tools/cost_model_torch.py predict/choose/threshold`` print what the
  port's ``CostModel`` computes on the same arguments, and under the CPU
  seeds the reference tool's numbers; with a tuning cache, the port's v3
  cache (levels ``nvlink``/``ib``) gives the numbers the reference's
  (``ici``/``dcn``) gives. ``flops`` counts the ResNet-50 step.
* ``tools/allreduce_bench_torch.py --device cpu --ranks 2 --smoke``
  prints one valid JSON row per measurement, with the wire collectives of
  ``flat`` (one all-reduce), ``rs_ag`` (one reduce-scatter and one
  all-gather) and two channels (two all-reduces), as the reference's
  ``tests/test_examples.py::test_allreduce_bench_tool_runs`` holds its
  rows.
"""

import argparse
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_tool_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed(mod, argv, capsys):
    capsys.readouterr()
    assert mod.main(argv) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    return json.loads(lines[0])


COST_CASES = [
    ["predict", "16777216", "--world", "8"],
    ["predict", "16777216", "--world", "8", "--slices", "2"],
    ["predict", "4096", "--world", "2", "--channels", "4"],
    ["predict", "1048576", "--world", "1"],
    ["choose", "16777216", "--world", "8"],
    ["choose", "262144", "--world", "16", "--slices", "4",
     "--max-channels", "2"],
    ["threshold", "--world", "8"],
    ["threshold", "--world", "16", "--slices", "2"],
]


@pytest.mark.parametrize("argv", COST_CASES, ids=lambda a: "_".join(a))
def test_cost_model_cli_equals_the_ports_model_and_the_reference(argv,
                                                                 capsys):
    from horovod_tpu_torch.ops import topology
    from horovod_tpu_torch.utils import costs

    got = _printed(_tool("cost_model_torch"), argv, capsys)
    want = _printed(_tool("cost_model"), argv, capsys)
    assert got == want
    # The same numbers straight from the port's model.
    ns = argparse.Namespace(world=8, slices=1, channels=1, max_channels=8)
    for flag, value in zip(argv[1:], argv[2:]):
        if flag.startswith("--"):
            setattr(ns, flag[2:].replace("-", "_"), int(value))
    nvlink, ib = topology.seed_links("cpu")
    topo = topology.Topology(
        group_size=ns.world,
        slice_of=tuple(r * ns.slices // ns.world for r in range(ns.world)),
        num_slices=ns.slices, local_size=ns.world // ns.slices,
        device_kind="cpu", nvlink=nvlink, ib=ib)
    model = costs.CostModel(nvlink=nvlink, ib=ib)
    if argv[0] == "predict":
        for algo in costs.ALGORITHMS:
            us = model.predict_us(algo, int(argv[1]), topo,
                                  channels=ns.channels)
            assert got[f"predicted_us_{algo}"] == (
                None if us == float("inf") else round(us, 2))
    elif argv[0] == "choose":
        algo = model.choose(int(argv[1]), topo)
        assert got["chosen_algo"] == algo
        assert got["chosen_channels"] == model.choose_channels(
            algo, int(argv[1]), topo, ns.max_channels)
    else:
        assert got["fusion_threshold_bytes"] == \
            model.fusion_threshold_bytes(topo)


def test_a_calibrated_cache_gives_the_references_numbers(tmp_path, capsys):
    """The same constants in each package's v3 cache, its levels named
    its own way (ici/dcn against nvlink/ib)."""
    from horovod_tpu.utils import costs as jcosts

    from horovod_tpu_torch.utils import costs as tcosts

    consts = {"alpha_us": 3.5, "gbps": 40.0, "ch_eff": 0.6}
    cross = {"alpha_us": 30.0, "gbps": 6.25}
    jpath = jcosts.save_tuning_cache({"ici": consts, "dcn": cross},
                                     device_kind="cpu", world=8,
                                     path=str(tmp_path / "jax.json"))
    tpath = tcosts.save_tuning_cache({"nvlink": consts, "ib": cross},
                                     device_kind="cpu", world=8,
                                     path=str(tmp_path / "torch.json"))
    for argv in (["predict", "8388608", "--world", "8", "--slices", "2",
                  "--channels", "2"],
                 ["choose", "8388608", "--world", "8", "--slices", "2"],
                 ["threshold", "--world", "8"]):
        got = _printed(_tool("cost_model_torch"), argv + ["--cache", tpath],
                       capsys)
        want = _printed(_tool("cost_model"), argv + ["--cache", jpath],
                        capsys)
        assert got == want and got["source"] == "calibrated"


def test_flops_counts_the_resnet50_step(capsys):
    """FlopCounterMode's count of one ResNet-50 train step. The reference
    derives 24.49 GFLOP an image from XLA's count (docs/benchmarks.md);
    the two counters differ, so this holds the count within 5% of it."""
    out = _printed(_tool("cost_model_torch"), ["1"], capsys)
    assert out["batch"] == 1 and out["flops_per_step"] > 0
    assert abs(out["gflops_per_image"] - 24.49) / 24.49 < 0.05


def test_allreduce_bench_smoke_prints_its_rows(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    # A cache of this test's own: the recalibrator's end-of-run flush then
    # depends on this run's rows only.
    env["HOROVOD_TUNING_CACHE"] = str(tmp_path / "tuning.json")
    proc = subprocess.run(
        [sys.executable, str(REPO / "tools" / "allreduce_bench_torch.py"),
         "--device", "cpu", "--ranks", "2", "--smoke"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rows = [json.loads(ln) for ln in proc.stdout.splitlines()
            if ln.startswith("{")]
    busbw = [r for r in rows if r["metric"] == "allreduce_busbw"]
    assert len(busbw) == 4
    for r in busbw:
        assert r["world"] == 2 and r["backend"] == "gloo"
        assert r["value"] > 0 and r["time_us"] > 0
        assert r["schedule_ops"] == {"ALLREDUCE": 1}
        assert "predicted_busbw_gbps" in r
    flat = [r for r in busbw if "algo" not in r and "channels" not in r]
    assert len(flat) == 2
    for r in flat:
        assert r["allreduce_ops"] == 1
        assert r["collective_ops"] == {"all-reduce": 1, "reduce-scatter": 0,
                                       "all-gather": 0, "all-to-all": 0}
    [rs_ag] = [r for r in busbw if r.get("algo") == "rs_ag"]
    assert rs_ag["collective_ops"] == {"all-reduce": 0, "reduce-scatter": 1,
                                       "all-gather": 1, "all-to-all": 0}
    [chan] = [r for r in busbw if r.get("channels") == 2]
    assert chan["collective_ops"]["all-reduce"] == 2
    [sparse] = [r for r in rows if r["metric"] == "sparse_exchange"]
    assert sparse["sparse_time_us"] > 0 and sparse["dense_time_us"] > 0
    steps = [r for r in rows if r["metric"] == "exchange_step"]
    assert [r["schedule"] for r in steps] == ["none", "enum", "priority"]
    assert all("exchange_schedule_hash" in r for r in steps[1:])
