"""The port's examples as integration tests: each of
``horovod_tpu_torch.examples`` runs in a subprocess with ``--device cpu``
and the tiny flags of the JAX package's ``tests/test_examples.py``, and
must exit 0 (the examples check themselves: ``lm_generate`` raises unless
every served request equals ``generate``, ``grouped_collectives`` unless
every rank sees the reference's values). ``grouped_collectives`` runs in
a 5-rank gloo world and ``long_context_transformer`` in a 4-rank one
(``horovod_tpu_torch.run.run``).
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_LM = ["--steps", "60", "--seq-len", "16", "--batch-size", "2",
       "--embed-dim", "32", "--num-heads", "2", "--num-kv-heads", "1",
       "--max-new", "8"]
_CASES = [
    ("mnist", ["--steps", "4", "--batch-size", "8"], "final loss"),
    ("keras_mnist", ["--epochs", "1", "--steps-per-epoch", "2",
                     "--batch-size", "8", "--synthetic"], "Epoch 1/1"),
    ("keras_mnist_advanced", ["--epochs", "1", "--steps-per-epoch", "2",
                              "--batch-size", "8"], "checkpoints in"),
    ("mnist_estimator", ["--steps", "16", "--batch-size", "8"],
     "predict OK"),
    ("imagenet_resnet50", ["--tiny", "--epochs", "1", "--steps-per-epoch",
                           "2", "--batch-size", "4", "--image-size", "32"],
     "Epoch 1/1"),
    ("lm_generate", _LM, "(6/6 bit-identical to generate)"),
    ("lm_generate", _LM + ["--speculate", "3"], "accept_rate=1.00"),
]


def _run(args, tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), TMPDIR=str(tmp_path))
    for name in list(env):
        if name.startswith("HOROVOD_"):
            del env[name]
    return subprocess.run([sys.executable, *args], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("name,flags,says", _CASES,
                         ids=[f"{c[0]}{'-speculate' if '--speculate' in c[1] else ''}"
                              for c in _CASES])
def test_example_runs_on_the_cpu(name, flags, says, tmp_path):
    proc = _run(["-m", f"horovod_tpu_torch.examples.{name}", *flags,
                 "--device", "cpu"], tmp_path)
    assert proc.returncode == 0, (
        f"{name} exited {proc.returncode}\n--- stdout ---\n"
        f"{proc.stdout[-3000:]}\n--- stderr ---\n{proc.stderr[-3000:]}")
    assert says in proc.stdout


def test_keras_mnist_trains_on_idx_files(tmp_path):
    """Real MNIST through ShardedDataset and prefetch_to_device when the
    IDX files are in --data-dir."""
    import gzip
    import struct

    import numpy as np

    rng = np.random.RandomState(0)
    for name, shape in (("train-images-idx3-ubyte", (64, 28, 28)),
                        ("train-labels-idx1-ubyte", (64,)),
                        ("t10k-images-idx3-ubyte", (8, 28, 28)),
                        ("t10k-labels-idx1-ubyte", (8,))):
        arr = rng.randint(0, 10 if len(shape) == 1 else 256, size=shape)
        with gzip.open(tmp_path / f"{name}.gz", "wb") as f:
            f.write(struct.pack(">HBB", 0, 0x08, len(shape))
                    + struct.pack(f">{len(shape)}I", *shape)
                    + arr.astype(np.uint8).tobytes())
    proc = _run(["-m", "horovod_tpu_torch.examples.keras_mnist", "--epochs",
                 "1", "--steps-per-epoch", "3", "--batch-size", "8",
                 "--data-dir", str(tmp_path), "--device", "cpu"], tmp_path)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "MNIST: 64 examples, 8 steps/epoch/rank" in proc.stdout


def test_grouped_collectives_in_a_five_rank_gloo_world(tmp_path):
    code = ("from horovod_tpu_torch.run import run\n"
            "from horovod_tpu_torch.examples import grouped_collectives as g\n"
            "outs = run(g.main, 5, device='cpu', args=(['--device', 'cpu'],),"
            " timeout=240)\n"
            "assert all(o == outs[0] for o in outs), outs\n"
            "print(outs[0])\n")
    proc = _run(["-c", code], tmp_path)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "grouped collectives OK" in proc.stdout
    assert ("'s1': [3.0, 3.0, 3.0, 3.0, 4.0], "
            "'s2': [0.0, 1.0, 9.0, 9.0, 9.0]") in proc.stdout


@pytest.mark.parametrize("attention", ["ring", "ulysses"])
def test_long_context_transformer_in_a_four_rank_gloo_world(tmp_path,
                                                             attention):
    """2 DP x 2 SP over gloo, the reference's test flags on one repeated
    batch: finite, falling losses, and the parameters equal on every rank
    (gradients averaged over group 0)."""
    code = ("import math\n"
            "from horovod_tpu_torch.run import run\n"
            "from horovod_tpu_torch.examples import "
            "long_context_transformer as m\n"
            "outs = run(m.main, 4, device='cpu', args=(['--device', 'cpu', "
            "'--steps', '4', '--seq-len', '64', '--batch-size', '1', "
            "'--num-layers', '1', '--embed-dim', '32', '--num-heads', '4', "
            f"'--attention', '{attention}', '--repeat-batch'],), "
            "timeout=240)\n"
            "losses = outs[0]['losses']\n"
            "assert all(o['losses'] == losses for o in outs), outs\n"
            "assert all(math.isfinite(v) for v in losses), losses\n"
            "assert losses[-1] < losses[0], losses\n"
            "assert len({o['params_crc'] for o in outs}) == 1, outs\n"
            "print('long context OK', losses)\n")
    proc = _run(["-c", code], tmp_path)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "4 devices as 2-way DP x 2-way SP" in proc.stdout
    assert "long context OK" in proc.stdout


def test_long_context_transformer_needs_two_ranks(capsys):
    from horovod_tpu_torch.examples import long_context_transformer

    assert long_context_transformer.main(["--device", "cpu"]) is None
    assert ("needs an even device count >= 2 (have 1)"
            in capsys.readouterr().out)


def test_grouped_collectives_needs_five_ranks(capsys):
    from horovod_tpu_torch.examples import grouped_collectives

    assert grouped_collectives.main(["--device", "cpu"]) is None
    assert "needs >= 5 devices; have 1" in capsys.readouterr().out
