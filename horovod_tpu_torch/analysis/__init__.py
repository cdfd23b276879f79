"""Static analysis: the ``hvd-lint`` schedule verifier and lints, and the
``hvd-model`` protocol checker — the counterpart of
``horovod_tpu/analysis``.

* **Program level** — :mod:`~horovod_tpu_torch.analysis.hlo` holds the
  schedule records (parsed from HLO text, or recorded from the wire calls
  a step makes: ``step_wire``); :mod:`~horovod_tpu_torch.analysis.
  schedule` verifies them (replica-group well-formedness, per-rank
  identity, wait-for acyclicity, wire dtypes, decomposition phase shapes)
  and the committed artifacts, and drives the recorded steps.
* **Source level** — :mod:`~horovod_tpu_torch.analysis.lints` walks
  Python ASTs for the hazards that never reach one program
  (rank-conditional collectives, auto-name drift, host syncs in hot paths,
  store calls in a program, unknown env knobs).
* **Protocol level** — :mod:`~horovod_tpu_torch.analysis.protocol` holds
  the negotiation layer's pure transition functions (the live runtime
  executes them); :mod:`~horovod_tpu_torch.analysis.model` is the
  ``hvd-model`` checker that explores their interleavings (HVD201-HVD206).

Every module here imports without torch (it loads inside the recording
drivers only), so ``tools/hvd_lint_torch.py`` and
``tools/hvd_model_torch.py`` run on a bare interpreter.
"""

from horovod_tpu_torch.analysis.report import RULES, Finding, render
from horovod_tpu_torch.analysis import hlo, lints, model, protocol, schedule

__all__ = ["RULES", "Finding", "render", "hlo", "lints", "model",
           "protocol", "schedule"]
