"""horovod_tpu_torch.serving — continuous-batching LM inference on the GPU.

Counterpart of ``horovod_tpu.serving`` (on the GPU the engine's forwards
are captured CUDA graphs; the prefill/decode split over two subset groups
spans two ranks, each building the engine: the decode rank serves, the
prefill rank answers in ``Engine.serve_prefill()`` — engine.py):

    from horovod_tpu_torch import serving
    from horovod_tpu_torch.models import transformer
    model = transformer.init_params(cfg, seed=0)       # on the GPU
    engine = serving.Engine(cfg, model, max_batch=8)
    req = engine.submit(prompt_tokens, max_new_tokens=64)
    for done in engine.run_until_idle():
        print(done.request_id, done.output)

Pieces: :class:`Engine` (fixed-shape prefill/decode over a paged KV cache,
and draft-and-verify speculative decoding with ``speculate=k`` —
engine.py), :class:`Scheduler` + :class:`Request` (continuous batching,
tenant fairness, admission control, prefix sharing — scheduler.py),
:class:`BlockPool` (the paged-cache allocator — kv_cache.py),
:class:`RequestJournal` + :class:`Watchdog` + :class:`EngineStalled`
(deadlines, stall detection, crash-safe journal and replay —
resilience.py). The open-loop load driver is ``tools/serve_bench_torch.py``.
"""

# kv_cache first: models/transformer.py imports it, and the engine imports
# models/transformer.py.
from horovod_tpu_torch.serving.kv_cache import (KV_DTYPES,  # noqa: I001
                                                NULL_BLOCK, BlockPool,
                                                BlockPoolError,
                                                dequantize_kv,
                                                kv_bytes_per_token,
                                                make_kv_pools,
                                                num_blocks_for_bytes,
                                                padded_table, quantize_kv,
                                                resolve_kv_dtype)
from horovod_tpu_torch.serving.engine import Engine
from horovod_tpu_torch.serving.resilience import (EngineStalled,
                                                  RequestJournal, Watchdog,
                                                  load_journal, replay_plan)
from horovod_tpu_torch.serving.scheduler import (AdmissionError, PrefixIndex,
                                                 Request, RequestState,
                                                 Scheduler)

__all__ = [
    "AdmissionError",
    "BlockPool",
    "BlockPoolError",
    "Engine",
    "EngineStalled",
    "KV_DTYPES",
    "NULL_BLOCK",
    "PrefixIndex",
    "Request",
    "RequestJournal",
    "RequestState",
    "Scheduler",
    "Watchdog",
    "dequantize_kv",
    "kv_bytes_per_token",
    "load_journal",
    "make_kv_pools",
    "num_blocks_for_bytes",
    "padded_table",
    "quantize_kv",
    "replay_plan",
    "resolve_kv_dtype",
]
