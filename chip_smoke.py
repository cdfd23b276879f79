#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of horovod_tpu on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line of output each:

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA source of the main paths (``horovod_tpu_torch/csrc``:
   ``adamw.cu``, ``batchnorm.cu``, ``bn_sums.cu``, ``ce_head.cu``,
   ``flash_fwd.cu``, ``flash_bwd.cu``) with ``nvcc`` for ``sm_90a``, all
   builds started together;
3. each kernel against its plain PyTorch version on the card, in bf16 and
   fp32, at every distinct (N, C) the main path gives it (ResNet-50, batch
   128, 224 px — read off the model's BatchNorm inputs) plus one ragged N;
   B1 also at its edge cases (``B1_EDGE_CASES``: N below one stage, odd C,
   unaligned bases, N = 0, ragged N across its stages and blocks, C wider
   than a stage), every B1 call run twice and bit-identical, a planted B1
   fault (one ring stage left out) that must fail the check, and one device
   kernel a B1 call (profiler trace); kernel, plain, bound and library-call
   times (``torch.batch_norm_stats`` for B1, ``torch.batch_norm_backward_
   reduce`` for B2, which is checked against B2's plain version), B1 and
   its library call also as medians and under a clean-L2 flush;
4. one full-width ResNet-50 ``Trainer`` step (224 px, 1000 classes, batch 2)
   on the card with the kernels (bf16) against the same step on the CPU
   with the plain path (fp32): loss and every gradient;
5. the main path: ``hvd.init()`` (world of 1, NCCL), ResNet-50 at full
   width with ``norm_impl="fused"``, batch 128, bf16,
   ``DistributedOptimizer(SGD(0.1, momentum=0.9))``, ``Trainer.fit`` for 10
   steps on a repeated seeded batch — the step captured as a CUDA graph by
   ``hvd.spmd``: the first step eager, the second captured and replayed,
   the rest replayed; the loss must be finite and fall, and each kernel's
   launch count must be exactly 53 (BatchNorm layers) a step over the 10
   steps (a launch recorded by the capture counts at each replay, where the
   card runs it; phase 12 shows the kernels inside the replays);
6. the flash kernels B3/B4 against their plain versions on the card, row
   by row, at small shapes for every masking mode (GQA, ragged lengths
   crossing the kernels' tiles, offsets, dead rows, window, segment ids, an
   LSE cotangent, fp32 operands) and at the LM's shape (B=2, T=8192, H=8,
   Hkv=4, D=128, causal, bf16); every case run twice, and the two runs must
   agree bit for bit (B4 uses no float atomics); five planted faults,
   confined to late tiles or to di, must fail that check; kernel, plain,
   bound and library times at the LM's shape
   (``scaled_dot_product_attention``: its forward for B3, forward +
   backward for B4, and its backward alone, ``library_bwd_ms``), with each
   kernel's achieved TFLOP/s and share of its bound;
7. one step of the full-width LM (E=1024, H=8, Hkv=4, mlp 4096, V=32768),
   depth cut to 2 layers, B=1, T=2304, fused head, through
   ``Trainer.train_step`` on the card (B3/B4, fp32 and bf16) against the
   same loss and gradients on the CPU (``blockwise``, fp32), every
   gradient tensor held on its own; B4 with di dropped must fail it;
8. the LM's main path: bench.py's config (8 layers, T=8192, B=2, bf16,
   fused head), ``DistributedOptimizer(AdamW(3e-4, weight_decay=0.1))``,
   ``Trainer.fit`` for 10 steps on a repeated seeded batch, captured as in
   5; the loss must be finite and fall, B3 and B4 must launch exactly 8
   times a step, the AdamW kernel A1 once and the head's kernel A2 4 + 4
   times (``LM_CHUNKS`` a direction), in the eager step and the capture;
9. LM serving: bench.py's LM at full width and depth (bf16 weights from
   ``init_params``, bf16 KV pages, block size 16, ``max_seq_len`` 2048 =
   the engine's view length) through ``serving.Engine``, whose forwards
   are CUDA graphs captured once and replayed:
   (a) a one-slot engine serves a 256-token prompt for 64 greedy tokens,
   which must equal ``transformer.generate``'s token for token, and its
   pool pages must equal the dense cache bit for bit; (b) an 8-slot engine
   with the prefix cache serves 12 requests (prompts 128-512 tokens, 32-128
   new, two tenants, 4 sharing a 64-token prefix), the pool passing
   ``check_invariants`` after every step, with one decode and one prefill
   capture (the replays are counted); the rows are compared with their
   solo runs in an engine of the same shape (the count of equal rows, and
   each other row's first differing step with its top-2 logit margin);
   (c) a pool too small for 8 slots forces preemptions, and every
   preempted request must equal its solo run; (d) the 12 requests under
   ``kv_dtype="int8_block"`` finish, and the share of tokens that agree
   with bf16 is printed; (e) a planted fault — the fresh K/V of position
   ``FAULT_SCATTER - 1`` scattered one position late, inside the captured
   prefill — must fail (a)'s check; (g) teacher-forced
   ``decode_step`` logits over a 256-token prompt must agree with the
   training forward ``model(tokens)`` (plain attention, no decode code
   shared) within ``SERVE_FWD_TOL``, and the same comparison with each
   query's visibility frontier moved one position on must fail it;
   (f) decode tokens/s at B=1 and B=8 (several timed windows each),
   prefill tokens/s (several admissions), p50 and maximum request latency
   of a short open-loop load (12 requests: too few for a p99), peak
   memory (``tools/serve_bench_torch.py``). No kernel of the port lies on
   this path, and none may launch in it.

10. checkpoint and resume at full width, for ResNet-50 (batch 128, bf16,
    fused BN, SGD) and the LM (phase 8's, AdamW): ``Trainer.fit`` for 3
    epochs of 2 steps with ``ModelCheckpointCallback`` under
    ``HOROVOD_FAULT_INJECT=torn_write@epoch=2`` (set in the phase, restored
    after); ``latest_epoch`` must return 1 and warn that epoch 2 is torn; a
    trainer built from another seed then runs ``fit(resume=dir)``, which
    must resume at epoch 2 with parameters, buffers, optimizer state (SGD
    momenta; AdamW moments and step counts) and LR equal bit for bit to
    what run A held when it saved epoch 1, and a first loss equal bit for
    bit to run A's first loss of epoch 2; the save and resume seconds and
    the checkpoint's bytes are printed;
11. A1 (``csrc/adamw.cu``) against its plain version at the LM's 159.4 M
    parameters and at three ragged cases (sizes across its vectors and
    chunks, bases off 16 bytes, bf16 parameters with fp32 moments):
    parameters within ``A1_UPD_TOL`` of the update, moments within one ulp,
    step counts equal, each run twice and bit-identical; a planted fault
    (one chunk left out) must fail; its time (one launch a step), bound,
    plain and ``torch.optim.AdamW(fused=True)`` times (fp32 moments: not
    the same function, so ``library_ms`` is null); and the LM step's
    tokens/s with A1 against the plain update, A1, plain, plain, A1 (each
    captured);
12. the captured step: ``Trainer(steps_per_call=5)``, which ``hvd.spmd``
    captures as one CUDA graph of 5 steps, against the function it wraps
    run eagerly (``trainer.step_fn``), from the same seeded weights and
    batches, 3 calls each (eager, captured and replayed, replayed) with
    ``set_lr`` before the second and the third, cuDNN held deterministic:
    (a) ResNet-50 (bf16, batch 128, fused BN, ``training.sgd(0.1,
    momentum=0.9)``) and (b) the LM (phase 8's, AdamW with its LR in a
    device tensor, on A1) must match every loss and every parameter,
    buffer and optimizer state tensor bit for bit; (c) the profiled
    replays must run B1 and B2 53 times a step, B3 and B4 8 times, A1
    once and A2 4 + 4 times; (d) the same ResNet-50 trainer with a Python float LR, a planted
    fault: ``set_lr`` must refuse once the step is captured, and the LR
    written into ``param_groups`` after the capture, which the graph
    ignores, must fail the bit-equality check while the calls before it
    pass; (e) images/s and tokens/s, captured against eager, 5 timed
    windows each in turns (median, min, max), and each side's device ms a
    step and busy share in one profiled call; (f) a small MLP: a
    ``torch.optim.AdamW`` trainer (made capturable) equals its eager step
    bit for bit, loading the inner optimizer's state recaptures the step
    and still equals the eager step, a ragged batch's program shares the
    first one's memory pool, and ``torch.optim.Adagrad`` is refused;
13. serving on captured graphs, and speculative decoding, at phase 9's LM
    and shapes: (a) the engine replaying its graphs against the same
    forward bodies called eagerly (``serve_bench_torch.eager_bodies``), at
    B=1 and B=8: tokens equal, pools bit for bit outside the null block;
    (b) each graph captured once, the replays counted; (c) a one-slot
    engine self-speculating at k=4 (``draft_kv_dtype="model"``) equals
    ``generate`` with accept rate 1.0 and never captures decode; (d) the
    distilled pair (``serve_bench_torch.distilled_draft_pair``: the 8-layer
    target's upper blocks zeroed, a 1-layer draft sharing its first block)
    on an int4 draft pool equals the plain engine; (e) a garbage 1-layer
    draft under ``min_accept=0.5`` latches DEGRADE, equals the plain engine
    and captures nothing more; (f) a planted fault, a verify accepting one
    token past the first mismatch, must fail (e)'s check; (g) decode
    tokens/s at B=1 and B=8, graphs against eager bodies, 5 windows each in
    turns; B=1 speculative tokens/s with the distilled pair (int4 and bf16
    draft pools) and with self-speculation, accept rates and draft ms; the
    busy share of one profiled window of graph decode; (h) a (B, 5) decode
    forward equals 5 one-token forwards bit for bit (logits and view pages)
    at B = 1, 2, 3 and 8 over one seeded random view, with the elements a
    single library product of the MLP's down-projection would change. No
    kernel of the port may launch;
14. the reference's examples (``horovod_tpu_torch.examples``), each
    ``main`` called in this process on ``cuda:0`` with the kernels' counts
    set to 0 just before it: ``imagenet_resnet50`` (ResNet-50, 224 px,
    batch 32) for 2 epochs of 5 steps, then again from its checkpoint
    directory, which must resume at epoch 2; ``mnist`` (40 steps, its first
    loss within ``MNIST_LOSS_TOL`` of the same step on the CPU),
    ``keras_mnist`` (adadelta), ``keras_mnist_advanced`` (adam: A1 once a
    step), ``mnist_estimator`` (train, evaluate, predict) and
    ``lm_generate`` at its defaults and with ``--speculate 3`` (A1 once a
    step; every served request equal to ``generate``, which the example
    itself asserts); every loss finite, every step program 2 runs of its
    Python then replays, no other kernel launched; ``grouped_collectives``
    needs 5 ranks and says so. Then ``prefetch_to_device`` from
    ``ShardedDataset`` batches of seeded numpy arrays: bit for bit (fp32,
    and bf16-cast), ``depth`` batches in flight, and by profiler trace its
    copies from pinned memory on a stream other than the consumer's;
    ResNet-50's images/s (batch 32, the captured step) fed from host numpy
    arrays through ``prefetch_to_device(dtype=bf16)`` beside batches
    already on the card, windows in turns; and, where Pillow imports, the
    tiny ResNet example on a directory of PNGs through
    ``ImageFolderDataset``;
15. the sparse path (no kernel of the port lies on it): (a) the exchange's
    dedup-and-merge (``ops/sparse.py``) at 8 ranks' gathered rows (8 x
    1,024 rows of 128 fp32, Zipf-hot indices) on the card against the
    CPU: bit for bit on integer-valued rows, within ``SPARSE_TOL`` of each
    segment's sum|row| on random rows, two runs on the card bit-identical;
    (b) ``alltoall``, ``reducescatter`` and a one-group allreduce family
    in bf16, fp32 and bool inside an ``hvd.spmd`` program: captured once,
    replayed, each equal to its eager result; (c) the ``word2vec`` example
    at the reference's width (V = 50,000, D = 128, 64 negatives, batch
    128, synthetic corpus) for 200 steps: 2 runs of the step's Python then
    replays, the loss falling, every table finite, its first loss within
    ``W2V_LOSS_TOL`` of the same step on the CPU, and a captured program
    equal to its step run eagerly, every table bit for bit; (d) the
    ``embedding_bag`` example at its defaults with ``--sparse-algo
    gather`` and ``dense``: tables within ``BAG_TOL`` after 20 steps, and
    the loss falling on a repeated batch; (e) steps/s of (c) and (d) and
    the device ms of their merges; (f) a captured ``Trainer`` refuses a
    COO gradient (``nn.Embedding(sparse=True)``) and names it;
16. wire compression and decomposition (no kernel of the port lies on
    it): (a) ResNet-50's gradient (25.6 M fp32 values, seeded, in the
    buckets of the default fusion threshold) through bf16, int8,
    int8_block and int4 with an explicit ``compression_key``: wire, scales
    and dequantized values on the card equal the CPU's bit for bit, and
    two card runs each other; (b) each format's compress + decompress of
    those buckets, device ms (CUDA events, median, min and max of
    ``WIRE_WINDOWS`` windows) against the byte bound, printed as
    ``compression_ms`` JSON lines; (c) ResNet-50 (bf16, fused BN, batch
    ``WIRE_BATCH``) through ``DistributedOptimizer(compression=
    "int8_block", error_feedback=True)``, 10 captured steps on a repeated
    batch: finite losses whose last 3 average below the first, every loss,
    parameter, buffer, momentum and residual equal bit for bit to the same
    steps run eagerly, and images/s beside the uncompressed captured step
    in turns (at one rank the wire saves nothing: the price of the
    compression alone); (d) in a captured program, ``algo="rs_ag"`` and
    ``channels=4`` equal ``flat`` bit for bit for every format,
    ``algo="hierarchical"`` at one slice raises the reference's text, and
    ``algo="auto"`` resolves to ``flat``;
17. the whole-step exchange planner (``ops/exchange.py``; no kernel of the
    port lies on it beyond B1/B2): (a) phase 16's ResNet-50 (bf16, fused
    BN, batch ``WIRE_BATCH``), 5 captured steps under
    ``schedule="priority"`` and 5 under ``"enum"``, uncompressed and with
    ``int8_block`` and error feedback: losses, parameters, buffers,
    momenta and residuals bit-equal, B1 and B2 53 times a step at every
    replay; (b) ``last_plan()`` after the steps has the hash of the JAX
    package's plan of the same leaves (``PLAN_HASHES``, pinned by the
    CPU tests), and a ``save`` -> ``from_json`` round
    trip through ``_chip_smoke_plan/`` (gitignored, removed after) gives
    the same plan; (c) wall ms a step of each run (median, min and max of
    5 windows in turns) and the host's ms planning ResNet-50's and the
    LM's gradients (at one rank every collective is the identity, so
    ``priority`` has nothing to hide: equal times are the expected
    reading);
18. ZeRO-1/2/3 (``parallel/sharded.py``) at one rank over NCCL (fsdp 1 x
    data 1, so every exchange is the identity: this shows the shard
    layout, the inner update on the shards, the gather-on-use forward and
    the capture, not the wire): (a) phase 8's LM (bf16, B=2, T=8192, fused
    head, ``AdamW(3e-4, weight_decay=0.1)``), 10 captured ``Trainer``
    steps under ``sharding="off"``, ``"zero2"`` and ``"zero3"``: losses
    and final parameters bit-identical across the arms, B3 and B4 8 times
    a step, A1 once and A2 4 + 4 times in each, and each arm's step ms; (b) phase 5's
    ResNet-50 (bf16, fused BN, batch 128, ``SGD(0.1, momentum=0.9)``),
    ``Trainer(sharded=True)`` (ZeRO-1) against ``sharded=False``, 10
    captured steps: losses, parameters, BN buffers and momenta
    bit-identical, B1 and B2 53 times a step; (c) the zero3 trainer's
    state through ``checkpoint.save_sharded`` (epoch 0, then epoch 1 torn
    under ``HOROVOD_FAULT_INJECT=torn_write@epoch=1``) and
    ``load_sharded(epoch=None)``: epoch 0 back bit for bit, the torn one
    skipped with its warning (``_chip_smoke_zero/``, gitignored, removed
    after); (d) the zero3 step's ``last_plan()`` carries the fsdp section
    and has the hash of the JAX package's plan of the same leaves
    (``ZERO3_PLAN_HASH``, pinned by the CPU tests);
19. sequence parallelism (``parallel/sequence.py``): (a) a 4-rank ring
    replayed on one card: the LM's attention (``LM_ATTN_SHAPE``, bf16,
    causal) cut into 4 shards of 2048, and for each virtual rank r and
    step s the port's own ring step (``sequence.ring_step``, flash body)
    on the shard that rank holds then, src = (r − s) mod 4, contiguous
    and zigzag; the hops are left out, so B3 and B4 run at exactly the
    offsets a 4-rank ring gives them (shards wholly in the causal future,
    dead rows, a nonzero LSE cotangent from the merge). O, the LSE and
    dq, dk, dv of the concatenated outputs are held to phase 6's row
    limits against ``flash_attention_lse`` at full T (B3/B4), against
    B3/B4's plain versions at full T, and against the same replay through
    the plain versions; each replay runs twice and must give the same
    bits; (b) phase 8's LM at world 1 (8 layers, B=2, T=8192, bf16,
    ``AdamW(3e-4, weight_decay=0.1)``), 10 captured ``Trainer`` steps
    under ``attention='ring'`` (fused head), ``'ring'`` with
    ``sp_layout='zigzag'`` (logits head: zigzag refuses the fused one) and
    ``'ulysses'`` (fused head): finite, falling losses, each first loss
    within ``SP_LOSS_TOL`` of phase 8's (the same function, up to the
    merge's roundings; zigzag's of B times it, as the reference's zigzag
    loss is), and the launches a step of ``SP_LAUNCHES``
    (the ring's recompute doubles B3; zigzag attends four chunk pairs a
    layer); each arm's step ms; (c) the ported example
    ``long_context_transformer`` at world 1 prints the reference's
    message and launches nothing.
20. tensor, expert and pipeline parallelism (``parallel/tensor.py``,
    ``expert.py``, ``pipeline.py``) at one rank: (a) the TP transformer's
    block at the LM's width (E=1024, H=8, D=128, mlp 4096, B=2, T=8192,
    causal, bf16) replayed for tp = 2 and 4 virtual ranks, each running
    the port's per-rank arithmetic (``tensor.attention_shard``,
    ``mlp_shard``: B3/B4 at H/tp heads) on its column and row shards, the
    partials summed in rank order; its output and the gradients of x and
    every weight from a seeded cotangent held to ``TP_ROW_TOL`` (each
    row's relative L2 error) against the dense block (tp = 1) through
    B3/B4 and through their plain versions; each replay twice,
    bit-identical, launching B3 and B4 tp times; (b) the ported
    ``tp_transformer``'s loss and step at world 1 (``hvd.init([[0], [0],
    [0]])``: TP family ``(1,)``, DP family ``(2,)``; V=32768, bf16,
    ``training.adam``), 10 steps captured by ``hvd.spmd``: finite, falling
    losses, B3, B4 and A1 once a step, and the first loss equal bit for
    bit to the same block written without the TP functions; (c)
    ``moe_mlp`` at world 1 (one expert) and a 4-expert EP group replayed
    through the layer's per-rank steps (``expert.route``, ``dispatch``,
    ``expert_mlp``, ``combine``) for k=1 and k=2, each against per-token
    dense routing in fp32 (``MOE_ROW_TOL``, the dropped choices counted
    and the same), then ``moe_transformer`` at world 1, 10 captured steps
    as in (b); (d) ``gpipe`` and ``pipeline_1f1b`` at one stage over 4
    microbatches of one LM block (Hkv=4, T=8192): gpipe's outputs and
    gradients equal to the block run microbatch by microbatch bit for
    bit, 1F1B's loss and gradients against gpipe + autograd
    (``PIPE_LOSS_TOL``, ``PIPE_ROW_TOL``); (e) ``tp_transformer`` at
    world 1 returns without a launch, and ``parallelism_zoo`` runs the
    modes one rank can (DP, PP, SP, EP) and skips TP.
21. profile-guided tuning and the device timeline (``horovod_tpu_torch/
    tune``, ``core/xprof.py``, ``parallel/spmd.py``'s sampling): (a)
    ``hvd.tune()`` at world 1 with the live timer (``tune/calibrate.py::
    allreduce_seconds`` and the tiny LM): the samples, the seconds against
    ``HOROVOD_TUNE_BUDGET_S``, the LM's compute window, the committed
    knobs (the defaults: one rank fits no constant, so every candidate
    ties), ``verify_tuned_config`` of the written pair (no finding) and
    ``tune_report()``; (b) ``measure_lm_ab`` of a candidate off the
    defaults (``AB_KNOBS``), both arms' ms a step; (c) a verified pair of
    ``TUNED_KNOBS`` under ``HOROVOD_TUNED_CONFIG`` at ``hvd.init``, then
    phase 8's LM for ``TUNE_STEPS`` captured steps: ``tune_report()`` says
    ``tuned`` for each knob, ``last_plan()`` is the committed plan, the
    losses equal the same knobs set by env bit for bit, and an env knob
    set beside the config wins; (d) ``HOROVOD_TIMELINE_DEVICE=1`` at
    interval 2 on 5 calls of ResNet-50 (fused BN) and of phase 8's LM: 3
    of 5 calls sampled, one ``DEVICE_STEP`` each and no
    ``NO_DEVICE_PLANE`` (a sampled call with no CUDA event fails), the
    port's kernels by name on the ``_kernels`` row, as many as the
    profiler recorded in the sampled calls (each kernel in each call),
    the wrappers' counts 53 / 8 / 1 a call over the 5 calls, a sampled
    call's records printed where the profiler missed a launch, the
    collective spans matched (none unless the card ran an NCCL kernel:
    the NCCL kernels of a step are printed), the losses equal the same
    calls without the device mode bit for bit, and each call's wall ms;
    (e) ``xprof.timed_steps(strict=True)`` on the LM's step: the device
    window beside the wall clock. Writes ``_chip_smoke_tune/``
    (gitignored) and removes it.
22. resilience (``core/resilience.py``, ``core/elastic.py``): (a) phase
    8's ResNet-50 (fused BN) fit, 3 steps, fault-free, then in a fresh
    init cycle under ``kv_timeout`` at the first and the last store call
    the fault-free fit made, with the timeline on: 2 retries, 2 ``RETRY``
    events on its ``coordination`` row, losses and state bit-identical;
    (b) phase 8's LM, 6 calls, without the liveness knobs and with them
    and a heartbeat running beside the step (started by the phase: at
    world 1 ``hvd.init`` starts none), a liveness check after each call:
    no ``WorkerLost``, the heartbeat key advances, bit-identical, each
    arm's median replay ms; (c) the reference's crash drill in child
    processes (``python3 chip_smoke.py --resilience-child MODE DIR``):
    ``crash@rank=0,step=2`` exits 43 (the LM's under
    ``HOROVOD_ELASTIC=1``), ``fit(resume=)`` in a new process, and the
    state's CRC equals an uninterrupted child's, for ResNet-50 and the LM;
    (d) a ``WorkerLost`` under ``HOROVOD_ELASTIC=1`` at world 1 is refused
    with the reference's min-world text, chained to the loss; (e)
    ``tools/fault_drill_torch.py --device cuda`` passes its training
    scenarios (its elastic scenario needs four GPUs; its serve scenario
    runs in phase 25). Writes ``_chip_smoke_resil/`` (gitignored) and
    removes it.
23. the control plane (``core/native``, ``core/negotiate.py``'s verdict
    replay, ``utils/distributed.py``, the two exchange tools): (a) after
    ``hvd.init`` the native core is loaded; phase 8's ResNet-50 (fused
    BN) fits ``CTL_STEPS`` steps under ``HOROVOD_TIMELINE``, written by
    the native writer: every round it negotiated went through the native
    request table, each request validated again by a fresh native table
    equals ``validate_py``'s verdict, the native fusion plans of the
    ResNet-50 and LM parameter lists equal ``plan_buckets_py``'s at the
    default threshold and at 0 and 1 MiB, and the trace parses and holds
    the fit's ``NEGOTIATE_*`` rows with their ready ticks; (b)
    ``CTL_EAGER_CALLS`` named eager allreduces of a 4-MiB bf16 tensor with
    the cache on (no store call after the first) and with
    ``HOROVOD_EAGER_CACHE=0``, bit-identical, each arm's ms a call; phase
    8's LM ``CTL_STEPS`` steps with and without the cache, losses
    bit-identical; (c) ``tools/allreduce_bench_torch.py --device cuda
    --smoke`` and ``tools/cost_model_torch.py predict/choose/threshold``
    at world 1 in child processes, each exiting 0 with its JSON rows (a
    world-1 row's busbw is 0 by its formula and says so); (d)
    ``init_distributed("127.0.0.1:<free port>", 1, 0)`` in a child
    process, one allreduce on the card. Writes ``_chip_smoke_ctl/``
    (gitignored) and removes it.
24. the analysis layer (``horovod_tpu_torch/analysis``, the two tools):
    (a) phase 8's LM as the Trainer's captured ``hvd.spmd`` program at
    world 1 under the arms flat, rs_ag, channels=2, schedule="priority"
    and zero3, each built once for ``ANA_CALLS`` calls (the capture
    records every ``torch.distributed`` call into ``Spmd.wire``): each
    arm's losses bit-identical to the flat arm's, B3/B4/A1 launched as in
    phase 8, each recorded listing verified with 0 findings (with its
    exchange plan where it has one), its ``schedule_summary`` rows and
    replay wall ms printed. At world 1 the verifier checks types and
    per-rank identity only (one rank has no phase shape), and rs_ag and
    zero3 move nothing and record no rows: they are launch-count arms;
    (b)
    the lints over the package, ``tools/*_torch.py`` and this script: 0
    findings; (c) the protocol sweep at 2 and 3 processes with and
    without the default faults is clean, and the three corpus
    ``.world.json`` files exit exactly 1 from ``tools/hvd_model_torch.py``
    with their rules; (d) ``tools/fault_drill_torch.py``'s preflights
    (the drill's training step recorded on the card in a child process at
    world 1; the model sweep of its faults); (e) planted faults: the tiny
    LM's rs_ag listings of ``ANA_RANKS`` gloo ranks (child processes)
    verify clean, then give HVD103 with one rank's instruction dropped
    and HVD105 with the all-gather phase removed; a rank-conditional
    ``hvd.allreduce`` in a source gives HVD001.

25. serving's fault tools and the prefill/decode split (no kernel of the
    port lies on them, and none may launch): (a)
    ``tools/fault_drill_torch.py``'s serve scenario at ``--device cuda``,
    three child processes serving phase 9's LM at full width cut to
    ``fault_drill_torch.SERVE_LAYERS`` layers: a journaled engine hard-killed mid-batch
    by ``engine_crash@step=4`` (exit 43), a new process replaying its
    journal, every output's CRC equal to an uninterrupted child's; (b)
    ``serve_bench_torch.bench_recovery`` at phase 9's LM (8 layers, bf16
    pages): ``bit_identical``, and ``serve_recovery_ms``; (c) the split's
    two halves in this process on the one card (NCCL refuses two ranks on
    one card): a prefill-side and a decode-side engine joined by
    ``serving.engine.loopback_split``, which hands the prefill engine the
    exact tensors the two-rank split sends through the same pack and unpack
    code and leaves out only the ``torch.distributed`` call, serve
    ``SPLIT_REQUESTS`` requests sharing a two-block prefix in two rounds
    (between them the prefill engine's pool is zeroed and the decode engine
    told so, so it ships the shared pages) with the prefix cache: every
    token equal to the unsplit engine's, one capture of each graph on each
    side (prefill: ``prefill``, ``first``; decode: ``decode``), the bytes
    per admission printed.

26. the gradient exchange overlapped with backward, on the one card:
    phase 8's LM (full width and depth, B=2, T=8192, bf16, AdamW on A1)
    through ``Trainer`` under ``schedule="priority"`` at a fusion threshold
    of ``OVERLAP_THRESHOLD`` bytes, in two arms: the Trainer's step (armed
    from its second call, so the capture's backward runs the
    post-accumulate-grad hooks, which issue buckets on the wrapper's
    exchange stream while backward still owes gradients, forked from the
    capture stream and joined as backward ends) and the same step with gradients from
    ``torch.autograd.grad`` (``tools/overlap_torch.py::unoverlapped``: no
    hook fires). At world 1 the collective is the identity, so this
    guards the capture: one hook a parameter in the capture and none in
    the eager first call, buckets issued from backward, the 3 calls'
    losses and the parameters' CRC equal between the arms bit for bit, a
    replay launching B3 and B4 8 times, A1 once and A2 4 + 4 times, within
    ``OVERLAP_BUDGET_S`` seconds.

27. the sharded modes' exchange overlapped with compute, on the one card:
    phase 8's LM (full width and depth, B=2, T=8192, bf16, AdamW on A1
    over the shards) through ``Trainer(sharding="zero2"|"zero3")``, each
    in two arms: the Trainer's step (armed from its second call, the
    capture: backward's post-accumulate-grad hooks issue each tensor's
    reduce-scatter in reverse gather order on the wrapper's exchange
    stream, forked from the capture stream and joined as backward ends;
    zero3's gathers run on a gather stream forked before the forward,
    one event a parameter, which the capture stream waits for where the
    forward first reads the parameter) and the same step with the
    module's gradients zeroed in place and nothing armed
    (``tools/overlap_torch.py::unarmed``: no hook, no wait). At world 1
    every exchange is the identity (zero3's gather a copy), so this
    guards the capture's forks and joins and the counts:
    one hook a parameter in the capture and none in the eager first call,
    units issued from backward, one gather wait a parameter (zero3), the 3
    calls' losses and the parameters and shards' CRC equal between the
    arms bit for bit, a replay launching B3 and B4 8 times, A1 once and
    A2 4 + 4 times, within ``SHARDED_OVERLAP_BUDGET_S`` seconds.

28. kernel A2 (``csrc/ce_head.cu``), the fused cross-entropy head's work
    on each fp32 logit tile, at the LM's head (``CE_SHAPE``: N = 16,382,
    E = 1,024, V = 32,768, chunk 8,192, bf16): (a) the head's loss, dx and
    dW through A2 against the same head with each chunk's fold and dlogits
    taken by the plain versions on the card (``CE_LOSS_TOL``,
    ``CE_GRAD_TOL`` of the largest entry); (b) rerun bit for bit, and
    4 + 4 launches; (c) each kernel on one chunk (CUDA events, a dirty
    flush of L2 before each launch) beside its byte bound, its plain
    version and, for the forward, ``torch.logsumexp`` over the tile (no
    library call computes the backward's function), and the head's
    forward and backward with A2 and with the plain versions, within
    ``CE_BUDGET_S`` seconds.

Each main path (5, 8 and 10, each example of 14, each run of 17, each
arm of 18, of 19 (b), of 20, of 22 (a) and (b), of 23 (a) and (b), of 24
(a), phase 25 and each arm of 26 and of 27) runs with its kernels' launch
counts set to 0 just before it and read just after; the kernels line's
``launches`` are phases 5 and 8's counts (the eager step and the 9
replays), ``launches_phase18``, ``launches_phase19`` and
``launches_phase20`` each arm's count in phases 18, 19 and 20, and
``launches_phase21`` the launches the device timeline of phase 21 (d)
shows in its 3 sampled calls, ``launches_phase22`` each arm's count in
phase 22 (a) and (b), ``launches_phase23`` each fit's count in phase
23 (a) and (b), ``launches_phase24`` each arm's count in phase 24 (a),
``launches_phase26`` each arm's count over phase 26's 3 calls,
``launches_phase27`` each mode and arm's count over phase 27's 3 calls,
and, for A2, ``launches_phase28`` its count in phase 28's first head call
(A2's ``launches`` are phase 8's, like B3, B4 and A1's).
Then a JSON line with each kernel's
record, and last the result line ``{"ok": true, "device": {...}}``. Any failed phase raises: the script then
exits non-zero and prints no result. It also fails without CUDA, and when
the ``horovod_tpu_torch`` package is not beside it.

Precision: TF32 is switched off for fp32 matmuls and convolutions
(``torch.backends.cuda.matmul.allow_tf32 = False``,
``torch.backends.cudnn.allow_tf32 = False``), so fp32 work on the card is
full fp32; the main path computes in bf16, which TF32 does not touch.
"""

from __future__ import annotations

import contextlib
import copy
import itertools
import json
import math
import os
import shutil
import statistics
import gc
import importlib
import subprocess
import sys
import time
import warnings
import zlib

import numpy as np
import torch
import torch.nn.functional as F

import horovod_tpu_torch as hvd
from horovod_tpu_torch import serving
from horovod_tpu_torch.core import negotiate, resilience
from horovod_tpu_torch.core import state as hstate
from horovod_tpu_torch.models import mnist, resnet, transformer
from horovod_tpu_torch.models.layers import FusedBatchNorm
from horovod_tpu_torch.ops import _build
from horovod_tpu_torch.ops import batchnorm as bn
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.ops import losses as xent
from horovod_tpu_torch.ops import optim
from horovod_tpu_torch.ops import (compression, exchange, fusion, sparse,
                                   strategy)
from horovod_tpu_torch.ops.optim import AdamW
from horovod_tpu_torch.examples import moe_transformer as moe_example
from horovod_tpu_torch.examples import parallelism_zoo as zoo_example
from horovod_tpu_torch.examples import tp_transformer as tp_example
from horovod_tpu_torch.parallel import expert, sequence, tensor
from horovod_tpu_torch.parallel.optimizer import (FusedAllreduce,
                                                  optimizer_state_tensors)
from horovod_tpu_torch import training
from horovod_tpu_torch.training import checkpoint, data
from horovod_tpu_torch.training.callbacks import (Callback,
                                                  ModelCheckpointCallback)

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "tools"))
import serve_bench_torch  # noqa: E402  (tools/serve_bench_torch.py)
import overlap_torch  # noqa: E402  (tools/overlap_torch.py)
import profile_torch_step  # noqa: E402  (tools/profile_torch_step.py)

SEED = 0
BATCH = 128
IMAGE = 224
CLASSES = 1000
STEPS = 10
BN_LAYERS = 53            # BatchNorm layers of ResNet-50
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12   # H100 SXM, fp32 outside the tensor cores
KERNEL_TOL = 1e-5          # |kernel − plain| ≤ KERNEL_TOL · Σ|term|, per channel
LIBRARY_TOL = 1e-4         # the same, for the library call timed beside B2
# B1's inputs beside the ResNet-50 shapes, each in bf16 and fp32: (name, N,
# C, elements the base lies into its allocation). Odd C and a base off 16
# bytes take the kernel's ordinary loads (C = 2500 in tiles of 1024
# channels), the rest its bulk-copy ring (C = 9000 and the wide ResNet rows
# in tiles of 512 bytes); the ragged N cross its stage and block edges.
B1_EDGE_CASES = (
    ("N below one stage", 3, 64, 0),
    ("odd C", 1001, 3, 0),
    ("rows 1.. of an (N+1, 12) tensor", 4097, 12, 12),
    ("base one element off", 4097, 16, 1),
    ("N = 0", 0, 64, 0),
    ("ragged N at C = 64", 100003, 64, 0),
    ("ragged N at C = 2048", 6271, 2048, 0),
    ("C wider than a stage", 7, 9000, 0),
    ("base one element off, C wider than a tile", 5, 2500, 1),
)
# Phase 4 limits (relative loss error, relative L2 error of all gradients)
# against the CPU fp32 step. fp32 on the card differs from the CPU only in
# summation order. bf16 keeps 8 significant bits, and the error of each
# rounding is carried through 53 BatchNorm layers, whose statistics at batch
# 2 amplify it: the bf16 limits are a sanity bound, the fp32 ones (with
# phase 3) the kernels' check.
STEP_FP32_TOL = (1e-4, 1e-2)
STEP_BF16_TOL = (2e-2, 0.3)
REPS = 20

BF16_FLOPS_PER_S = 989e12  # H100 SXM data sheet, dense bf16 tensor cores
# Attention of the LM at full width: (B, T, H, Hkv, D), causal.
LM_ATTN_SHAPE = (2, 8192, 8, 4, 128)
FLASH_OUTPUTS = ("O", "dq", "dk", "dv")
# B3/B4 against their plain versions, row by row: for every row of O, dq,
# dk and dv (the D values of one batch, position and head),
# ‖kernel − plain‖₂ / ‖plain‖₂, the worst row counting. Rows differ in
# scale by orders of magnitude (a causal O row averages i + 1 values, an
# early key's dk sums every later query), so a limit on the whole tensor
# would let the small rows go unchecked. The denominator is floored at
# FLASH_ROW_FLOOR of the tensor's rms row norm: a row that is ~0 by
# cancellation (dq of a query that sees one key) is judged at the
# tensor's scale, and a row that is exactly 0 on both sides (dead rows,
# keys no query sees) reads 0. Both sides round the same quantities to bf16
# (q, k, v, dO, P, dS) and accumulate in fp32; a row moves where a
# summation-order difference flips one bf16 rounding of P, dS or the output
# (2^-8 of that value). Read on an H100: at most 5.1e-3 at the small cases
# and 6.8e-3 at the LM's shape (dq); the planted faults read 0.2 and up.
# The limit, 2e-2, is 3x the worst sound reading and 10x below the
# weakest fault: an error of 10% in any row fails.
FLASH_ROW_TOL = 2e-2
FLASH_ROW_FLOOR = 1e-3
# The LSE is fp32 on both sides, from fp32 scores: 1e-3 absolute (natural
# log units) on rows that see a key; rows that see none must agree on it.
LSE_TOL = 1e-3
# SDPA (timed beside B3/B4) against B3's plain version, the same row
# error: SDPA rounds at its own points (read: 4.0e-3).
LIBRARY_FLASH_TOL = 2e-2
# The planted faults' first q or kv tile (64 rows or keys a tile) at the
# first small case (T=192) and at the LM's shape (T=8192).
FAULT_TILE = {"small": 2, "LM": 64}
# Launches timed at the LM's shape, a mean as everywhere: now and then one
# SDPA launch stalls (SDPA's forward read 0.48 ms in most calls and 1.05 ms
# in one as a mean of 5), so its mean takes 10.
FLASH_REPS = 10
# The LM: bench.py's full-width config (_lm_extra) and its main-path batch.
LM_LAYERS = 8
LM_BATCH = 2
LM_T = 8192
LM_CHUNKS = 4  # the fused head's vocabulary chunks: 32,768 / 8,192
# The card-vs-CPU LM step: depth cut to 2 layers, one row of 2304 tokens
# (above local_attention's 2048 switch).
LM_STEP_LAYERS = 2
LM_STEP_T = 2304
# Its limits (relative loss error, relative L2 error of all gradients
# together, the worst single tensor's relative L2 error) against the CPU
# fp32 step. The embedding and lm_head gradients dominate the total, so the
# attention weights' gradients are held by the per-tensor limit. Card fp32:
# the matmuls are full fp32 on both sides, but attention rounds to bf16 at
# different points on the two (B3/B4 round P and dS; the CPU's blockwise
# path rounds P and the cotangents of its bf16 casts), each rounding 2^-8
# relative: a gradient error of a few 2^-8, limit 3e-2 in total and 2e-2
# per tensor (read: 2.67e-3 and 7.04e-3); the loss moves far less, limit
# 1e-3. Card bf16 rounds every activation and product (2^-8 each, through
# 2 layers and a 32768-way softmax): a sanity bound, as for the ResNet
# step, 6e-2 per tensor (read: 1.88e-2).
LM_STEP_FP32_TOL = (1e-3, 3e-2, 2e-2)
LM_STEP_BF16_TOL = (2e-2, 0.3, 6e-2)
# Small B3/B4 checks: (name, (B, Tq, Tk, H, Hkv, D), dtype, kwargs,
# segment ids). "g_lse" in kwargs also feeds an LSE cotangent to B4.
FLASH_CASES = (
    ("causal", (2, 192, 192, 4, 4, 64), torch.bfloat16,
     dict(causal=True), False),
    ("non-causal GQA ragged", (1, 130, 200, 4, 2, 128), torch.bfloat16,
     dict(causal=False), False),
    ("offsets g_lse", (1, 80, 200, 4, 1, 32), torch.bfloat16,
     dict(causal=True, q_offset=120, kv_offset=0, g_lse=True), False),
    ("dead rows", (1, 96, 160, 2, 2, 16), torch.bfloat16,
     dict(causal=True, q_offset=0, kv_offset=40, g_lse=True), False),
    ("window", (2, 300, 300, 4, 2, 128), torch.bfloat16,
     dict(causal=True, window=100), False),
    ("segments", (2, 257, 257, 4, 2, 64), torch.bfloat16,
     dict(causal=True, g_lse=True), True),
    ("fp32 operands", (1, 200, 200, 8, 4, 128), torch.float32,
     dict(causal=True), False),
    # Crosses the kernels' 128-row q and kv tiles (and B4's 64-row ones) in
    # both lengths, with four q heads to a kv head.
    ("GQA tile edges", (1, 257, 257, 8, 2, 128), torch.bfloat16,
     dict(causal=False), False),
)


def free_cuda() -> None:
    """Return the memory of dropped objects to the card: a trainer's CUDA
    graphs hold their memory pools until the trainer is collected."""
    gc.collect()
    torch.cuda.empty_cache()


def say(msg: str) -> None:
    print(msg, flush=True)


def card_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True)
    return out.stdout.strip().splitlines()[0]


def seeded_resnet50(dtype, device, seed: int = SEED):
    """ResNet-50 (fused BN) with weights made from ``seed`` on the CPU. Where
    the reference zero-initialises each block's last BN scale, these draw it
    from U(0, 0.2): each block still starts close to the identity, and every
    layer gets a non-zero gradient."""
    g = torch.Generator().manual_seed(seed)
    model = resnet.ResNet50(num_classes=CLASSES, dtype=dtype,
                            norm_impl="fused", generator=g)
    with torch.no_grad():
        for block in model.blocks:
            block.norm3.scale.copy_(
                torch.rand(block.norm3.scale.shape, generator=g) * 0.2)
    return model.to(device)


def cuda_times(fn, flush, reps: int = REPS, clean=None) -> list[float]:
    """Device time of each of ``reps`` launches of ``fn()``, in ms, each
    launch after a write of ``flush``, a buffer larger than L2, so every
    launch finds its input cold. That write leaves L2 full of dirty lines,
    which the timed launch pays to write back; with ``clean`` (a second
    buffer larger than L2) that buffer is read after the write, so the
    launch finds L2 holding clean lines only."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        if clean is not None:
            clean.sum()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def cuda_time_ms(fn, flush, reps: int = REPS) -> float:
    """Mean device time of ``fn()`` over ``reps`` launches, each after a
    write of a buffer larger than L2, so every launch finds its input cold."""
    times = cuda_times(fn, flush, reps)
    return sum(times) / len(times)


def time_fields(fn, flush, clean, field: str) -> dict:
    """``field`` (the mean under :func:`cuda_time_ms`'s dirty flush) with
    its median, and the mean and median under the clean flush."""
    dirty = cuda_times(fn, flush)
    tidy = cuda_times(fn, flush, clean=clean)
    return {field: sum(dirty) / len(dirty),
            f"{field}_median": statistics.median(dirty),
            f"{field}_clean": sum(tidy) / len(tidy),
            f"{field}_clean_median": statistics.median(tidy)}


def bn_shapes(model, images):
    """(N, C) of every BatchNorm input of one forward pass, in order."""
    shapes = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: shapes.append(
            (args[0].numel() // args[0].shape[-1], args[0].shape[-1])))
        for m in model.modules() if isinstance(m, FusedBatchNorm)]
    try:
        with torch.no_grad():
            model.train()(images)
    finally:
        for h in hooks:
            h.remove()
    return shapes


def _sums_rel(got, want, xf) -> tuple[float, float]:
    """B1's worst |got − want| / Σ|term| over channels (terms x and x²) and
    its largest absolute error."""
    rel, err = 0.0, 0.0
    for g, w, mag in ((got[0], want[0], xf.abs()), (got[1], want[1], xf * xf)):
        diff = (g - w).abs()
        rel = max(rel, float((diff / mag.sum(0).clamp_min(1e-30)).max()))
        err = max(err, float(diff.max()))
    return rel, err


def check_b1(x, what: str) -> tuple[float, float]:
    """B1 on ``x`` twice against its plain version: the two runs must give
    the same bits, and each channel must agree within KERNEL_TOL of Σ|term|.
    Returns (relative, absolute) error."""
    got = bn.channel_sums(x)
    again = bn.channel_sums(x)
    want = bn.channel_sums_plain(x)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])):
        raise RuntimeError(f"channel_sums is not deterministic at {what}: a "
                           f"second run on the same input changed its bits")
    rel, err = _sums_rel(got, want, x.reshape(-1, x.shape[-1]).float())
    if not rel <= KERNEL_TOL:
        raise RuntimeError(f"channel_sums disagrees with its plain version at "
                           f"{what}: {rel:.3e} > {KERNEL_TOL} of the summed "
                           f"magnitude")
    return rel, err


def b1_planted_fault(x) -> float:
    """B1's result with one ring stage of one block left out (that stage's
    rows, summed by the plain version, taken off the kernel's sums) must
    fail the check; returns its relative error."""
    n, c = x.shape
    plan = bn.launch_plan(x)
    r0, r1 = bn.block_rows(plan, n, plan.gx // 2)
    step = plan.rows_per_stage or (r1 - r0)
    lo = r0 + step if r1 - r0 > step else r0
    rows = x[lo:min(r1, lo + step)]
    got = bn.channel_sums(x)
    cut = bn.channel_sums_plain(rows)
    bad = (got[0] - cut[0], got[1] - cut[1])
    rel, _ = _sums_rel(bad, bn.channel_sums_plain(x), x.float())
    if rel <= KERNEL_TOL:
        raise RuntimeError(f"planted fault passed the channel_sums check: "
                           f"rows {lo}..{lo + len(rows)} of ({n}, {c}) left "
                           f"out read {rel:.3e}")
    return rel


def b1_kernels_per_call(x, calls: int = 3) -> list[str]:
    """The device kernels ``calls`` calls of B1 run, by profiler trace: one
    each, all B1's own. Raises otherwise."""
    from torch.profiler import ProfilerActivity, profile

    bn.channel_sums(x)  # the stream's barrier word exists from here on
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            bn.channel_sums(x)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and not getattr(e, "is_user_annotation", False)]
    if len(names) != calls or not all(
            "channel_sums_ring_kernel" in k for k in names):
        raise RuntimeError(f"{calls} channel_sums calls ran {len(names)} "
                           f"device kernels, expected one each: {names}")
    return names


def _edge_input(n, c, offset, dtype, g, device):
    """An (n, c) input whose base lies ``offset`` elements into its
    allocation (so ``offset`` · size bytes past a 16-byte boundary when
    that is not a multiple of 16)."""
    flat = (torch.randn(offset + n * c, generator=g, device=device) * 3
            + 2).to(dtype)
    return flat[offset:].view(n, c)


def phase_kernels(model, device):
    """Phase 3: B1/B2 against their plain versions, B1's edge cases,
    determinism, planted fault and one launch a call, and their times."""
    g = torch.Generator(device=device).manual_seed(SEED)
    images = torch.randn((BATCH, IMAGE, IMAGE, 3), generator=g, device=device)
    layer_shapes = bn_shapes(model, images)
    if len(layer_shapes) != BN_LAYERS:
        raise RuntimeError(f"expected {BN_LAYERS} BatchNorm inputs, saw "
                           f"{len(layer_shapes)}")
    distinct = sorted(set(layer_shapes))
    ragged = (25087, 1024)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=device)
    clean = torch.empty_like(flush).fill_(1.0)
    rec = {k: {"max_abs_err": 0.0, "bound_ms": 0.0,
               "bound_terms": {"bytes": 0.0, "operations": 0.0}}
           for k in ("channel_sums", "channel_grad_sums")}
    worst_rel = 0.0
    worst_library_rel = 0.0
    fault_rel = None
    for dtype in (torch.bfloat16, torch.float32):
        for (n, c) in distinct + [ragged]:
            x = (torch.randn((n, c), generator=g, device=device) * 3 + 2) \
                .to(dtype)
            dy = torch.randn((n, c), generator=g, device=device).to(dtype)
            xf, dyf = x.float(), dy.float()
            mean = xf.mean(0)
            rstd = torch.rsqrt(xf.var(0, unbiased=False) + 1e-5)
            rel, err = check_b1(x, f"({n}, {c}) {dtype}")
            worst_rel = max(worst_rel, rel)
            rec["channel_sums"]["max_abs_err"] = max(
                rec["channel_sums"]["max_abs_err"], err)
            if fault_rel is None and dtype == torch.bfloat16 \
                    and (n, c) == (25088, 256):
                fault_rel = b1_planted_fault(x)
            sdy, sdx = bn.channel_grad_sums(dy, x, mean, rstd)
            q1, q2 = bn.channel_grad_sums_plain(dy, x, mean, rstd)
            torch.cuda.synchronize()
            term = dyf * (xf - mean) * rstd
            for got, want, mag in ((sdy, q1, dyf.abs()),
                                   (sdx, q2, term.abs())):
                diff = (got - want).abs()
                rel = float((diff / mag.sum(0).clamp_min(1e-30)).max())
                worst_rel = max(worst_rel, rel)
                rec["channel_grad_sums"]["max_abs_err"] = max(
                    rec["channel_grad_sums"]["max_abs_err"],
                    float(diff.max()))
                if not rel <= KERNEL_TOL:
                    raise RuntimeError(
                        f"channel_grad_sums disagrees with its plain version "
                        f"at ({n}, {c}) {dtype}: {rel:.3e} > {KERNEL_TOL} of "
                        f"the summed magnitude")
            if dtype != torch.bfloat16 or (n, c) == ragged:
                del xf, dyf, term
                continue
            # The library calls timed beside B1/B2: batch_norm_stats gives
            # mean and invstd (B1's sums, finished), batch_norm_backward_
            # reduce with weight 1 gives Σdy and Σdy·x̂ (B2's function).
            ones = torch.ones(c, dtype=torch.float32, device=device)
            lib_sdy, _, lib_sdx, _ = torch.batch_norm_backward_reduce(
                dy, x, mean, rstd, ones, False, True, True)
            for got, want, mag in ((lib_sdy, q1, dyf.abs()),
                                   (lib_sdx, q2, term.abs())):
                worst_library_rel = max(worst_library_rel, float(
                    ((got.float() - want).abs()
                     / mag.sum(0).clamp_min(1e-30)).max()))
            del xf, dyf, term
            # Per-step times: each distinct shape weighted by how many of
            # the 53 layers have it (bf16, the main path's dtype). B1 and
            # its library call also under the clean flush, each with its
            # median.
            count = layer_shapes.count((n, c))
            elem = n * c
            fields = {}
            fields.update(time_fields(lambda: bn.channel_sums(x), flush,
                                      clean, "ms"))
            fields.update(time_fields(lambda: torch.batch_norm_stats(x, 1e-5),
                                      flush, clean, "library_ms"))
            fields["plain_ms"] = cuda_time_ms(
                lambda: bn.channel_sums_plain(x), flush)
            for f, v in fields.items():
                rec["channel_sums"][f] = rec["channel_sums"].get(f, 0.0) \
                    + count * v
            for field, fn in (
                    ("ms", lambda: bn.channel_grad_sums(dy, x, mean, rstd)),
                    ("plain_ms",
                     lambda: bn.channel_grad_sums_plain(dy, x, mean, rstd)),
                    ("library_ms", lambda: torch.batch_norm_backward_reduce(
                        dy, x, mean, rstd, ones, False, True, True))):
                r = rec["channel_grad_sums"]
                r[field] = r.get(field, 0.0) + count * cuda_time_ms(fn, flush)
            # Bounds: bytes read once and written once over the memory
            # rate, or fp32 operations over the fp32 rate, the larger; the
            # term that wins at each shape is credited with its time.
            for key, nbytes, ops in (
                    ("channel_sums", elem * 2 + 2 * c * 4, 3 * elem),
                    ("channel_grad_sums",
                     2 * elem * 2 + 2 * c * 4 + 2 * c * 4, 5 * elem)):
                terms = {"bytes": nbytes / HBM_BYTES_PER_S,
                         "operations": ops / FP32_FLOPS_PER_S}
                by = max(terms, key=terms.get)
                rec[key]["bound_ms"] += count * terms[by] * 1e3
                rec[key]["bound_terms"][by] += count * terms[by] * 1e3
    # B1's edge cases: in both dtypes, each run twice and bit-identical;
    # N = 0 must give zeros.
    for dtype in (torch.bfloat16, torch.float32):
        for name, n, c, offset in B1_EDGE_CASES:
            x = _edge_input(n, c, offset, dtype, g, device)
            rel, err = check_b1(x, f"{name} ({n}, {c}) {dtype}")
            worst_rel = max(worst_rel, rel)
            rec["channel_sums"]["max_abs_err"] = max(
                rec["channel_sums"]["max_abs_err"], err)
            if n == 0 and any(bool(s.any()) for s in bn.channel_sums(x)):
                raise RuntimeError(f"channel_sums of an empty {dtype} input "
                                   f"is not zero")
    b1_kernels_per_call(
        torch.randn((25088, 256), generator=g, device=device).bfloat16())
    del flush, clean
    free_cuda()
    if not worst_library_rel <= LIBRARY_TOL:
        raise RuntimeError(
            f"batch_norm_backward_reduce disagrees with channel_grad_sums_"
            f"plain: {worst_library_rel:.3e} > {LIBRARY_TOL} of the summed "
            f"magnitude, so it is not B2's function")
    if fault_rel is None:
        raise RuntimeError("no (25088, 256) shape to plant B1's fault in")
    for r in rec.values():
        terms = r.pop("bound_terms")
        r["bound_by"] = max(terms, key=terms.get)
    return rec, distinct, worst_rel, worst_library_rel, fault_rel


# -- flash attention (B3/B4) ------------------------------------------------------

def _flash_inputs(b, tq, tk, h, hkv, d, dtype, device, seed, segs=False):
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((b, tq, h, d), generator=g, device=device).to(dtype)
    k = torch.randn((b, tk, hkv, d), generator=g, device=device).to(dtype)
    v = torch.randn((b, tk, hkv, d), generator=g, device=device).to(dtype)
    g_out = torch.randn((b, tq, h, d), generator=g, device=device).to(dtype)
    g_lse = torch.randn((b, tq, h), generator=g, device=device)
    kw = {}
    if segs:
        # Three packed documents per row; the q side's third id differs
        # from the kv side's, so its rows see nothing (dead rows).
        qs = torch.zeros((b, tq), dtype=torch.int32, device=device)
        ks = torch.zeros((b, tk), dtype=torch.int32, device=device)
        qs[:, tq // 3:] = 1
        ks[:, tk // 3:] = 1
        qs[:, 2 * tq // 3:] = 2
        ks[:, 2 * tk // 3:] = 3
        kw = dict(q_segment_ids=qs, kv_segment_ids=ks)
    return q, k, v, g_out, g_lse, kw


def _row_err(got, want) -> float:
    """The worst row's ‖got − want‖₂ / ‖want‖₂ over the last dim, the
    denominator floored at FLASH_ROW_FLOOR of the rms row norm."""
    d = want.shape[-1]
    w = want.float().reshape(-1, d)
    num = (got.float().reshape(-1, d) - w).norm(dim=1)
    den = w.norm(dim=1)
    floor = FLASH_ROW_FLOOR * float(den.pow(2).mean().sqrt())
    return float((num / den.clamp_min(max(floor, 1e-30))).max())


def _max_rel_err(outs, wants) -> float:
    """max|got − want| / max|want|, the worst of O/dq/dk/dv: printed
    beside the row error for the planted faults, it shows how much of a
    late-tile fault a whole-tensor scale hides."""
    return max(float((a.float() - b.float()).abs().max()
                     / b.float().abs().max().clamp_min(1e-30))
               for a, b in zip(outs, wants))


def _flash_kernels(q, k, v, g_out, g_lse, kw):
    """(out, lse, dq, dk, dv) of B3 then B4."""
    out, lse = fa.flash_fwd_kernel(q, k, v, **kw)
    return (out, lse, *fa.flash_bwd_kernel(q, k, v, out, lse, g_out, g_lse,
                                           **kw))


def _flash_run(q, k, v, g_out, g_lse, kw):
    """(out, lse, dq, dk, dv) of B3/B4 and of their plain versions on the
    same card inputs. B3/B4 run twice and must give the same bits: every
    sum stays in one block, in a fixed order."""
    got = _flash_kernels(q, k, v, g_out, g_lse, kw)
    again = _flash_kernels(q, k, v, g_out, g_lse, kw)
    p_out, p_lse = fa.flash_fwd_plain(q, k, v, **kw)
    p_grads = fa.flash_bwd_plain(q, k, v, p_out, p_lse, g_out, g_lse, **kw)
    torch.cuda.synchronize()
    differ = [n for n, a, b in zip(("O", "lse") + FLASH_OUTPUTS[1:], got,
                                   again) if not torch.equal(a, b)]
    if differ:
        raise RuntimeError(f"B3/B4 are not deterministic: a second run on "
                           f"the same inputs changed {differ}")
    return got, (p_out, p_lse, *p_grads)


def _flash_errors(got, want) -> dict:
    """Row errors of O/dq/dk/dv, the LSE's absolute error on rows that see
    a key, whether both sides agree on which rows see none, and the largest
    absolute errors of B3 (O, LSE) and of B4 (dq, dk, dv)."""
    (out, lse, *grads), (p_out, p_lse, *p_grads) = got, want
    errs = {n: _row_err(a, b) for n, a, b in
            zip(FLASH_OUTPUTS, (out, *grads), (p_out, *p_grads))}
    live = p_lse > fa._DEAD_LSE
    errs["lse"] = float((lse - p_lse)[live].abs().max()) if live.any() \
        else 0.0
    errs["dead_rows_agree"] = torch.equal(live, lse > fa._DEAD_LSE)
    errs["fwd_abs"] = max(float((out.float() - p_out.float()).abs().max()),
                          errs["lse"])
    errs["bwd_abs"] = max(float((a.float() - b.float()).abs().max())
                          for a, b in zip(grads, p_grads))
    return errs


def _flash_faults(errs) -> str:
    """What breaks the limits, or '' when nothing does."""
    bad = [f"{n} row err {errs[n]:.3e}" for n in FLASH_OUTPUTS
           if not errs[n] <= FLASH_ROW_TOL]
    if not errs["lse"] <= LSE_TOL:
        bad.append(f"lse err {errs['lse']:.3e}")
    if not errs["dead_rows_agree"]:
        bad.append("they disagree on which rows see no key")
    return "; ".join(bad)


def _check_flash(name, got, want) -> dict:
    errs = _flash_errors(got, want)
    fault = _flash_faults(errs)
    if fault:
        raise RuntimeError(
            f"flash {name}: kernel vs plain beyond the limits (row "
            f"{FLASH_ROW_TOL}, lse {LSE_TOL}): {fault}")
    return errs


def _planted_faults(q, k, v, g_out, kw, got, want, tile: int) -> dict:
    """Wrong results the check must reject, each confined to q or kv tiles
    at and past ``tile`` (64 rows or keys a tile), or to di: B3 dropping
    those kv tiles (the kernel run on the keys before them), B3 shifting O
    by one row there, B4 dropping those kv tiles (dq without them, their
    dk/dv zero), B4 dropping di (the kernel given g_lse = rowsum(dO·O)),
    B4's dq 20% low there. Raises if one passes; returns each fault's
    (row error, max-normalized error)."""
    cut = 64 * tile
    out, lse, dq, dk, dv = got
    shifted = out.clone()
    shifted[:, cut:] = out[:, cut - 1:-1]
    low_dq = dq.clone()
    low_dq[:, cut:] *= 0.8
    kc, vc = k[:, :cut], v[:, :cut]
    tail = torch.zeros_like(k[:, cut:])
    cut_dq, cut_dk, cut_dv = fa.flash_bwd_kernel(q, kc, vc, out, lse, g_out,
                                                 None, **kw)
    faults = {
        f"B3 drops kv tiles >= {tile}":
            (fa.flash_fwd_kernel(q, kc, vc, **kw)[0], lse, dq, dk, dv),
        f"B3 shifts O by one row from q tile {tile}":
            (shifted, lse, dq, dk, dv),
        f"B4 drops kv tiles >= {tile}":
            (out, lse, cut_dq, torch.cat([cut_dk, tail], 1),
             torch.cat([cut_dv, tail], 1)),
        "B4 drops di":
            (out, lse, *fa.flash_bwd_kernel(
                q, k, v, out, lse, g_out,
                (g_out.float() * out.float()).sum(-1), **kw)),
        f"B4's dq 20% low from q tile {tile}": (out, lse, low_dq, dk, dv),
    }
    readings = {}
    for name, bad in faults.items():
        errs = _flash_errors(bad, want)
        if not _flash_faults(errs):
            raise RuntimeError(f"planted fault passed the flash check: "
                               f"{name}: {errs}")
        readings[name] = (max(errs[n] for n in FLASH_OUTPUTS),
                          _max_rel_err(bad[:1] + bad[2:],
                                       want[:1] + want[2:]))
    return readings


def _flash_bounds(b, t, h, hkv, d):
    """(B3, B4) bounds in ms, what bounds each, and the operations counted,
    at a causal same-offset (T, T) call: the visible pairs are T(T+1)/2 per
    (b, h); B3 does 2 products on them, B4 at least 5, at the dense bf16
    rate; the bytes are each input read once and each output written
    once."""
    pairs = b * h * t * (t + 1) // 2
    q_bytes = 2 * b * t * h * d
    kv_bytes = 2 * b * t * hkv * d
    lse_bytes = 4 * b * h * t
    out = {}
    for name, flops, nbytes in (
            ("flash_fwd", 4 * d * pairs, 2 * q_bytes + 2 * kv_bytes
             + lse_bytes),
            ("flash_bwd", 10 * d * pairs, 4 * q_bytes + 4 * kv_bytes
             + lse_bytes)):
        terms = {"bytes": nbytes / HBM_BYTES_PER_S,
                 "operations": flops / BF16_FLOPS_PER_S}
        by = max(terms, key=terms.get)
        out[name] = (terms[by] * 1e3, by, flops)
    return out


def phase_flash_kernels(device):
    """B3/B4 against their plain versions on the card at small shapes for
    every masking mode (GQA, ragged lengths, offsets, dead rows, window,
    segment ids, g_lse, fp32 operands) and at the LM's shape, each run
    twice and bit-identical, then kernel, plain, bound and library (SDPA)
    times at the LM's shape, with SDPA's backward alone for B4
    (``library_bwd_ms``). Planted faults (``_planted_faults``) must fail
    the check at the first small case and at the LM's shape."""
    worst = dict.fromkeys(FLASH_OUTPUTS + ("lse",), 0.0)
    abs_err = {"flash_fwd": 0.0, "flash_bwd": 0.0}
    faults = {}

    def account(errs):
        for n in worst:
            worst[n] = max(worst[n], errs[n])
        abs_err["flash_fwd"] = max(abs_err["flash_fwd"], errs["fwd_abs"])
        abs_err["flash_bwd"] = max(abs_err["flash_bwd"], errs["bwd_abs"])
        return errs

    for i, (name, shape, dtype, kw, segs) in enumerate(FLASH_CASES):
        q, k, v, g_out, g_lse, seg_kw = _flash_inputs(
            *shape, dtype, device, SEED + 10 + i, segs)
        kw = dict(kw)
        if not kw.pop("g_lse", False):
            g_lse = None
        got, want = _flash_run(q, k, v, g_out, g_lse, {**kw, **seg_kw})
        account(_check_flash(name, got, want))
        if i == 0:
            faults["small"] = _planted_faults(q, k, v, g_out, kw, got, want,
                                              FAULT_TILE["small"])
    b, t, h, hkv, d = LM_ATTN_SHAPE
    q, k, v, g_out, _, _ = _flash_inputs(b, t, t, h, hkv, d, torch.bfloat16,
                                         device, SEED + 3)
    kw = dict(causal=True)
    got, want = _flash_run(q, k, v, g_out, None, kw)
    full = account(_check_flash("LM shape", got, want))
    faults["LM"] = _planted_faults(q, k, v, g_out, kw, got, want,
                                   FAULT_TILE["LM"])
    (out, lse), (p_out, p_lse) = got[:2], want[:2]
    del got, want
    # The library call timed beside each kernel: SDPA (cuDNN / flash
    # backends) on the same inputs — forward for B3, forward + backward for
    # B4, and its backward alone from one saved forward (no single PyTorch
    # call computes B4's function with GQA) — checked against the plain
    # version first.
    qT, kT, vT = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    gT = g_out.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(qT, kT, vT, is_causal=True,
                                              enable_gqa=True)

    def sdpa_fwd_bwd():
        return torch.autograd.grad(sdpa(), (qT, kT, vT), gT)

    sdpa_out = sdpa()

    def sdpa_bwd():
        return torch.autograd.grad(sdpa_out, (qT, kT, vT), gT,
                                   retain_graph=True)

    lib_err = _row_err(sdpa().detach().transpose(1, 2), p_out)
    if not lib_err <= LIBRARY_FLASH_TOL:
        raise RuntimeError(f"SDPA disagrees with flash_fwd_plain: row err "
                           f"{lib_err:.3e} > {LIBRARY_FLASH_TOL}")
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=device)
    bounds = _flash_bounds(b, t, h, hkv, d)
    # The plain versions (≈ 0.1-0.2 s a call) are timed last: timed after
    # their seconds of load, SDPA's backward alone read slower than SDPA's
    # forward and backward together.
    times = {
        ("flash_fwd", "ms"): lambda: fa.flash_fwd_kernel(q, k, v, **kw),
        ("flash_fwd", "library_ms"): sdpa,
        ("flash_bwd", "ms"): lambda: fa.flash_bwd_kernel(
            q, k, v, out, lse, g_out, None, **kw),
        ("flash_bwd", "library_ms"): sdpa_fwd_bwd,
        ("flash_bwd", "library_bwd_ms"): sdpa_bwd,
        ("flash_fwd", "plain_ms"): lambda: fa.flash_fwd_plain(q, k, v, **kw),
        ("flash_bwd", "plain_ms"): lambda: fa.flash_bwd_plain(
            q, k, v, p_out, p_lse, g_out, None, **kw),
    }
    rec = {name: {"max_abs_err": abs_err[name], "bound_ms": bounds[name][0],
                  "bound_by": bounds[name][1]} for name in bounds}
    for (name, field), fn in times.items():
        rec[name][field] = cuda_time_ms(fn, flush, reps=FLASH_REPS)
    for name, r in rec.items():
        # The bound's operations (B3: 2 products, B4: the 5-product
        # minimum) over the kernel's time, and the bound over that time.
        r["tflops"] = bounds[name][2] / (r["ms"] * 1e-3) / 1e12
        r["bound_share"] = r["bound_ms"] / r["ms"]
    del flush, sdpa_out
    free_cuda()
    return rec, worst, full, lib_err, faults


def _step_errors(gpu, cpu):
    """Relative loss error, relative L2 error of all gradients together, and
    the worst single tensor's relative L2 error with its name."""
    (gl, gg), (cl, cg) = gpu, cpu
    if not (math.isfinite(gl)
            and all(bool(torch.isfinite(t).all()) for t in gg.values())):
        raise RuntimeError("non-finite loss or gradient on the card")
    num = sum(float((gg[n] - cg[n]).pow(2).sum()) for n in cg)
    den = sum(float(cg[n].pow(2).sum()) for n in cg)
    worst = max((float((gg[n] - cg[n]).norm()
                       / cg[n].norm().clamp_min(1e-30)), n) for n in cg)
    return abs(gl - cl) / abs(cl), math.sqrt(num / den), worst


def phase_step_vs_cpu(device):
    """Phase 4: one full-width Trainer step on the card (kernels) against
    the same step on the CPU (plain path, fp32), same weights and batch:
    the card in fp32 (tight limits) and in bf16, the main path's dtype."""
    g = torch.Generator().manual_seed(SEED + 2)
    images = torch.randn((2, IMAGE, IMAGE, 3), generator=g)
    labels = torch.randint(0, CLASSES, (2,), generator=g)

    def one_step(dtype, dev):
        model = seeded_resnet50(dtype, dev)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9))
        trainer = hvd.Trainer(model, resnet.make_loss_fn(model), opt,
                              has_aux=True)
        before = dict(bn.LAUNCHES)
        loss, _ = trainer.train_step((images.to(dev), labels.to(dev)))
        grads = {n: p.grad.detach().float().cpu()
                 for n, p in model.named_parameters()}
        if dev != "cpu":
            for k in before:
                if bn.LAUNCHES[k] - before[k] != BN_LAYERS:
                    raise RuntimeError(
                        f"{k}: {bn.LAUNCHES[k] - before[k]} launches in one "
                        f"step, expected {BN_LAYERS}")
        return float(loss), grads

    hvd.init(device="cpu")
    try:
        cpu = one_step(torch.float32, "cpu")
    finally:
        hvd.shutdown()
    hvd.init()  # the card, NCCL: the rest of the run uses this world
    out = {}
    for name, dtype, (loss_tol, grad_tol) in (
            ("fp32", torch.float32, STEP_FP32_TOL),
            ("bf16", torch.bfloat16, STEP_BF16_TOL)):
        errs = _step_errors(one_step(dtype, device), cpu)
        if errs[0] > loss_tol or errs[1] > grad_tol:
            raise RuntimeError(
                f"card {name} step disagrees with the CPU fp32 step: loss "
                f"rel err {errs[0]:.3e} (limit {loss_tol}), gradient rel L2 "
                f"err {errs[1]:.3e} (limit {grad_tol}); worst {errs[2]}")
        out[name] = errs
    return cpu[0], out


class StepTimer(Callback):
    """Host time of each fit step, each ended by a device sync."""

    def __init__(self):
        self.times = []
        self._t0 = 0.0

    def on_batch_begin(self, batch, logs=None):
        torch.cuda.synchronize()
        self._t0 = time.perf_counter()

    def on_batch_end(self, batch, logs=None):
        torch.cuda.synchronize()
        self.times.append(time.perf_counter() - self._t0)


def phase_main_path(device):
    """Phase 5: the port's main path at full width."""
    model = seeded_resnet50(torch.bfloat16, device)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9))
    trainer = hvd.Trainer(model, resnet.make_loss_fn(model), opt,
                          has_aux=True)
    batch = resnet.synthetic_imagenet(BATCH, IMAGE, seed=SEED,
                                      num_classes=CLASSES, device=device)
    timer = StepTimer()
    bn.reset_launch_counts()
    history = trainer.fit(
        [batch], epochs=STEPS, steps_per_epoch=1, verbose=False,
        callbacks=[hvd.BroadcastGlobalVariablesCallback(0),
                   hvd.MetricAverageCallback(), timer])
    torch.cuda.synchronize()
    launches = dict(bn.LAUNCHES)
    losses = history["loss"]
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"loss did not fall: {losses}")
    check_captured(trainer, launches, {k: BN_LAYERS for k in launches})
    steady = timer.times[2:]
    images_per_s = BATCH * len(steady) / sum(steady)
    return losses, launches, images_per_s, steady


def check_captured(trainer, launches: dict, per_step: dict) -> None:
    """A main path's STEPS calls through the captured step: the first eager,
    the second captured, the rest replays (a tree before ``hvd.spmd``, as
    ``tools/bench_bn_sums.py --root`` may load, runs every step eagerly);
    each kernel launched ``per_step`` times a step, its launches in a replay
    counted there."""
    step = getattr(trainer, "_step", None)
    if step is not None and (step.runs, step.replays) != (2, STEPS - 1):
        raise RuntimeError(f"{STEPS} steps ran the step in Python "
                           f"{step.runs} times and replayed it "
                           f"{step.replays} times; expected 2 and "
                           f"{STEPS - 1}")
    for k, n in per_step.items():
        if launches[k] != n * STEPS:
            raise RuntimeError(f"{k} launched {launches[k]} times in "
                               f"{STEPS} steps, expected {n} a step")


# -- the LM (B3/B4's path) -----------------------------------------------------------

def lm_config(dtype, num_layers: int = LM_LAYERS):
    """bench.py's full-width LM (``_lm_extra``): vocab 32768, E=1024, H=8,
    Hkv=4, mlp 4096, T up to 8192."""
    return transformer.TransformerConfig(
        vocab_size=32_768, num_layers=num_layers, num_heads=8,
        num_kv_heads=4, embed_dim=1024, mlp_dim=4096, max_seq_len=8192,
        dtype=dtype)


def phase_lm_step_vs_cpu(device):
    """One full-width LM step, depth cut to 2 layers, B=1, T=2304 (above
    the 2048 switch, so the card runs B3/B4 and the CPU ``blockwise``), on
    the card through ``Trainer.train_step`` against the same loss and
    gradients on the CPU in fp32 (plain path): the card in fp32 (tight
    limits) and in bf16, the main path's dtype. A planted B4 fault (di
    dropped) must fail the fp32 check."""
    g = torch.Generator().manual_seed(SEED + 4)
    tokens = torch.randint(0, lm_config(torch.float32).vocab_size,
                           (1, LM_STEP_T), generator=g)

    def init(dtype, dev):
        return transformer.init_params(lm_config(dtype, LM_STEP_LAYERS),
                                       seed=SEED, device=dev)

    def card_step(dtype):
        model = init(dtype, device)
        cfg = lm_config(dtype, LM_STEP_LAYERS)
        trainer = hvd.Trainer(
            model, transformer.make_loss_fn(cfg, fused_head=True),
            hvd.DistributedOptimizer(AdamW(model.parameters(), 3e-4,
                                           weight_decay=0.1)))
        before = dict(fa.LAUNCHES)
        gl, _ = trainer.train_step(tokens.to(device))
        grads = {n: p.grad.detach().float().cpu()
                 for n, p in model.named_parameters()}
        for k in before:
            if fa.LAUNCHES[k] - before[k] != LM_STEP_LAYERS:
                raise RuntimeError(
                    f"{k}: {fa.LAUNCHES[k] - before[k]} launches in one "
                    f"2-layer step, expected {LM_STEP_LAYERS}")
        del model, trainer
        free_cuda()
        return _step_errors((float(gl), grads), cpu)

    def beyond(errs, tol):
        return any(e > lim for e, lim in zip(
            (errs[0], errs[1], errs[2][0]), tol))

    model = init(torch.float32, "cpu")
    loss = transformer.make_loss_fn(lm_config(torch.float32, LM_STEP_LAYERS),
                                    fused_head=True)(model, tokens)
    loss.backward()
    cpu = (loss.item(), {n: p.grad.detach().float()
                         for n, p in model.named_parameters()})
    del model
    out = {}
    for name, dtype, tol in (("fp32", torch.float32, LM_STEP_FP32_TOL),
                             ("bf16", torch.bfloat16, LM_STEP_BF16_TOL)):
        errs = card_step(dtype)
        if beyond(errs, tol):
            raise RuntimeError(
                f"card {name} LM step disagrees with the CPU fp32 step: loss "
                f"rel err {errs[0]:.3e}, gradient rel L2 err {errs[1]:.3e}, "
                f"worst tensor {errs[2]} (limits {tol})")
        out[name] = errs
    # The planted fault: B4 given g_lse = rowsum(dO·O), so di = 0.
    kernel = fa.flash_bwd_kernel

    def drop_di(q, k, v, o, lse, g_out, g_lse=None, **kw):
        return kernel(q, k, v, o, lse, g_out,
                      (g_out.float() * o.float()).sum(-1), **kw)

    fa.flash_bwd_kernel = drop_di
    try:
        errs = card_step(torch.float32)
    finally:
        fa.flash_bwd_kernel = kernel
    if not beyond(errs, LM_STEP_FP32_TOL):
        raise RuntimeError(f"planted fault (B4 drops di) passed the fp32 LM "
                           f"step check: {errs}")
    out["fault"] = errs
    return cpu[0], out


def phase_lm_main_path(device):
    """The LM's main path at full width: bench.py's config (8 layers,
    T=8192, B=2, bf16, fused head), ``DistributedOptimizer(AdamW(3e-4,
    weight_decay=0.1))``, ``Trainer.fit`` for STEPS steps on a repeated
    seeded batch."""
    cfg = lm_config(torch.bfloat16)
    model = transformer.init_params(cfg, seed=SEED, device=device)
    n_params = sum(p.numel() for p in model.parameters())
    opt = hvd.DistributedOptimizer(AdamW(model.parameters(), 3e-4,
                                         weight_decay=0.1))
    trainer = hvd.Trainer(model, transformer.make_loss_fn(cfg,
                                                          fused_head=True),
                          opt)
    tokens = transformer.synthetic_tokens(LM_BATCH, LM_T, cfg.vocab_size,
                                          seed=SEED, device=device)
    timer = StepTimer()
    torch.cuda.reset_peak_memory_stats(device)
    reset_launch_counts()
    history = trainer.fit(
        [tokens], epochs=STEPS, steps_per_epoch=1, verbose=False,
        callbacks=[hvd.BroadcastGlobalVariablesCallback(0),
                   hvd.MetricAverageCallback(), timer])
    torch.cuda.synchronize()
    launches = {k: v for k, v in launch_counts().items()
                if k in REPLAY_COUNTS["lm"]}
    losses = history["loss"]
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"non-finite LM loss: {losses}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"LM loss did not fall: {losses}")
    check_captured(trainer, launches, REPLAY_COUNTS["lm"])
    steady = timer.times[2:]
    tokens_per_s = LM_BATCH * LM_T * len(steady) / sum(steady)
    peak_gib = torch.cuda.max_memory_allocated(device) / 2 ** 30
    del model, trainer, opt
    free_cuda()
    return losses, launches, tokens_per_s, steady, n_params, peak_gib


# -- checkpoint and resume (phase 10) -------------------------------------------

# Run A trains CKPT_EPOCHS epochs of CKPT_STEPS steps, saving every epoch,
# with the save of epoch CKPT_TORN torn; run B, from another seed, resumes
# from the directory. The directory lies in the checkout (.gitignore lists
# it) and is removed after each workload.
CKPT_DIR = "_chip_smoke_ckpt"
CKPT_EPOCHS = 3
CKPT_STEPS = 2
CKPT_TORN = 2


def _cpu_tree(x):
    """A CPU copy of a state dict (nested dicts and lists of tensors)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, dict):
        return {k: _cpu_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_cpu_tree(v) for v in x)
    return x


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The bytes of ``t``, so that equality is bit for bit (NaNs too)."""
    flat = t.detach().reshape(-1)
    return flat.view(torch.uint8) if flat.numel() else flat


def _leaves(x) -> list:
    if isinstance(x, dict):
        return [t for v in x.values() for t in _leaves(v)]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _leaves(v)]
    return [x] if isinstance(x, torch.Tensor) else []


def _tree_diff(a, b, path="") -> list[str]:
    """Where two state trees differ: a tensor must match in dtype, shape and
    every bit, any other value must be equal."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        same = (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                and a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(_bits(a), _bits(b)))
        return [] if same else [path]
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            return [f"{path} keys"]
        return [d for k in a for d in _tree_diff(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return [f"{path} length"]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in _tree_diff(x, y, f"{path}/{i}")]
    return [] if a == b else [path]


class Snapshot(Callback):
    """A CPU copy of the trainer's model and optimizer state: at the end of
    epoch ``at``, or at train begin (after ``fit(resume=)`` restored)."""

    def __init__(self, at: int | None = None) -> None:
        self.at = at
        self.state = None
        self.epoch = None
        self.clock = None

    def _take(self) -> None:
        self.state = _cpu_tree({"model": self.trainer.model.state_dict(),
                                "optimizer":
                                    self.trainer.optimizer.state_dict()})
        self.epoch = self.trainer.epoch

    def on_train_begin(self, logs=None):
        self.clock = time.perf_counter()
        if self.at is None:
            self._take()

    def on_epoch_end(self, epoch, logs=None):
        if epoch == self.at:
            self._take()


class LossLog(Callback):
    """Every step's loss, as the trainer returned it."""

    def __init__(self) -> None:
        self.losses = []

    def on_batch_end(self, batch, logs=None):
        self.losses.append(logs["loss"].detach().cpu().clone())


class TimedCheckpoint(ModelCheckpointCallback):
    """ModelCheckpointCallback with the seconds of each save."""

    def __init__(self, directory: str) -> None:
        super().__init__(directory)
        self.seconds = []

    def on_epoch_end(self, epoch, logs=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        super().on_epoch_end(epoch, logs)
        self.seconds.append(time.perf_counter() - t0)


def ckpt_workload(name: str, device, seed: int):
    """A fresh trainer of the workload, weights from ``seed``, and the
    batch every step takes."""
    if name == "resnet50":
        model = seeded_resnet50(torch.bfloat16, device, seed)
        opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
        trainer = hvd.Trainer(model, resnet.make_loss_fn(model),
                              hvd.DistributedOptimizer(opt), has_aux=True)
        batch = resnet.synthetic_imagenet(BATCH, IMAGE, seed=SEED,
                                          num_classes=CLASSES, device=device)
        return trainer, batch
    cfg = lm_config(torch.bfloat16)
    model = transformer.init_params(cfg, seed=seed, device=device)
    trainer = hvd.Trainer(
        model, transformer.make_loss_fn(cfg, fused_head=True),
        hvd.DistributedOptimizer(AdamW(model.parameters(), 3e-4,
                                       weight_decay=0.1)))
    batch = transformer.synthetic_tokens(LM_BATCH, LM_T, cfg.vocab_size,
                                         seed=SEED, device=device)
    return trainer, batch


def checkpoint_drill(name: str, device, directory: str) -> dict:
    """Phase 10 for one workload: the torn-write drill, then the resume."""
    trainer, batch = ckpt_workload(name, device, SEED)
    saves, at_save, run_a = TimedCheckpoint(directory), Snapshot(1), LossLog()
    before = os.environ.get("HOROVOD_FAULT_INJECT")
    os.environ["HOROVOD_FAULT_INJECT"] = f"torn_write@epoch={CKPT_TORN}"
    resilience.reset_injector()
    try:
        trainer.fit([batch], CKPT_EPOCHS, CKPT_STEPS, verbose=False,
                    callbacks=[saves, at_save, run_a])
    finally:
        if before is None:
            del os.environ["HOROVOD_FAULT_INJECT"]
        else:
            os.environ["HOROVOD_FAULT_INJECT"] = before
        resilience.reset_injector()
    del trainer
    free_cuda()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        latest = checkpoint.latest_epoch(directory)
    torn = [str(w.message) for w in caught
            if f"epoch {CKPT_TORN} " in str(w.message)
            and "(torn write)" in str(w.message)]
    if latest != CKPT_TORN - 1 or not torn:
        raise RuntimeError(
            f"{name}: latest_epoch {latest} (expected {CKPT_TORN - 1}), "
            f"warnings {[str(w.message) for w in caught]}")
    trainer, _ = ckpt_workload(name, device, SEED + 1)
    resumed, run_b = Snapshot(), LossLog()
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # the torn epoch
        trainer.fit([batch], CKPT_EPOCHS, CKPT_STEPS, verbose=False,
                    callbacks=[resumed, run_b], resume=directory)
    load_s = resumed.clock - t0
    del trainer
    free_cuda()
    if resumed.epoch != CKPT_TORN:
        raise RuntimeError(f"{name}: resumed at epoch {resumed.epoch}, "
                           f"expected {CKPT_TORN}")
    diff = _tree_diff(resumed.state, at_save.state)
    if diff:
        raise RuntimeError(f"{name}: the restored state differs from the "
                           f"state saved at epoch {CKPT_TORN - 1}: "
                           f"{diff[:8]} ({len(diff)} entries)")
    first_a, first_b = run_a.losses[CKPT_TORN * CKPT_STEPS], run_b.losses[0]
    if not torch.equal(first_a, first_b):
        raise RuntimeError(f"{name}: first resumed loss {first_b.item()!r} "
                           f"differs from run A's {first_a.item()!r}")
    return {"latest": latest, "torn": torn[0], "loss": first_b.item(),
            "save_s": saves.seconds, "load_s": load_s,
            "bytes": os.path.getsize(checkpoint._path(directory,
                                                      CKPT_TORN - 1)),
            "tensors": len(_leaves(at_save.state))}


def phase_checkpoint(device) -> dict:
    """Phase 10: checkpoint and resume at full width, ResNet-50 and the LM,
    through ``fit``, ``ModelCheckpointCallback`` and ``fit(resume=)``. Every
    kernel of the two paths must launch."""
    reset_launch_counts()
    out = {}
    for name in ("resnet50", "lm"):
        directory = os.path.join(HERE, CKPT_DIR, name)
        shutil.rmtree(directory, ignore_errors=True)
        try:
            out[name] = checkpoint_drill(name, device, directory)
        finally:
            shutil.rmtree(directory, ignore_errors=True)
    shutil.rmtree(os.path.join(HERE, CKPT_DIR), ignore_errors=True)
    launches = launch_counts()
    idle = sorted(k for k, v in launches.items() if v == 0)
    if idle:
        raise RuntimeError(f"phase 10 never launched {idle}: {launches}")
    out["launches"] = launches
    return out


# -- A1, the AdamW update (phase 11) --------------------------------------------

# A1 against its plain version on the same inputs. The moments: both sides
# form the same fp32 blend with the same operations (A1's _rn intrinsics
# leave nvcc nothing to contract) and round it once to the moment dtype:
# within one ulp of that dtype (read: equal). The parameters: the bias
# corrections 1 − b1ᵗ and 1 − b2ᵗ come from powf on the card on both sides;
# against the CPU's pow, k ulp of b2ᵗ (6e-8) become k·6e-5 of c2 at t = 1
# (1 − b2 = 1e-3) and half that of √v̂. So the limit: A1_UPD_TOL of the
# plain version's update, plus one rounding of the parameter (2^-23 of |p|
# in fp32, 2^-8 in bf16). The step counts must be equal.
A1_UPD_TOL = 1e-3
A1_HYPER = dict(lr=3e-4, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.1)
A1_REPS = 20
PLAIN_REPS = 3
# Beside the LM's parameters (fp32, bf16 moments, step 7 → 8): (name,
# sizes, parameter dtype, moment dtype, step count before the update,
# elements each base lies into its allocation). Sizes cross A1's 8-element
# vectors and 8192-element chunks; a base one element off takes the scalar
# loads; a 0-element tensor must still count its step.
A1_CASES = (
    ("ragged, first step", (0, 1, 7, 8191, 8193, 20000), torch.float32,
     torch.bfloat16, 0, 0),
    ("bases off 16 bytes", (5000, 12345), torch.float32, torch.bfloat16, 3,
     1),
    ("bf16 parameters, fp32 moments", (3, 4099, 16385), torch.bfloat16,
     torch.float32, 0, 0),
)
A1_LM_STEP = 7
# The LM step A/B: warm-up and timed steps of each run, A1 then plain
# then plain then A1.
LM_AB_WARM = 3
LM_AB_STEPS = 10


def _at_offset(t: torch.Tensor, offset: int) -> torch.Tensor:
    """A copy of ``t`` whose base lies ``offset`` elements into its
    allocation (a clone would be aligned)."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    return buf[offset:].view(t.shape).copy_(t)


def a1_inputs(sizes, pdt, mdt, step0: int, offset: int, device, seed: int):
    """(params, grads, exp_avg, exp_avg_sq, steps) for A1, seeded."""
    g = torch.Generator(device=device).manual_seed(seed)

    def draw(n, dt, scale, square=False):
        x = torch.randn(n, generator=g, device=device)
        return _at_offset(((x * x) if square else x).mul_(scale).to(dt),
                          offset)

    return ([draw(n, pdt, 0.02) for n in sizes],
            [draw(n, pdt, 1e-2) for n in sizes],
            [draw(n, mdt, 1e-3) for n in sizes],
            [draw(n, mdt, 1e-5, square=True) for n in sizes],
            [torch.full((), step0, dtype=torch.int32, device=device)
             for _ in sizes])


def a1_copy(inputs):
    return tuple([_at_offset(t, t.storage_offset()) for t in col]
                 for col in inputs)


def a1_run(update, inputs):
    """``update`` applied to a copy of ``inputs``; returns the copy."""
    out = a1_copy(inputs)
    update(*out, **A1_HYPER)
    torch.cuda.synchronize()
    return out


def a1_errors(got, want, inputs) -> dict:
    """The worst parameter error as a share of its limit (≤ 1 passes), the
    worst moment error in ulps of the moment dtype, whether the step counts
    agree, and the largest absolute parameter difference."""
    (pk, _, mk, vk, sk), (pp, _, mp, vp, sp) = got, want
    p_share = mom_ulps = max_abs = 0.0
    for a, b, x0 in zip(pk, pp, inputs[0]):
        if not a.numel():
            continue
        rnd = 2.0 ** (-23 if a.dtype == torch.float32 else -8)
        a, b, x0 = a.float(), b.float(), x0.float()
        lim = A1_UPD_TOL * (b - x0).abs() + rnd * b.abs()
        d = (a - b).abs()
        p_share = max(p_share, float((d / lim.clamp_min(1e-30)).max()))
        max_abs = max(max_abs, float(d.max()))
    for a, b in zip(mk + vk, mp + vp):
        if not a.numel():
            continue
        _, exp = torch.frexp(b.float())
        bits = 8 if b.dtype == torch.bfloat16 else 24
        ulp = torch.ldexp(torch.ones_like(b, dtype=torch.float32),
                          exp - bits)
        mom_ulps = max(mom_ulps, float(((a.float() - b.float()).abs()
                                        / ulp).max()))
    steps_equal = all(torch.equal(a, b) for a, b in zip(sk, sp))
    return {"p_share": p_share, "moment_ulps": mom_ulps,
            "steps_equal": steps_equal, "max_abs_err": max_abs}


def a1_fails(err) -> bool:
    return (err["p_share"] > 1.0 or err["moment_ulps"] > 1.0
            or not err["steps_equal"])


def a1_identical(a, b) -> bool:
    return all(torch.equal(_bits(x), _bits(y))
               for ca, cb in zip(a, b) for x, y in zip(ca, cb))


def a1_short(params, grads, mus, nus, steps, **hyper):
    """The planted fault: A1 launched over one chunk fewer than its table
    holds, so the last tensor's last chunk is never updated."""
    table = optim.build_table(params, grads, mus, nus, steps)
    optim.launch(table, chunks=table.chunks - 1, **hyper)


class PlainAdamW(AdamW):
    """AdamW whose update is the plain version on the card: the other side
    of phase 11's LM step A/B."""

    def _update(self, params, grads, mus, nus, steps, group, table):
        optim.adamw_update_plain(
            params, grads, mus, nus, steps, lr=group["lr"], b1=group["b1"],
            b2=group["b2"], eps=group["eps"],
            weight_decay=group["weight_decay"])
        return None


def lm_ab(model, cfg, tokens) -> dict:
    """LM steps with A1, then the plain update, then plain, then A1, on one
    model: tokens/s of each run's timed steps, and A1's launches in each."""
    out = {"a1": [], "plain": []}
    loss_fn = transformer.make_loss_fn(cfg, fused_head=True)
    for which in ("a1", "plain", "plain", "a1"):
        cls = AdamW if which == "a1" else PlainAdamW
        trainer = hvd.Trainer(model, loss_fn, hvd.DistributedOptimizer(
            cls(model.parameters(), 3e-4, weight_decay=0.1)))
        optim.reset_launch_counts()
        for _ in range(LM_AB_WARM):  # eager, captured, replayed
            trainer.train_step(tokens)
        torch.cuda.synchronize()
        launches = optim.LAUNCHES["adamw"]
        if launches != (LM_AB_WARM if which == "a1" else 0):
            raise RuntimeError(f"LM A/B {which}: {launches} A1 launches in "
                               f"{LM_AB_WARM} steps")
        t0 = time.perf_counter()
        for _ in range(LM_AB_STEPS):
            trainer.train_step(tokens)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        out[which].append(LM_BATCH * LM_T * LM_AB_STEPS / dt)
        del trainer
        free_cuda()
    return out


def phase_adamw(device) -> dict:
    """Phase 11: A1 against its plain version at the LM's parameters and at
    A1_CASES, twice each and bit-identical, a planted fault, its times at
    the LM's parameters, and the LM step with A1 against the plain update
    (``lm_ab``)."""
    cfg = lm_config(torch.bfloat16)
    model = transformer.init_params(cfg, seed=SEED, device=device)
    sizes = [p.numel() for p in model.parameters()]
    cases = (("LM", sizes, torch.float32, torch.bfloat16, A1_LM_STEP, 0),
             *A1_CASES)
    rec = {"cases": {}}
    for i, (name, sz, pdt, mdt, step0, off) in enumerate(cases):
        inputs = a1_inputs(sz, pdt, mdt, step0, off, device, SEED + 20 + i)
        want = a1_run(optim.adamw_update_plain, inputs)
        optim.reset_launch_counts()
        got = a1_run(optim.adamw_update, inputs)
        if optim.LAUNCHES["adamw"] != 1:
            raise RuntimeError(f"A1 {name}: {optim.LAUNCHES['adamw']} "
                               f"launches for one update")
        again = a1_run(optim.adamw_update, inputs)
        err = a1_errors(got, want, inputs)
        if a1_fails(err):
            raise RuntimeError(f"A1 {name} disagrees with its plain version: "
                               f"{err}")
        if not a1_identical(got, again):
            raise RuntimeError(f"A1 {name}: two runs differ")
        rec["cases"][name] = err
        if name != "LM":
            del inputs, want, got, again
            continue
        fault = a1_errors(a1_run(a1_short, inputs), want, inputs)
        if not a1_fails(fault):
            raise RuntimeError(f"A1's planted fault (one chunk left out) "
                               f"passed the check: {fault}")
        rec["fault"] = fault
        del want, got, again
        work = a1_copy(inputs)
        table = optim.build_table(*work)
        # The learning rate as the optimizer holds it: a device tensor.
        hyper = dict(A1_HYPER, lr=torch.full((), A1_HYPER["lr"],
                                             device=device))
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        for reps, fn, field in (
                (A1_REPS, lambda: optim.launch(table, **hyper), "ms"),
                (PLAIN_REPS, lambda: optim.adamw_update_plain(
                    *work, **hyper), "plain_ms")):
            fn()
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            rec[field] = start.elapsed_time(end) / reps
        # The nearest library call: torch.optim.AdamW(fused=True), fp32
        # moments and the decay applied first — not the same function.
        lib_params = [torch.nn.Parameter(p.clone()) for p in work[0]]
        for p, g in zip(lib_params, work[1]):
            p.grad = g
        lib = torch.optim.AdamW(lib_params, lr=A1_HYPER["lr"],
                                betas=(A1_HYPER["b1"], A1_HYPER["b2"]),
                                eps=A1_HYPER["eps"],
                                weight_decay=A1_HYPER["weight_decay"],
                                fused=True)
        lib.step()
        start.record()
        for _ in range(A1_REPS):
            lib.step()
        end.record()
        end.synchronize()
        rec["nearest_library_ms"] = start.elapsed_time(end) / A1_REPS
        nbytes = sum(n * (3 * 4 + 4 * 2) + 8 for n in sizes)
        rec.update(bound_ms=1e3 * nbytes / HBM_BYTES_PER_S, bound_by="bytes",
                   bytes=nbytes, params=sum(sizes), tensors=len(sizes),
                   max_abs_err=err["max_abs_err"])
        del work, table, lib, lib_params, inputs
        free_cuda()
    tokens = transformer.synthetic_tokens(LM_BATCH, LM_T, cfg.vocab_size,
                                          seed=SEED, device=device)
    rec["lm_ab"] = lm_ab(model, cfg, tokens)
    del model
    free_cuda()
    return rec


# -- the captured step (phase 12) ----------------------------------------------

# Trainer(steps_per_call=CAPTURE_K) runs its step through hvd.spmd: the first
# call eager, the second captured as one CUDA graph and replayed, every later
# call replayed. Phase 12 holds three such calls against three calls of the
# function spmd wraps, run eagerly (trainer.step_fn), from the same seeded
# weights and batches, with the learning rate changed through set_lr before
# the second and the third call: every loss, parameter, buffer and optimizer
# state tensor must be equal bit for bit. cuDNN is held to its deterministic
# algorithms in the phase (restored after), so that two eager runs agree
# bit for bit; the port's kernels have no float atomics.
CAPTURE_K = 5
CAPTURE_LRS = {"resnet50": (0.1, 0.05, 0.025), "lm": (3e-4, 1.5e-4, 7.5e-5)}
AB_WINDOWS = 5
AB_CALLS = 2  # calls of CAPTURE_K steps in one timed window
REPLAY_MARK = "chip_smoke.replay"
# The port's kernels a replay of each workload must run, a step.
REPLAY_KERNELS = {
    "resnet50": {"channel_sums_ring_kernel": BN_LAYERS,
                 "channel_grad_sums_kernel": BN_LAYERS},
    "lm": {"flash_fwd_kernel": LM_LAYERS, "flash_bwd_dq_kernel": LM_LAYERS,
           "flash_bwd_dkdv_kernel": LM_LAYERS, "adamw_kernel": 1,
           "ce_chunk_fwd_kernel": LM_CHUNKS,
           "ce_chunk_bwd_kernel": LM_CHUNKS},
}
# The same, as the wrappers count them (LAUNCHES).
REPLAY_COUNTS = {
    "resnet50": {"channel_sums": BN_LAYERS, "channel_grad_sums": BN_LAYERS},
    "lm": {"flash_fwd": LM_LAYERS, "flash_bwd": LM_LAYERS, "adamw": 1,
           "ce_chunk_fwd": LM_CHUNKS, "ce_chunk_bwd": LM_CHUNKS},
}
RULES_CALLS = 8  # (f): the inner optimizer's state is loaded after call 4


def launch_counts() -> dict:
    return {**bn.LAUNCHES, **fa.LAUNCHES, **optim.LAUNCHES, **xent.LAUNCHES}


def reset_launch_counts() -> None:
    for reset in (bn.reset_launch_counts, fa.reset_launch_counts,
                  optim.reset_launch_counts, xent.reset_launch_counts):
        reset()


def capture_workload(name: str, device, float_lr: bool = False):
    """A fresh ``Trainer(steps_per_call=CAPTURE_K)`` of the workload, weights
    from SEED, and the batches of its three calls (CAPTURE_K stacked each).
    ResNet-50 takes ``training.sgd(0.1, momentum=0.9)`` — or, with
    ``float_lr``, the same SGD with a Python float LR, the planted fault —
    and the LM AdamW(weight_decay=0.1) with a tensor LR, on A1."""
    lr0 = CAPTURE_LRS[name][0]
    if name == "resnet50":
        model = seeded_resnet50(torch.bfloat16, device)
        opt = (training.SGD(model.parameters(), lr0, momentum=0.9)
               if float_lr else training.sgd(lr0, momentum=0.9))
        trainer = hvd.Trainer(model, resnet.make_loss_fn(model), opt,
                              has_aux=True, steps_per_call=CAPTURE_K)
        batches = []
        for c in range(3):
            parts = [resnet.synthetic_imagenet(
                BATCH, IMAGE, seed=SEED + 10 * c + i, num_classes=CLASSES,
                device=device) for i in range(CAPTURE_K)]
            batches.append(tuple(torch.stack(t) for t in zip(*parts)))
        return trainer, batches
    cfg = lm_config(torch.bfloat16)
    model = transformer.init_params(cfg, seed=SEED, device=device)
    lr = torch.full((), lr0, dtype=torch.float32, device=device)
    trainer = hvd.Trainer(
        model, transformer.make_loss_fn(cfg, fused_head=True),
        AdamW(model.parameters(), lr, weight_decay=0.1),
        steps_per_call=CAPTURE_K)
    batches = [torch.stack([transformer.synthetic_tokens(
        LM_BATCH, LM_T, cfg.vocab_size, seed=SEED + 10 * c + i,
        device=device) for i in range(CAPTURE_K)]) for c in range(3)]
    return trainer, batches


def trainer_state(trainer) -> dict:
    """Every parameter, buffer and optimizer state tensor, cloned."""
    out = {f"model/{k}": v.detach().clone()
           for k, v in trainer.model.state_dict().items()}
    out.update({f"optimizer/{k}": v.detach().clone()
                for k, v in optimizer_state_tensors(
                    trainer.optimizer.optimizer).items()})
    return out


def _profiled(fn, marker: str | None = None) -> dict:
    """``fn()`` (which returns the host wall seconds of the part it times)
    under ``torch.profiler``, ended by a device sync: its kernels by name,
    and from the start of the ``marker`` range ``fn`` opens (all of it
    without one) the summed kernel µs, the µs in which some kernel ran
    (the union of their intervals: a graph may run kernels side by side),
    and the wall. Host events are recorded only for the marker."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA]
    if marker:
        activities.append(ProfilerActivity.CPU)
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        wall = fn()
        torch.cuda.synchronize()
    events = prof.events()
    start = min((e.time_range.start for e in events
                 if e.name == marker
                 and e.device_type == torch.autograd.DeviceType.CPU),
                default=None) if marker else float("-inf")
    if start is None:
        raise RuntimeError(f"no {marker} range in the profile")
    spans = sorted((e.time_range.start, e.time_range.end,
                    profile_torch_step._device_us(e)) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and e.time_range.start >= start)
    busy, reach = 0.0, float("-inf")
    for lo, hi, _ in spans:
        busy += max(0.0, hi - max(lo, reach))
        reach = max(reach, hi)
    return {"kernels": profile_torch_step.kernel_times(events),
            "device_us": sum(us for _, _, us in spans), "busy_us": busy,
            "launches": len(spans), "wall_s": wall}


def _timed(fn) -> float:
    """Host seconds of ``fn()`` up to a device sync."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def three_calls(trainer, batches, lrs, call, profiled=None
                ) -> tuple[list, dict]:
    """The three calls, the LR changed through ``set_lr`` before the second
    and the third. With ``profiled`` (a list), the second and third calls
    run under ``torch.profiler`` (:func:`_profiled`, the third call
    marked) and the profile is appended to it."""
    from torch.profiler import record_function

    losses = []

    def run(i):
        if i:
            trainer.set_lr(lrs[i])
        loss, _ = call(batches[i])
        losses.append(loss)

    def calls_2_and_3():
        run(1)

        def third():
            with record_function(REPLAY_MARK):
                run(2)
        return _timed(third)

    run(0)
    if profiled is None:
        run(1)
        run(2)
    else:
        profiled.append(_profiled(calls_2_and_3, REPLAY_MARK))
    torch.cuda.synchronize()
    return losses, trainer_state(trainer)


def state_diff(a: dict, b: dict) -> list[str]:
    return [k for k in a if not torch.equal(_bits(a[k]), _bits(b[k]))]


def items_ms(r: dict, side: str) -> float:
    """Wall ms a step of the median window of ``side``."""
    return 1e3 * r["items"] / statistics.median(r["rates"][side])


def capture_ab(eager, captured, batch, items: int) -> dict:
    """(e): AB_WINDOWS timed windows of AB_CALLS calls each side, in turns
    (eager, captured, captured, eager, ...): items/s of each window; and
    the eager side's profile of one call (:func:`_profiled`)."""
    rates = {"eager": [], "captured": []}
    for w in range(AB_WINDOWS):
        order = ("eager", "captured") if w % 2 == 0 else ("captured",
                                                          "eager")
        for side in order:
            call = eager.step_fn if side == "eager" else captured.train_step
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(AB_CALLS):
                call(batch)
            torch.cuda.synchronize()
            rates[side].append(items * AB_CALLS * CAPTURE_K
                               / (time.perf_counter() - t0))
    return {"rates": rates, "items": items,
            "eager": _profiled(lambda: _timed(lambda: eager.step_fn(batch)))}


def captured_vs_eager(name: str, device, items: int) -> dict:
    """Phase 12 (a)/(b), (c) and (e) for one workload."""
    lrs = CAPTURE_LRS[name]
    eager, batches = capture_workload(name, device)
    want_losses, want = three_calls(eager, batches, lrs, eager.step_fn)
    captured, _ = capture_workload(name, device)
    kernels: list = []
    reset_launch_counts()
    got_losses, got = three_calls(captured, batches, lrs,
                                  captured.train_step, profiled=kernels)
    counted = launch_counts()
    step = captured._step
    if step.runs != 2 or step.replays != 2 or step.trace_count != 1:
        raise RuntimeError(
            f"{name}: the captured trainer ran its step in Python "
            f"{step.runs} times, replayed {step.replays} and recorded "
            f"{step.trace_count} programs; expected 2, 2 and 1")
    if captured.get_lr() != eager.get_lr():
        raise RuntimeError(f"{name}: LR {captured.get_lr()} vs "
                           f"{eager.get_lr()}")
    if not all(math.isfinite(float(x)) for x in want_losses):
        raise RuntimeError(f"{name}: non-finite eager losses "
                           f"{[float(x) for x in want_losses]}")
    bad = [i for i, (a, b) in enumerate(zip(got_losses, want_losses))
           if not torch.equal(_bits(a), _bits(b))]
    diff = state_diff(got, want)
    if bad or diff:
        raise RuntimeError(
            f"{name}: the captured step differs from the eager step: calls "
            f"{bad} (losses {[float(x) for x in got_losses]} vs "
            f"{[float(x) for x in want_losses]}), state {diff[:8]} "
            f"({len(diff)} of {len(want)} tensors)")
    if name == "resnet50":
        # B1's grid-barrier words of the program's stream: made by the eager
        # first call, baked into the graph; every replay must leave their
        # arrival counts (the low 32 bits; the high half is the generation,
        # which each barrier moves on) at zero.
        stream = next(iter(step.programs.values())).stream
        words = bn._barriers[(device.index, stream.cuda_stream)]
        if (words & 0xFFFFFFFF).any():
            raise RuntimeError(f"B1's barrier words after the replays: "
                               f"{words.tolist()}")
    # (c): the profiled window held the two replays and no eager step, so
    # every launch of the port's kernels in it ran inside a replay.
    window = kernels[0]["kernels"]  # the two replays, by kernel
    replay = {}
    for k, per_step in REPLAY_KERNELS[name].items():
        n = sum(c for kn, (_, c) in window.items() if k in kn)
        if n != 2 * CAPTURE_K * per_step:
            raise RuntimeError(
                f"{name}: {n} launches of {k} in two replays of "
                f"{CAPTURE_K} steps, expected {per_step} a step: "
                f"{sorted(window)[:40]}")
        replay[k] = n // 2
    # The wrappers' counts: the eager call and the two replays, each
    # CAPTURE_K steps.
    for k, per_step in REPLAY_COUNTS[name].items():
        if counted[k] != 3 * CAPTURE_K * per_step:
            raise RuntimeError(
                f"{name}: {k} counted {counted[k]} launches in 3 calls of "
                f"{CAPTURE_K} steps, expected {per_step} a step")
    ab = capture_ab(eager, captured, batches[0], items)
    ab["captured"] = kernels[0]
    ab["replay_kernels"] = replay
    ab["kernels_per_replay"] = sum(c for _, c in window.values()) / 2
    ab["tensors"] = len(want)
    ab["losses"] = [float(x) for x in got_losses]
    del eager, captured, batches
    free_cuda()
    return ab


def planted_float_lr(device) -> dict:
    """(d): ResNet-50 with a Python float LR, captured; set_lr must refuse,
    and the LR written into param_groups after the capture — which the
    graph ignores — must fail the bit-equality check against the eager
    step, while the calls before it pass it."""
    lrs = CAPTURE_LRS["resnet50"]
    eager, batches = capture_workload("resnet50", device)
    want_losses, want = three_calls(eager, batches, lrs, eager.step_fn)
    del eager
    faulty, _ = capture_workload("resnet50", device, float_lr=True)
    losses = []
    refused = None
    for i, batch in enumerate(batches):
        if i:
            if i == 2:
                try:
                    faulty.set_lr(lrs[i])
                except hvd.HorovodError as e:
                    refused = str(e)
            for group in faulty.optimizer.param_groups:
                group["lr"] = lrs[i]
        losses.append(faulty.train_step(batch)[0])
    torch.cuda.synchronize()
    got = trainer_state(faulty)
    if refused is None:
        raise RuntimeError("set_lr on a captured float LR did not raise")
    same = [torch.equal(_bits(a), _bits(b))
            for a, b in zip(losses, want_losses)]
    diff = state_diff(got, want)
    if not (same[0] and same[1]) or same[2] or not diff:
        raise RuntimeError(
            f"planted float LR: losses equal by call {same} (expected "
            f"[True, True, False]), {len(diff)} state tensors differ "
            f"(expected some)")
    del faulty, batches
    free_cuda()
    return {"refused": refused, "differ": len(diff), "tensors": len(want)}


def capture_rules(device) -> dict:
    """(f): the Trainer's capture rules on a small fp32 MLP with
    ``torch.optim.AdamW`` (float LR). Captured and eager (``step_fn``) run
    RULES_CALLS calls from the same weights and batches, and both load the
    inner optimizer's state saved after call 2 before call 5: every loss
    and the final state must be equal bit for bit, the captured trainer
    recording its step twice (once more after the load). Then two calls
    on a ragged batch capture a second program, which must share the first
    one's memory pool; and a ``torch.optim.Adagrad`` trainer is refused."""
    def make(cls=torch.optim.AdamW, **kw):
        torch.manual_seed(SEED)
        model = torch.nn.Sequential(
            torch.nn.Linear(64, 256), torch.nn.GELU(),
            torch.nn.Linear(256, 10)).to(device)
        return hvd.Trainer(model, lambda m, b: F.cross_entropy(m(b[0]), b[1]),
                           cls(model.parameters(), lr=1e-3, **kw))

    g = torch.Generator().manual_seed(SEED + 30)
    batches = [(torch.randn(32, 64, generator=g).to(device),
                torch.randint(0, 10, (32,), generator=g).to(device))
               for _ in range(RULES_CALLS)]
    runs = {}
    for side in ("eager", "captured"):
        trainer = make()
        inner = trainer.optimizer.optimizer
        if not all(gr["capturable"] for gr in inner.param_groups):
            raise RuntimeError("the Trainer left torch.optim.AdamW "
                               "uncapturable")
        call = trainer.step_fn if side == "eager" else trainer.train_step
        losses, saved = [], None
        for i, batch in enumerate(batches):
            if i == 2:
                saved = copy.deepcopy(inner.state_dict())
            if i == 4:
                inner.load_state_dict(saved)
            losses.append(call(batch)[0])
        torch.cuda.synchronize()
        runs[side] = (trainer, losses, trainer_state(trainer))
    (_, want_losses, want), (captured, got_losses, got) = (
        runs["eager"], runs["captured"])
    step = captured._step
    bad = [i for i, (a, b) in enumerate(zip(got_losses, want_losses))
           if not torch.equal(_bits(a), _bits(b))]
    diff = state_diff(got, want)
    if bad or diff or step.trace_count != 2:
        raise RuntimeError(
            f"torch.optim.AdamW trainer: calls {bad} and state {diff[:8]} "
            f"differ from the eager step, {step.trace_count} programs "
            f"recorded (expected none, none and 2)")
    ragged = tuple(t[:20] for t in batches[0])
    for _ in range(2):
        captured.train_step(ragged)
    pools = [p.graph.pool() for p in step.programs.values()
             if p.graph is not None]
    if len(pools) != 2 or pools[0] != pools[1]:
        raise RuntimeError(f"a ragged batch's program: pools {pools}, "
                           f"expected two graphs on one pool")
    try:
        make(torch.optim.Adagrad)
    except hvd.HorovodError as e:
        refused = str(e)
    else:
        raise RuntimeError("a Trainer over torch.optim.Adagrad was built")
    del runs, captured, step
    free_cuda()
    return {"tensors": len(want), "refused": refused}


def captured_step_line(cs: dict, ident: str) -> str:
    """Phase 12's line of output."""
    def spread(rates):
        return (f"median {statistics.median(rates):.1f} (min "
                f"{min(rates):.1f}, max {max(rates):.1f})")

    def side(r, k):
        p = r[k]
        busy_ms = p["busy_us"] / 1e3 / CAPTURE_K
        return (f"{k} wall {items_ms(r, k):.2f} ms a step (median window), "
                f"kernels {p['device_us'] / 1e3 / CAPTURE_K:.2f} ms summed "
                f"and {busy_ms:.2f} ms busy a step (profiled call), busy "
                f"share {p['busy_us'] / 1e6 / p['wall_s']:.3f} of the "
                f"profiled call's wall and {busy_ms / items_ms(r, k):.3f} of "
                f"the median window's")

    def ab(r, unit):
        return (f"{unit}/s captured {spread(r['rates']['captured'])}, eager "
                f"{spread(r['rates']['eager'])}; {side(r, 'captured')}; "
                f"{side(r, 'eager')}; the port's kernels a replay "
                f"{r['replay_kernels']}, "
                f"{r['kernels_per_replay']:.0f} device kernels a call")

    return (
        f"phase 12 captured step: ok; Trainer(steps_per_call={CAPTURE_K}) "
        f"replaying its CUDA graph equals the eager step bit for bit over "
        f"3 calls ({3 * CAPTURE_K} steps: eager, captured + replayed, "
        f"replayed) with set_lr before calls 2 and 3, cuDNN deterministic: "
        f"ResNet-50 (bf16 batch {BATCH}, fused BN, training.sgd(0.1, "
        f"momentum 0.9), LRs {CAPTURE_LRS['resnet50']}) "
        f"{cs['resnet50']['tensors']} tensors, losses "
        f"{cs['resnet50']['losses']}; LM ({LM_LAYERS} layers, B={LM_BATCH} "
        f"T={LM_T} bf16, AdamW wd 0.1 on A1, LRs {CAPTURE_LRS['lm']}) "
        f"{cs['lm']['tensors']} tensors, losses {cs['lm']['losses']}; "
        f"planted float LR caught: set_lr refused (\"{cs['fault']['refused']}"
        f"\"), the LR written after the capture ignored, "
        f"{cs['fault']['differ']} of {cs['fault']['tensors']} tensors "
        f"differ; A/B over {AB_WINDOWS} windows of {AB_CALLS} calls: "
        f"ResNet-50 {ab(cs['resnet50'], 'images')}; LM "
        f"{ab(cs['lm'], 'tokens')}; MLP with torch.optim.AdamW: captured = "
        f"eager bit for bit over {RULES_CALLS} calls, the inner optimizer's "
        f"state loaded before call 5 (recaptured), {cs['rules']['tensors']} "
        f"tensors; a ragged batch's graph on the first one's pool; Adagrad "
        f"refused (\"{cs['rules']['refused']}\"); on {ident}")


def phase_captured_step(device) -> dict:
    """Phase 12: the captured step against the eager step, ResNet-50 and the
    LM at full width, (a)-(e)."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        out = {"resnet50": captured_vs_eager("resnet50", device, BATCH),
               "fault": planted_float_lr(device),
               "lm": captured_vs_eager("lm", device, LM_BATCH * LM_T),
               "rules": capture_rules(device)}
    finally:
        torch.cuda.synchronize()
        torch.backends.cudnn.deterministic = deterministic
    return out


# -- LM serving (phase 9) ------------------------------------------------------

# bench.py's LM at full width and depth; the engine's view (max_blocks ·
# block_size) equals max_seq_len, so its decode attend and generate's run at
# the same shapes and the one-slot engine must match generate bit for bit.
SERVE_BLOCK = 16
SERVE_SEQ = 2048
SERVE_SLOTS = 8
SERVE_B1 = (256, 64)          # (prompt, new tokens) of the one-slot check
SERVE_REQUESTS = 12
SERVE_PROMPTS = (128, 512)
SERVE_NEW = (32, 128)
SERVE_PREFIX = 64             # tokens shared by every third request
# The planted fault: the fresh K/V of this pool scatter (a prefill step of
# the one-slot check, position FAULT_SCATTER - 1) land one position late.
FAULT_SCATTER = 200
# Decode against the training forward: the largest relative L2 error of
# a position's logits, ‖decode − forward‖₂ / ‖forward‖₂, over the
# SERVE_B1[0]-token prompt, bf16 weights and activations on both sides.
# An H100 read 9.5e-3 (argmax equal at 97.3% of positions) and 0.63 with
# the planted frontier fault: the limit is about three times the reading.
SERVE_FWD_TOL = 3e-2
# Serving numbers: SERVE_WINDOWS windows of decode steps timed at B=1 and
# B=8 after a 128-token prompt; SERVE_PREFILL_WINDOWS admissions of 8
# prompts of 256 tokens; an open-loop load of 12 requests at 0.5
# requests/s, prompts 32-128 tokens, 16-64 new (below the engine's
# capacity, so the latencies are not all queueing).
SERVE_DECODE_STEPS = 32
SERVE_DECODE_PROMPT = 128
SERVE_WINDOWS = 5
SERVE_PREFILL_PROMPT = 256
SERVE_PREFILL_WINDOWS = 3
SERVE_LOAD = dict(n=12, rate=0.5, prompt_range=(32, 128),
                  output_range=(16, 64))


def serve_config():
    return serve_bench_torch.lm_config(LM_LAYERS, SERVE_SEQ)


def serve_workload(vocab: int):
    """The 12 requests of phase 9b: (prompt, max_new, tenant), seeded;
    requests 0, 3, 6 and 9 start with the same 64 tokens."""
    g = torch.Generator().manual_seed(SEED + 9)
    prefix = torch.randint(0, vocab, (SERVE_PREFIX,), generator=g)
    out = []
    for i in range(SERVE_REQUESTS):
        plen = int(torch.randint(SERVE_PROMPTS[0], SERVE_PROMPTS[1] + 1, (1,),
                                 generator=g))
        new = int(torch.randint(SERVE_NEW[0], SERVE_NEW[1] + 1, (1,),
                                generator=g))
        prompt = torch.randint(0, vocab, (plen,), generator=g)
        if i % 3 == 0:
            prompt[:SERVE_PREFIX] = prefix
        out.append((prompt.numpy().astype("int32"), new, f"tenant{i % 2}"))
    return out


def keep_tables(engine) -> dict:
    """Record each request's block table as the engine releases it (the
    pages stay intact until reused)."""
    tables = {}
    release = engine.scheduler.release

    def release_and_keep(req):
        if req.blocks:
            tables[req.request_id] = list(req.blocks)
        release(req)

    engine.scheduler.release = release_and_keep
    return tables


def pages_vs_dense(engine, blocks, cache, n: int) -> bool:
    """Do the first ``n`` positions of a one-row dense cache equal the
    engine's pool pages behind ``blocks`` bit for bit?"""
    for pool, dense in zip(engine._pools, (cache.k, cache.v)):
        paged = pool[:, blocks].flatten(1, 2)[:, :n]
        if not torch.equal(paged, dense[:, 0, :n]):
            return False
    return True


def serve_one(cfg, model, device, prompt, fault: bool = False):
    """Phase 9a (and, with ``fault``, 9e): a one-slot engine against
    ``generate`` — tokens equal, pool pages equal the dense cache."""
    plen, new = SERVE_B1
    engine = serving.Engine(cfg, model, block_size=SERVE_BLOCK, max_batch=1,
                            device=device)
    tables = keep_tables(engine)
    if fault:
        # On the device, so that the captured prefill graph holds it.
        scatter = engine._scatter

        def late(tables_, lengths, active, fresh):
            scatter(tables_, lengths + (lengths == FAULT_SCATTER - 1).long(),
                    active, fresh)

        engine._scatter = late
    req = engine.submit(prompt, new)
    engine.run_until_idle()
    got = torch.as_tensor(req.full_sequence(), dtype=torch.long)
    want = transformer.generate(cfg, model, prompt[None], new,
                                device=device)[0].cpu()
    cache, _ = transformer.prefill(cfg, model, got[None, :-1], device=device)
    same_tokens = torch.equal(got, want)
    same_pages = pages_vs_dense(engine, tables[req.request_id], cache,
                                plen + new - 1)
    return same_tokens, same_pages


def decode_vs_forward(cfg, model, device, tokens,
                      shift_frontier: bool = False) -> tuple[float, float]:
    """Phase 9g: teacher-forced ``decode_step`` logits at every position of
    ``tokens`` against the training forward ``model(tokens)`` — the largest
    relative L2 error of a position's logits, and the share of positions
    whose argmax agrees. ``shift_frontier`` plants a fault in the decode
    side only: every query also sees the key one position past it."""
    with torch.no_grad():
        want = model(tokens[None].to(device))[0]
    visibility = transformer._visibility
    if shift_frontier:
        transformer._visibility = (
            lambda frontier, k_len, window: visibility(frontier + 1, k_len,
                                                       window))
    try:
        cache = transformer.init_cache(cfg, 1, device)
        got = torch.empty_like(want)
        for t in range(tokens.shape[0]):
            got[t], cache = transformer.decode_step(cfg, model, cache,
                                                    tokens[t:t + 1])
    finally:
        transformer._visibility = visibility
    rel = (got - want).norm(dim=-1) / want.norm(dim=-1)
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean()
    return float(rel.max()), float(agree)


def top2_margin(cfg, model, device, seq) -> float:
    """The top-2 logit margin of the next token after ``seq``."""
    _, logits = transformer.prefill(cfg, model, seq[None], device=device)
    top = logits[0].topk(2).values
    return float(top[0] - top[1])


def serve_all(cfg, model, device, work, check_each_step=False, **kw):
    """Serve ``work`` in one 8-slot engine; returns the engine and each
    request's generated tokens."""
    engine = serving.Engine(cfg, model, block_size=SERVE_BLOCK,
                            max_batch=SERVE_SLOTS, device=device, **kw)
    reqs = [engine.submit(p, new, tenant=t) for p, new, t in work]
    while engine.has_work():
        engine.step()
        if check_each_step:
            engine.pool.check_invariants()
    unfinished = [r.request_id for r in reqs
                  if r.state is not serving.RequestState.FINISHED
                  or len(r.output) != r.max_new_tokens]
    if unfinished:
        raise RuntimeError(f"requests {unfinished} did not finish")
    return engine, [list(r.output) for r in reqs], reqs


def phase_serving(device):
    """Phase 9: the LM's serving path at full width (module docstring)."""
    t0 = time.perf_counter()
    cfg = serve_config()
    model = transformer.init_params(cfg, seed=SEED, device=device)
    torch.cuda.reset_peak_memory_stats(device)
    bn.reset_launch_counts()
    fa.reset_launch_counts()
    out = {}

    # (a) one slot against generate.
    g = torch.Generator().manual_seed(SEED + 8)
    prompt = torch.randint(0, cfg.vocab_size, (SERVE_B1[0],), generator=g)
    same_tokens, same_pages = serve_one(cfg, model, device, prompt)
    if not (same_tokens and same_pages):
        raise RuntimeError(
            f"one-slot engine vs generate: tokens equal {same_tokens}, pool "
            f"pages equal the dense cache {same_pages}")

    # (b) continuous batching with the prefix cache, against solo runs.
    work = serve_workload(cfg.vocab_size)
    engine, batched, reqs = serve_all(cfg, model, device, work,
                                      check_each_step=True,
                                      prefix_cache=True)
    hits = engine.stats["prefix_hit_tokens"]
    if hits < SERVE_PREFIX:
        raise RuntimeError(f"the shared prefix was never hit ({hits} "
                           f"tokens from the prefix cache)")
    traces = (engine.decode_trace_count, engine.prefill_trace_count)
    if traces != (1, 1):
        raise RuntimeError(f"decode/prefill captures {traces}, expected 1")
    out["replays"] = dict(engine._replays)
    solo_engine = serving.Engine(cfg, model, block_size=SERVE_BLOCK,
                                 max_batch=SERVE_SLOTS, device=device)
    solo = [list(solo_engine.generate_batch([p], new)[0][len(p):])
            for p, new, _ in work]
    differ = []
    for i, ((p, _, _), a, b) in enumerate(zip(work, batched, solo)):
        if a != b:
            k = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
            seq = torch.as_tensor(list(p) + b[:k], dtype=torch.long)
            differ.append((i, k, top2_margin(cfg, model, device, seq)))
    out["batched"] = (SERVE_REQUESTS - len(differ), differ, hits,
                      sum(len(o) for o in batched))

    # (c) preemption: a pool that backs the first 8 prompts and 2 blocks.
    need = sum(-(-len(p) // SERVE_BLOCK) for p, _, _ in work[:SERVE_SLOTS])
    engine, pre, reqs = serve_all(cfg, model, device, work,
                                  check_each_step=True,
                                  num_blocks=need + 2 + 1)
    preempted = [r.request_id for r in reqs if r.preemptions]
    if not preempted:
        raise RuntimeError("the small pool preempted no request")
    wrong = [i for i in preempted if pre[i] != solo[i]]
    if wrong:
        raise RuntimeError(f"preempted requests {wrong} differ from their "
                           f"unpreempted runs")
    out["preempt"] = (preempted, engine.stats["preemptions"],
                      sum(a == b for a, b in zip(pre, solo)))

    # (d) int8_block pages.
    _, q8, _ = serve_all(cfg, model, device, work, check_each_step=True,
                         prefix_cache=True, kv_dtype="int8_block")
    agree = sum(x == y for a, b in zip(q8, batched) for x, y in zip(a, b))
    out["int8"] = agree / sum(len(b) for b in batched)

    # (e) the planted fault must fail (a)'s check.
    fault = serve_one(cfg, model, device, prompt, fault=True)
    if all(fault):
        raise RuntimeError("planted fault (one K/V scattered a position "
                           "late) passed the one-slot check")
    out["fault"] = fault

    # (g) decode against the training forward, and a planted frontier fault.
    fwd = decode_vs_forward(cfg, model, device, prompt)
    if not fwd[0] <= SERVE_FWD_TOL:
        raise RuntimeError(
            f"teacher-forced decode vs the training forward: worst "
            f"position's logits rel L2 err {fwd[0]:.3e} (limit "
            f"{SERVE_FWD_TOL})")
    fwd_fault = decode_vs_forward(cfg, model, device, prompt,
                                  shift_frontier=True)
    if fwd_fault[0] <= SERVE_FWD_TOL:
        raise RuntimeError(
            f"planted fault (visibility frontier one position on) passed "
            f"the decode-vs-forward check: {fwd_fault[0]:.3e}")
    out["forward"] = fwd + fwd_fault

    # (f) the card's numbers.
    sb = serve_bench_torch
    out["decode"] = {b: sb.decode_rates(
        cfg, model, b, steps=SERVE_DECODE_STEPS,
        prompt_len=SERVE_DECODE_PROMPT, block_size=SERVE_BLOCK,
        windows=SERVE_WINDOWS, device=device) for b in (1, SERVE_SLOTS)}
    out["prefill"] = sb.prefill_rates(
        cfg, model, SERVE_SLOTS, SERVE_PREFILL_PROMPT,
        block_size=SERVE_BLOCK, windows=SERVE_PREFILL_WINDOWS,
        device=device)
    load_engine = serving.Engine(cfg, model, block_size=SERVE_BLOCK,
                                 max_batch=SERVE_SLOTS, device=device)
    sb.warm_engine(load_engine)
    out["load"] = sb.run_load(load_engine, sb.sample_workload(
        SERVE_LOAD["n"], SERVE_LOAD["rate"],
        prompt_range=SERVE_LOAD["prompt_range"],
        output_range=SERVE_LOAD["output_range"], vocab=cfg.vocab_size,
        seed=SEED))
    if out["load"]["completed"] != SERVE_LOAD["n"]:
        raise RuntimeError(f"open-loop load: {out['load']}")
    torch.cuda.synchronize()
    # The serving path runs none of the port's kernels (its attend is plain
    # torch, as the reference's is outside Pallas).
    launched = {**bn.LAUNCHES, **fa.LAUNCHES}
    if any(launched.values()):
        raise RuntimeError(f"the serving path launched kernels: {launched}")
    out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
    out["seconds"] = time.perf_counter() - t0
    del model, engine, solo_engine, load_engine
    free_cuda()
    return out


# -- serving on captured graphs, and speculative decoding (phase 13) -----------

# Draft length of the speculative engines; the garbage draft of (e)/(f) is a
# 1-layer model from another seed, and (e) turns speculation off below this
# accept rate. (e)/(f) serve SPEC_GARBAGE_N requests of SPEC_GARBAGE tokens
# (prompt, new) in as many slots.
SPEC_K = 4
SPEC_GARBAGE_SEED = 7
SPEC_MIN_ACCEPT = 0.5
SPEC_GARBAGE = (128, 48)
SPEC_GARBAGE_N = 2
# (h): the batch sizes at which a (B, SPEC_K + 1) decode forward is held
# against SPEC_K + 1 one-token forwards.
ROW_CHECK_BATCHES = (1, 2, 3, 8)
# The engine's graphs on the card: a plain engine captures decode, prefill
# and the first-token sample, a speculating one prefill, the first-token
# sample, verify, draft propose and draft prefill — each once.
PLAIN_GRAPHS = {"decode": 1, "prefill": 1, "first": 1}
SPEC_GRAPHS = {"prefill": 1, "first": 1, "verify": 1, "draft": 1,
               "draft_prefill": 1}


def _serve(engine, prompts, new: int) -> list:
    reqs = [engine.submit(p, new) for p in prompts]
    engine.run_until_idle()
    return [list(r.output) for r in reqs]


def _captures(engine, want: dict, what: str) -> dict:
    got = dict(engine._captures)
    if got != want:
        raise RuntimeError(f"{what}: graphs captured {got}, expected {want}")
    return dict(engine._replays)


def graph_vs_body(cfg, model, device, batch: int) -> dict:
    """(a): ``batch`` requests of SERVE_DECODE_PROMPT tokens for
    SERVE_DECODE_STEPS tokens through an engine replaying its graphs and
    through one running the same bodies eagerly: tokens equal, and every
    pool bit for bit outside the null block."""
    prompts = serve_bench_torch._prompts(cfg, batch, SERVE_DECODE_PROMPT,
                                         seed=SEED + 13)
    outs, pools, replays = {}, {}, {}
    for side in ("graph", "eager"):
        engine = serving.Engine(cfg, model, block_size=SERVE_BLOCK,
                                max_batch=batch,
                                max_prompt_len=SERVE_DECODE_PROMPT,
                                device=device)
        if side == "eager":
            serve_bench_torch.eager_bodies(engine)
        outs[side] = _serve(engine, prompts, SERVE_DECODE_STEPS)
        pools[side] = engine._pools
        if side == "graph":
            replays = _captures(engine, PLAIN_GRAPHS, f"B={batch} engine")
    same_pools = all(torch.equal(_bits(a[:, 1:]), _bits(b[:, 1:]))
                     for a, b in zip(pools["graph"], pools["eager"]))
    if outs["graph"] != outs["eager"] or not same_pools:
        raise RuntimeError(
            f"B={batch}: the replayed graphs differ from their bodies run "
            f"eagerly: tokens equal {outs['graph'] == outs['eager']}, pools "
            f"equal outside block 0 {same_pools}")
    return replays


def row_invariance(cfg, model, device) -> dict:
    """(h): the decode side scores a row the same in a (B, k + 1) forward as
    in k + 1 one-token forwards — each B of ROW_CHECK_BATCHES over copies
    of one seeded random paged view (positions from 300), logits and view
    pages bit for bit. Printed beside it: the elements of the MLP's
    down-projection, all B(k + 1) rows in one library product, that differ
    from one-row products (what the decode side's 8-row products avoid)."""
    g = torch.Generator(device=device).manual_seed(SEED + 15)
    hkv, dh, w = cfg.num_kv_heads, cfg.embed_dim // cfg.num_heads, SPEC_K + 1
    out = {}
    for b in ROW_CHECK_BATCHES:
        view = [tuple(torch.randn(b, SERVE_SEQ, hkv, dh, generator=g,
                                  device=device).to(cfg.dtype)
                      for _ in range(2)) for _ in range(cfg.num_layers)]
        toks = torch.randint(0, cfg.vocab_size, (b, w), generator=g,
                             device=device)
        pos = 300 + torch.arange(w, device=device).expand(b, w)
        wide_view = [tuple(t.clone() for t in v) for v in view]
        with torch.no_grad():
            wide, _ = model.decode(toks, positions=pos, kv_views=wide_view)
            seq = torch.cat([model.decode(
                toks[:, i:i + 1], positions=pos[:, i:i + 1],
                kv_views=view)[0] for i in range(w)], dim=1)
            x = torch.randn(b * w, cfg.mlp_dim, generator=g,
                            device=device).to(cfg.dtype)
            wt = model.blocks[0].mlp_out.to(cfg.dtype)
            rows = torch.cat([x[i:i + 1] @ wt for i in range(b * w)])
            split = int(((x @ wt) != rows).sum())
        same = torch.equal(_bits(wide), _bits(seq)) and all(
            torch.equal(_bits(a), _bits(c))
            for v, u in zip(wide_view, view) for a, c in zip(v, u))
        if not same:
            raise RuntimeError(
                f"B={b}: a (B, {w}) decode forward differs from {w} one-token "
                f"forwards: {int((wide != seq).sum())} logits differ")
        out[b] = split
    return out


def accept_one_more(engine):
    """The planted fault of (f): verify's choices altered so that the host
    accepts one proposal past each row's first mismatch."""
    run, k = engine._run, engine.speculate_k

    def faulty(name):
        out = run(name)
        if name != "verify":
            return out
        choices, props = out.clone(), engine._props
        miss = props != choices[:, :k]
        first = miss.int().argmax(dim=1)
        rows = torch.arange(choices.shape[0], device=choices.device)
        choices[rows, first] = torch.where(miss.any(dim=1),
                                           props[rows, first],
                                           choices[rows, first])
        return choices

    engine._run = faulty
    return engine


def decode_busy(cfg, model, device, batch: int) -> dict:
    """(g): one profiled window of SERVE_DECODE_STEPS decode steps on the
    graphs, every slot busy (the engine is built and its graphs captured
    under the profiler, which sees a replay's kernels only so)."""
    def window():
        engine = serve_bench_torch._filled_engine(
            cfg, model, batch, SERVE_DECODE_PROMPT, SERVE_DECODE_STEPS + 5,
            SERVE_BLOCK, None, device)
        engine.step()
        torch.cuda.synchronize()
        with torch.profiler.record_function(REPLAY_MARK):
            return _timed(lambda: [engine.step()
                                   for _ in range(SERVE_DECODE_STEPS)])

    return _profiled(window, REPLAY_MARK)


def phase_serving_graphs(device) -> dict:
    """Phase 13: the engine's captured forwards against their bodies, and
    speculative decoding, at phase 9's shapes (module docstring)."""
    t0 = time.perf_counter()
    cfg = serve_config()
    model = transformer.init_params(cfg, seed=SEED, device=device)
    bn.reset_launch_counts()
    fa.reset_launch_counts()
    out = {}

    # (a)/(b) graph against eager body, and the capture counts.
    out["graph_vs_body"] = {b: graph_vs_body(cfg, model, device, b)
                            for b in (1, SERVE_SLOTS)}
    # (h) the row invariance speculation's equality rests on.
    out["rows"] = row_invariance(cfg, model, device)

    # (c) self-speculation against generate.
    g = torch.Generator().manual_seed(SEED + 8)
    prompt = torch.randint(0, cfg.vocab_size, (SERVE_B1[0],), generator=g)
    want = transformer.generate(cfg, model, prompt[None], SERVE_B1[1],
                                device=device)[0, SERVE_B1[0]:].tolist()
    engine = serving.Engine(cfg, model, block_size=SERVE_BLOCK, max_batch=1,
                            speculate=SPEC_K, draft_kv_dtype="model",
                            device=device)
    got = _serve(engine, [prompt], SERVE_B1[1])[0]
    if got != want or engine.spec_accept_rate != 1.0:
        raise RuntimeError(
            f"self-speculation: tokens equal generate {got == want}, accept "
            f"rate {engine.spec_accept_rate} (expected 1.0)")
    out["self"] = (engine.spec_accept_rate,
                   _captures(engine, SPEC_GRAPHS, "self-speculation"))
    if engine.decode_trace_count != 0:
        raise RuntimeError("a speculating engine captured decode")

    # (d) the distilled pair on an int4 draft pool against the plain engine.
    target, dcfg, draft = serve_bench_torch.distilled_draft_pair(
        cfg, seed=SEED, device=device)
    plain = serving.Engine(cfg, target, block_size=SERVE_BLOCK, max_batch=1,
                           device=device)
    want = _serve(plain, [prompt], SERVE_B1[1])[0]
    engine = serving.Engine(cfg, target, block_size=SERVE_BLOCK, max_batch=1,
                            speculate=SPEC_K, draft_config=dcfg,
                            draft_params=draft, device=device)
    got = _serve(engine, [prompt], SERVE_B1[1])[0]
    if engine.draft_kv_dtype != "int4" or got != want:
        raise RuntimeError(
            f"distilled pair ({engine.draft_kv_dtype} draft pool): tokens "
            f"equal the plain engine's {got == want}")
    out["distilled"] = (engine.spec_accept_rate,
                        engine.stats["spec_rollback_tokens"],
                        _captures(engine, SPEC_GRAPHS, "distilled pair"))
    del plain, engine

    # (e) a garbage draft under min_accept: the DEGRADE latch, same tokens.
    garbage = transformer.init_params(transformer.draft_config(cfg, 1),
                                      seed=SPEC_GARBAGE_SEED, device=device)
    prompts = serve_bench_torch._prompts(cfg, SPEC_GARBAGE_N,
                                         SPEC_GARBAGE[0], seed=SEED + 14)
    plain = serving.Engine(cfg, model, block_size=SERVE_BLOCK,
                           max_batch=SPEC_GARBAGE_N, device=device)
    wants = _serve(plain, prompts, SPEC_GARBAGE[1])
    engine = serving.Engine(cfg, model, block_size=SERVE_BLOCK,
                            max_batch=SPEC_GARBAGE_N, speculate=SPEC_K,
                            draft_config=transformer.draft_config(cfg, 1),
                            draft_params=garbage, min_accept=SPEC_MIN_ACCEPT,
                            device=device)
    got = _serve(engine, prompts, SPEC_GARBAGE[1])
    st = engine.stats
    if (got != wants or not engine.cache_stats()["spec_disabled"]
            or not st["draft_calls"] < st["verify_calls"]):
        raise RuntimeError(
            f"garbage draft with min_accept={SPEC_MIN_ACCEPT}: tokens equal "
            f"{got == wants}, disabled {engine.cache_stats()['spec_disabled']}"
            f", draft calls {st['draft_calls']}, verify calls "
            f"{st['verify_calls']}")
    out["degrade"] = (engine.spec_accept_rate, st["draft_calls"],
                      st["verify_calls"],
                      _captures(engine, SPEC_GRAPHS, "degraded engine"))
    del plain, engine

    # (f) the planted fault: a verify that accepts one token past the first
    # mismatch must change the tokens.
    engine = accept_one_more(serving.Engine(
        cfg, model, block_size=SERVE_BLOCK, max_batch=SPEC_GARBAGE_N,
        speculate=SPEC_K, draft_config=transformer.draft_config(cfg, 1),
        draft_params=garbage, device=device))
    got = _serve(engine, prompts, SPEC_GARBAGE[1])
    if got == wants:
        raise RuntimeError("planted fault (verify accepting one token past "
                           "the first mismatch) passed the check")
    out["fault"] = sum(a != b for x, y in zip(got, wants)
                       for a, b in zip(x, y))
    del engine, garbage

    # (g) the card's numbers.
    sb = serve_bench_torch
    out["decode"] = {b: sb.decode_ab(
        cfg, model, b, steps=SERVE_DECODE_STEPS,
        prompt_len=SERVE_DECODE_PROMPT, block_size=SERVE_BLOCK,
        windows=SERVE_WINDOWS, device=device) for b in (1, SERVE_SLOTS)}
    spec = dict(speculate=SPEC_K, steps=SERVE_DECODE_STEPS,
                prompt_len=SERVE_DECODE_PROMPT, block_size=SERVE_BLOCK,
                windows=SERVE_WINDOWS, device=device)
    out["spec_distilled"] = sb.speculative_rates(
        cfg, target, draft_config=dcfg, draft_params=draft, **spec)
    out["spec_distilled_model"] = sb.speculative_rates(
        cfg, target, draft_config=dcfg, draft_params=draft,
        draft_kv_dtype="model", **spec)
    out["spec_self"] = sb.speculative_rates(cfg, model,
                                            draft_kv_dtype="model", **spec)
    del target, draft
    free_cuda()
    out["busy"] = {b: decode_busy(cfg, model, device, b)
                   for b in (1, SERVE_SLOTS)}
    torch.cuda.synchronize()
    launched = {**bn.LAUNCHES, **fa.LAUNCHES}
    if any(launched.values()):
        raise RuntimeError(f"the serving path launched kernels: {launched}")
    out["seconds"] = time.perf_counter() - t0
    del model
    free_cuda()
    return out


def serving_graphs_line(sg: dict, ident: str) -> str:
    """Phase 13's line of output."""
    def spread(rates):
        return (f"median {statistics.median(rates):.1f} (min "
                f"{min(rates):.1f}, max {max(rates):.1f})")

    def busy(p):
        return (f"{p['busy_us'] / 1e3 / SERVE_DECODE_STEPS:.3f} ms busy of "
                f"{1e3 * p['wall_s'] / SERVE_DECODE_STEPS:.3f} ms a step, "
                f"busy share {p['busy_us'] / 1e6 / p['wall_s']:.3f}, "
                f"{p['launches'] / SERVE_DECODE_STEPS:.0f} kernels and "
                f"{p['device_us'] / 1e3 / SERVE_DECODE_STEPS:.3f} ms of them "
                f"a step")

    def spec(r):
        return (f"{spread(r['tokens_per_sec'])} tokens/s, accept rate "
                f"{r['accept_rate']:.4f}, draft {r['draft_overhead_ms']:.3f} "
                f"ms a step ({r['draft_kv_dtype']} draft pool)")

    b1, b8 = sg["decode"][1], sg["decode"][SERVE_SLOTS]
    return (
        f"phase 13 serving graphs: ok; phase 9's LM and shapes; (a) graphs "
        f"replayed = their bodies run eagerly, tokens and pools outside "
        f"block 0 bit for bit, B=1 and B={SERVE_SLOTS} over "
        f"{SERVE_DECODE_STEPS} tokens after a {SERVE_DECODE_PROMPT}-token "
        f"prompt; (b) each graph captured once (replays: B=1 "
        f"{sg['graph_vs_body'][1]}, B={SERVE_SLOTS} "
        f"{sg['graph_vs_body'][SERVE_SLOTS]}); (h) a (B, {SPEC_K + 1}) "
        f"decode forward = {SPEC_K + 1} one-token forwards bit for bit "
        f"(logits, view pages) at B=" + "/".join(map(str, sg["rows"]))
        + " (the MLP down-projection in one product of B x "
        f"{SPEC_K + 1} rows differs from one-row products at " + ", ".join(
            f"{v} elements (B={b})" for b, v in sg["rows"].items())
        + f"); (c) self-speculation k="
        f"{SPEC_K} (draft_kv_dtype='model') = generate for {SERVE_B1[0]}+"
        f"{SERVE_B1[1]} tokens, accept rate {sg['self'][0]}, replays "
        f"{sg['self'][1]}, decode never captured; (d) distilled pair (8-layer"
        f" target, 1-layer draft, int4 draft pool) = the plain engine, "
        f"accept rate {sg['distilled'][0]:.4f}, {sg['distilled'][1]} tokens "
        f"rolled back; (e) garbage draft with min_accept={SPEC_MIN_ACCEPT}: "
        f"DEGRADE latched, tokens = the plain engine, accept rate "
        f"{sg['degrade'][0]:.4f}, {sg['degrade'][1]} draft and "
        f"{sg['degrade'][2]} verify calls on the same graphs "
        f"{sg['degrade'][3]}; (f) planted fault (one token accepted past the "
        f"first mismatch) caught, {sg['fault']} tokens differ; (g) decode "
        f"tokens/s, {SERVE_WINDOWS} windows of {SERVE_DECODE_STEPS} steps in "
        f"turns: B=1 graphs {spread(b1['graph'])}, eager bodies "
        f"{spread(b1['eager'])}; B={SERVE_SLOTS} graphs "
        f"{spread(b8['graph'])}, eager bodies {spread(b8['eager'])}; B=1 "
        f"speculative k={SPEC_K}: distilled pair "
        f"{spec(sg['spec_distilled'])}; the same pair "
        f"{spec(sg['spec_distilled_model'])}; self-speculation "
        f"{spec(sg['spec_self'])}; one profiled window of graph decode: B=1 "
        f"{busy(sg['busy'][1])}; B={SERVE_SLOTS} "
        f"{busy(sg['busy'][SERVE_SLOTS])}; phase {sg['seconds']:.1f} s (no "
        f"kernel of the port launched), on {ident}")


# -- the reference's examples on the card (phase 14) --------------------------

EXAMPLES_DIR = os.path.join(CKPT_DIR, "examples")
# The mnist example's first loss on the card (bf16) against the same step on
# the CPU (bf16, same weights, batch and dropout mask): the two round the
# convolutions' and products' bf16 outputs after different accumulation
# orders, one bf16 rounding (2^-8) of some activations, through 4 layers;
# the loss moves far less than 2^-8 of itself. Limit: 2e-2 relative.
MNIST_LOSS_TOL = 2e-2
# Input pipeline: ShardedDataset batches of seeded numpy arrays (ImageNet's
# shape, 8 batches of 32) through prefetch_to_device, compared with the host
# arrays bit for bit, and fed to a captured program.
PREFETCH_BATCH = 32
PREFETCH_SHAPE = (8 * PREFETCH_BATCH, IMAGE, IMAGE, 3)
PREFETCH_DEPTH = 2
PREFETCH_SLEEP_CYCLES = 1_000_000_000  # the consumer's stream: ~0.5 s
# ResNet-50 images/s, the example's shapes (batch 32, 224 px, bf16 input),
# fed from host numpy arrays through prefetch_to_device against batches
# already on the card: IPS_POOL host batches cycled, IPS_STEPS timed steps
# a window, windows in turns (device, host, host, device).
IPS_BATCH = 32
IPS_POOL = 8
IPS_STEPS = 20


def _finite(name: str, losses) -> None:
    if not losses or not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"{name}: a loss is not finite: {losses}")


def _captured(name: str, out: dict, calls: int) -> None:
    """The example's step program: the first call eager, the second
    captured, every later call a replay."""
    if (out["runs"], out["replays"]) != (2, calls - 1):
        raise RuntimeError(
            f"{name}: step program ran its Python {out['runs']} times with "
            f"{out['replays']} replays over {calls} calls (want 2 and "
            f"{calls - 1})")


def run_example(name: str, argv: list, calls: int, a1: int = 0) -> dict:
    """``main(argv)`` of example ``name`` on the card, with the kernels'
    counts set to 0 just before; checks finite losses, the capture and the
    launches (A1 ``a1`` times, every other kernel never)."""
    import importlib

    mod = importlib.import_module(f"horovod_tpu_torch.examples.{name}")
    reset_launch_counts()
    t0 = time.perf_counter()
    out = mod.main(argv + ["--device", "cuda"])
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0
    out["launches"] = launch_counts()
    out["calls"] = calls
    _finite(name, out["losses"])
    _captured(name, out, calls)
    want = {k: (a1 if k == "adamw" else 0) for k in out["launches"]}
    if out["launches"] != want:
        raise RuntimeError(f"{name}: launches {out['launches']}, want "
                           f"{want}")
    return out


def mnist_first_loss_cpu(batch_size: int) -> float:
    """The mnist example's first loss on the CPU: the same seeded weights,
    batch and dropout key, in bf16."""
    model = mnist.ConvModel(generator=torch.Generator().manual_seed(0))
    batch = mnist.synthetic_mnist(batch_size, seed=0, device="cpu")
    with torch.no_grad():
        return float(mnist.make_loss_fn(model)(model, batch))


def check_prefetch(device) -> dict:
    """prefetch_to_device on the card, from ShardedDataset batches of
    seeded numpy arrays: bit for bit (and bf16-cast where asked),
    PREFETCH_DEPTH batches in flight, the copies on a stream other than
    the consumer's (they finish while the consumer's stream still sleeps),
    and each batch read right by a captured program, whose copies into its
    static inputs must follow the prefetch's."""
    rng = np.random.RandomState(SEED)
    x = rng.rand(*PREFETCH_SHAPE).astype(np.float32)
    y = rng.randint(0, 10, size=PREFETCH_SHAPE[0]).astype(np.int64)
    ds = data.ShardedDataset([x, y], 1, PREFETCH_BATCH, seed=SEED)
    cur = torch.cuda.current_stream(device)
    out = {"batches": 0}
    for dtype in (None, torch.bfloat16):
        host = list(ds.batches(0, rank=0))
        torch.cuda.synchronize()
        # The consumer's stream sleeps; copies queued behind it could not
        # finish before it wakes.
        torch.cuda._sleep(PREFETCH_SLEEP_CYCLES)
        it = data.prefetch_to_device(ds.batches(0, rank=0), dtype=dtype,
                                     depth=PREFETCH_DEPTH)
        got = [next(it)]
        if it.pulled != PREFETCH_DEPTH + 1:
            raise RuntimeError(
                f"prefetch: {it.pulled} batches taken when the first was "
                f"handed out (want depth + 1 = {PREFETCH_DEPTH + 1})")
        t0 = time.perf_counter()
        while not it.stream.query():
            if time.perf_counter() - t0 > 10:
                raise RuntimeError("prefetch: the copies never finished")
        if cur.query():
            raise RuntimeError("prefetch: the consumer's stream was idle "
                               "before the copies finished: no overlap to "
                               "show")
        out["overlap_ms"] = 1e3 * (time.perf_counter() - t0)
        got += list(it)
        for i, (batch, want) in enumerate(zip(got, host, strict=True)):
            for g, w in zip(batch, want):
                w = torch.from_numpy(w)
                if dtype is not None and w.is_floating_point():
                    w = w.to(dtype)
                if g.device != device or not torch.equal(g.cpu(), w):
                    raise RuntimeError(
                        f"prefetch: batch {i} ({dtype}) differs from the "
                        f"host's on {g.device}")
            out["batches"] += 1
    if out["batches"] != 2 * ds.steps_per_epoch:
        raise RuntimeError("prefetch: batches lost")
    prog = hvd.spmd(lambda a, b: (a * 2, b + 1))
    for i, (got, want) in enumerate(zip(
            data.prefetch_to_device(ds.batches(1, rank=0),
                                    dtype=torch.bfloat16,
                                    depth=PREFETCH_DEPTH),
            ds.batches(1, rank=0))):
        a, b = prog(*got)
        wa = torch.from_numpy(want[0]).to(torch.bfloat16) * 2
        if not (torch.equal(a.cpu(), wa)
                and torch.equal(b.cpu(), torch.from_numpy(want[1]) + 1)):
            raise RuntimeError(f"prefetch: the captured program read batch "
                               f"{i} wrong")
    if (prog.runs, prog.replays) != (2, ds.steps_per_epoch - 1):
        raise RuntimeError(f"prefetch: the program ran {prog.runs} times "
                           f"with {prog.replays} replays")
    out["captured"] = ds.steps_per_epoch
    return out


def resnet_input_rates(device) -> dict:
    """ResNet-50 images/s at the example's shapes, one captured Trainer
    fed (a) bf16 batches already on the card and (b) host numpy batches
    through prefetch_to_device(dtype=bf16), windows in turns."""
    model = resnet.ResNet50(generator=torch.Generator().manual_seed(SEED))
    model = model.to(device)
    trainer = hvd.Trainer(model, resnet.make_loss_fn(model),
                          training.sgd(0.0125, momentum=0.9), has_aux=True)
    rng = np.random.default_rng(SEED)
    n = IPS_POOL * IPS_BATCH
    images = rng.standard_normal((n, IMAGE, IMAGE, 3), dtype=np.float32)
    labels = rng.integers(0, CLASSES, size=n, dtype=np.int64)
    ds = data.ShardedDataset([images, labels], 1, IPS_BATCH, seed=SEED)
    resident = [[torch.from_numpy(a).to(device) for a in b]
                for b in ds.batches(0, rank=0)]
    for b in resident:
        b[0] = b[0].to(torch.bfloat16)

    def host_batches():
        epoch = 0
        while True:
            yield from ds.batches(epoch, rank=0)
            epoch += 1

    feeds = {"device": lambda: itertools.cycle(resident),
             "host": lambda: data.prefetch_to_device(
                 host_batches(), dtype=torch.bfloat16)}
    rates = {"device": [], "host": []}
    for k in ("device", "host"):  # warm-up: eager, capture, replay
        it = feeds[k]()
        for _ in range(3):
            trainer.train_step(next(it))
    for k in ("device", "host", "host", "device"):
        it = feeds[k]()
        trainer.train_step(next(it))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(IPS_STEPS):
            loss, _ = trainer.train_step(next(it))
        torch.cuda.synchronize()
        rates[k].append(IPS_STEPS * IPS_BATCH / (time.perf_counter() - t0))
    if not math.isfinite(float(loss)):
        raise RuntimeError("resnet input rates: the loss is not finite")
    if trainer._step.runs != 2:
        raise RuntimeError(f"resnet input rates: {trainer._step.runs} "
                           f"Python runs of the step (want 2)")
    return rates


def image_folder_example(root: str) -> dict | None:
    """The tiny ResNet example on a directory of PNGs through
    ImageFolderDataset and prefetch_to_device, where Pillow imports (None
    where it does not)."""
    try:
        from PIL import Image
    except ImportError:
        return None
    rng = np.random.RandomState(SEED)
    for c in range(2):
        os.makedirs(os.path.join(root, f"class{c}"), exist_ok=True)
        for i in range(8):
            px = rng.randint(0, 256, size=(40 + 4 * i, 48, 3), dtype=np.uint8)
            Image.fromarray(px).save(os.path.join(root, f"class{c}",
                                                  f"{i}.png"))
    return run_example("imagenet_resnet50", [
        "--tiny", "--epochs", "1", "--steps-per-epoch", "2", "--batch-size",
        "8", "--data-dir", root, "--checkpoint-dir",
        os.path.join(root, "ckpt")], calls=2)


def phase_examples(device) -> dict:
    """Phase 14: every example's main on the card, prefetch_to_device held
    against the host, ResNet-50's images/s with and without host input, and
    ImageFolderDataset where Pillow imports."""
    t_phase = time.perf_counter()
    root = os.path.join(HERE, EXAMPLES_DIR)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    out = {}
    try:
        ck = os.path.join(root, "rn50")
        out["rn50"] = run_example("imagenet_resnet50", [
            "--epochs", "2", "--steps-per-epoch", "5", "--checkpoint-dir",
            ck], calls=10)
        out["rn50_resumed"] = run_example("imagenet_resnet50", [
            "--epochs", "3", "--steps-per-epoch", "5", "--checkpoint-dir",
            ck], calls=5)
        if (out["rn50"]["start_epoch"], out["rn50_resumed"]["start_epoch"]) \
                != (0, 2):
            raise RuntimeError(
                f"imagenet_resnet50: started at epochs "
                f"{out['rn50']['start_epoch']} and "
                f"{out['rn50_resumed']['start_epoch']} (want 0 and 2)")
        free_cuda()
        out["mnist"] = run_example("mnist", ["--steps", "40"], calls=40)
        cpu = mnist_first_loss_cpu(64)
        rel = abs(out["mnist"]["losses"][0] - cpu) / abs(cpu)
        if rel > MNIST_LOSS_TOL:
            raise RuntimeError(f"mnist: first loss {out['mnist']['losses'][0]}"
                               f" on the card, {cpu} on the CPU: rel err "
                               f"{rel:.3e} > {MNIST_LOSS_TOL}")
        out["mnist_cpu"] = (cpu, rel)
        out["keras_mnist"] = run_example(
            "keras_mnist", ["--epochs", "2", "--steps-per-epoch", "20",
                            "--synthetic"], calls=40)
        out["keras_mnist_advanced"] = run_example(
            "keras_mnist_advanced", ["--epochs", "2", "--steps-per-epoch",
                                     "10", "--checkpoint-dir",
                                     os.path.join(root, "adv")],
            calls=20, a1=20)
        out["mnist_estimator"] = run_example(
            "mnist_estimator", ["--steps", "40", "--model-dir",
                                os.path.join(root, "est")], calls=40)
        for speculate in (0, 3):
            r = run_example("lm_generate", ["--speculate", str(speculate)],
                            calls=300, a1=300)
            if r["served_equal"] != r["requests"]:
                raise RuntimeError(f"lm_generate: {r['served_equal']} of "
                                   f"{r['requests']} served = generate")
            out[f"lm_generate_{speculate}"] = r
        from horovod_tpu_torch.examples import grouped_collectives

        if grouped_collectives.main(["--device", "cuda"]) is not None:
            raise RuntimeError("grouped_collectives ran in a world of 1")
        free_cuda()
        out["prefetch"] = check_prefetch(device)
        out["ips"] = resnet_input_rates(device)
        free_cuda()
        out["image_folder"] = image_folder_example(os.path.join(root, "img"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
        free_cuda()
    out["seconds"] = time.perf_counter() - t_phase
    return out


def examples_line(ex: dict, ident: str) -> str:
    """Phase 14's line of output."""
    def one(name, r):
        return (f"{name}: {r['calls']} steps ({r['runs']} runs, "
                f"{r['replays']} replays), loss "
                f"{r['losses'][0]:.4f} -> {r['losses'][-1]:.4f}, A1 "
                f"{r['launches']['adamw']}, {r['seconds']:.1f} s")

    lm0, lm3 = ex["lm_generate_0"], ex["lm_generate_3"]
    ips = ex["ips"]
    pf = ex["prefetch"]
    folder = ("ImageFolderDataset ran (Pillow imports): " + one(
        "tiny ResNet on 16 PNGs", ex["image_folder"])
        if ex["image_folder"] else
        "ImageFolderDataset skipped (no Pillow on this machine)")
    return (
        f"phase 14 examples: ok on cuda:0; every loss finite, every step "
        f"program 2 Python runs then replays, B1-B4 never launched; "
        f"{one('imagenet_resnet50 (ResNet-50 224 px batch 32)', ex['rn50'])}"
        f", resumed from epoch 1 at epoch 2: "
        f"{one('imagenet_resnet50', ex['rn50_resumed'])}; "
        f"{one('mnist', ex['mnist'])}, first loss vs CPU "
        f"{ex['mnist_cpu'][0]:.6f}: rel err {ex['mnist_cpu'][1]:.2e} (limit "
        f"{MNIST_LOSS_TOL}); "
        f"{one('keras_mnist (adadelta)', ex['keras_mnist'])}; "
        f"{one('keras_mnist_advanced (adam: A1)', ex['keras_mnist_advanced'])}"
        f"; {one('mnist_estimator', ex['mnist_estimator'])}; "
        f"{one('lm_generate', lm0)}, pattern accuracy {lm0['accuracy']:.2f}, "
        f"served {lm0['served_equal']}/{lm0['requests']} = generate bit for "
        f"bit, {lm0['tokens_per_sec']:.0f} tokens/s; --speculate 3: served "
        f"{lm3['served_equal']}/{lm3['requests']} = generate, accept rate "
        f"{lm3['accept_rate']:.2f}, {lm3['tokens_per_sec']:.0f} tokens/s; "
        f"grouped_collectives needs 5 ranks (a CPU gloo world in the tests);"
        f" prefetch_to_device: {pf['batches']} batches (fp32 and bf16) = "
        f"the host arrays bit for bit ({PREFETCH_BATCH} x {IMAGE} px a "
        f"batch), depth {PREFETCH_DEPTH} in flight, {pf['captured']} read "
        f"right by a captured program (2 runs, then replays), the copies of "
        f"depth + 1 batches done on a side stream while the consumer's "
        f"stream slept ({pf['overlap_ms']:.1f} ms after the first batch was "
        f"handed out); "
        f"ResNet-50 batch {IPS_BATCH} captured step, images/s over "
        f"{IPS_STEPS}-step windows (device, host, host, device): from "
        f"batches on the card " + ", ".join(
            f"{v:.1f}" for v in ips["device"]) + "; from host numpy arrays "
        "through prefetch_to_device(bf16) " + ", ".join(
            f"{v:.1f}" for v in ips["host"]) + f"; {folder}; phase "
        f"{ex['seconds']:.1f} s, on {ident}")


# -- the sparse path (phase 15) ----------------------------------------------

# (a) The merge of the sparse exchange at 8 ranks' gathered rows: 8 x 1,024
# rows of 128 fp32, Zipf-hot indices into a 50,000-row table. On
# integer-valued rows every sum is exact, so the card must equal the CPU bit
# for bit; on random rows each merged element is held within SPARSE_TOL of
# Σ|row| over its segment (a reassociation moves it by a few fp32 roundings
# of that sum, ~1e-7 each); either way two runs on the card must be equal
# bit for bit (no float atomics).
SPARSE_ROWS, SPARSE_DIM, SPARSE_TABLE = 8 * 1024, 128, 50_000
SPARSE_TOL = 1e-6
# (c) word2vec at the reference's width (V = 50,000, D = 128, 64 negatives,
# batch 128, skip window 1, 2 skips) on its synthetic corpus: the first loss
# against the same step on the CPU (fp32 on both; sums in another order),
# W2V_LOSS_TOL relative; a captured program against the same step function
# run eagerly, W2V_AB_STEPS steps, every table bit for bit.
W2V_ARGV = ["--vocab-size", "50000", "--embedding-dim", "128",
            "--num-sampled", "64", "--batch-size", "128", "--skip-window",
            "1", "--num-skips", "2", "--synthetic"]
W2V_STEPS = 200
W2V_LOSS_TOL = 1e-4
W2V_AB_STEPS = 5
# (d) the embedding bag at its defaults (60,000 x 32, bag 8, batch 64):
# the example with --sparse-algo gather and dense, BAG_STEPS steps each, the
# tables within BAG_TOL (relative; the two sum the same rows in other
# orders). Its batches are fresh every step, each with its own hot ids and
# a parity label, so its loss carries nothing from step to step; the loss
# is shown to fall on one repeated batch, through the same step.
BAG_STEPS = 20
BAG_TOL = 1e-5
# (e) steps/s over SPARSE_RATE_STEPS replays (batches on the card), and
# merge ms as a mean of REPS replays of the merge captured alone.
SPARSE_RATE_STEPS = 50


def merge_inputs(integer: bool, seed: int = SEED):
    rng = np.random.RandomState(seed)
    idx = (rng.zipf(1.5, SPARSE_ROWS) - 1).clip(max=SPARSE_TABLE - 1)
    vals = (rng.randint(-8, 9, (SPARSE_ROWS, SPARSE_DIM)) if integer
            else rng.randn(SPARSE_ROWS, SPARSE_DIM))
    return (torch.from_numpy(vals.astype(np.float32)),
            torch.from_numpy(idx.astype(np.int32)))


def graph_ms(fn, device) -> float:
    """Mean device ms of ``fn()`` captured as a CUDA graph and replayed, its
    inputs cold in L2. Called eagerly, a merge's dozen small kernels wait
    on the host's launches; in the step's graph they do not."""
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream(device).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        fn()
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32,
                        device=device)
    return cuda_time_ms(graph.replay, flush)


def merge_ms(values, indices) -> float:
    """Device ms of one dedup_merge, as a replayed graph."""
    return graph_ms(lambda: sparse.dedup_merge(values, indices),
                    values.device)


def check_merge(device) -> dict:
    """(a): dedup_merge on the card against the CPU's."""
    out = {}
    for integer in (True, False):
        vals, idx = merge_inputs(integer)
        cpu_v, cpu_i = sparse.dedup_merge(vals, idx)
        dv, di = vals.to(device), idx.to(device)
        runs = [sparse.dedup_merge(dv, di) for _ in range(2)]
        if not all(torch.equal(a, b) for a, b in zip(*runs)):
            raise RuntimeError("dedup_merge: two runs on the card differ")
        got_v, got_i = (t.cpu() for t in runs[0])
        if not torch.equal(got_i, cpu_i):
            raise RuntimeError("dedup_merge: merged indices differ from "
                               "the CPU's")
        if integer:
            if not torch.equal(got_v, cpu_v):
                raise RuntimeError("dedup_merge: integer-valued rows not "
                                   "bit for bit the CPU's")
            out["unique"] = int(torch.unique(idx).numel())
            continue
        scale = sparse.dedup_merge(vals.abs(), idx)[0]
        err = (got_v - cpu_v).abs()
        worst = float((err / scale.clamp(min=1e-30)).max())
        if worst > SPARSE_TOL:
            raise RuntimeError(f"dedup_merge: random rows {worst:.3e} of "
                               f"the segment's sum|row| > {SPARSE_TOL}")
        out["random_rel"] = worst
        out["random_bits_equal"] = bool(torch.equal(got_v, cpu_v))
        out["ms"] = merge_ms(dv, di)
        out["index_add_ms"] = graph_ms(
            lambda: torch.zeros(SPARSE_TABLE, SPARSE_DIM,
                                device=device).index_add_(0, di.long(), dv),
            device)
    return out


def check_collectives(device) -> dict:
    """(b): alltoall, reducescatter and a one-group allreduce family in a
    program: one capture, replays, each equal to its eager result."""
    gen = torch.Generator().manual_seed(SEED)
    inputs = {str(dt).removeprefix("torch."): (
        torch.randn(16, 128, generator=gen) > 0 if dt == torch.bool
        else torch.randn(16, 128, generator=gen).to(dt)).to(device)
        for dt in (torch.bfloat16, torch.float32, torch.bool)}

    def step(xs):
        return {k: (hvd.alltoall(x, name=f"a2a_{k}"),
                    hvd.reducescatter(x, name=f"rs_{k}"),
                    hvd.allreduce(x, group=(0,), average=False,
                                  name=f"family_{k}"))
                for k, x in xs.items()}

    eager = {k: (hvd.alltoall(x, name=f"eager_a2a_{k}"),
                 hvd.reducescatter(x, name=f"eager_rs_{k}"),
                 hvd.allreduce(x, average=False, name=f"eager_ar_{k}"))
             for k, x in inputs.items()}
    prog = hvd.spmd(step)
    calls = [prog(inputs) for _ in range(3)]
    for call in calls:
        for k, outs in call.items():
            for name, got, want in zip(("alltoall", "reducescatter",
                                        "allreduce family"), outs, eager[k]):
                if got.dtype != want.dtype or not torch.equal(got, want):
                    raise RuntimeError(f"{name} ({k}) in a program differs "
                                       f"from its eager result")
    if (prog.runs, prog.replays, prog.trace_count) != (2, 2, 1):
        raise RuntimeError(f"collectives program: {prog.runs} runs, "
                           f"{prog.replays} replays, {prog.trace_count} "
                           f"recordings (want 2, 2, 1)")
    rows = next(iter(prog.programs.values())).schedule
    if [r[4] for r in rows if r[0].startswith("family_")] != [[0]] * 3:
        raise RuntimeError("the family's schedule rows do not carry it")
    return {"collectives": len(rows), "dtypes": list(inputs)}


def step_rate(fn, batches) -> float:
    """Steps/s of ``fn`` over SPARSE_RATE_STEPS calls, batches cycled."""
    fn(*batches[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(SPARSE_RATE_STEPS):
        fn(*batches[i % len(batches)])
    torch.cuda.synchronize()
    return SPARSE_RATE_STEPS / (time.perf_counter() - t0)


def check_word2vec(device) -> dict:
    """(c): the example at the reference's width, its first loss against
    the CPU's, and a captured program against its step run eagerly."""
    from horovod_tpu_torch.examples import word2vec as ex
    from horovod_tpu_torch.models import word2vec

    out = run_example("word2vec", W2V_ARGV + ["--steps", str(W2V_STEPS)],
                      calls=W2V_STEPS)
    model = out.pop("model")
    if not all(bool(torch.isfinite(t).all())
               for t in model.state_dict().values()):
        raise RuntimeError("word2vec: a table holds a non-finite value")
    first, last = (statistics.mean(out["losses"][s]) for s in
                   (slice(0, 10), slice(-10, None)))
    if not last < first:
        raise RuntimeError(f"word2vec: loss did not fall ({first:.4f} -> "
                           f"{last:.4f}, means of 10 steps)")
    out["mean_first_last"] = (first, last)
    del model

    args = ex.parse_args(W2V_ARGV + ["--device", "cuda"])
    model_a, step_a, batches_a = ex.setup(args)
    model_b, step_b, _ = ex.setup(args)
    batch = next(batches_a)
    cpu = word2vec.Word2Vec(model_a.config,
                            generator=torch.Generator().manual_seed(0))
    cpu_loss = float(word2vec.value_and_sparse_grad(
        cpu, *(t.cpu() for t in batch))[0])
    rel = abs(out["losses"][0] - cpu_loss) / abs(cpu_loss)
    if rel > W2V_LOSS_TOL:
        raise RuntimeError(f"word2vec: first loss {out['losses'][0]} on the "
                           f"card, {cpu_loss} on the CPU: rel err "
                           f"{rel:.3e} > {W2V_LOSS_TOL}")
    out["cpu"] = (cpu_loss, rel)
    prog = hvd.spmd(step_a)
    for i in range(W2V_AB_STEPS):
        if i:
            batch = next(batches_a)
        la, lb = prog(*batch), step_b(*batch)
        if not torch.equal(la, lb):
            raise RuntimeError(f"word2vec: captured loss {float(la)} != "
                               f"eager {float(lb)} at step {i}")
    diff = [k for k, t in model_a.state_dict().items()
            if not torch.equal(t, model_b.state_dict()[k])]
    if diff or (prog.runs, prog.replays) != (2, W2V_AB_STEPS - 1):
        raise RuntimeError(f"word2vec: captured vs eager tables {diff}, "
                           f"{prog.runs} runs, {prog.replays} replays")
    batches = [next(batches_a) for _ in range(8)]
    out["steps_per_s"] = step_rate(prog, batches)
    merges = {"embeddings": batch[0].numel(),
              "nce": batch[1].numel() + batch[2].numel()}
    out["merge_ms"] = sum(
        merge_ms(torch.randn(n, d, device=device),
                 torch.randint(0, args.vocab_size, (n,), dtype=torch.int32,
                               device=device))
        for n, d in ((merges["embeddings"], args.embedding_dim),
                     (merges["nce"], args.embedding_dim), (merges["nce"], 1)))
    out["merge_rows"] = merges
    return out


def check_embedding_bag(device) -> dict:
    """(d): the example with gather and with dense; the loss on a repeated
    batch through the same step."""
    from horovod_tpu_torch.models import embedding_bag

    runs = {algo: run_example("embedding_bag", [
        "--steps", str(BAG_STEPS), "--sparse-algo", algo], calls=BAG_STEPS)
        for algo in ("gather", "dense")}
    a, b = (runs[k].pop("model").state_dict() for k in ("gather", "dense"))
    worst = max(float(((a[k] - b[k]).abs()
                       / (b[k].abs() + BAG_TOL)).max()) for k in a)
    if worst > BAG_TOL:
        raise RuntimeError(f"embedding_bag: gather and dense tables differ "
                           f"by {worst:.3e} > {BAG_TOL}")
    del a, b
    cfg = embedding_bag.EmbeddingBagConfig()
    model = embedding_bag.EmbeddingBag(
        cfg, generator=torch.Generator().manual_seed(0)).to(device)

    def step(bags, labels):
        loss, grads = embedding_bag.value_and_sparse_grad(model, bags,
                                                          labels)
        keys = list(grads)
        synced = hvd.allreduce_gradients([grads[k] for k in keys],
                                         name="bag.repeated")
        embedding_bag.apply_sgd(model, dict(zip(keys, synced)), lr=0.5)
        return hvd.allreduce(loss, name="bag.repeated.loss")

    prog = hvd.spmd(step)
    batch = [torch.from_numpy(a).to(device) for a in
             embedding_bag.synthetic_batch(cfg, 64, seed=0)]
    losses = [float(prog(*batch)) for _ in range(BAG_STEPS)]
    _finite("embedding_bag (repeated batch)", losses)
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"embedding_bag: loss on a repeated batch did not "
                           f"fall: {losses[0]:.4f} -> {losses[-1]:.4f}")
    return {"runs": runs, "rel": worst, "repeated": (losses[0], losses[-1]),
            "steps_per_s": step_rate(prog, [batch]),
            "merge_ms": merge_ms(
                torch.randn(64 * cfg.bag_size, cfg.embedding_dim,
                            device=device),
                batch[0].reshape(-1).contiguous())}


def check_coo_refused(device) -> str:
    """(f): a captured Trainer refuses a COO gradient and names it."""
    emb = torch.nn.Embedding(1000, 16, sparse=True).to(device)
    trainer = hvd.Trainer(emb, lambda m, b: m(b).float().pow(2).mean(),
                          torch.optim.SGD(emb.parameters(), lr=0.1))
    try:
        trainer.train_step(torch.arange(64, device=device))
    except hvd.HorovodError as e:
        if "COO" not in str(e):
            raise
        return str(e).split(":")[0]
    raise RuntimeError("a captured Trainer stepped a COO gradient")


def phase_sparse(device) -> dict:
    """Phase 15: the sparse path on the card."""
    t0 = time.perf_counter()
    out = {"merge": check_merge(device),
           "collectives": check_collectives(device)}
    free_cuda()
    out["word2vec"] = check_word2vec(device)
    free_cuda()
    out["bag"] = check_embedding_bag(device)
    out["coo"] = check_coo_refused(device)
    free_cuda()
    out["seconds"] = time.perf_counter() - t0
    return out


def sparse_line(sp: dict, ident: str) -> str:
    """Phase 15's line of output."""
    m, w, b = sp["merge"], sp["word2vec"], sp["bag"]
    g, d = b["runs"]["gather"], b["runs"]["dense"]
    return (
        f"phase 15 sparse: ok on cuda:0; (a) dedup_merge of {SPARSE_ROWS} x "
        f"{SPARSE_DIM} fp32 rows, Zipf-hot indices into {SPARSE_TABLE} "
        f"rows ({m['unique']} unique): integer-valued rows = the CPU's bit "
        f"for bit, random rows {m['random_rel']:.2e} of each segment's "
        f"sum|row| (limit {SPARSE_TOL}; bit for bit: "
        f"{m['random_bits_equal']}), two runs on the card bit-identical; "
        f"{m['ms']:.4f} ms a merge, a replayed graph (index_add_ into a "
        f"zeroed table, not deterministic: {m['index_add_ms']:.4f} ms); (b) alltoall, reducescatter and a "
        f"one-group allreduce family in {sp['collectives']['dtypes']}: one "
        f"capture, 2 replays, each = its eager result; (c) word2vec V=50000 "
        f"D=128 K=64 batch 128 through the example: {W2V_STEPS} steps "
        f"({w['runs']} runs, {w['replays']} replays), loss "
        f"{w['losses'][0]:.4f} -> {w['losses'][-1]:.4f} (means of 10: "
        f"{w['mean_first_last'][0]:.4f} -> {w['mean_first_last'][1]:.4f}), "
        f"every table finite, first loss vs CPU {w['cpu'][0]:.6f}: rel err "
        f"{w['cpu'][1]:.2e} (limit {W2V_LOSS_TOL}), captured = eager bit "
        f"for bit over {W2V_AB_STEPS} steps on every table, "
        f"{w['steps_per_s']:.1f} steps/s over {SPARSE_RATE_STEPS} replays, "
        f"a step's merges ({w['merge_rows']['embeddings']} + 2 x "
        f"{w['merge_rows']['nce']} rows) {w['merge_ms']:.4f} ms, example "
        f"{w['seconds']:.1f} s; (d) embedding bag 60000 x 32 bag 8 batch "
        f"64, {BAG_STEPS} steps each: gather ({g['runs']} runs, "
        f"{g['replays']} replays) and dense tables agree within "
        f"{b['rel']:.2e} (limit {BAG_TOL}), losses finite, loss on a "
        f"repeated batch {b['repeated'][0]:.4f} -> {b['repeated'][1]:.4f}, "
        f"{b['steps_per_s']:.1f} steps/s over {SPARSE_RATE_STEPS} replays, "
        f"its merge (512 rows) {b['merge_ms']:.4f} ms, examples "
        f"{g['seconds']:.1f} s and {d['seconds']:.1f} s; (f) a captured "
        f"Trainer refuses a COO gradient (\"{sp['coo']}: ...\"); no kernel "
        f"of the port launched; phase {sp['seconds']:.1f} s, on {ident}")


# -- wire compression and decomposition (phase 16) ------------------------------

WIRE_FORMATS = ("bf16", "int8", "int8_block", "int4")
WIRE_KEY = 1017                # the explicit compression_key of (a), (b)
WIRE_WINDOWS = 7               # (b): timed windows of one step's buckets
WIRE_BATCH = 32                # (c): the ResNet-50 step's batch
WIRE_LR = 0.0125               # (c): SGD's LR at that batch (phase 14's)
WIRE_STEPS = 10                # (c): steps eager and captured
WIRE_AB_WINDOWS = 4            # (c): images/s windows a side, in turns
WIRE_AB_STEPS = 5
DECOMP_ELEMS = 1 << 20         # (d): the program's tensor
HIERARCHICAL_ONE_SLICE = (
    "allreduce algo='hierarchical' (tensor wire.hierarchical) needs a "
    "multi-slice topology; this group's 1 rank(s) live on one slice. Use "
    "'flat'/'rs_ag'/'auto', or HOROVOD_TOPOLOGY_SLICES=N to simulate "
    "slices in tests.")


def resnet_gradient_buckets(seed: int = SEED) -> list[torch.Tensor]:
    """ResNet-50's gradient as the fusion plan cuts it at the default
    threshold: seeded fp32 values (N(0, 0.01²)) on the CPU, one flat
    tensor per bucket."""
    shapes = [p.shape for p in resnet.ResNet50(
        num_classes=CLASSES,
        generator=torch.Generator().manual_seed(seed)).parameters()]
    plan = fusion.plan_buckets_py([torch.empty(s, device="meta")
                                   for s in shapes],
                                  hstate.fusion_threshold())
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(b.elems, generator=g) * 1e-2 for b in plan]


def _wire(comp, flat) -> dict:
    """One compress + decompress with the explicit key: wire, scales,
    dequantized values."""
    ctx = compression.WireContext(group_size=1, key=WIRE_KEY)
    wire, meta = comp.compress(flat, ctx)
    unit = meta[0] if isinstance(meta, tuple) else meta
    out = {"wire": wire, "dequantized": comp.decompress(
        wire, meta, torch.float32, ctx)}
    if unit is not None:
        out["scales"] = unit
    return out


def check_wire_formats(device, buckets) -> dict:
    """(a): each format on the card against the same call on the CPU, and
    two card runs against each other, bit for bit."""
    out = {}
    for name in WIRE_FORMATS:
        comp = compression.resolve(name)
        compared = 0
        for flat in buckets:
            cpu = _wire(comp, flat)
            card = _wire(comp, flat.to(device))
            again = _wire(comp, flat.to(device))
            for k, want in cpu.items():
                if not torch.equal(card[k], again[k]):
                    raise RuntimeError(f"{name}: two runs on the card give "
                                       f"different {k}")
                got = card[k].cpu()
                if got.dtype != want.dtype or not torch.equal(got, want):
                    gap = float((got.float() - want.float()).abs().max())
                    raise RuntimeError(
                        f"{name}: the card's {k} differs from the CPU's "
                        f"(largest gap {gap:.3e})")
                compared += want.numel()
        out[name] = compared
    return out


def time_wire_formats(device, buckets) -> dict:
    """(b): compress + decompress of one step's buckets on the card (CUDA
    events, WIRE_WINDOWS windows after a warm-up), against the byte bound:
    the fp32 buckets read and written once, the wire and scales written
    and read once, over the card's memory rate."""
    flats = [b.to(device) for b in buckets]
    n = sum(f.numel() for f in flats)
    rec = {}
    for name in WIRE_FORMATS:
        comp = compression.resolve(name)
        ctx = compression.WireContext(group_size=1, key=WIRE_KEY)

        def step():
            for f in flats:
                wire, meta = comp.compress(f, ctx)
                comp.decompress(wire, meta, torch.float32, ctx)

        step()
        torch.cuda.synchronize()
        times = []
        for _ in range(WIRE_WINDOWS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            step()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        wire_b = sum(compression.wire_bytes(f.numel(), f.dtype, comp, 1)
                     for f in flats)
        scale_b = sum(4 * (-(-f.numel() // comp.block)) if hasattr(
            comp, "block") else (4 if name == "int8" else 0) for f in flats)
        moved = 2 * 4 * n + 2 * (wire_b + scale_b)
        rec[name] = {"format": name, "elements": n,
                     "buckets": len(flats),
                     "ms_median": statistics.median(times),
                     "ms_min": min(times), "ms_max": max(times),
                     "windows": len(times), "bytes": moved,
                     "bound_ms": 1e3 * moved / HBM_BYTES_PER_S,
                     "bound_by": "bytes", "wire_bytes": wire_b,
                     "scale_bytes": scale_b, "fp32_bytes": 4 * n}
    del flats
    return rec


def _wire_trainer(device, comp: str, error_feedback: bool):
    """ResNet-50 (bf16, fused BN, weights from SEED) in a Trainer whose
    DistributedOptimizer(SGD(WIRE_LR, momentum 0.9)) compresses."""
    model = seeded_resnet50(torch.bfloat16, device)
    opt = hvd.DistributedOptimizer(
        training.sgd(WIRE_LR, momentum=0.9)(model.parameters()),
        compression=comp, error_feedback=error_feedback)
    return hvd.Trainer(model, resnet.make_loss_fn(model), opt, has_aux=True)


def _wire_state(trainer) -> dict:
    state = trainer_state(trainer)
    state.update({f"residual/{i}": r.detach().clone()
                  for i, r in trainer.optimizer.residual.items()})
    return state


def compressed_step(device) -> dict:
    """(c): the captured step with int8_block and error feedback against
    the same step run eagerly, and images/s beside the uncompressed
    captured step."""
    batch = resnet.synthetic_imagenet(WIRE_BATCH, IMAGE, seed=SEED,
                                      num_classes=CLASSES, device=device)
    eager = _wire_trainer(device, "int8_block", True)
    want = [eager.step_fn(batch)[0] for _ in range(WIRE_STEPS)]
    want_state = _wire_state(eager)
    del eager
    captured = _wire_trainer(device, "int8_block", True)
    got = [captured.train_step(batch)[0] for _ in range(WIRE_STEPS)]
    torch.cuda.synchronize()
    got_state = _wire_state(captured)
    losses = [float(x) for x in got]
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"compressed step: non-finite losses {losses}")
    if not statistics.mean(losses[-3:]) < losses[0]:
        raise RuntimeError(f"compressed step: the loss did not fall "
                           f"{losses}")
    bad = [i for i, (a, b) in enumerate(zip(got, want))
           if not torch.equal(_bits(a), _bits(b))]
    diff = state_diff(got_state, want_state)
    if bad or diff:
        raise RuntimeError(
            f"compressed step: the replay differs from the eager step: "
            f"steps {bad}, state {diff[:8]} ({len(diff)} of "
            f"{len(want_state)} tensors)")
    step = captured._step
    if (step.runs, step.replays) != (2, WIRE_STEPS - 1):
        raise RuntimeError(f"compressed step: {step.runs} runs, "
                           f"{step.replays} replays")
    residuals = [k for k in got_state if k.startswith("residual/")]
    if not any(bool(got_state[k].any()) for k in residuals):
        raise RuntimeError("compressed step: every residual is zero")
    plain = _wire_trainer(device, "none", False)
    for _ in range(3):
        plain.train_step(batch)
    rates = {"int8_block": [], "none": []}
    for w in range(WIRE_AB_WINDOWS):
        order = ("int8_block", "none") if w % 2 == 0 else ("none",
                                                           "int8_block")
        for side in order:
            trainer = captured if side == "int8_block" else plain
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(WIRE_AB_STEPS):
                trainer.train_step(batch)
            torch.cuda.synchronize()
            rates[side].append(WIRE_AB_STEPS * WIRE_BATCH
                               / (time.perf_counter() - t0))
    buckets = captured.optimizer._allreduce.buckets(
        [p.grad for p in captured.model.parameters()])
    del captured, plain
    free_cuda()
    return {"losses": losses, "tensors": len(want_state),
            "residuals": len(residuals), "rates": rates,
            "buckets": [b.describe() for b in buckets]}


def check_decompositions(device) -> dict:
    """(d): rs_ag and 4 channels equal flat bit for bit in a captured
    program, for every wire format (a world of 1: each is the identity,
    and the compressed ones quantize once, keyed by the data, so every
    call draws the same noise); hierarchical at one slice raises the
    reference's text; auto resolves to flat."""
    g = torch.Generator().manual_seed(SEED)
    x = (torch.randn(DECOMP_ELEMS, generator=g) * 1e-2).to(device)
    ways = (("flat", 1), ("rs_ag", 1), ("flat", 4), ("rs_ag", 4),
            ("auto", 1))

    def step(x):
        return {f"{fmt}/{algo}/{ch}": hvd.allreduce(
            x, average=False, name=f"wire.{fmt}.{algo}.{ch}",
            compression=fmt, algo=algo, channels=ch)
            for fmt in ("none",) + WIRE_FORMATS for algo, ch in ways}

    prog = hvd.spmd(step)
    calls = [prog(x) for _ in range(3)]
    if (prog.runs, prog.replays, prog.trace_count) != (2, 2, 1):
        raise RuntimeError(f"decomposition program: {prog.runs} runs, "
                           f"{prog.replays} replays, {prog.trace_count} "
                           f"recordings (want 2, 2, 1)")
    for call in calls:
        for fmt in ("none",) + WIRE_FORMATS:
            want = call[f"{fmt}/flat/1"]
            if fmt == "none" and not torch.equal(want, x):
                raise RuntimeError("flat at a world of 1 is not the "
                                   "identity")
            for algo, ch in ways[1:]:
                if not torch.equal(call[f"{fmt}/{algo}/{ch}"], want):
                    raise RuntimeError(f"{fmt}: algo={algo} channels={ch} "
                                       f"differs from flat")
    try:
        hvd.spmd(lambda x: hvd.allreduce(
            x, algo="hierarchical", name="wire.hierarchical"))(x)
        raise RuntimeError("algo='hierarchical' at one slice did not raise")
    except hvd.HorovodError as e:
        if str(e) != HIERARCHICAL_ONE_SLICE:
            raise RuntimeError(f"hierarchical at one slice: {e}") from None
        refusal = str(e)
    auto = strategy.select("auto", nbytes=4 * DECOMP_ELEMS,
                           group=hstate.get_group(0))[0]
    planned = {b.algo for b in FusedAllreduce(
        "wire.auto", algo="auto").buckets([x])}
    if auto != "flat" or planned != {"flat"}:
        raise RuntimeError(f"auto resolved to {auto}, {planned}")
    return {"outputs": len(calls[0]), "refusal": refusal, "auto": auto}


def phase_wire(device) -> dict:
    """Phase 16: wire compression and decomposition on the card."""
    t0 = time.perf_counter()
    buckets = resnet_gradient_buckets()
    out = {"formats": check_wire_formats(device, buckets),
           "timing": time_wire_formats(device, buckets)}
    free_cuda()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        out["step"] = compressed_step(device)
    finally:
        torch.cuda.synchronize()
        torch.backends.cudnn.deterministic = deterministic
    out["decompositions"] = check_decompositions(device)
    out["elements"] = sum(b.numel() for b in buckets)
    out["seconds"] = time.perf_counter() - t0
    return out


def wire_lines(wr: dict, ident: str) -> list[str]:
    """Phase 16's line, then one ``compression_ms`` JSON line a format."""
    st, dc = wr["step"], wr["decompositions"]
    ips = {k: statistics.median(v) for k, v in st["rates"].items()}
    line = (
        f"phase 16 wire compression and decomposition: ok on cuda:0; (a) "
        f"ResNet-50's gradient ({wr['elements']} fp32 elements in "
        f"{wr['timing']['bf16']['buckets']} buckets at the default fusion "
        f"threshold), key {WIRE_KEY}: "
        + ", ".join(f"{k} wire/scales/dequantized = the CPU's bit for bit "
                    f"({v} values)" for k, v in wr["formats"].items())
        + "; two runs on the card bit-identical; (b) compress + decompress "
        f"a step, median of {WIRE_WINDOWS} windows (min-max), against the "
        f"byte bound: " + "; ".join(
            f"{k} {r['ms_median']:.4f} ms ({r['ms_min']:.4f}-"
            f"{r['ms_max']:.4f}), bound {r['bound_ms']:.4f} ms, wire "
            f"{r['wire_bytes']} of {r['fp32_bytes']} bytes"
            for k, r in wr["timing"].items())
        + f"; (c) ResNet-50 bf16 batch {WIRE_BATCH}, "
        f"DistributedOptimizer(int8_block, error_feedback=True), "
        f"{WIRE_STEPS} steps on a repeated batch: loss "
        f"{st['losses'][0]:.4f} -> {st['losses'][-1]:.4f}, the captured "
        f"replays = the eager steps bit for bit (losses and "
        f"{st['tensors']} state tensors, {st['residuals']} residuals), "
        f"buckets {st['buckets']}; images/s, median of "
        f"{WIRE_AB_WINDOWS} windows of {WIRE_AB_STEPS} captured steps in "
        f"turns: int8_block {ips['int8_block']:.1f} "
        f"({', '.join(f'{v:.1f}' for v in st['rates']['int8_block'])}), "
        f"uncompressed {ips['none']:.1f} "
        f"({', '.join(f'{v:.1f}' for v in st['rates']['none'])}) — at one "
        f"rank the wire saves nothing, so this prices compression's "
        f"overhead alone; (d) rs_ag and 4 channels = flat bit for bit in "
        f"a captured program for none and {'/'.join(WIRE_FORMATS)} "
        f"({dc['outputs']} outputs), hierarchical at one slice raises "
        f"\"{dc['refusal'][:60]}...\", auto resolves to {dc['auto']}; "
        f"phase {wr['seconds']:.1f} s, on {ident}")
    return [line] + [f"compression_ms {json.dumps(r)}"
                     for r in wr["timing"].values()]


# -- the whole-step exchange planner (phase 17) -----------------------------------

PLAN_STEPS = 5                 # (a): captured steps a run
PLAN_WINDOWS = 5               # (c): timed windows a run, in turns
PLAN_WINDOW_STEPS = 5
PLAN_REPS = 20                 # (c): planning calls timed a side
PLAN_DIR = os.path.join(HERE, "_chip_smoke_plan")   # (b): gitignored
PLAN_CASES = (("none", False), ("int8_block", True))
# (b): the hash of the priority plan of ResNet-50's gradients at one rank
# (default threshold, ``flat``), a case of PLAN_CASES each: the JAX
# package's plan of the same leaves, pinned on the CPU by
# tests/test_torch_exchange.py::test_chip_smoke_pins_the_jax_plan_hash.
PLAN_HASHES = {"none": "a1ea81f7", "int8_block": "81950534"}


def _plan_trainer(device, schedule: str, comp: str, error_feedback: bool):
    """Phase 16's ResNet-50 trainer (bf16, fused BN, SGD(WIRE_LR, momentum
    0.9), weights from SEED) with the exchange planned under ``schedule``."""
    model = seeded_resnet50(torch.bfloat16, device)
    opt = hvd.DistributedOptimizer(
        training.sgd(WIRE_LR, momentum=0.9)(model.parameters()),
        compression=comp, error_feedback=error_feedback, schedule=schedule)
    return hvd.Trainer(model, resnet.make_loss_fn(model), opt, has_aux=True)


def _planned_steps(device, schedule, comp, error_feedback, batch) -> dict:
    """(a): PLAN_STEPS captured steps, B1 and B2 counted at every replay;
    the losses, the state and residuals after them, and the step's plan."""
    trainer = _plan_trainer(device, schedule, comp, error_feedback)
    bn.reset_launch_counts()
    losses = [trainer.train_step(batch)[0] for _ in range(PLAN_STEPS)]
    torch.cuda.synchronize()
    launches = dict(bn.LAUNCHES)
    plan = exchange.last_plan()
    if plan is None or plan.mode != schedule:
        raise RuntimeError(f"planner {schedule}/{comp}: the step's plan is "
                           f"{plan and plan.mode}")
    step = trainer._step
    if (step.runs, step.replays) != (2, PLAN_STEPS - 1):
        raise RuntimeError(f"planner {schedule}/{comp}: {step.runs} runs, "
                           f"{step.replays} replays")
    for k in ("channel_sums", "channel_grad_sums"):
        if launches[k] != BN_LAYERS * PLAN_STEPS:
            raise RuntimeError(
                f"planner {schedule}/{comp}: {k} launched {launches[k]} "
                f"times in {PLAN_STEPS} steps, expected {BN_LAYERS} a step")
    values = [float(v) for v in losses]
    if not all(math.isfinite(v) for v in values):
        raise RuntimeError(f"planner {schedule}/{comp}: losses {values}")
    return {"trainer": trainer, "losses": losses, "state": _wire_state(
        trainer), "plan": plan, "launches": launches}


def _check_plan_on_card(run: dict, comp: str) -> dict:
    """(b): the step's plan against the JAX package's hash (PLAN_HASHES),
    and a save -> from_json round trip through PLAN_DIR."""
    card = run["plan"]
    if card.plan_hash() != PLAN_HASHES[comp]:
        raise RuntimeError(f"planner {comp}: the step's plan "
                           f"{card.plan_hash()} is not the JAX package's "
                           f"{PLAN_HASHES[comp]}")
    os.makedirs(PLAN_DIR, exist_ok=True)
    try:
        path = card.save(os.path.join(PLAN_DIR, f"{comp}.exchange.json"))
        with open(path) as f:
            back = exchange.ExchangeSchedule.from_json(f.read())
    finally:
        shutil.rmtree(PLAN_DIR, ignore_errors=True)
    if back != card or back.plan_hash() != card.plan_hash():
        raise RuntimeError(f"planner {comp}: save -> from_json changed "
                           f"the plan")
    return {"hash": card.plan_hash(), "buckets": len(card.buckets),
            "regions": list(card.region_thresholds)}


def _step_ms(runs: dict, batch) -> dict:
    """(c): wall ms a step of each run, PLAN_WINDOWS windows of
    PLAN_WINDOW_STEPS captured steps, the runs in turns."""
    out = {k: [] for k in runs}
    order = list(runs)
    for w in range(PLAN_WINDOWS):
        for k in (order if w % 2 == 0 else order[::-1]):
            trainer = runs[k]["trainer"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(PLAN_WINDOW_STEPS):
                trainer.train_step(batch)
            torch.cuda.synchronize()
            out[k].append(1e3 * (time.perf_counter() - t0)
                          / PLAN_WINDOW_STEPS)
    return {k: {"ms_median": statistics.median(v), "ms_min": min(v),
                "ms_max": max(v), "windows": len(v)}
            for k, v in out.items()}


def planning_ms(leaves) -> dict:
    """(c): host ms of planning a new signature (``FusedAllreduce``'s
    ``_resolve``: the algorithm choice and ``plan_exchange``) of
    ``leaves``, a median of PLAN_REPS calls a mode."""
    g = hstate.get_group(0)
    out = {}
    for mode in exchange.MODES:
        fused = FusedAllreduce("plan", schedule=mode)
        times = []
        for _ in range(PLAN_REPS):
            t0 = time.perf_counter()
            fused._resolve(leaves, g, False)
            times.append(1e3 * (time.perf_counter() - t0))
        out[mode] = {"ms_median": statistics.median(times),
                     "ms_min": min(times), "ms_max": max(times)}
    return out


def phase_planner(device) -> dict:
    """Phase 17: the exchange planner on the card."""
    t0 = time.perf_counter()
    batch = resnet.synthetic_imagenet(WIRE_BATCH, IMAGE, seed=SEED,
                                      num_classes=CLASSES, device=device)
    out = {"cases": {}}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for comp, ef in PLAN_CASES:
            runs = {mode: _planned_steps(device, mode, comp, ef, batch)
                    for mode in ("enum", "priority")}
            enum, prio = runs["enum"], runs["priority"]
            bad = [i for i, (a, b) in enumerate(zip(prio["losses"],
                                                    enum["losses"]))
                   if not torch.equal(_bits(a), _bits(b))]
            diff = state_diff(prio["state"], enum["state"])
            if bad or diff:
                raise RuntimeError(
                    f"planner {comp}: priority differs from enum: steps "
                    f"{bad}, state {diff[:8]} ({len(diff)} of "
                    f"{len(enum['state'])} tensors)")
            residuals = [k for k in prio["state"] if k.startswith("residual/")]
            if ef and not any(bool(prio["state"][k].any())
                              for k in residuals):
                raise RuntimeError(f"planner {comp}: every residual is zero")
            out["cases"][comp] = {
                "losses": [float(v) for v in prio["losses"]],
                "tensors": len(enum["state"]), "residuals": len(residuals),
                "plan": _check_plan_on_card(prio, comp),
                "enum_buckets": len(enum["plan"].buckets),
                "times": _step_ms(runs, batch)}
            resnet_leaves = [torch.empty(p.shape, dtype=p.dtype,
                                         device="meta")
                             for p in prio["trainer"].model.parameters()]
            del runs, enum, prio
            free_cuda()
    finally:
        torch.cuda.synchronize()
        torch.backends.cudnn.deterministic = deterministic
    with torch.device("meta"):
        lm = transformer.Transformer(lm_config(torch.bfloat16),
                                     generator=torch.Generator())
    out["planning"] = {
        "resnet50": dict(planning_ms(resnet_leaves),
                         tensors=len(resnet_leaves)),
        "lm": dict(planning_ms([torch.empty(p.shape, dtype=p.dtype,
                                            device="meta")
                                for p in lm.parameters()]),
                   tensors=len(list(lm.parameters())))}
    out["seconds"] = time.perf_counter() - t0
    return out


def planner_line(pl: dict, ident: str) -> str:
    """Phase 17's line."""
    def spread(r):
        return (f"{r['ms_median']:.4f} ms ({r['ms_min']:.4f}-"
                f"{r['ms_max']:.4f})")

    cases = "; ".join(
        f"{comp}{' + error feedback' if comp != 'none' else ''}: "
        f"{PLAN_STEPS} captured steps under priority = enum bit for bit "
        f"(losses {c['losses'][0]:.4f} -> {c['losses'][-1]:.4f}, "
        f"{c['tensors']} state tensors, {c['residuals']} residuals), B1 "
        f"and B2 {BN_LAYERS} a step at every replay; priority plan "
        f"{c['plan']['hash']} ({c['plan']['buckets']} buckets, regions "
        f"{c['plan']['regions']}; enum {c['enum_buckets']}) = the JAX "
        f"package's plan of the same leaves, save -> from_json the same "
        f"plan; wall "
        f"ms a step, median of {PLAN_WINDOWS} windows of "
        f"{PLAN_WINDOW_STEPS} (min-max): enum "
        f"{spread(c['times']['enum'])}, priority "
        f"{spread(c['times']['priority'])}"
        for comp, c in pl["cases"].items())
    planning = "; ".join(
        f"{name} ({r['tensors']} tensors) enum {spread(r['enum'])}, "
        f"priority {spread(r['priority'])}"
        for name, r in pl["planning"].items())
    return (f"phase 17 exchange planner: ok on cuda:0; ResNet-50 bf16 "
            f"fused BN batch {WIRE_BATCH}, SGD({WIRE_LR}, momentum 0.9); "
            f"{cases}; at one rank every collective is the identity, so "
            f"priority has nothing to hide; host planning ms of a new "
            f"signature, median of {PLAN_REPS} (min-max): {planning}; phase "
            f"{pl['seconds']:.1f} s, on {ident}")


# -- ZeRO-1/2/3 on the data x fsdp mesh (phase 18) ---------------------------------

ZERO_STEPS = 10                # (a), (b): captured steps an arm
ZERO_DIR = os.path.join(HERE, "_chip_smoke_zero")   # (c): gitignored
ZERO_ARMS = ("off", "zero2", "zero3")
# (d): the hash of the zero3 step's plan of the LM's gradients at one rank
# (the fsdp section included): the JAX package's plan of the same leaves,
# pinned on the CPU by
# tests/test_torch_fsdp.py::test_chip_smoke_pins_the_jax_zero3_plan_hash.
ZERO3_PLAN_HASH = "3b549afc"


def _zero_params(trainer) -> list[torch.Tensor]:
    """A trainer's parameters as full tensors, cloned (zero3: its shards,
    cut back to the parameters' shapes)."""
    opt = trainer.optimizer
    if trainer.sharding != "zero3":
        return [p.detach().clone() for p in trainer.model.parameters()]
    return [s[:math.prod(shape)].view(shape).clone()
            for s, shape in zip(opt.shards, opt._shapes)]


def _timed_steps(step, batch, steps: int):
    """``steps`` calls of a captured step (``step(batch) -> loss``), each
    timed (host wall, ended by a device sync): the losses and the ms of
    each step."""
    losses, ms = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step(batch))
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    return losses, ms


def _same_run(a: dict, b: dict) -> list[str]:
    """Where two arms' losses and parameters differ, bit for bit (a
    non-finite loss counts as a difference)."""
    bad = [f"loss {i} {float(x)}" for i, x in enumerate(a["losses"])
           if not math.isfinite(float(x))]
    bad += [f"loss {i}" for i, (x, y) in enumerate(zip(a["losses"],
                                                      b["losses"]))
           if not torch.equal(_bits(x), _bits(y))]
    return bad + [f"param {i}" for i, (x, y) in enumerate(zip(a["params"],
                                                             b["params"]))
                  if x.shape != y.shape or not torch.equal(_bits(x),
                                                           _bits(y))]


def zero_lm_arm(device, sharding: str, tokens, keep: bool = False) -> dict:
    """(a): bench.py's LM under ``sharding``, AdamW(3e-4, weight_decay
    0.1), ZERO_STEPS captured steps on one batch; B3, B4 and A1 counted."""
    cfg = lm_config(torch.bfloat16)
    model = transformer.init_params(cfg, seed=SEED, device=device)
    trainer = hvd.Trainer(model, transformer.make_loss_fn(cfg,
                                                          fused_head=True),
                          AdamW(model.parameters(), 3e-4, weight_decay=0.1),
                          sharding=sharding)
    reset_launch_counts()
    losses, ms = _timed_steps(lambda b: trainer.train_step(b)[0], tokens,
                              ZERO_STEPS)
    launches = {k: v for k, v in launch_counts().items()
                if k in REPLAY_COUNTS["lm"]}
    check_captured(trainer, launches, REPLAY_COUNTS["lm"])
    out = {"losses": losses, "ms": ms, "launches": launches,
           "params": _zero_params(trainer), "plan": exchange.last_plan()}
    if keep:
        out["trainer"] = trainer
    return out


def zero_resnet_arm(device, sharded: bool, batch) -> dict:
    """(b): ResNet-50 (bf16, fused BN) with SGD(0.1, momentum 0.9), ZeRO-1
    or not, ZERO_STEPS captured steps; B1 and B2 counted."""
    model = seeded_resnet50(torch.bfloat16, device)
    trainer = hvd.Trainer(model, resnet.make_loss_fn(model),
                          torch.optim.SGD(model.parameters(), lr=0.1,
                                          momentum=0.9),
                          has_aux=True, sharded=sharded)
    reset_launch_counts()
    losses, ms = _timed_steps(lambda b: trainer.train_step(b)[0], batch,
                              ZERO_STEPS)
    launches = {k: v for k, v in launch_counts().items()
                if k in ("channel_sums", "channel_grad_sums")}
    check_captured(trainer, launches, {k: BN_LAYERS for k in launches})
    opt = trainer.optimizer
    params = list(model.parameters())
    if sharded:
        # The momenta of each (param group, dtype) bucket: at one rank the
        # shard is the bucket's whole flat vector.
        momenta = [opt.state[s]["momentum_buffer"][:total]
                   for s, (_, total, _) in zip(opt.shards, opt._buckets)]
        order = [i for idx, _, _ in opt._buckets for i in idx]
    else:
        momenta = [torch.cat([opt.state[params[i]]["momentum_buffer"]
                              .reshape(-1) for i in idx])
                   for idx in _resnet_buckets(params)]
        order = [i for idx in _resnet_buckets(params) for i in idx]
    state = {f"momentum/{b}": m.detach().clone()
             for b, m in enumerate(momenta)}
    state.update({f"model/{k}": v.detach().clone()
                  for k, v in model.state_dict().items()})
    return {"losses": losses, "ms": ms, "launches": launches,
            "params": [p.detach().clone() for p in params], "state": state,
            "order": order}


def _resnet_buckets(params) -> list[list[int]]:
    """ZeRO-1's buckets of one param group: the parameters by dtype, in
    order of first appearance."""
    by_dt: dict = {}
    for i, p in enumerate(params):
        by_dt.setdefault(p.dtype, []).append(i)
    return list(by_dt.values())


def zero_checkpoint(trainer) -> dict:
    """(c): the zero3 trainer's state through ``save_sharded`` (epoch 0,
    then epoch 1 torn by ``HOROVOD_FAULT_INJECT=torn_write@epoch=1``) and
    ``load_sharded(epoch=None)``, which must fall back to epoch 0 and
    return its state bit for bit."""
    shutil.rmtree(ZERO_DIR, ignore_errors=True)
    saved = _cpu_tree(trainer.train_state())
    before = os.environ.get("HOROVOD_FAULT_INJECT")
    try:
        t0 = time.perf_counter()
        path = checkpoint.save_sharded(ZERO_DIR, trainer.train_state(), 0)
        save_s = time.perf_counter() - t0
        os.environ["HOROVOD_FAULT_INJECT"] = "torn_write@epoch=1"
        resilience.reset_injector()
        checkpoint.save_sharded(ZERO_DIR, trainer.train_state(), 1)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            back = checkpoint.load_sharded(ZERO_DIR, saved)
            load_s = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
    finally:
        if before is None:
            os.environ.pop("HOROVOD_FAULT_INJECT", None)
        else:
            os.environ["HOROVOD_FAULT_INJECT"] = before
        resilience.reset_injector()
        shutil.rmtree(ZERO_DIR, ignore_errors=True)
    torn = [str(w.message) for w in caught
            if "epoch 1 " in str(w.message) and "torn write" in str(w.message)]
    if back.get("epoch") != 0 or not torn:
        raise RuntimeError(
            f"zero checkpoint: load_sharded(epoch=None) returned epoch "
            f"{back.get('epoch')} (expected 0), warnings "
            f"{[str(w.message) for w in caught]}")
    diff = _tree_diff(dict(saved, epoch=0), back)
    if diff:
        raise RuntimeError(f"zero checkpoint: the loaded state differs from "
                           f"the saved one: {diff[:8]} ({len(diff)})")
    return {"tensors": len(_leaves(saved)), "bytes": nbytes,
            "save_s": save_s, "load_s": load_s, "torn": torn[0]}


def phase_zero(device) -> dict:
    """Phase 18: ZeRO-1/2/3 on the card, one rank (F = 1, so every
    exchange is the identity): the shard layout, the inner update on the
    shards, the gather-on-use forward and the capture."""
    t0 = time.perf_counter()
    out = {}
    cfg = lm_config(torch.bfloat16)
    tokens = transformer.synthetic_tokens(LM_BATCH, LM_T, cfg.vocab_size,
                                          seed=SEED, device=device)
    lm = {}
    for arm in ZERO_ARMS:
        lm[arm] = zero_lm_arm(device, arm, tokens, keep=arm == "zero3")
        if arm == "zero3":
            trainer = lm[arm].pop("trainer")
            out["checkpoint"] = zero_checkpoint(trainer)
            del trainer
        free_cuda()
    for arm in ZERO_ARMS[1:]:
        diff = _same_run(lm["off"], lm[arm])
        if diff:
            raise RuntimeError(f"zero LM: {arm} differs from off: {diff[:8]} "
                               f"({len(diff)})")
    plan = lm["zero3"]["plan"]
    if plan is None or plan.fsdp is None or plan.fsdp.mode != "zero3":
        raise RuntimeError(f"zero LM: the zero3 step's plan has no zero3 "
                           f"fsdp section: {plan and plan.fsdp}")
    if plan.plan_hash() != ZERO3_PLAN_HASH:
        raise RuntimeError(f"zero LM: the zero3 plan {plan.plan_hash()} is "
                           f"not the JAX package's {ZERO3_PLAN_HASH}")
    out["plan"] = {"hash": plan.plan_hash(), "buckets": len(plan.buckets),
                   "gathers": len(plan.fsdp.gather_order)}
    out["lm"] = {arm: {"losses": [float(v) for v in r["losses"]],
                       "ms": r["ms"], "launches": r["launches"],
                       "tensors": len(r["params"])}
                 for arm, r in lm.items()}
    del lm
    free_cuda()
    batch = resnet.synthetic_imagenet(BATCH, IMAGE, seed=SEED,
                                      num_classes=CLASSES, device=device)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        rn = {arm: zero_resnet_arm(device, arm == "zero1", batch)
              for arm in ("off", "zero1")}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    diff = _same_run(rn["off"], rn["zero1"])
    diff += [k for k in rn["off"]["state"]
             if not torch.equal(_bits(rn["off"]["state"][k]),
                                _bits(rn["zero1"]["state"][k]))]
    if rn["off"]["order"] != rn["zero1"]["order"]:
        diff.append("bucket order")
    if diff:
        raise RuntimeError(f"zero ResNet-50: ZeRO-1 differs from off: "
                           f"{diff[:8]} ({len(diff)})")
    out["resnet50"] = {arm: {"losses": [float(v) for v in r["losses"]],
                             "ms": r["ms"], "launches": r["launches"],
                             "tensors": len(r["state"])}
                       for arm, r in rn.items()}
    del rn
    free_cuda()
    out["seconds"] = time.perf_counter() - t0
    return out


def zero_line(z: dict, ident: str) -> str:
    """Phase 18's line."""
    def ms(r):
        steady = r["ms"][2:]
        return (f"{statistics.median(steady):.2f} ms (min "
                f"{min(steady):.2f}, max {max(steady):.2f})")

    lm = "; ".join(f"{arm} {ms(r)}, launches {r['launches']}"
                   for arm, r in z["lm"].items())
    rn = "; ".join(f"{arm} {ms(r)}, launches {r['launches']}"
                   for arm, r in z["resnet50"].items())
    ck = z["checkpoint"]
    first = z["lm"]["off"]["losses"]
    rfirst = z["resnet50"]["off"]["losses"]
    return (f"phase 18 zero: ok on cuda:0, one rank (fsdp 1 x data 1); (a) "
            f"the LM ({LM_LAYERS} layers, B={LM_BATCH} T={LM_T} bf16 fused "
            f"head, AdamW(3e-4, wd 0.1)), {ZERO_STEPS} captured steps under "
            f"sharding off, zero2, zero3: losses ({first[0]:.4f} -> "
            f"{first[-1]:.4f}) and {z['lm']['off']['tensors']} final "
            f"parameters bit-identical across the arms; step ms, median of "
            f"steps 3-{ZERO_STEPS}: {lm}; (b) ResNet-50 (bf16 fused BN, "
            f"batch {BATCH}, SGD(0.1, momentum 0.9)) sharded=True against "
            f"sharded=False, {ZERO_STEPS} captured steps: losses "
            f"({rfirst[0]:.4f} -> {rfirst[-1]:.4f}), parameters, BN buffers "
            f"and momenta ({z['resnet50']['off']['tensors']} tensors) "
            f"bit-identical; {rn}; (c) the zero3 state ({ck['tensors']} "
            f"tensors, {ck['bytes']} bytes) through save_sharded -> "
            f"load_sharded(epoch=None) bit for bit, the torn epoch 1 "
            f"skipped (\"{ck['torn']}\"), save {ck['save_s']:.2f} s, load "
            f"{ck['load_s']:.2f} s; (d) the zero3 plan {z['plan']['hash']} "
            f"({z['plan']['buckets']} reduce rows, {z['plan']['gathers']} "
            f"gathers) = the JAX package's plan of the same leaves; phase "
            f"{z['seconds']:.1f} s, on {ident}")


# -- sequence parallelism (phase 19) -------------------------------------------

SP_RING = 4                    # (a): the virtual ranks of the replayed ring
SP_STEPS = STEPS               # (b): captured steps an arm
# (b): each arm's first loss against phase 8's, relative: the same
# function on the same weights and tokens, but the ring merges its
# partials (bf16 outputs) by their LSE and zigzag leaves out the one
# transition across its chunk boundary (1 of 8191 a row), each a
# difference of ~1e-3 at most.
SP_LOSS_TOL = 2e-2
# The reference's zigzag loss (models/transformer.py:412-413, kept by the
# port for parity) divides the masked sum over all B rows by one row's
# transition count: B times the mean. Its first loss is held as that.
SP_LOSS_SCALE = {"zigzag": LM_BATCH}
SP_ARMS = {"ring": dict(attention="ring"),
           "zigzag": dict(attention="ring", sp_layout="zigzag"),
           "ulysses": dict(attention="ulysses")}
# (b): launches a step. At world 1 the ring has one step a layer, run
# under torch.utils.checkpoint, so the backward runs B3 again before B4;
# zigzag attends its two chunks' four pairs a step (the pair wholly in
# the causal future included), each recomputed; Ulysses attends once,
# uncheckpointed, as the local path does.
SP_LAUNCHES = {
    "ring": {"flash_fwd": 2 * LM_LAYERS, "flash_bwd": LM_LAYERS,
             "adamw": 1},
    "zigzag": {"flash_fwd": 8 * LM_LAYERS, "flash_bwd": 4 * LM_LAYERS,
               "adamw": 1},
    "ulysses": {"flash_fwd": LM_LAYERS, "flash_bwd": LM_LAYERS, "adamw": 1},
}


def _ring_shards(x, layout):
    """The SP_RING shards of (B, T, ...) a ring of that many ranks holds."""
    if layout == "zigzag":
        return list(sequence.zigzag_shard(x, SP_RING).unbind(0))
    return list(x.chunk(SP_RING, dim=1))


def _ring_join(parts, layout):
    if layout == "zigzag":
        return sequence.zigzag_unshard(torch.stack(parts))
    return torch.cat(parts, dim=1)


def ring_replay(q, k, v, g_out, layout: str) -> tuple:
    """(O, LSE, dq, dk, dv) of a SP_RING-rank ring over (q, k, v) replayed on
    one card: for each virtual rank r, the port's ring step at each step s
    on the shard r holds then (src = (r - s) mod SP_RING), no hops; then
    backward of the concatenated outputs against ``g_out``. The LSE is
    each row's m + log(l) of the merged state."""
    q, k, v = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    t_local = q.shape[1] // SP_RING
    chunks = 2 if layout == "zigzag" else 1
    qs, ks, vs = (_ring_shards(t, layout) for t in (q, k, v))

    def offsets(r):
        return sequence.chunk_offsets(r, SP_RING, t_local, chunks)

    outs, lses = [], []
    for r in range(SP_RING):
        state = sequence.ring_state(qs[r], chunks, "flash")
        for s in range(SP_RING):
            src = (r - s) % SP_RING
            state = sequence.ring_step(qs[r], ks[src], vs[src], state,
                                       offsets(r), offsets(src),
                                       causal=True)
        outs.append(sequence.ring_output(state, "flash", q.dtype))
        lses.append(torch.cat([(m + torch.log(l)).detach()
                               for m, l, _ in state], dim=1))
    out = _ring_join(outs, layout)
    out.backward(g_out)
    lse = _ring_join(lses, layout).transpose(1, 2).contiguous()
    return (out.detach(), lse, q.grad, k.grad, v.grad)


@contextlib.contextmanager
def _through_plain():
    """Route B3/B4's dispatch to their plain versions for a ``with`` block
    (the autograd function calls ``fa.flash_fwd``/``fa.flash_bwd``)."""
    fwd, bwd = fa.flash_fwd, fa.flash_bwd
    fa.flash_fwd, fa.flash_bwd = fa.flash_fwd_plain, fa.flash_bwd_plain
    try:
        yield
    finally:
        fa.flash_fwd, fa.flash_bwd = fwd, bwd


def check_ring_replay(device) -> dict:
    """(a): the replayed ring, both layouts, against full-T B3/B4, full-T
    plain B3/B4 and the replay through the plain versions."""
    b, t, h, hkv, d = LM_ATTN_SHAPE
    q, k, v, g_out, _, _ = _flash_inputs(b, t, t, h, hkv, d, torch.bfloat16,
                                         device, SEED + 19)
    full = _flash_kernels(q, k, v, g_out, None, dict(causal=True))
    p_out, p_lse = fa.flash_fwd_plain(q, k, v, causal=True)
    plain = (p_out, p_lse, *fa.flash_bwd_plain(q, k, v, p_out, p_lse, g_out,
                                               causal=True))
    out = {}
    for layout in ("contiguous", "zigzag"):
        fa.reset_launch_counts()
        got = ring_replay(q, k, v, g_out, layout)
        launches = dict(fa.LAUNCHES)
        again = ring_replay(q, k, v, g_out, layout)
        torch.cuda.synchronize()
        differ = [n for n, a, c in zip(("O", "lse") + FLASH_OUTPUTS[1:],
                                       got, again) if not torch.equal(a, c)]
        if differ:
            raise RuntimeError(f"ring replay ({layout}) is not deterministic:"
                               f" a second run changed {differ}")
        with _through_plain():
            by_plain = ring_replay(q, k, v, g_out, layout)
        rec = {"launches": launches}
        for name, want in (("full", full), ("full_plain", plain),
                           ("replay_plain", by_plain)):
            errs = _flash_errors(got, want)
            fault = _flash_faults(errs)
            if fault:
                raise RuntimeError(
                    f"ring replay ({layout}) vs {name}: beyond the limits "
                    f"(row {FLASH_ROW_TOL}, lse {LSE_TOL}): {fault}")
            rec[name] = errs
        out[layout] = rec
        del got, again, by_plain
        free_cuda()
    return out


def sp_lm_arm(device, arm: str, tokens) -> dict:
    """(b): phase 8's LM under one SP arm at world 1, SP_STEPS captured
    ``Trainer`` steps on one batch; B3, B4 and A1 counted."""
    cfg = lm_config(torch.bfloat16)._replace(**SP_ARMS[arm])
    model = transformer.init_params(cfg, seed=SEED, device=device)
    trainer = hvd.Trainer(
        model, transformer.make_loss_fn(
            cfg, sp_rank=lambda: hvd.rank(cfg.sp_group),
            fused_head=arm != "zigzag"),
        AdamW(model.parameters(), 3e-4, weight_decay=0.1))
    torch.cuda.reset_peak_memory_stats(device)
    reset_launch_counts()
    losses, ms = _timed_steps(lambda b: trainer.train_step(b)[0], tokens,
                              SP_STEPS)
    launches = {k: v for k, v in launch_counts().items()
                if k in ("flash_fwd", "flash_bwd", "adamw")}
    losses = [float(x) for x in losses]
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"sp LM {arm}: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"sp LM {arm}: loss did not fall: {losses}")
    check_captured(trainer, launches, SP_LAUNCHES[arm])
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    del trainer, model
    free_cuda()
    return {"losses": losses, "ms": ms, "launches": launches,
            "peak_gib": peak}


def phase_sequence(device, local_first_loss: float | None = None) -> dict:
    """Phase 19: sequence parallelism at one rank (module docstring).
    ``local_first_loss``: phase 8's first loss (None: one eager step of
    the local arm here)."""
    t0 = time.perf_counter()
    out = {"replay": check_ring_replay(device)}
    cfg = lm_config(torch.bfloat16)
    tokens = transformer.synthetic_tokens(LM_BATCH, LM_T, cfg.vocab_size,
                                          seed=SEED, device=device)
    if local_first_loss is None:
        model = transformer.init_params(cfg, seed=SEED, device=device)
        trainer = hvd.Trainer(model, transformer.make_loss_fn(
            cfg, fused_head=True), AdamW(model.parameters(), 3e-4,
                                         weight_decay=0.1))
        local_first_loss = float(trainer.train_step(tokens)[0])
        del trainer, model
        free_cuda()
    out["local_first_loss"] = local_first_loss
    out["lm"] = {}
    for arm in SP_ARMS:
        r = sp_lm_arm(device, arm, tokens)
        want = SP_LOSS_SCALE.get(arm, 1) * local_first_loss
        rel = abs(r["losses"][0] - want) / abs(want)
        if not rel <= SP_LOSS_TOL:
            raise RuntimeError(
                f"sp LM {arm}: first loss {r['losses'][0]:.6f} vs "
                f"{want:.6f} (the local arm's {local_first_loss:.6f}), rel "
                f"err {rel:.3e} (limit {SP_LOSS_TOL})")
        r["first_rel"] = rel
        out["lm"][arm] = r
    from horovod_tpu_torch.examples import long_context_transformer

    reset_launch_counts()
    got = long_context_transformer.main([])
    if got is not None or any(launch_counts().values()):
        raise RuntimeError(f"long_context_transformer at world 1 ran: "
                           f"{got}, launches {launch_counts()}")
    out["seconds"] = time.perf_counter() - t0
    return out


def sequence_line(sq: dict, ident: str) -> str:
    """Phase 19's line."""
    def errs(e):
        return ", ".join(f"{n} {e[n]:.2e}" for n in FLASH_OUTPUTS) + \
            f", lse {e['lse']:.2e}"

    rp = "; ".join(
        f"{layout}: launches {r['launches']}, vs full-T B3/B4 {errs(r['full'])}"
        f"; vs full-T plain {errs(r['full_plain'])}; vs the replay through "
        f"the plain versions {errs(r['replay_plain'])}"
        for layout, r in sq["replay"].items())

    def ms(r):
        steady = r["ms"][2:]
        return (f"{statistics.median(steady):.2f} ms (min "
                f"{min(steady):.2f}, max {max(steady):.2f})")

    lm = "; ".join(
        f"{arm}: loss {r['losses'][0]:.4f} -> {r['losses'][-1]:.4f} (first "
        f"vs local{' x B' if arm in SP_LOSS_SCALE else ''} rel err "
        f"{r['first_rel']:.2e}), launches {r['launches']} "
        f"({SP_LAUNCHES[arm]} a step), step {ms(r)}, peak memory "
        f"{r['peak_gib']:.1f} GiB" for arm, r in sq["lm"].items())
    return (f"phase 19 sequence: ok; (a) a {SP_RING}-rank ring replayed on "
            f"one card at {LM_ATTN_SHAPE} causal bf16 (shards of "
            f"{LM_ATTN_SHAPE[1] // SP_RING}), each replay twice and "
            f"bit-identical, worst row err (limit {FLASH_ROW_TOL}) and lse "
            f"err (limit {LSE_TOL}): {rp}; (b) the LM ({LM_LAYERS} layers, "
            f"B={LM_BATCH} T={LM_T} bf16, AdamW(3e-4, wd 0.1)) at world 1, "
            f"{SP_STEPS} captured steps, local first loss "
            f"{sq['local_first_loss']:.4f} (limit {SP_LOSS_TOL}): {lm}; (c) "
            f"long_context_transformer at world 1 returned without a "
            f"launch; phase {sq['seconds']:.1f} s, on {ident}")


# -- tensor, expert and pipeline parallelism (phase 20) -------------------------

TP_DEGREES = (2, 4)            # (a): the virtual ranks of a replayed TP block
TP_E, TP_HEADS, TP_MLP = 1024, 8, 4096   # the LM's width (D = 128)
TP_VOCAB = 32_768
PAR_STEPS = STEPS              # (b), (c): captured steps
# (a): the worst row's relative L2 error of the replayed block's output and
# gradients against the dense block. The replay adds tp bf16 partials
# (each rounded once) where the dense block rounds one sum.
TP_ROW_TOL = 2e-2
# (c): the replayed MoE layer (bf16) against per-token dense routing in
# fp32, rows of the tokens kept; dropped rows must be 0 on both.
MOE_EXPERTS = 4                # the replayed EP group's virtual ranks
MOE_ROW_TOL = 3e-2
# (d): gpipe/1F1B microbatches of one LM block at full width (Hkv=4).
PIPE_M = 4
# (d): 1F1B against gpipe + autograd: the worst row's relative L2 error of
# each gradient, and the loss's relative error.
PIPE_ROW_TOL = 1e-2
PIPE_LOSS_TOL = 1e-3
PAR_LAUNCHES = {
    "tp_transformer": {"flash_fwd": 1, "flash_bwd": 1, "adamw": 1},
    "moe_transformer": {"flash_fwd": 1, "flash_bwd": 1, "adamw": 1},
}


def _seeded(shape, seed, device, scale=1.0, dtype=torch.bfloat16):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).to(device, dtype)


def tp_block(x, w, tp: int) -> torch.Tensor:
    """The TP transformer's block (``x + attention``, then ``+ MLP``) as tp
    virtual ranks compute it: each runs the port's per-rank arithmetic
    (``tensor.attention_shard``/``mlp_shard``) on its column and row
    shards of ``w``, and the partials are summed in rank order, as the
    family allreduce sums them. tp = 1 is the dense block."""
    h = TP_HEADS // tp

    def cols(name, r):
        c = w[name].shape[1] // tp
        return w[name][:, r * c:(r + 1) * c]

    def rows(name, r):
        c = w[name].shape[0] // tp
        return w[name][r * c:(r + 1) * c]

    parts = [tensor.attention_shard(x, cols("wq", r), cols("wk", r),
                                    cols("wv", r), rows("wo", r), h)
             for r in range(tp)]
    y = x + sum(parts)
    parts = [tensor.mlp_shard(y, cols("w1", r), None, rows("w2", r))
             for r in range(tp)]
    return y + sum(parts)


TP_OUTPUTS = ("out", "dx", "dwq", "dwk", "dwv", "dwo", "dw1", "dw2")


def tp_replay(x, w, g, tp: int) -> tuple:
    """(output, dx, dW…) of :func:`tp_block` at ``tp`` from the seeded
    cotangent ``g``."""
    x = x.detach().clone().requires_grad_(True)
    ws = {k: v.detach().clone().requires_grad_(True) for k, v in w.items()}
    out = tp_block(x, ws, tp)
    out.backward(g)
    return (out.detach(), x.grad) + tuple(ws[k].grad for k in
                                          ("wq", "wk", "wv", "wo", "w1",
                                           "w2"))


def tp_inputs(device):
    b, t = LM_BATCH, LM_T
    e, m = TP_E, TP_MLP
    w = {k: _seeded(s, SEED + 20 + i, device, 1 / math.sqrt(s[0]))
         for i, (k, s) in enumerate((("wq", (e, e)), ("wk", (e, e)),
                                     ("wv", (e, e)), ("wo", (e, e)),
                                     ("w1", (e, m)), ("w2", (m, e))))}
    return (_seeded((b, t, e), SEED + 30, device), w,
            _seeded((b, t, e), SEED + 31, device))


def check_tp_replay(device) -> dict:
    """(a): the TP block replayed at each tp of TP_DEGREES against the dense
    block through B3/B4 and through their plain versions."""
    x, w, g = tp_inputs(device)
    dense = tp_replay(x, w, g, 1)
    with _through_plain():
        plain = tp_replay(x, w, g, 1)
    out = {}
    for tp in TP_DEGREES:
        fa.reset_launch_counts()
        got = tp_replay(x, w, g, tp)
        launches = {k: fa.LAUNCHES[k] for k in ("flash_fwd", "flash_bwd")}
        again = tp_replay(x, w, g, tp)
        torch.cuda.synchronize()
        differ = [n for n, a, c in zip(TP_OUTPUTS, got, again)
                  if not torch.equal(a, c)]
        if differ:
            raise RuntimeError(f"TP replay (tp={tp}) is not deterministic: "
                               f"a second run changed {differ}")
        if launches != {"flash_fwd": tp, "flash_bwd": tp}:
            raise RuntimeError(f"TP replay (tp={tp}): launches {launches}, "
                               f"want B3 and B4 {tp} each")
        rec = {"launches": launches}
        for name, want in (("dense", dense), ("dense_plain", plain)):
            errs = {n: _row_err(a, b) for n, a, b in zip(TP_OUTPUTS, got,
                                                         want)}
            bad = {n: e for n, e in errs.items() if not e <= TP_ROW_TOL}
            if bad:
                raise RuntimeError(f"TP replay (tp={tp}) vs {name}: beyond "
                                   f"{TP_ROW_TOL}: {bad}")
            rec[name] = errs
        out[tp] = rec
        del got, again
        free_cuda()
    out["dense_vs_plain"] = {n: _row_err(a, b) for n, a, b in
                             zip(TP_OUTPUTS, dense, plain)}
    return out


def _check_training(name, step, losses, launches) -> None:
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"{name}: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"{name}: loss did not fall: {losses}")
    want = {k: v * PAR_STEPS for k, v in PAR_LAUNCHES[name].items()}
    if launches != want or (step.runs, step.replays) != (2, PAR_STEPS - 1):
        raise RuntimeError(
            f"{name}: launches {launches} (want {want}), runs {step.runs}, "
            f"replays {step.replays} (want 2, {PAR_STEPS - 1})")


def tp_transformer_world1(device, tokens) -> dict:
    """(b): the ported example's loss and step at world 1 (TP family (1,),
    DP family (2,)), PAR_STEPS captured steps; its first loss against the
    same block written without the TP functions."""
    hvd.shutdown()
    hvd.init([[0], [0], [0]])
    full = tp_example.init_params(TP_VOCAB, TP_E, TP_MLP, seed=SEED,
                                  device=device, dtype=torch.bfloat16)
    with torch.no_grad():
        x = full["embed"][tokens]
        b, t, _ = x.shape

        def heads(wn):
            return (x @ full[wn]).reshape(b, t, TP_HEADS, -1)

        attn = sequence.local_attention(heads("wq"), heads("wk"),
                                        heads("wv"), causal=True)
        x = x + attn.reshape(b, t, -1) @ full["wo"]
        x = x + F.gelu(x @ full["w1"], approximate="tanh") @ full["w2"]
        logits = x @ full["out"]
        dense = F.cross_entropy(logits[:, :-1].float().reshape(
            -1, TP_VOCAB), tokens[:, 1:].reshape(-1))
        del x, attn, logits
    rep, shd = tp_example.split(full, (1,))
    opt = training.adam(3e-4)(list(rep.values()) + list(shd.values()))
    step = hvd.spmd(tp_example.train_step(rep, shd, opt, TP_HEADS,
                                          tp_family=(1,), dp_family=(2,)))
    reset_launch_counts()
    losses, ms = _timed_steps(step, tokens, PAR_STEPS)
    losses = [float(v) for v in losses]
    launches = {k: v for k, v in launch_counts().items()
                if k in ("flash_fwd", "flash_bwd", "adamw")}
    _check_training("tp_transformer", step, losses, launches)
    first_err = abs(losses[0] - float(dense))
    del rep, shd, opt, step, full
    free_cuda()
    return {"losses": losses, "ms": ms, "launches": launches,
            "dense_first": float(dense), "first_equal": first_err == 0.0,
            "first_err": first_err}


def moe_dense_reference(xs, gate, experts, k: int, cap: int):
    """Per-token dense routing in fp32 for the replayed EP group: each
    source's router probabilities from the same bf16 logits as the layer,
    its top-k by a stable descending sort (a tie to the lower expert, the
    layer's rule: bf16 logits tie often), capacity positions in source
    order (first choices before second choices), and every kept choice's
    expert MLP run on the token in fp32. Returns the outputs and the number
    of dropped choices."""
    outs, dropped = [], 0
    for xf in xs:
        probs = torch.softmax((xf @ gate).float(), dim=-1)
        top_p, top_e = (t[:, :k] for t in probs.sort(
            dim=-1, descending=True, stable=True))
        if k == 2:
            top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
        out = torch.zeros(xf.shape, device=xf.device)
        used = torch.zeros(len(experts), dtype=torch.long,
                           device=xf.device)
        for c in range(k):
            for e, (w1, b1, w2, b2) in enumerate(experts):
                idx = (top_e[:, c] == e).nonzero().flatten()   # source order
                room = int(cap - used[e])
                keep = idx[:max(room, 0)]
                used[e] += len(idx)
                dropped += len(idx) - len(keep)
                h = F.gelu(xf[keep].float() @ w1.float() + b1.float(),
                           approximate="tanh")
                y = h @ w2.float() + b2.float()
                out[keep] += top_p[keep, c][:, None] * y
        outs.append(out)
    return outs, dropped


def moe_replay(xs, gate, experts, k: int, cap: int):
    """The MoE layer over MOE_EXPERTS virtual ranks on one card, through
    the port's per-rank steps (``expert.route``, ``dispatch``,
    ``expert_mlp``, ``combine``) with the two all-to-alls done as the
    transposes they are."""
    routed = [expert.route(xf, gate, cap, k) for xf in xs]
    sends = [expert.dispatch(xf, r[2]).to(xf.dtype)
             for xf, r in zip(xs, routed)]
    n = len(experts)
    recvs = [torch.stack([sends[src][e] for src in range(n)])
             for e in range(n)]
    bufs = [expert.expert_mlp(recv, *experts[e])
            for e, recv in enumerate(recvs)]
    backs = [torch.stack([bufs[e][src] for e in range(n)])
             for src in range(n)]
    return [expert.combine(back, r[1], r[2])
            for back, r in zip(backs, routed)]


def check_moe(device) -> dict:
    """(c)'s layer checks: ``moe_mlp`` at world 1 (one expert, k=1), and a
    MOE_EXPERTS-rank EP group replayed for k=1 and k=2, each against
    per-token dense routing in fp32."""
    e, f = TP_E, TP_MLP
    tokens = LM_BATCH * LM_T
    out = {}

    def rows(got, want):
        kept = want.abs().sum(-1) > 0
        if not torch.equal(got.float().abs().sum(-1) > 0, kept):
            raise RuntimeError("MoE: the dropped tokens differ from the "
                               "dense routing's")
        return _row_err(got[kept], want[kept])

    def expert_weights(i):
        return (_seeded((e, f), SEED + 40 + 4 * i, device, 1 / math.sqrt(e)),
                _seeded((f,), SEED + 41 + 4 * i, device, 0.1),
                _seeded((f, e), SEED + 42 + 4 * i, device, 1 / math.sqrt(f)),
                _seeded((e,), SEED + 43 + 4 * i, device, 0.1))

    x = _seeded((LM_BATCH, LM_T, e), SEED + 50, device)
    one = expert_weights(0)
    gate1 = _seeded((e, 1), SEED + 51, device, 1 / math.sqrt(e))
    got = hvd.spmd(lambda x: hvd.moe_mlp(x, gate1, *one)[0])(x)
    cap1 = expert.moe_capacity(tokens, 1)
    want, dropped = moe_dense_reference([x.reshape(tokens, e)], gate1,
                                        [one], 1, cap1)
    err = rows(got.reshape(tokens, e), want[0])
    if not err <= MOE_ROW_TOL:
        raise RuntimeError(f"moe_mlp (world 1) vs dense: {err:.3e} (limit "
                           f"{MOE_ROW_TOL})")
    out["world1"] = {"err": err, "dropped": dropped, "cap": cap1}
    experts = [expert_weights(i) for i in range(MOE_EXPERTS)]
    gate = _seeded((e, MOE_EXPERTS), SEED + 52, device, 1 / math.sqrt(e))
    xs = list(x.reshape(MOE_EXPERTS, tokens // MOE_EXPERTS, e).unbind(0))
    cap = expert.moe_capacity(tokens // MOE_EXPERTS, MOE_EXPERTS)
    for k in (1, 2):
        got = moe_replay(xs, gate, experts, k, cap)
        want, dropped = moe_dense_reference(xs, gate, experts, k, cap)
        err = max(rows(a, b) for a, b in zip(got, want))
        if not err <= MOE_ROW_TOL:
            raise RuntimeError(f"MoE replay k={k} vs dense: {err:.3e} "
                               f"(limit {MOE_ROW_TOL})")
        out[f"k{k}"] = {"err": err, "dropped": dropped, "cap": cap,
                        "choices": k * tokens}
    free_cuda()
    return out


def moe_transformer_world1(device, tokens) -> dict:
    """(c): the ported example at world 1 (one expert), PAR_STEPS captured
    steps."""
    hvd.shutdown()
    hvd.init()
    rep, exp = moe_example.init_params(TP_VOCAB, TP_E, TP_MLP, 1, 0,
                                       seed=SEED, device=device,
                                       dtype=torch.bfloat16)
    params = list(rep.values()) + list(exp.values())
    for p in params:
        p.requires_grad_(True)
    opt = training.adam(3e-4)(params)
    step = hvd.spmd(moe_example.train_step(rep, exp, opt, TP_HEADS))
    reset_launch_counts()
    losses, ms = _timed_steps(step, tokens, PAR_STEPS)
    losses = [float(v) for v in losses]
    launches = {k: v for k, v in launch_counts().items()
                if k in ("flash_fwd", "flash_bwd", "adamw")}
    _check_training("moe_transformer", step, losses, launches)
    del rep, exp, params, opt, step
    free_cuda()
    return {"losses": losses, "ms": ms, "launches": launches}


def check_pipeline(device) -> dict:
    """(d): gpipe and pipeline_1f1b at world 1 (one stage) over PIPE_M
    microbatches of one LM block (B=1, T=8192): gpipe's outputs and
    gradients against the block run microbatch by microbatch (the
    gradients summed last microbatch first, as gpipe's backward does), bit
    for bit; 1F1B's loss and gradients against gpipe plus autograd."""
    cfg = lm_config(torch.bfloat16, num_layers=1)
    gen = torch.Generator().manual_seed(SEED + 60)
    block = transformer.Block(cfg, gen).to(device)
    params = {k: v.detach() for k, v in block.named_parameters()}
    names = list(params)
    positions = torch.arange(LM_T, device=device)
    mbs = _seeded((PIPE_M, 1, LM_T, cfg.embed_dim), SEED + 61, device)
    g = _seeded((PIPE_M, 1, LM_T, cfg.embed_dim), SEED + 62, device)

    def stage(p, x):
        return torch.func.functional_call(block, p, (x, positions))

    def run_gpipe(params, mbs):
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        y = hvd.gpipe(stage, p, mbs)
        return (y.detach(),) + torch.autograd.grad(y, list(p.values()), g)

    fa.reset_launch_counts()
    got = hvd.spmd(run_gpipe)(params, mbs)
    torch.cuda.synchronize()
    gpipe_launches = {k: fa.LAUNCHES[k] for k in ("flash_fwd", "flash_bwd")}
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    outs, acc = [None] * PIPE_M, None
    for j in reversed(range(PIPE_M)):
        y = stage(p, mbs[j])
        outs[j] = y.detach()
        d = torch.autograd.grad(y, list(p.values()), g[j])
        acc = d if acc is None else tuple(a + b for a, b in zip(acc, d))
    seq = (torch.stack(outs),) + acc
    differ = [n for n, a, b in zip(["out"] + names, got, seq)
              if not torch.equal(a, b)]
    out = {"gpipe_launches": gpipe_launches, "gpipe_differ": differ}
    if differ:
        raise RuntimeError(f"gpipe at one stage differs from the block run "
                           f"in turn at {differ}")

    def loss_fn(y):
        return y.float().pow(2).mean()

    def run_1f1b(params, mbs):
        return hvd.pipeline_1f1b(stage, params, mbs, loss_fn)

    def run_gpipe_loss(params, mbs):
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        y = hvd.gpipe(stage, p, mbs)
        loss = sum(loss_fn(y[j]) for j in range(PIPE_M)) / PIPE_M
        return (loss.detach(),) + torch.autograd.grad(loss,
                                                      list(p.values()))

    fa.reset_launch_counts()
    loss, grads = hvd.spmd(run_1f1b)(params, mbs)
    torch.cuda.synchronize()
    out["1f1b_launches"] = {k: fa.LAUNCHES[k]
                            for k in ("flash_fwd", "flash_bwd")}
    want = hvd.spmd(run_gpipe_loss)(params, mbs)
    out["loss_rel"] = abs(float(loss) - float(want[0])) / abs(float(want[0]))
    out["grad_err"] = max(_row_err(grads[k], w)
                          for k, w in zip(names, want[1:]))
    if not (out["loss_rel"] <= PIPE_LOSS_TOL
            and out["grad_err"] <= PIPE_ROW_TOL):
        raise RuntimeError(f"1F1B vs gpipe + autograd: loss rel "
                           f"{out['loss_rel']:.3e} (limit {PIPE_LOSS_TOL}), "
                           f"worst gradient row {out['grad_err']:.3e} "
                           f"(limit {PIPE_ROW_TOL})")
    if (gpipe_launches != {"flash_fwd": 2 * PIPE_M, "flash_bwd": PIPE_M}
            or out["1f1b_launches"] != {"flash_fwd": 2 * PIPE_M,
                                        "flash_bwd": PIPE_M}):
        raise RuntimeError(f"pipeline launches: gpipe {gpipe_launches}, "
                           f"1F1B {out['1f1b_launches']}")
    out["loss"] = float(loss)
    del block, got, seq, grads, want
    free_cuda()
    return out


def phase_parallel(device) -> dict:
    """Phase 20: tensor, expert and pipeline parallelism at one rank
    (module docstring)."""
    t0 = time.perf_counter()
    out = {"tp_replay": check_tp_replay(device)}
    tokens = transformer.synthetic_tokens(LM_BATCH, LM_T, TP_VOCAB,
                                          seed=SEED, device=device)
    out["tp_transformer"] = tp_transformer_world1(device, tokens)
    out["moe"] = check_moe(device)
    out["moe_transformer"] = moe_transformer_world1(device, tokens)
    out["pipeline"] = check_pipeline(device)
    reset_launch_counts()
    got = tp_example.main([])
    if got is not None or any(launch_counts().values()):
        raise RuntimeError(f"tp_transformer at world 1 ran: {got}, "
                           f"launches {launch_counts()}")
    hvd.shutdown()
    out["zoo"] = zoo_example.main([])
    if out["zoo"]["TP"] != "skipped" or "skipped" in [
            v for k, v in out["zoo"].items() if k != "TP"]:
        raise RuntimeError(f"parallelism_zoo at world 1: {out['zoo']}")
    hvd.init()
    out["seconds"] = time.perf_counter() - t0
    return out


def parallel_line(pr: dict, ident: str) -> str:
    """Phase 20's line."""
    def errs(e):
        return ", ".join(f"{n} {e[n]:.2e}" for n in TP_OUTPUTS)

    def ms(r):
        steady = r["ms"][2:]
        return (f"{statistics.median(steady):.2f} ms (min "
                f"{min(steady):.2f}, max {max(steady):.2f})")

    rp = pr["tp_replay"]
    tp_rec = "; ".join(
        f"tp={tp}: launches {rp[tp]['launches']}, vs dense B3/B4 "
        f"{errs(rp[tp]['dense'])}; vs dense plain "
        f"{errs(rp[tp]['dense_plain'])}" for tp in TP_DEGREES)
    tt, mt, moe, pp = (pr["tp_transformer"], pr["moe_transformer"],
                       pr["moe"], pr["pipeline"])
    first = ("equal bit for bit" if tt["first_equal"] else
             f"differs by {tt['first_err']:.3e}")
    zoo = ", ".join(f"{k}: {v}" for k, v in pr["zoo"].items())
    return (f"phase 20 parallel: ok; (a) the TP block (E={TP_E} H="
            f"{TP_HEADS} D={TP_E // TP_HEADS} mlp {TP_MLP}, B={LM_BATCH} "
            f"T={LM_T} causal bf16) replayed rank by rank, each replay "
            f"twice and bit-identical, worst row err (limit {TP_ROW_TOL}): "
            f"{tp_rec}; dense B3/B4 vs dense plain "
            f"{errs(rp['dense_vs_plain'])}; (b) tp_transformer's step at "
            f"world 1 (TP (1,), DP (2,), V={TP_VOCAB}), {PAR_STEPS} captured"
            f" steps: loss {tt['losses'][0]:.4f} -> {tt['losses'][-1]:.4f}, "
            f"first loss vs the block without the TP functions "
            f"({tt['dense_first']:.6f}) {first}, launches {tt['launches']}, "
            f"step {ms(tt)}; (c) moe_mlp at world 1 (k=1, cap "
            f"{moe['world1']['cap']}) vs dense fp32 routing "
            f"{moe['world1']['err']:.2e}, {moe['world1']['dropped']} "
            f"dropped; a {MOE_EXPERTS}-expert group replayed (cap "
            f"{moe['k1']['cap']}): k=1 {moe['k1']['err']:.2e} with "
            f"{moe['k1']['dropped']} of {moe['k1']['choices']} choices "
            f"dropped, k=2 {moe['k2']['err']:.2e} with "
            f"{moe['k2']['dropped']} of {moe['k2']['choices']} dropped "
            f"(limit {MOE_ROW_TOL}); moe_transformer at world 1, "
            f"{PAR_STEPS} captured steps: loss {mt['losses'][0]:.4f} -> "
            f"{mt['losses'][-1]:.4f}, launches {mt['launches']}, step "
            f"{ms(mt)}; (d) one LM block (Hkv=4), {PIPE_M} microbatches of "
            f"T={LM_T}: gpipe = the block in turn bit for bit (launches "
            f"{pp['gpipe_launches']}), 1F1B (launches "
            f"{pp['1f1b_launches']}) vs gpipe + autograd loss rel "
            f"{pp['loss_rel']:.2e} (limit {PIPE_LOSS_TOL}), worst gradient "
            f"row {pp['grad_err']:.2e} (limit {PIPE_ROW_TOL}); (e) "
            f"tp_transformer at world 1 returned without a launch; "
            f"parallelism_zoo: {zoo}; phase {pr['seconds']:.1f} s, on "
            f"{ident}")


# -- profile-guided tuning and the device timeline (phase 21) --------------------

TUNE_DIR = os.path.join(HERE, "_chip_smoke_tune")    # gitignored
TUNE_STEPS = 3            # (c): an LM run's captured steps (eager, capture,
                          # replay)
TIMELINE_CALLS = 5        # (d): calls of each step in the device mode
TIMELINE_INTERVAL = 2     # (d): HOROVOD_TIMELINE_DEVICE_INTERVAL
TIMED_TRIALS = 3          # (e): timed_steps' trials
# (c): the committed pair's knobs (every one off its default).
TUNED_KNOBS = {"HOROVOD_COMPRESSION": "bf16",
               "HOROVOD_EXCHANGE_SCHEDULE": "priority",
               "HOROVOD_FUSION_THRESHOLD": 16 << 20}
# (b): the candidate measure_lm_ab holds against the defaults.
AB_KNOBS = {"HOROVOD_EXCHANGE_SCHEDULE": "priority",
            "HOROVOD_COMPRESSION": "bf16"}
TIMELINE_KERNELS = {"lm": ("flash_fwd", "flash_bwd", "adamw", "ce_chunk_fwd",
                           "ce_chunk_bwd"),
                    "resnet50": ("channel_sums", "channel_grad_sums")}


@contextlib.contextmanager
def env_knobs(**knobs):
    """``os.environ`` with ``knobs`` set (None unsets one), restored after."""
    before = {k: os.environ.get(k) for k in knobs}
    try:
        for k, v in knobs.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = str(v)
        yield
    finally:
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def world_with(**knobs):
    """The world re-initialised under ``knobs`` for the block (the
    timeline and the tuned config are read at ``hvd.init``, the exchange
    knobs at a step), shut down before they are restored, and the default
    world after it."""
    hvd.shutdown()
    try:
        with env_knobs(**knobs):
            hvd.init()
            yield
            hvd.shutdown()
    finally:
        hvd.shutdown()
        hvd.init()


def lm_trainer(device):
    """Phase 8's LM trainer (8 layers, bf16, fused head,
    ``DistributedOptimizer(AdamW(3e-4, weight_decay=0.1))``), weights from
    SEED."""
    cfg = lm_config(torch.bfloat16)
    model = transformer.init_params(cfg, seed=SEED, device=device)
    opt = hvd.DistributedOptimizer(AdamW(model.parameters(), 3e-4,
                                         weight_decay=0.1))
    return hvd.Trainer(model, transformer.make_loss_fn(cfg,
                                                       fused_head=True), opt)


def resnet_trainer(device):
    """Phase 5's ResNet-50 trainer (bf16, fused BN: B1/B2, SGD(0.1,
    momentum 0.9))."""
    model = seeded_resnet50(torch.bfloat16, device)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9))
    return hvd.Trainer(model, resnet.make_loss_fn(model), opt, has_aux=True)


def timed_calls(trainer, batch, calls: int) -> tuple[list, list]:
    """``calls`` calls of the trainer's step: the losses (on the host) and
    each call's wall ms, each ended by a device sync."""
    losses, ms = [], []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = trainer.train_step(batch)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(loss.detach().cpu())
    return losses, ms


def same_bits(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        torch.equal(_bits(x), _bits(y)) for x, y in zip(a, b))


def tune_live(device) -> dict:
    """(a): ``hvd.tune()`` at world 1 with the live timer; the pair it
    commits verified, and the provenance report."""
    from horovod_tpu_torch.analysis import schedule as verify
    from horovod_tpu_torch.tune import apply as tune_apply
    from horovod_tpu_torch.utils import env as knobs_env

    # The pass hvd.tune() prices with, kept on its way (the package
    # re-exports a function named ``tune``: the module by its name).
    tune_pkg = importlib.import_module("horovod_tpu_torch.tune")
    calibrate, passes = tune_pkg.calibrate, []
    tune_pkg.calibrate = lambda *a, **kw: passes.append(
        calibrate(*a, **kw)) or passes[-1]
    path = os.path.join(TUNE_DIR, "live.tuned.json")
    t0 = time.perf_counter()
    try:
        config = hvd.tune(path=path)
    finally:
        tune_pkg.calibrate = calibrate
    seconds = time.perf_counter() - t0
    [cal] = passes
    with open(path) as f:
        findings = verify.verify_tuned_config(f.read(), path=path)
    if findings:
        raise RuntimeError(f"hvd.tune()'s pair fails verification: "
                           f"{[str(x) for x in findings]}")
    report = hvd.tune_report()
    if not report["active"] or report["hash"] != config.config_hash():
        raise RuntimeError(f"hvd.tune() applied nothing: {report}")
    if cal.compute_window_s is None or not cal.compute_window_s > 0:
        raise RuntimeError(f"the tiny LM's window: {cal.compute_window_s}")
    tune_apply.deactivate()
    return {"config": config, "cal": cal, "seconds": seconds,
            "report": report, "budget_s": knobs_env.tune_budget_seconds()}


def ab_arms(device) -> dict:
    """(b): ``measure_lm_ab`` with a candidate off the defaults."""
    from horovod_tpu_torch.ops import topology
    from horovod_tpu_torch.tune import TunedConfig
    from horovod_tpu_torch.tune.calibrate import measure_lm_ab

    kind = topology.discover(hvd.get_group(0)).device_kind
    cand = TunedConfig(device_kind=kind,
                       world_size=1, num_slices=1, constants={},
                       knobs=dict(AB_KNOBS),
                       exchange_artifact="ab.exchange.json",
                       exchange_plan_hash="00000000")
    default_s, tuned_s = measure_lm_ab(cand)
    return {"default_ms": 1e3 * default_s, "tuned_ms": 1e3 * tuned_s}


def committed_pair(device) -> tuple[str, object]:
    """(c): a verified ``.tuned.json`` + ``.exchange.json`` pair of
    TUNED_KNOBS, its plan the one the LM's gradient path makes under them
    (the ``DistributedOptimizer.grads.<i>`` labels)."""
    from horovod_tpu_torch.analysis import schedule as verify
    from horovod_tpu_torch.ops import topology
    from horovod_tpu_torch.tune import TunedConfig

    with torch.device("meta"):
        model = transformer.Transformer(lm_config(torch.bfloat16))
    leaves = list(model.parameters())
    topo = topology.discover(hvd.get_group(0))
    plan = exchange.plan_exchange(
        leaves, TUNED_KNOBS["HOROVOD_FUSION_THRESHOLD"],
        mode=TUNED_KNOBS["HOROVOD_EXCHANGE_SCHEDULE"],
        compression=compression.resolve(TUNED_KNOBS["HOROVOD_COMPRESSION"]),
        algo="flat", topo=topo, world_size=1, max_channels=1,
        labels=[f"DistributedOptimizer.grads.{i}"
                for i in range(len(leaves))])
    path = os.path.join(TUNE_DIR, "lm.tuned.json")
    plan.save(path[:-len(".tuned.json")] + ".exchange.json")
    config = TunedConfig(
        device_kind=topo.device_kind, world_size=1, num_slices=1,
        constants={}, knobs=dict(TUNED_KNOBS),
        exchange_artifact="lm.exchange.json",
        exchange_plan_hash=plan.plan_hash())
    config.save(path)
    with open(path) as f:
        findings = verify.verify_tuned_config(f.read(), path=path)
    if findings:
        raise RuntimeError(f"the committed pair fails verification: "
                           f"{[str(x) for x in findings]}")
    return path, plan


def lm_run(device, tokens, steps: int) -> dict:
    """The LM's captured steps; the losses' bits and the step's plan."""
    trainer = lm_trainer(device)
    losses, _ = timed_calls(trainer, tokens, steps)
    out = {"losses": losses, "plan": exchange.last_plan(),
           "report": hvd.tune_report()}
    del trainer
    free_cuda()
    return out


def tuned_lm(device) -> dict:
    """(c): HOROVOD_TUNED_CONFIG applied at hvd.init against the same
    knobs set by env, and an env knob beside the config."""
    path, plan = committed_pair(device)
    tokens = transformer.synthetic_tokens(LM_BATCH, LM_T, 32_768, seed=SEED,
                                          device=device)
    with world_with(HOROVOD_TUNED_CONFIG=path):
        tuned = lm_run(device, tokens, TUNE_STEPS)
    sources = {k: tuned["report"]["knobs"][k]["source"] for k in TUNED_KNOBS}
    if set(sources.values()) != {"tuned"}:
        raise RuntimeError(f"tune_report() under the config: {sources}")
    if tuned["plan"].to_json() != plan.to_json():
        raise RuntimeError(
            f"last_plan() {tuned['plan'].plan_hash()} != the committed plan "
            f"{plan.plan_hash()}: {tuned['plan'].describe_rows()[:3]}")
    with world_with(**TUNED_KNOBS):
        by_env = lm_run(device, tokens, TUNE_STEPS)
    if not same_bits(tuned["losses"], by_env["losses"]):
        raise RuntimeError("the tuned config's losses differ from the same "
                           "knobs set by env")
    with world_with(HOROVOD_TUNED_CONFIG=path,
                    HOROVOD_EXCHANGE_SCHEDULE="enum"):
        beside = lm_run(device, tokens, 1)
    knobs = beside["report"]["knobs"]
    if (knobs["HOROVOD_EXCHANGE_SCHEDULE"]["source"] != "env"
            or beside["plan"].mode != "enum"
            or knobs["HOROVOD_COMPRESSION"]["source"] != "tuned"
            or beside["plan"].threshold_bytes != TUNED_KNOBS[
                "HOROVOD_FUSION_THRESHOLD"]):
        raise RuntimeError(f"env beside the config: {knobs}, plan mode "
                           f"{beside['plan'].mode}")
    return {"plan": plan, "losses": [float(v) for v in tuned["losses"]],
            "sources": sources, "beside": knobs["HOROVOD_EXCHANGE_SCHEDULE"]}


def read_timeline(path: str) -> list:
    """The timeline's events, each with its row's name as ``row``."""
    with open(path) as f:
        lines = [ln.strip().rstrip(",") for ln in f if ln.strip() not in
                 ("[", "]", "")]
    events = [json.loads(ln) for ln in lines]
    rows = {e["pid"]: e["args"]["name"] for e in events
            if e["name"] == "process_name"}
    return [dict(e, row=rows.get(e["pid"])) for e in events
            if e.get("ph") != "M"]


def timeline_run(name: str, device) -> dict:
    """(d): TIMELINE_CALLS calls of one workload's step in the device mode
    (interval TIMELINE_INTERVAL), against the same calls unsampled; the
    unsampled trainer and its batch are returned for (e)."""
    from horovod_tpu_torch.core import xprof
    from horovod_tpu_torch.ops import launches

    make = lm_trainer if name == "lm" else resnet_trainer
    if name == "lm":
        batch = transformer.synthetic_tokens(LM_BATCH, LM_T, 32_768,
                                             seed=SEED, device=device)
    else:
        batch = resnet.synthetic_imagenet(BATCH, IMAGE, seed=SEED,
                                          num_classes=CLASSES, device=device)
    path = os.path.join(TUNE_DIR, f"{name}.timeline.json")
    # Each sampled call's device events as the profiler returned them:
    # what the timeline's spans are held to.
    profiled, sessions = xprof.profiled_events, []

    def recorded(run_once):
        out = profiled(run_once)
        sessions.append(out[1])
        return out

    with world_with(HOROVOD_TIMELINE=path, HOROVOD_TIMELINE_DEVICE=1,
                    HOROVOD_TIMELINE_DEVICE_INTERVAL=TIMELINE_INTERVAL):
        trainer = make(device)
        reset_launch_counts()
        xprof.profiled_events = recorded
        try:
            sampled_losses, sampled_ms = timed_calls(trainer, batch,
                                                     TIMELINE_CALLS)
        finally:
            xprof.profiled_events = profiled
        wrapped = {k: v for k, v in launch_counts().items() if v}
        sampled = trainer._step.sampled
        del trainer
        free_cuda()
    trainer = make(device)
    plain_losses, plain_ms = timed_calls(trainer, batch, TIMELINE_CALLS)
    # The NCCL kernels the card ran in a step (world 1), by name.
    _, events, _ = xprof.profiled_events(lambda: trainer.train_step(batch))
    nccl = sorted({n for n, _, _ in events if "nccl" in n.lower()})
    want = TIMELINE_CALLS // TIMELINE_INTERVAL + 1
    if not sampled == len(sessions) == want:
        raise RuntimeError(f"{name}: {sampled} of {TIMELINE_CALLS} calls "
                           f"sampled at interval {TIMELINE_INTERVAL} "
                           f"({len(sessions)} profiler sessions)")
    if not same_bits(sampled_losses, plain_losses):
        raise RuntimeError(f"{name}: sampled losses differ from unsampled")
    tl = read_timeline(path)
    steps = [e for e in tl if e["name"] == "DEVICE_STEP"]
    if len(steps) != sampled or any(e["row"] != "_device" for e in steps):
        raise RuntimeError(f"{name}: {len(steps)} DEVICE_STEP spans for "
                           f"{sampled} sampled calls")
    if any(e["name"] == "NO_DEVICE_PLANE" for e in tl):
        raise RuntimeError(f"{name}: a sampled call saw no CUDA event")
    per_step = {**REPLAY_COUNTS["lm"], "channel_sums": BN_LAYERS,
                "channel_grad_sums": BN_LAYERS}
    counts, records = {}, {}
    for wrapper in TIMELINE_KERNELS[name]:
        fn = launches.KERNELS[wrapper][0]
        counts[wrapper] = sum(1 for e in tl if e["row"] == "_kernels"
                              and e["name"] == fn)
        # Each sampled call's records of the kernel, by the profiler.
        records[wrapper] = [sum(1 for n, _, _ in ev
                                if xprof.kernel_base(n) == fn)
                            for ev in sessions]
        if counts[wrapper] != sum(records[wrapper]) \
                or 0 in records[wrapper]:
            raise RuntimeError(
                f"{name}: the timeline's {fn} spans {counts[wrapper]}, the "
                f"profiler's records in the sampled calls "
                f"{records[wrapper]} (the wrapper launches "
                f"{per_step[wrapper]} a call)")
    # What the profiler did not record of the wrappers' launches (CUPTI
    # can lose a record; the timeline shows what it was given).
    if wrapped != {k: per_step[k] * TIMELINE_CALLS for k in records}:
        raise RuntimeError(f"{name}: the wrappers launched {wrapped} in "
                           f"{TIMELINE_CALLS} calls")
    missed = {k: v for k, v in records.items()
              if v != [per_step[k]] * sampled}
    colls = [e for e in tl if e["name"].startswith("XLA_")]
    if bool(colls) != any(xprof.kernel_base(n) in xprof._COLL_KIND
                          for n in nccl):
        raise RuntimeError(f"{name}: {len(colls)} collective spans, NCCL "
                           f"kernels {nccl}")
    return {
        "trainer": trainer, "batch": batch,
        "sampled": sampled, "spans": len(tl), "counts": counts,
        "missed": missed, "wrapped": wrapped,
        "kernel_spans": sum(1 for e in tl if e["row"] == "_kernels"),
        "collective_spans": len(colls), "nccl": nccl,
        "events_a_step": len(events),
        "device_step_ms": [e["dur"] / 1e3 for e in steps],
        "sampled_ms": sampled_ms, "plain_ms": plain_ms}


def phase_tuning(device) -> dict:
    """Phase 21: hvd.tune, a tuned config on the LM's step, the device
    timeline on the LM's and ResNet-50's steps, and timed_steps (module
    docstring)."""
    from horovod_tpu_torch.core import xprof

    t0 = time.perf_counter()
    shutil.rmtree(TUNE_DIR, ignore_errors=True)
    os.makedirs(TUNE_DIR)
    try:
        out = {"tune": tune_live(device), "ab": ab_arms(device),
               "tuned": tuned_lm(device), "timeline": {}}
        for name in ("resnet50", "lm"):
            r = timeline_run(name, device)
            trainer, batch = r.pop("trainer"), r.pop("batch")
            out["timeline"][name] = r
            if name == "resnet50":
                del trainer
                free_cuda()
        info = {}
        device_s = xprof.timed_steps(lambda: trainer.train_step(batch), 1,
                                     trials=TIMED_TRIALS, strict=True,
                                     info=info)
        wall = min(_timed(lambda: trainer.train_step(batch))
                   for _ in range(TIMED_TRIALS))
        if info["timing"] != "device":
            raise RuntimeError(f"timed_steps on the card: {info}")
        out["timed"] = {"device_ms": 1e3 * device_s, "wall_ms": 1e3 * wall}
        del trainer
        free_cuda()
    finally:
        shutil.rmtree(TUNE_DIR, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    return out


def tuning_line(tn: dict, ident: str) -> str:
    """Phase 21's line."""
    tu, ab, tc, tm = tn["tune"], tn["ab"], tn["tuned"], tn["timed"]
    cal = tu["cal"]

    def tl(name):
        r = tn["timeline"][name]
        return (f"{name}: {r['sampled']} of {TIMELINE_CALLS} calls sampled,"
                f" {r['spans']} spans, DEVICE_STEP "
                + ", ".join(f"{v:.2f}" for v in r["device_step_ms"])
                + f" ms, kernel spans {r['counts']} ({r['kernel_spans']} on "
                f"_kernels) = the profiler's records of the sampled calls, "
                + (f"short of the wrappers' launches ({r['wrapped']} in "
                   f"{TIMELINE_CALLS} calls): the profiler's records a "
                   f"sampled call {r['missed']}"
                   if r["missed"] else "every launch of the wrappers")
                + f", {r['collective_spans']} collective spans "
                f"matched, NCCL kernels in a step {r['nccl'] or 'none'} (of "
                f"{r['events_a_step']} device events), sampled = unsampled "
                f"losses bit for bit; wall ms a call sampled "
                + ", ".join(f"{r['sampled_ms'][i]:.1f}" for i in (0, 2, 4))
                + " (calls 1, 3, 5), unsampled "
                + ", ".join(f"{r['sampled_ms'][i]:.1f}" for i in (1, 3))
                + " (calls 2, 4); without the device mode "
                + ", ".join(f"{v:.1f}" for v in r["plain_ms"]))

    return (f"phase 21 tuning: ok; (a) hvd.tune() at world 1, live timer: "
            f"{cal.samples} samples in {cal.seconds_spent:.2f} s of the "
            f"{tu['budget_s']:.0f} s budget (tune {tu['seconds']:.2f} s), "
            f"constants {cal.constants or '{} (one rank: no fit)'}, tiny "
            f"LM window {1e3 * cal.compute_window_s:.3f} ms, committed "
            f"{tu['config'].knobs} (hash {tu['config'].config_hash()}, "
            f"plan {tu['config'].exchange_plan_hash}), verify_tuned_config "
            f"[] , tune_report sources "
            f"{ {k: v['source'] for k, v in tu['report']['knobs'].items()} }"
            f"; (b) measure_lm_ab({AB_KNOBS}): default "
            f"{ab['default_ms']:.3f} ms, candidate {ab['tuned_ms']:.3f} ms a "
            f"step; (c) HOROVOD_TUNED_CONFIG of {TUNED_KNOBS} (verified, "
            f"plan {tc['plan'].plan_hash()}, {len(tc['plan'].buckets)} "
            f"buckets) on phase 8's LM, {TUNE_STEPS} captured steps: sources "
            f"{tc['sources']}, last_plan() = the committed plan, losses "
            + ", ".join(f"{v:.4f}" for v in tc["losses"])
            + f" = the same knobs by env bit for bit, "
            f"HOROVOD_EXCHANGE_SCHEDULE=enum beside the config: "
            f"{tc['beside']}; (d) HOROVOD_TIMELINE_DEVICE=1, interval "
            f"{TIMELINE_INTERVAL}: {tl('lm')}; {tl('resnet50')}; (e) "
            f"timed_steps(strict=True) on the LM step: device window "
            f"{tm['device_ms']:.2f} ms, wall {tm['wall_ms']:.2f} ms "
            f"(best of {TIMED_TRIALS}); phase {tn['seconds']:.1f} s, on "
            f"{ident}")


# -- resilience (phase 22) ------------------------------------------------------

RESIL_DIR = "_chip_smoke_resil"
RESIL_STEPS = 3  # (a): the eager call, the capture, one replay
RESIL_LM_CALLS = 6  # (b): eager, captured, 4 replays (timed: the replays)
LIVENESS_KNOBS = {"HOROVOD_LIVENESS_TIMEOUT": "30",
                  "HOROVOD_LIVENESS_INTERVAL": "0.5"}
# (c): CRASH_EPOCHS epochs of CRASH_SPE steps, a checkpoint an epoch; the
# crash at step CRASH_AT (the first boundary of epoch 1) leaves epoch 0.
CRASH_EPOCHS, CRASH_SPE, CRASH_AT = 2, 2, 2
# Each child process of (c) runs these (workload, action) in turn: the
# uninterrupted fits; ResNet-50's crash; its resume and the LM's crash (under
# HOROVOD_ELASTIC=1: at world 1 the target is this process, which exits 43
# as (d) asks); the LM's resume.
RESIL_CHILDREN = (
    ("full", (("resnet50", "full"), ("lm", "full"))),
    ("crash_resnet50", (("resnet50", "crash"),)),
    ("resume_resnet50", (("resnet50", "resume"), ("lm", "crash"))),
    ("resume_lm", (("lm", "resume"),)),
)


@contextlib.contextmanager
def env_set(**kw):
    """Set environment variables (None unsets) and re-read the fault spec;
    restore both after."""
    saved = {k: os.environ.get(k) for k in kw}
    try:
        for k, v in kw.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        resilience.reset_injector()
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        resilience.reset_injector()


def reinit() -> None:
    """A fresh init cycle with fresh fault-injection and retry state."""
    hvd.shutdown()
    resilience._reset_for_tests()
    hvd.init()


def state_crc(model) -> int:
    """CRC32 of every tensor of the model's state dict, in order."""
    crc = 0
    for t in model.state_dict().values():
        crc = zlib.crc32(_bits(t).cpu().numpy().tobytes(), crc)
    return crc & 0xFFFFFFFF


def resil_kv_retry(device) -> dict:
    """(a): phase 8's ResNet-50 (fused BN) fit, fault-free and then under
    two ``kv_timeout`` faults at store calls the fault-free fit reached
    (the first and the last); with the timeline on, in fresh init cycles."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    tl_path = os.path.join(HERE, RESIL_DIR, "timeline.json")
    out = {"launches": {}}
    try:
        runs = {}
        for arm in ("clean", "faults"):
            spec = (None if arm == "clean" else ";".join(
                f"kv_timeout@seq={q}" for q in out["seqs"]))
            with env_set(HOROVOD_FAULT_INJECT=spec,
                         HOROVOD_TIMELINE=None if spec is None else tl_path,
                         HOROVOD_KV_BACKOFF_MS="5"):
                reinit()
                trainer, batch = ckpt_workload("resnet50", device, SEED)
                log = LossLog()
                reset_launch_counts()
                trainer.fit([batch], 1, RESIL_STEPS, verbose=False,
                            callbacks=[log])
                torch.cuda.synchronize()
                out["launches"][arm] = launch_counts()
                runs[arm] = (log.losses, _cpu_tree(trainer.model.state_dict()),
                             resilience.injector().kv_calls,
                             resilience.retry_count())
                del trainer
                free_cuda()
                hvd.shutdown()  # closes the timeline
            if arm == "clean":
                calls = runs["clean"][2]
                if calls < 2:
                    raise RuntimeError(f"phase 22 (a): the fit made {calls} "
                                       f"store call(s); two faults need two")
                out["seqs"] = (0, calls - 1)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    events = []
    with open(tl_path) as f:
        for line in f:
            if line.startswith("{"):
                events.append(json.loads(line.rstrip().rstrip(",")))
    retry_events = sum(e.get("name") == "RETRY" for e in events)
    (la, sa, calls, _), (lb, sb, calls_b, retries) = (runs["clean"],
                                                      runs["faults"])
    diff = _tree_diff(sa, sb)
    if not same_bits(la, lb) or diff:
        raise RuntimeError(f"phase 22 (a): the fit under store faults "
                           f"differs: losses equal {same_bits(la, lb)}, "
                           f"state {diff[:8]}")
    if retries != 2 or retry_events != 2 or calls_b != calls + 2:
        raise RuntimeError(f"phase 22 (a): {retries} retries, {retry_events} "
                           f"RETRY events, {calls_b} store calls (wanted 2, "
                           f"2, {calls + 2})")
    out.update(calls=calls, retries=retries, retry_events=retry_events,
               losses=[float(x) for x in la])
    return out


def resil_liveness(device) -> dict:
    """(b): phase 8's LM, without the liveness knobs and with them and a
    heartbeat running beside the step (at world 1 ``hvd.init`` starts
    none: the phase starts it), a liveness check of the heartbeat after
    each call."""
    cfg = lm_config(torch.bfloat16)
    tokens = transformer.synthetic_tokens(LM_BATCH, LM_T, cfg.vocab_size,
                                          seed=SEED, device=device)
    out = {"launches": {}}
    runs = {}
    for arm in ("plain", "liveness"):
        with env_set(**(LIVENESS_KNOBS if arm == "liveness" else {})):
            reinit()
            if arm == "liveness":
                resilience.start_heartbeat(force=True)
                hb = resilience.heartbeat()
                store = negotiate.negotiator().store
                key = resilience._hb_key(hstate.kv_generation(), 0)
                t_first = json.loads(store.get(key))["t"]
                n_first = hb.published
            trainer = lm_trainer(device)
            reset_launch_counts()
            losses, ms = [], []
            for _ in range(RESIL_LM_CALLS):
                l_, m_ = timed_calls(trainer, tokens, 1)
                losses += l_
                ms += m_
                if arm == "liveness":
                    resilience.liveness().check(store, [0],
                                                "phase 22 (b)")
            out["launches"][arm] = launch_counts()
            runs[arm] = (losses, _cpu_tree(trainer.model.state_dict()), ms)
            if arm == "liveness":
                out["heartbeats"] = hb.published - n_first
                out["hb_advanced_s"] = json.loads(store.get(key))["t"] - \
                    t_first
                resilience.stop_heartbeat()
            del trainer
            free_cuda()
    (la, sa, ma), (lb, sb, mb) = runs["plain"], runs["liveness"]
    diff = _tree_diff(sa, sb)
    if not same_bits(la, lb) or diff:
        raise RuntimeError(f"phase 22 (b): the fit beside the heartbeat "
                           f"differs: losses equal {same_bits(la, lb)}, "
                           f"state {diff[:8]}")
    if out["heartbeats"] < 2 or out["hb_advanced_s"] <= 0:
        raise RuntimeError(f"phase 22 (b): the heartbeat did not advance: "
                           f"{out['heartbeats']} beats, "
                           f"{out['hb_advanced_s']} s")
    out["step_ms"] = {arm: statistics.median(r[2][2:])
                      for arm, r in runs.items()}
    out["losses"] = [float(x) for x in la]
    return out


def resilience_child(mode: str, directory: str) -> int:
    """One child process of (c): the (workload, action) list of ``mode``
    (``RESIL_CHILDREN``). Prints ``RESIL <workload> <action> crc=...``
    lines; a crash action ends the process with exit 43."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    device = torch.device("cuda", 0)
    hvd.init()
    for name, action in dict(RESIL_CHILDREN)[mode]:
        where = os.path.join(directory, name)
        trainer, batch = ckpt_workload(name, device, SEED)
        spec = (f"crash@rank=0,step={CRASH_AT}" if action == "crash"
                else None)
        elastic = "1" if (action, name) == ("crash", "lm") else None
        with env_set(HOROVOD_FAULT_INJECT=spec, HOROVOD_ELASTIC=elastic):
            saves = TimedCheckpoint(where)
            t0 = time.perf_counter()
            trainer.fit([batch], CRASH_EPOCHS, CRASH_SPE, verbose=False,
                        callbacks=[] if action == "full" else [saves],
                        resume=where if action == "resume" else None)
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        print(f"RESIL {name} {action} crc={state_crc(trainer.model)} "
              f"epoch={trainer.epoch} seconds={secs:.3f}", flush=True)
        del trainer
        free_cuda()
    hvd.shutdown()
    return 0


def resil_crash_resume(device) -> dict:
    """(c): the reference's crash drill in child processes on the card,
    for ResNet-50 (fused BN) and the LM; the resumed parameters' CRC must
    equal the uninterrupted child's."""
    directory = os.path.join(HERE, RESIL_DIR, "ckpt")
    shutil.rmtree(directory, ignore_errors=True)
    os.makedirs(directory)
    lines, exits, wall = {}, {}, {}
    env = {k: v for k, v in os.environ.items()
           if k not in ("HOROVOD_FAULT_INJECT", "HOROVOD_ELASTIC")}
    for mode, _ in RESIL_CHILDREN:
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--resilience-child", mode, directory],
                           env=env, capture_output=True, text=True,
                           timeout=600, cwd=HERE)
        wall[mode] = time.perf_counter() - t0
        exits[mode] = r.returncode
        for ln in r.stdout.splitlines():
            if ln.startswith("RESIL "):
                _, name, action, *kv = ln.split()
                lines[(name, action)] = dict(x.split("=") for x in kv)
        crashes = mode.startswith("crash") or mode == "resume_resnet50"
        want = resilience.CRASH_EXIT_CODE if crashes else 0
        if r.returncode != want or (crashes and "simulating hard crash"
                                    not in r.stdout):
            raise RuntimeError(f"phase 22 (c): child {mode} exited "
                               f"{r.returncode} (wanted {want})\n"
                               f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    shutil.rmtree(directory, ignore_errors=True)
    out = {"exits": exits, "child_s": wall}
    for name in ("resnet50", "lm"):
        full, res = lines[(name, "full")], lines[(name, "resume")]
        if full["crc"] != res["crc"] or int(res["epoch"]) != CRASH_EPOCHS:
            raise RuntimeError(f"phase 22 (c) {name}: resumed crc "
                               f"{res['crc']} epoch {res['epoch']}, "
                               f"uninterrupted crc {full['crc']}")
        out[name] = {"crc": int(full["crc"]),
                     "resume_fit_s": float(res["seconds"])}
    return out


def resil_elastic_world1(device) -> dict:
    """(d): a WorkerLost under HOROVOD_ELASTIC=1 at world 1, with the
    default min world, is refused with the reference's text, chained to
    the loss (the targeted crash's exit 43 is (c)'s LM crash child)."""

    class Linear(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(4, 2, device=device))

    def lost(step, ranks, span=1, peers=()):
        if step == 1:
            raise resilience.WorkerLost("peer lost at step 1", ranks=(0,))

    batch = (torch.ones(8, 4, device=device), torch.ones(8, 2,
                                                        device=device))
    with env_set(HOROVOD_ELASTIC="1"):
        reinit()
        model = Linear()
        trainer = hvd.Trainer(
            model, lambda m, b: torch.mean((b[0] @ m.w - b[1]) ** 2),
            training.sgd(0.05))
        real, resilience.maybe_crash = resilience.maybe_crash, lost
        try:
            trainer.fit([batch], 1, 2, verbose=False)
            raise RuntimeError("phase 22 (d): the WorkerLost was not refused")
        except hvd.HorovodError as e:
            text, cause = str(e), e.__cause__
        finally:
            resilience.maybe_crash = real
        del trainer
    want = ("Elastic shrink refused: 0 survivor(s) would fall below "
            "HOROVOD_ELASTIC_MIN_WORLD=1. Restart the failed host(s) and "
            "resume from the last complete checkpoint "
            "(Trainer.fit(resume=...)).")
    if text != want or not isinstance(cause, resilience.WorkerLost):
        raise RuntimeError(f"phase 22 (d): refused with {text!r} from "
                           f"{cause!r}")
    return {"refusal": text}


# Phase 22 (e)'s drill scenarios: the serve scenario runs in phase 25 (a).
RESIL_DRILL = "kv_timeout,liveness,torn_write,crash,elastic"


def resil_drill(device) -> dict:
    """(e): ``tools/fault_drill_torch.py --device cuda``: the training
    scenarios one card runs (the elastic one needs four)."""
    t0 = time.perf_counter()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HOROVOD_")}
    r = subprocess.run([sys.executable,
                        os.path.join(HERE, "tools", "fault_drill_torch.py"),
                        "--device", "cuda", "--scenario", RESIL_DRILL],
                       env=env, capture_output=True,
                       text=True, timeout=900, cwd=HERE)
    if r.returncode != 0 or not r.stdout.rstrip().endswith(
            "FAULT DRILL PASSED"):
        raise RuntimeError(f"phase 22 (e): the fault drill exited "
                           f"{r.returncode}\n{r.stdout[-3000:]}\n"
                           f"{r.stderr[-3000:]}")
    summary = [ln.strip() for ln in r.stdout.splitlines()
               if ln.startswith("  ")]
    return {"seconds": time.perf_counter() - t0, "summary": summary}


def phase_resilience(device) -> dict:
    """Phase 22: (a) store retry, (b) liveness beside the step, (c) crash
    and resume, (d) elastic at world 1, (e) the fault drill."""
    os.makedirs(os.path.join(HERE, RESIL_DIR), exist_ok=True)
    try:
        out = {"kv": resil_kv_retry(device)}
        out["liveness"] = resil_liveness(device)
        free_cuda()
        out["crash"] = resil_crash_resume(device)
        out["elastic"] = resil_elastic_world1(device)
        out["drill"] = resil_drill(device)
    finally:
        shutil.rmtree(os.path.join(HERE, RESIL_DIR), ignore_errors=True)
    for arm, counts in {**out["kv"]["launches"],
                        **out["liveness"]["launches"]}.items():
        idle = sorted(k for k, v in counts.items()
                      if v == 0 and (k in REPLAY_COUNTS["lm"]) == (
                          arm in ("plain", "liveness")))
        if idle:
            raise RuntimeError(f"phase 22 ({arm}) never launched {idle}: "
                               f"{counts}")
    return out


def resilience_line(rs: dict, ident: str) -> str:
    kv, lv, cr = rs["kv"], rs["liveness"], rs["crash"]
    return (
        f"phase 22 resilience: ok; (a) ResNet-50 fused BN, {RESIL_STEPS} "
        f"steps, {kv['calls']} store calls, kv_timeout at seq "
        f"{kv['seqs'][0]} and {kv['seqs'][1]}: {kv['retries']} retries, "
        f"{kv['retry_events']} RETRY events on the timeline's coordination "
        f"row, losses and state bit-identical to the fault-free fit; (b) "
        f"the LM ({LM_LAYERS} layers, B={LM_BATCH} T={LM_T}) beside a "
        f"heartbeat (HOROVOD_LIVENESS_TIMEOUT="
        f"{LIVENESS_KNOBS['HOROVOD_LIVENESS_TIMEOUT']}, _INTERVAL="
        f"{LIVENESS_KNOBS['HOROVOD_LIVENESS_INTERVAL']}): no WorkerLost, "
        f"{lv['heartbeats']} heartbeats, key advanced "
        f"{lv['hb_advanced_s']:.2f} s, bit-identical to the fit without; "
        f"median step {lv['step_ms']['plain']:.2f} ms without, "
        f"{lv['step_ms']['liveness']:.2f} ms with; (c) crash@rank=0,step="
        f"{CRASH_AT} exits 43, fit(resume=) in a new process: crc equal "
        f"to the uninterrupted child's (ResNet-50 {cr['resnet50']['crc']}, "
        f"LM {cr['lm']['crc']}); resumed fits "
        f"{cr['resnet50']['resume_fit_s']:.2f} s and "
        f"{cr['lm']['resume_fit_s']:.2f} s; children "
        + ", ".join(f"{k} {v:.1f} s" for k, v in cr["child_s"].items())
        + f"; (d) world 1 under HOROVOD_ELASTIC=1 refuses with the "
        f"min-world text; (e) fault_drill_torch.py --device cuda "
        f"--scenario {RESIL_DRILL} passed in "
        f"{rs['drill']['seconds']:.1f} s: " + " | ".join(
            rs["drill"]["summary"]) + f"; on {ident}")


# -- the control plane (phase 23) -------------------------------------------------

CTL_DIR = "_chip_smoke_ctl"   # gitignored; removed after the phase
CTL_STEPS = 3                 # (a), (b): the eager call, the capture, a replay
CTL_EAGER_CALLS = 200         # (b): named eager allreduces an arm
CTL_EAGER_ELEMS = 2 << 20     # (b): 4 MiB of bf16
CTL_THRESHOLDS = (0, 1 << 20)  # (a): fusion thresholds beside the default
CTL_HOST_REPS = 50            # (a): repetitions of each host-side timing


def host_us(fn) -> float:
    """Mean host µs of ``fn()`` over CTL_HOST_REPS calls."""
    t0 = time.perf_counter()
    for _ in range(CTL_HOST_REPS):
        fn()
    return 1e6 * (time.perf_counter() - t0) / CTL_HOST_REPS


def native_plans_equal(core, tensors) -> dict:
    """The native fusion plan of ``tensors`` against ``plan_buckets_py``'s
    at the default threshold and ``CTL_THRESHOLDS`` (buckets a threshold),
    and each planner's host µs at the default threshold."""
    leaves = [torch.empty(t.shape, dtype=t.dtype, device="meta")
              for t in tensors]
    out = {"buckets": {}}
    for thr in (hstate.fusion_threshold(),) + CTL_THRESHOLDS:
        a = fusion.plan_buckets_native(core, leaves, thr)
        b = fusion.plan_buckets_py(leaves, thr)
        if a != b:
            raise RuntimeError(f"phase 23: the native fusion plan at "
                               f"threshold {thr} differs from the Python "
                               f"plan")
        out["buckets"][thr] = len(a)
    thr = hstate.fusion_threshold()
    out["tensors"] = len(leaves)
    out["native_us"] = host_us(
        lambda: fusion.plan_buckets_native(core, leaves, thr))
    out["python_us"] = host_us(lambda: fusion.plan_buckets_py(leaves, thr))
    return out


@contextlib.contextmanager
def recorded_rounds():
    """Every negotiation round the coordinator validates inside the block:
    each member's batch and the group's size, and whether the round went
    through the native table."""
    real_validate, real_round = negotiate._validate, negotiate._native_round
    rounds, tables = [], []

    def validate(gathered, g, seq, table=None):
        rounds.append((copy.deepcopy(gathered), g.index, g.size))
        return real_validate(gathered, g, seq, table)

    def native_round(names, g):
        table = real_round(names, g)
        tables.append(table is not None)
        return table

    negotiate._validate, negotiate._native_round = validate, native_round
    try:
        yield rounds, tables
    finally:
        negotiate._validate, negotiate._native_round = (real_validate,
                                                        real_round)


def verdicts_agree(rounds) -> dict:
    """Every request of ``rounds`` validated again by a fresh native table
    and by ``validate_py``: the verdicts must be equal. Returns the count
    and each path's host µs a round (mean over the rounds)."""
    from horovod_tpu_torch.core import native

    n, us = 0, {"native": 0.0, "python": 0.0}
    for gathered, gi, size in rounds:
        core = native.NativeCore([size] * (gi + 1))
        try:
            reqs = [[negotiate.Request(
                rank=r, name=b[i][0], op=negotiate.CollectiveOp(b[i][1]),
                dtype=b[i][2], shape=tuple(b[i][3]), root_rank=b[i][4],
                group=gi) for r, b in enumerate(gathered)]
                for i in range(len(gathered[0]))]
            for one in reqs:
                if (negotiate._validate_native(core, one, size)
                        != negotiate.validate_py(one, size)):
                    raise RuntimeError(f"phase 23 (a): the native verdict on "
                                       f"{one[0].name} differs from "
                                       f"validate_py's")
                n += 1
            us["native"] += host_us(lambda: [
                negotiate._validate_native(core, one, size) for one in reqs])
            us["python"] += host_us(lambda: [
                negotiate.validate_py(one, size) for one in reqs])
        finally:
            core.close()
    return {"verdicts": n, **{k: v / max(1, len(rounds))
                              for k, v in us.items()}}


def ctl_native_fit(device) -> dict:
    """(a): ResNet-50 (fused BN) for CTL_STEPS steps under HOROVOD_TIMELINE
    on the native writer, its rounds recorded and validated again, its
    gradient plans held against the Python planner."""
    path = os.path.join(HERE, CTL_DIR, "timeline.json")
    with world_with(HOROVOD_TIMELINE=path):
        core = hstate.native_core()
        if core is None or negotiate._tl.session().native_core is not core:
            raise RuntimeError("phase 23 (a): the native core is not loaded "
                               "or does not write the timeline")
        trainer = resnet_trainer(device)
        batch = resnet.synthetic_imagenet(BATCH, IMAGE, seed=SEED,
                                          num_classes=CLASSES, device=device)
        log = LossLog()
        reset_launch_counts()
        with recorded_rounds() as (rounds, tables):
            trainer.fit([batch], 1, CTL_STEPS, verbose=False,
                        callbacks=[log])
        torch.cuda.synchronize()
        launches = launch_counts()
        plans = native_plans_equal(core, list(trainer.model.parameters()))
        del trainer
        free_cuda()
    if not rounds or not all(tables) or len(tables) != len(rounds):
        raise RuntimeError(f"phase 23 (a): {len(rounds)} rounds, native "
                           f"tables {tables}")
    events = read_timeline(path)
    neg_rows = sorted({e["row"] for e in events
                       if e["name"].startswith("NEGOTIATE_")})
    ticks = sum(e["ph"] == "X" and e["name"] == "0" for e in events)
    if not any(r.startswith("DistributedOptimizer.grads") for r in neg_rows) \
            or ticks < len(neg_rows):
        raise RuntimeError(f"phase 23 (a): the trace's NEGOTIATE rows "
                           f"{neg_rows}, {ticks} ready ticks")
    if not all(torch.isfinite(x).all() for x in log.losses):
        raise RuntimeError("phase 23 (a): a loss is not finite")
    return {"rounds": len(rounds), "validation": verdicts_agree(rounds),
            "plans": plans, "neg_rows": len(neg_rows), "ticks": ticks,
            "events": len(events), "launches": launches,
            "losses": [float(x) for x in log.losses]}


def ctl_eager_arm(device, cache: str) -> dict:
    """(b): CTL_EAGER_CALLS named eager allreduces of a 4-MiB bf16 tensor
    with HOROVOD_EAGER_CACHE=``cache``: the last result, the store calls
    after the first call, and the mean ms a call (each call synced)."""
    g = torch.Generator().manual_seed(SEED)
    x = torch.randn(CTL_EAGER_ELEMS, generator=g).to(device, torch.bfloat16)
    neg = negotiate.negotiator()
    with env_knobs(HOROVOD_EAGER_CACHE=cache):
        out = hvd.allreduce(x, name="ctl_eager", average=False)
        torch.cuda.synchronize()
        calls0 = neg.store_calls
        t0 = time.perf_counter()
        for _ in range(CTL_EAGER_CALLS - 1):
            out = hvd.allreduce(x, name="ctl_eager", average=False)
            torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / (CTL_EAGER_CALLS - 1)
    return {"out": out, "store_calls": neg.store_calls - calls0, "ms": ms}


def ctl_lm_arm(device, cache: str) -> dict:
    """(b): phase 8's LM for CTL_STEPS steps in a fresh init cycle with
    HOROVOD_EAGER_CACHE=``cache``; its gradient plans against the Python
    planner."""
    cfg = lm_config(torch.bfloat16)
    tokens = transformer.synthetic_tokens(LM_BATCH, LM_T, cfg.vocab_size,
                                          seed=SEED, device=device)
    with world_with(HOROVOD_EAGER_CACHE=cache):
        trainer = lm_trainer(device)
        log = LossLog()
        reset_launch_counts()
        trainer.fit([tokens], 1, CTL_STEPS, verbose=False, callbacks=[log])
        torch.cuda.synchronize()
        launches = launch_counts()
        plans = native_plans_equal(hstate.native_core(),
                                   list(trainer.model.parameters()))
        calls = negotiate.negotiator().store_calls
        del trainer
        free_cuda()
    return {"losses": log.losses, "launches": launches, "plans": plans,
            "store_calls": calls}


def ctl_tools(device) -> dict:
    """(c): the two tools at world 1 in child processes."""
    env = {k: v for k, v in os.environ.items() if not k.startswith(
        "HOROVOD_")}
    env["HOROVOD_TUNING_CACHE"] = os.path.join(HERE, CTL_DIR, "tuning.json")
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    kind = torch.cuda.get_device_name(device)
    runs = {
        "bench": ["allreduce_bench_torch.py", "--device", "cuda", "--smoke"],
        "predict": ["cost_model_torch.py", "predict", "16777216", "--world",
                    "8", "--device-kind", kind],
        "choose": ["cost_model_torch.py", "choose", "16777216", "--world",
                   "8", "--device-kind", kind],
        "threshold": ["cost_model_torch.py", "threshold", "--world", "8",
                      "--device-kind", kind],
    }
    out = {}
    for name, argv in runs.items():
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, os.path.join(HERE, "tools",
                                                         argv[0]),
                            *argv[1:]], env=env, cwd=HERE,
                           capture_output=True, text=True, timeout=600)
        rows = [json.loads(ln) for ln in r.stdout.splitlines()
                if ln.startswith("{")]
        if r.returncode != 0 or not rows:
            raise RuntimeError(f"phase 23 (c): {' '.join(argv)} exited "
                               f"{r.returncode}\n{r.stdout[-3000:]}\n"
                               f"{r.stderr[-3000:]}")
        out[name] = {"rows": rows, "seconds": time.perf_counter() - t0}
    busbw = [r for r in out["bench"]["rows"]
             if r["metric"] == "allreduce_busbw"]
    if not busbw or any(r["world"] != 1 or r["value"] != 0.0
                        or "note" not in r for r in busbw):
        raise RuntimeError(f"phase 23 (c): world-1 rows {busbw}")
    return out


INIT_DISTRIBUTED_CHILD = """
import json, sys, torch
import torch.distributed as dist
import horovod_tpu_torch as hvd
from horovod_tpu_torch.utils import distributed
distributed.init_distributed(sys.argv[1], 1, 0)
x = hvd.allreduce(torch.arange(4.0, device="cuda"), name="init_distributed",
                  average=False)
print(json.dumps({"sum": x.tolist(), "device": str(x.device),
                  "backend": dist.get_backend(), "size": hvd.size()}))
distributed.shutdown_distributed()
"""


def ctl_init_distributed() -> dict:
    """(d): ``init_distributed("127.0.0.1:<free port>", 1, 0)`` in a child
    process, one allreduce on the card."""
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if not k.startswith(
        "HOROVOD_") and k not in ("MASTER_ADDR", "MASTER_PORT", "RANK",
                                  "WORLD_SIZE")}
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", INIT_DISTRIBUTED_CHILD,
                        f"127.0.0.1:{port}"], env=env, cwd=HERE,
                       capture_output=True, text=True, timeout=300)
    rows = [json.loads(ln) for ln in r.stdout.splitlines()
            if ln.startswith("{")]
    if r.returncode != 0 or not rows or rows[0]["sum"] != [0.0, 1.0, 2.0,
                                                          3.0]:
        raise RuntimeError(f"phase 23 (d): the child exited {r.returncode}"
                           f"\n{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    return dict(rows[0], seconds=time.perf_counter() - t0)


def phase_control_plane(device) -> dict:
    """Phase 23: (a) the native core on the main path, (b) the verdict
    replay, (c) the tools at world 1, (d) init_distributed in a child."""
    t0 = time.perf_counter()
    os.makedirs(os.path.join(HERE, CTL_DIR), exist_ok=True)
    try:
        reinit()
        if hstate.native_core() is None:
            raise RuntimeError("phase 23: hvd.init loaded no native core")
        out = {"native": ctl_native_fit(device)}
        on = ctl_eager_arm(device, "1")
        off = ctl_eager_arm(device, "0")
        if not torch.equal(_bits(on["out"]), _bits(off["out"])):
            raise RuntimeError("phase 23 (b): the replayed and the "
                               "renegotiated allreduces differ")
        if on["store_calls"] != 0 or off["store_calls"] == 0:
            raise RuntimeError(f"phase 23 (b): store calls {on['store_calls']}"
                               f" replayed, {off['store_calls']} "
                               f"renegotiated")
        out["eager"] = {arm: {k: r[k] for k in ("store_calls", "ms")}
                        for arm, r in (("cached", on), ("renegotiated",
                                                        off))}
        lm = {arm: ctl_lm_arm(device, cache)
              for arm, cache in (("cached", "1"), ("renegotiated", "0"))}
        if not same_bits(lm["cached"]["losses"],
                         lm["renegotiated"]["losses"]):
            raise RuntimeError("phase 23 (b): the LM's losses differ with "
                               "and without the cache")
        out["lm"] = {arm: {"losses": [float(x) for x in r["losses"]],
                           "launches": r["launches"], "plans": r["plans"],
                           "store_calls": r["store_calls"]}
                     for arm, r in lm.items()}
        out["tools"] = ctl_tools(device)
        out["init_distributed"] = ctl_init_distributed()
    finally:
        shutil.rmtree(os.path.join(HERE, CTL_DIR), ignore_errors=True)
    counts = {"resnet50": out["native"]["launches"],
              **{f"lm_{arm}": r["launches"] for arm, r in out["lm"].items()}}
    for arm, c in counts.items():
        idle = sorted(k for k, v in c.items()
                      if v == 0 and (k in REPLAY_COUNTS["lm"])
                      == arm.startswith("lm"))
        if idle:
            raise RuntimeError(f"phase 23 ({arm}) never launched {idle}: {c}")
    out["launches"] = counts
    out["seconds"] = time.perf_counter() - t0
    return out


def control_plane_line(cp: dict, ident: str) -> str:
    nv, ea, lm, tl = cp["native"], cp["eager"], cp["lm"], cp["tools"]
    bench = [r for r in tl["bench"]["rows"]
             if r["metric"] == "allreduce_busbw"]
    pred = tl["predict"]["rows"][0]
    return (
        f"phase 23 control plane: ok; (a) native core loaded, ResNet-50 "
        f"fused BN {CTL_STEPS} steps under HOROVOD_TIMELINE on the native "
        f"writer: {nv['rounds']} rounds through the native table, "
        f"{nv['validation']['verdicts']} verdicts equal to validate_py's "
        f"(host µs a round: native {nv['validation']['native']:.1f}, "
        f"Python {nv['validation']['python']:.1f}), fusion plans equal to "
        f"plan_buckets_py's (ResNet-50's {nv['plans']['tensors']} tensors, "
        f"buckets by threshold {nv['plans']['buckets']}, host µs native "
        f"{nv['plans']['native_us']:.1f}, Python "
        f"{nv['plans']['python_us']:.1f}; the LM's "
        f"{lm['cached']['plans']['tensors']} tensors "
        f"{lm['cached']['plans']['buckets']}, native "
        f"{lm['cached']['plans']['native_us']:.1f}, Python "
        f"{lm['cached']['plans']['python_us']:.1f}), trace of "
        f"{nv['events']} events with {nv['neg_rows']} NEGOTIATE rows and "
        f"{nv['ticks']} ready ticks, launches {nv['launches']}; (b) "
        f"{CTL_EAGER_CALLS} named eager allreduces of 4 MiB bf16: replayed "
        f"{ea['cached']['ms']:.4f} ms a call with {ea['cached']['store_calls']}"
        f" store calls after the first, renegotiated "
        f"{ea['renegotiated']['ms']:.4f} ms with "
        f"{ea['renegotiated']['store_calls']}, bit-identical; the LM "
        f"({LM_LAYERS} layers, B={LM_BATCH} T={LM_T}) {CTL_STEPS} steps with "
        f"and without the cache: losses bit-identical "
        + ", ".join(f"{x:.4f}" for x in lm["cached"]["losses"])
        + f", store calls {lm['cached']['store_calls']} and "
        f"{lm['renegotiated']['store_calls']}, launches "
        f"{lm['cached']['launches']}; (c) allreduce_bench_torch.py --smoke "
        f"at world 1 (busbw 0 by its formula: no byte crosses a link): "
        + ", ".join(f"{r['bytes']} B {r.get('algo', 'flat')}"
                    f"{'/' + str(r['channels']) + 'ch' if 'channels' in r else ''}"
                    f" {r['time_us']} µs algbw {r['algbw_gbps']} GB/s"
                    for r in bench)
        + f" ({tl['bench']['seconds']:.1f} s); cost_model_torch.py on the "
        f"card's seeds, 16 MiB over 8: flat {pred['predicted_us_flat']} µs,"
        f" rs_ag {pred['predicted_us_rs_ag']} µs, chosen "
        f"{tl['choose']['rows'][0]['chosen_algo']}/"
        f"{tl['choose']['rows'][0]['chosen_channels']}ch, threshold "
        f"{tl['threshold']['rows'][0]['fusion_threshold_bytes']} B; (d) "
        f"init_distributed in a child: {cp['init_distributed']['backend']} "
        f"world {cp['init_distributed']['size']}, allreduce on "
        f"{cp['init_distributed']['device']} "
        f"({cp['init_distributed']['seconds']:.1f} s); phase "
        f"{cp['seconds']:.1f} s, on {ident}")


# -- phase 24: the analysis layer -------------------------------------------------

ANA_CALLS = 5   # (a): the eager call, the capture (and its replay), 3 replays
ANA_ARMS = {    # (a): arm -> the exchange settings of its trainer
    "flat": {"algo": "flat"},
    "rs_ag": {"algo": "rs_ag"},
    "channels2": {"channels": 2},
    "priority": {"schedule": "priority"},
    "zero3": {"sharding": "zero3"},
}
ANA_RANKS = 4   # (e): the gloo world whose rs_ag listings take the faults
ANA_HVD001 = """import horovod_tpu_torch as hvd


def metric_sync(metric):
    if hvd.rank() == 0:
        metric = hvd.allreduce(metric, name="metric")
    return metric
"""


def _rows(summary) -> str:
    return "[" + ", ".join(
        f"{op} {et} {n} {g}x{size}" for op, et, n, g, size, _ in summary) + "]"


def ana_lm_arm(model, init, tokens, arm: str) -> dict:
    """(a): phase 8's LM under ``arm`` from the weights ``init``: ANA_CALLS
    calls of the trainer's captured step, whose capture records its wire;
    B3, B4 and A1 counted, the replays timed."""
    kw = ANA_ARMS[arm]
    for p, t in zip(model.parameters(), init):
        p.data = t.clone()
        p.grad = None
    cfg = lm_config(torch.bfloat16)
    loss_fn = transformer.make_loss_fn(cfg, fused_head=True)
    inner = AdamW(model.parameters(), 3e-4, weight_decay=0.1)
    if "sharding" in kw:
        trainer = hvd.Trainer(model, loss_fn, inner, sharding=kw["sharding"])
    else:
        trainer = hvd.Trainer(model, loss_fn,
                              hvd.DistributedOptimizer(inner, **kw))
    reset_launch_counts()
    losses, ms = _timed_steps(lambda b: trainer.train_step(b)[0], tokens,
                              ANA_CALLS)
    torch.cuda.synchronize()
    launches = {k: v for k, v in launch_counts().items()
                if k in REPLAY_COUNTS["lm"]}
    step = trainer._step
    if (step.runs, step.replays) != (2, ANA_CALLS - 1):
        raise RuntimeError(f"phase 24 (a) {arm}: runs {step.runs}, replays "
                           f"{step.replays}")
    for k, n in REPLAY_COUNTS["lm"].items():
        if launches[k] != n * ANA_CALLS:
            raise RuntimeError(f"phase 24 (a) {arm}: {k} launched "
                               f"{launches[k]} times in {ANA_CALLS} calls, "
                               f"expected {n} a call")
    out = {"losses": losses, "replay_ms": ms[2:], "launches": launches,
           "wire": step.wire, "plan": exchange.last_plan()}
    del trainer, step
    free_cuda()
    return out


def ana_recorded(device) -> dict:
    """(a): each arm built once; its recorded listing verified, its losses
    bit-identical to the flat arm's."""
    from horovod_tpu_torch.analysis import schedule

    cfg = lm_config(torch.bfloat16)
    model = transformer.init_params(cfg, seed=SEED, device=device)
    init = [p.detach().clone() for p in model.parameters()]
    tokens = transformer.synthetic_tokens(LM_BATCH, LM_T, cfg.vocab_size,
                                          seed=SEED, device=device)
    out = {}
    plain = None
    for arm, kw in ANA_ARMS.items():
        on = ana_lm_arm(model, init, tokens, arm)
        if on["wire"] is None:
            raise RuntimeError(f"phase 24 (a) {arm}: no wire recorded")
        plain = plain or on["losses"]
        if not same_bits(on["losses"], plain):
            raise RuntimeError(f"phase 24 (a) {arm}: losses differ from the "
                               f"flat arm's")
        sharding = kw.get("sharding")
        summary: list = []
        findings = schedule.verify_listings(
            [on["wire"]], algo=None if sharding else kw.get("algo", "flat"),
            path=f"<phase 24 {arm}>", sharding=sharding,
            fsdp_size=1 if sharding else None, summary=summary)
        if "algo" not in kw:
            plan = on["plan"]
            if plan is None:
                raise RuntimeError(f"phase 24 (a) {arm}: no exchange plan")
            findings += schedule.verify_exchange_artifact(
                plan.to_json(), f"<phase 24 {arm} plan>")
        if findings:
            raise RuntimeError(f"phase 24 (a) {arm}: "
                               + "; ".join(str(f) for f in findings))
        out[arm] = {"summary": summary,
                    "losses": [float(x) for x in on["losses"]],
                    "replay_ms": statistics.mean(on["replay_ms"]),
                    "launches": on["launches"]}
    del model, init
    free_cuda()
    return out


def ana_lints() -> dict:
    """(b): the lints over the port's sources, the tools and this script."""
    from horovod_tpu_torch.analysis import lints
    from horovod_tpu_torch.utils import env as henv

    t0 = time.perf_counter()
    files = sorted(
        [os.path.join(r, f) for r, _, fs in os.walk(os.path.join(
            HERE, "horovod_tpu_torch")) for f in fs if f.endswith(".py")]
        + [os.path.join(HERE, "tools", f)
           for f in os.listdir(os.path.join(HERE, "tools"))
           if f.endswith("_torch.py")]
        + [os.path.join(HERE, "chip_smoke.py")])
    findings = [f for path in files
                for f in lints.lint_file(path, known_env=henv.KNOWN_ENV_VARS)]
    if findings:
        raise RuntimeError("phase 24 (b): " + "; ".join(map(str, findings)))
    return {"files": len(files), "seconds": time.perf_counter() - t0}


def ana_model() -> dict:
    """(c): the protocol sweep at 2 and 3 processes, with and without the
    default faults, and the corpus worlds through the tool."""
    from horovod_tpu_torch.analysis import model, protocol

    t0 = time.perf_counter()
    worlds = states = 0
    for n in (2, 3):
        for spec in [None] + model.default_fault_specs(n):
            for world in model.standard_worlds(
                    n, protocol.parse_fault_spec(spec)):
                res = model.check_world(world)
                if res.findings:
                    raise RuntimeError(f"phase 24 (c) {world.label}: "
                                       + "; ".join(map(str, res.findings)))
                worlds += 1
                states += res.states
    sweep_s = time.perf_counter() - t0
    corpus = {}
    for name, rule in (("bad_protocol_deadlock", "HVD202"),
                       ("bad_split_brain", "HVD201"),
                       ("bad_stale_generation", "HVD205")):
        path = os.path.join(HERE, "tests", "lint_corpus",
                            f"{name}.world.json")
        r = subprocess.run([sys.executable, os.path.join(
            HERE, "tools", "hvd_model_torch.py"), path], cwd=HERE,
            capture_output=True, text=True, timeout=300)
        if r.returncode != 1 or f": {rule} " not in r.stdout:
            raise RuntimeError(f"phase 24 (c) {name}: exit {r.returncode}"
                               f"\n{r.stdout[-2000:]}\n{r.stderr[-2000:]}")
        corpus[name] = rule
    return {"worlds": worlds, "states": states, "sweep_s": sweep_s,
            "corpus": corpus}


def ana_rank_listing() -> list:
    """(e), one rank of the gloo world: the tiny LM step's rs_ag wire."""
    from horovod_tpu_torch.analysis import hlo, schedule

    hvd.init(device="cpu")
    fn, args = schedule.lm_step(algo="rs_ag", device="cpu")
    out = hlo.step_wire(fn, args)
    hvd.shutdown()
    return out


def ana_planted() -> dict:
    """(e): an rs_ag listing of ANA_RANKS gloo ranks verifies clean, and
    fails with one rank's instruction dropped (HVD103) and with its
    all-gather phase removed (HVD105); a rank-conditional allreduce in a
    source fails the lint (HVD001)."""
    from horovod_tpu_torch.analysis import lints, schedule

    listings = hvd.run(ana_rank_listing, ANA_RANKS, device="cpu")
    rules = {}
    clean = schedule.verify_listings(listings, algo="rs_ag")
    dropped = [list(x) for x in listings]
    del dropped[-1][0]
    no_ag = [[i for i in x if i.opcode != "all-gather"] for x in listings]
    for name, ls, want in (("dropped", dropped, "HVD103"),
                           ("no_all_gather", no_ag, "HVD105")):
        rules[name] = sorted({f.rule for f in schedule.verify_listings(
            ls, algo="rs_ag")})
        if want not in rules[name]:
            raise RuntimeError(f"phase 24 (e) {name}: {rules[name]}")
    rules["rank_conditional"] = sorted(
        {f.rule for f in lints.lint_source(ANA_HVD001, "<planted>")})
    if clean or "HVD001" not in rules["rank_conditional"]:
        raise RuntimeError(f"phase 24 (e): clean {clean}, {rules}")
    return {"rows": len(listings[0]), "rules": rules}


def phase_analysis(device) -> dict:
    """Phase 24: (a) the recorded schedules of the full-width LM step, (b)
    the lints, (c) the protocol sweep, (d) the fault drill's preflights,
    (e) planted faults."""
    import fault_drill_torch

    t0 = time.perf_counter()
    reinit()
    out = {"recorded": ana_recorded(device)}
    out["a_s"] = time.perf_counter() - t0
    out["lints"] = ana_lints()
    out["model"] = ana_model()
    t1 = time.perf_counter()
    try:
        fault_drill_torch.preflight_lint("cuda")
        out["drill_worlds"] = fault_drill_torch.preflight_model()
    except SystemExit as e:
        raise RuntimeError(f"phase 24 (d): {e}") from None
    out["drill_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    out["planted"] = ana_planted()
    out["planted_s"] = time.perf_counter() - t1
    out["seconds"] = time.perf_counter() - t0
    return out


def analysis_line(an: dict, ident: str) -> str:
    rec, li, mo, pl = (an["recorded"], an["lints"], an["model"],
                       an["planted"])
    return (
        f"phase 24 analysis: ok; (a) phase 8's LM ({LM_LAYERS} layers, "
        f"B={LM_BATCH} T={LM_T}, AdamW on A1) as a captured hvd.spmd "
        f"program at world 1, {ANA_CALLS} calls an arm, each arm built once: "
        f"losses bit-identical to the flat arm's, launches a call as phase "
        f"8; recorded listings verify with 0 findings (at world 1 types and "
        f"per-rank identity only; rs_ag and zero3 record no rows: launch-"
        f"count arms): " + "; ".join(
            f"{arm} {len(r['summary'])} rows {_rows(r['summary'])}, replay "
            f"wall ms {r['replay_ms']:.2f}, launches {r['launches']}"
            for arm, r in rec.items())
        + f" ({an['a_s']:.1f} s); (b) lints over {li['files']} files: 0 "
        f"findings ({li['seconds']:.2f} s); (c) protocol sweep at 2 and 3 "
        f"processes with and without the default faults: {mo['worlds']} "
        f"worlds, {mo['states']} states, clean ({mo['sweep_s']:.2f} s); "
        f"corpus worlds exit 1 with " + ", ".join(
            f"{k} {v}" for k, v in mo["corpus"].items())
        + f"; (d) the fault drill's preflights clean (the training step "
        f"recorded on the card at world 1, {an['drill_worlds']} model "
        f"worlds; {an['drill_s']:.1f} s); (e) the tiny LM's rs_ag listing "
        f"of {ANA_RANKS} gloo ranks ({pl['rows']} rows a rank) verifies "
        f"clean; planted: one instruction dropped "
        f"{pl['rules']['dropped']}, all-gather phase removed "
        f"{pl['rules']['no_all_gather']}, rank-conditional allreduce "
        f"{pl['rules']['rank_conditional']} ({an['planted_s']:.1f} s); "
        f"phase {an['seconds']:.1f} s, on {ident}")


# -- phase 25: serving's fault tools and the prefill/decode split -------------

RECOVERY_PROMPT = 32          # (b): bench_recovery's prompts and new tokens
RECOVERY_NEW = 16
SPLIT_REQUESTS = 4            # (c): requests, two rounds of two
SPLIT_PRIVATE = (16, 40, 24, 48)  # (c): private prompt tokens a request
SPLIT_NEW = 16
SPLIT_GRAPHS = {"prefill": {"prefill": 1, "first": 1},
                "decode": {"decode": 1},
                "unsplit": {"decode": 1, "prefill": 1, "first": 1}}


def split_prompts(vocab: int) -> list:
    """(c)'s prompts: a two-block shared prefix, then private tokens."""
    g = torch.Generator().manual_seed(SEED + 25)
    shared = torch.randint(0, vocab, (2 * SERVE_BLOCK,), generator=g)
    return [torch.cat([shared, torch.randint(0, vocab, (n,), generator=g)])
            .numpy().astype("int32") for n in SPLIT_PRIVATE]


def serve_rounds(decode, prompts, wipe=None) -> dict:
    """Serve ``prompts`` in two rounds; ``wipe`` (the prefill engine) is
    zeroed between them and the decode engine told so. Returns each
    request's output by id."""
    outputs, half = {}, len(prompts) // 2
    for r, batch in enumerate((prompts[:half], prompts[half:])):
        if r and wipe is not None:
            for pool in wipe._pools:
                pool.zero_()
            decode._remote_valid.clear()
        for p in batch:
            decode.submit(p, SPLIT_NEW)
        for done in decode.run_until_idle():
            outputs[done.request_id] = list(done.output)
    return outputs


def split_halves(cfg, model, device) -> dict:
    """(c): the split's two halves on one card against the unsplit
    engine."""
    from horovod_tpu_torch.serving import engine as serving_engine

    prompts = split_prompts(cfg.vocab_size)
    kw = dict(block_size=SERVE_BLOCK, max_batch=2, prefix_cache=True,
              max_prompt_len=max(map(len, prompts)) + SPLIT_NEW,
              device=device)
    unsplit = serving.Engine(cfg, model, **kw)
    want = serve_rounds(unsplit, prompts)
    prefill = serving.Engine(cfg, model, **kw)
    decode = serving.Engine(cfg, model, **kw)
    serving_engine.loopback_split(prefill, decode)
    t0 = time.perf_counter()
    got = serve_rounds(decode, prompts, wipe=prefill)
    torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    if got != want:
        differ = sorted(k for k in want if got.get(k) != want[k])
        raise RuntimeError(f"phase 25 (c): the split's halves differ from "
                           f"the unsplit engine at requests {differ}")
    captures = {"prefill": dict(prefill._captures),
                "decode": dict(decode._captures),
                "unsplit": dict(unsplit._captures)}
    if captures != SPLIT_GRAPHS:
        raise RuntimeError(f"phase 25 (c): captures {captures}, wanted "
                           f"{SPLIT_GRAPHS}")
    st, pst = decode.split_stats, prefill.split_stats
    swapped = dict(pst, bytes_sent=pst["bytes_received"],
                   bytes_received=pst["bytes_sent"])
    if st["pages_shipped"] == 0 or swapped != st:
        raise RuntimeError(f"phase 25 (c): split stats {st} (decode) and "
                           f"{pst} (prefill)")
    return {"requests": len(got), "tokens": sum(map(len, got.values())),
            "stats": dict(st), "seconds": seconds,
            "bytes_per_admission": (st["bytes_sent"] + st["bytes_received"])
            / st["admissions"],
            "prefix_hits": decode.stats["prefix_hit_tokens"],
            "replays": {k: dict(e._replays) for k, e in (
                ("prefill", prefill), ("decode", decode))}}


def phase_serve_split(device) -> dict:
    """Phase 25: (a) the drill's serve scenario on the card, (b)
    ``bench_recovery`` at phase 9's LM, (c) the split's two halves."""
    import tempfile

    import fault_drill_torch

    t0 = time.perf_counter()
    reset_launch_counts()
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as td:
        try:
            out["drill"] = fault_drill_torch.scenario_serve("cuda", td)
        except AssertionError as e:
            raise RuntimeError(f"phase 25 (a): {e}") from None
        out["drill_s"] = time.perf_counter() - t0
        cfg = serve_config()
        model = transformer.init_params(cfg, seed=SEED, device=device)
        t1 = time.perf_counter()
        rec = serve_bench_torch.bench_recovery(
            cfg, model, os.path.join(td, "recovery.journal.json"),
            prompt_len=RECOVERY_PROMPT, max_new=RECOVERY_NEW,
            block_size=SERVE_BLOCK, seed=SEED, device=device)
        if not rec["bit_identical"] or rec["recovered"] < 1:
            raise RuntimeError(f"phase 25 (b): bench_recovery {rec}")
        out["recovery"] = rec
        out["recovery_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    out["split"] = split_halves(cfg, model, device)
    out["split_s"] = time.perf_counter() - t1
    del model
    free_cuda()
    launched = {k: v for k, v in launch_counts().items() if v}
    if launched:
        raise RuntimeError(f"phase 25: kernels of the port launched on a "
                           f"path none lies on: {launched}")
    out["seconds"] = time.perf_counter() - t0
    return out


def serve_split_line(ss: dict, ident: str) -> str:
    import fault_drill_torch

    dr, rec, sp = ss["drill"], ss["recovery"], ss["split"]
    st = sp["stats"]
    return (
        f"phase 25 serving faults and split: ok; (a) fault_drill_torch.py "
        f"--scenario serve --device cuda at the full-width LM cut to "
        f"{fault_drill_torch.SERVE_LAYERS} layers: engine_crash@step=4 exit 43, the "
        f"restart recovered {dr['recovered']} request(s) (recover() "
        f"{dr['recover_s'] * 1e3:.2f} ms) and all {len(dr['crcs'])} outputs "
        f"are CRC-identical to the uninterrupted child's; children "
        + ", ".join(f"{k} {v:.1f} s" for k, v in dr["children_s"].items())
        + f" ({ss['drill_s']:.1f} s); (b) bench_recovery at phase 9's LM "
        f"({LM_LAYERS} layers, bf16 pages, {rec['requests']} requests of "
        f"{RECOVERY_PROMPT}+{RECOVERY_NEW} tokens, abandoned after "
        f"{rec['interrupt_steps']} steps): recovered {rec['recovered']}, "
        f"bit_identical {rec['bit_identical']}, serve_recovery_ms "
        f"{rec['serve_recovery_ms']} ({ss['recovery_s']:.1f} s); (c) the "
        f"split's halves in one process ({sp['requests']} requests, "
        f"{sp['tokens']} tokens, {sp['prefix_hits']} prompt tokens from the "
        f"prefix cache, the prefill engine's pool zeroed between the rounds): "
        f"tokens equal the unsplit engine's; captures as {SPLIT_GRAPHS}; "
        f"{st['admissions']} admissions, {st['pages_written']} pages written "
        f"back, {st['pages_shipped']} shipped, {st['bytes_sent']} bytes sent "
        f"and {st['bytes_received']} received "
        f"({sp['bytes_per_admission']:.0f} a admission; replays "
        f"{sp['replays']}; {ss['split_s']:.1f} s); no kernel of the port "
        f"launched; phase {ss['seconds']:.1f} s, on {ident}")


# -- the exchange overlapped with backward (phase 26) -------------------------

OVERLAP_CALLS = 3                 # the eager call, the capture, one replay
OVERLAP_THRESHOLD = 16 << 20      # bytes: the LM's gradients in ~20 buckets
OVERLAP_BUDGET_S = 45.0


def overlap_arm(model, init, cfg, tokens, arm: str) -> dict:
    """Phase 8's LM (``model``, from the weights ``init``) through
    ``Trainer`` under ``schedule="priority"``: ``armed`` is the Trainer's
    own step (armed from its second call, the capture), ``unarmed`` the
    same step with gradients from ``torch.autograd.grad``
    (``overlap_torch.unoverlapped``: no hook fires, so ``step()`` issues
    every bucket after backward)."""
    with torch.no_grad():
        for p, t in zip(model.parameters(), init):
            p.copy_(t)
            p.grad = None
    opt = hvd.DistributedOptimizer(
        AdamW(model.parameters(), 3e-4, weight_decay=0.1),
        schedule="priority", fusion_threshold=OVERLAP_THRESHOLD)
    trainer = hvd.Trainer(model, transformer.make_loss_fn(cfg,
                                                          fused_head=True),
                          opt)
    run = (trainer.train_step if arm == "armed"
           else overlap_torch.unoverlapped(trainer))
    reset_launch_counts()
    losses, hooks, per_call = [], [], []
    for _ in range(OVERLAP_CALLS):
        before = (launch_counts(), opt.hooks_fired, opt.buckets_in_backward)
        out = run(tokens)
        losses.append((out[0] if isinstance(out, tuple) else out).clone())
        hooks.append((opt.hooks_fired - before[1],
                      opt.buckets_in_backward - before[2]))
        per_call.append({k: v - before[0].get(k, 0)
                         for k, v in launch_counts().items() if v})
    torch.cuda.synchronize()
    got = {"losses": [_bits(v).cpu() for v in losses],
           "loss_values": [float(v) for v in losses],
           "crc": overlap_torch.param_crc(model),
           "params": sum(1 for p in model.parameters() if p.requires_grad),
           "hooks": hooks, "replay_launches": per_call[-1],
           "launches": {k: v for k, v in launch_counts().items() if v},
           "buckets": len(opt._allreduce.plan.buckets)}
    del opt, trainer, run
    free_cuda()
    return got


def phase_overlap(device) -> dict:
    """Phase 26: the armed step's capture on one card. At world 1 the
    collective is the identity, so what this guards is the capture: the
    exchange stream (made in the capture, at the first armed step) forks
    from the capture stream in the hooks and joins it as backward ends;
    the replays' losses and parameters equal the unarmed
    arm's bit for bit after 3 calls; a replay still launches B3 and B4 8
    times and A1 once."""
    t0 = time.perf_counter()
    cfg = lm_config(torch.bfloat16)
    tokens = transformer.synthetic_tokens(LM_BATCH, LM_T, cfg.vocab_size,
                                          seed=SEED, device=device)
    model = transformer.init_params(cfg, seed=SEED, device=device)
    init = [p.detach().clone() for p in model.parameters()]
    arms = {arm: overlap_arm(model, init, cfg, tokens, arm)
            for arm in ("armed", "unarmed")}
    del model, init
    free_cuda()
    armed, unarmed = arms["armed"], arms["unarmed"]
    # The eager first call has no .grad to arm on; the capture is armed.
    if armed["hooks"][0] != (0, 0) or armed["hooks"][1][0] != armed["params"]:
        raise RuntimeError(
            f"phase 26: hooks a call {armed['hooks']}, expected none in the "
            f"eager call and {armed['params']} (one a parameter) in the "
            f"capture")
    if armed["hooks"][1][1] < 1:
        raise RuntimeError(
            f"phase 26: the capture issued no bucket from backward; under "
            f"priority the last layers' buckets go out during backward")
    if any(h != (0, 0) for h in unarmed["hooks"]):
        raise RuntimeError(f"phase 26: the unarmed arm took hooks "
                           f"{unarmed['hooks']}")
    same = all(torch.equal(a, b) for a, b in zip(armed["losses"],
                                                 unarmed["losses"]))
    if not same or armed["crc"] != unarmed["crc"]:
        raise RuntimeError(
            f"phase 26: the armed capture differs from the unarmed one: "
            f"losses {armed['loss_values']} vs {unarmed['loss_values']}, "
            f"parameter CRCs {armed['crc']:08x} vs {unarmed['crc']:08x}")
    for arm, r in arms.items():
        if r["replay_launches"] != REPLAY_COUNTS["lm"]:
            raise RuntimeError(
                f"phase 26 {arm}: a replay launched {r['replay_launches']}, "
                f"expected {REPLAY_COUNTS['lm']}")
    seconds = time.perf_counter() - t0
    if seconds > OVERLAP_BUDGET_S:
        raise RuntimeError(f"phase 26 took {seconds:.1f} s, over its "
                           f"{OVERLAP_BUDGET_S:.0f}-s budget")
    return {"arms": arms, "seconds": seconds}


def overlap_line(ov: dict, ident: str) -> str:
    a, u = ov["arms"]["armed"], ov["arms"]["unarmed"]
    return (
        f"phase 26 overlap: ok; phase 8's LM ({LM_LAYERS} layers, B="
        f"{LM_BATCH} T={LM_T}, bf16, AdamW on A1) through Trainer under "
        f"schedule=priority, fusion threshold {OVERLAP_THRESHOLD} bytes "
        f"({a['buckets']} buckets), world 1: the capture's defining pass "
        f"took {a['hooks'][1][0]} hooks (one a parameter) and issued "
        f"{a['hooks'][1][1]} buckets from backward (the exchange stream "
        f"while gradients were still owed) "
        f"(the eager first call, with no .grad yet, none); after "
        f"{OVERLAP_CALLS} calls the losses "
        + ", ".join(f"{v:.6f}" for v in a["loss_values"])
        + f" and the parameter CRC {a['crc']:08x} equal the unarmed "
        f"arm's (torch.autograd.grad, no hook) bit for bit; a replay "
        f"launches {a['replay_launches']} in both arms; launches over the "
        f"{OVERLAP_CALLS} calls: armed {a['launches']}, unarmed "
        f"{u['launches']}; phase {ov['seconds']:.1f} s (budget "
        f"{OVERLAP_BUDGET_S:.0f} s), on {ident}")


# -- the sharded modes' exchange overlapped with compute (phase 27) -----------

SHARDED_OVERLAP_CALLS = 3         # the eager call, the capture, one replay
SHARDED_OVERLAP_BUDGET_S = 40.0
SHARDED_OVERLAP_MODES = ("zero2", "zero3")


def sharded_overlap_arm(model, init, cfg, tokens, mode: str,
                        arm: str) -> dict:
    """Phase 8's LM (``model``, from the weights ``init``) through
    ``Trainer(sharding=mode)``: ``armed`` is the Trainer's own step (armed
    from its second call, the capture), ``unarmed`` the same step with
    nothing armed (``overlap_torch.unarmed``)."""
    with torch.no_grad():
        for p, t in zip(model.parameters(), init):
            p.data = t.clone()      # zero3 released the last arm's
            p.grad = None
    trainer = hvd.Trainer(model, transformer.make_loss_fn(cfg,
                                                          fused_head=True),
                          AdamW(model.parameters(), 3e-4, weight_decay=0.1),
                          sharding=mode)
    opt = trainer.optimizer
    run = (trainer.train_step if arm == "armed"
           else overlap_torch.unarmed(trainer))
    reset_launch_counts()
    losses, hooks, per_call = [], [], []
    for _ in range(SHARDED_OVERLAP_CALLS):
        before = (launch_counts(), opt.hooks_fired, opt.buckets_in_backward,
                  getattr(opt, "gather_waits", 0))
        out = run(tokens)
        losses.append((out[0] if isinstance(out, tuple) else out).clone())
        hooks.append((opt.hooks_fired - before[1],
                      opt.buckets_in_backward - before[2],
                      getattr(opt, "gather_waits", 0) - before[3]))
        per_call.append({k: v - before[0].get(k, 0)
                         for k, v in launch_counts().items() if v})
    torch.cuda.synchronize()
    got = {"losses": [_bits(v).cpu() for v in losses],
           "loss_values": [float(v) for v in losses],
           "crc": overlap_torch.param_crc(model, opt.shards),
           "params": len(opt.shards), "hooks": hooks,
           "replay_launches": per_call[-1],
           "launches": {k: v for k, v in launch_counts().items() if v}}
    del opt, trainer, run
    free_cuda()
    return got


def phase_sharded_overlap(device) -> dict:
    """Phase 27: the armed zero2 and zero3 steps' captures on one card. At
    world 1 every exchange is the identity, so what this guards is the
    capture: the exchange stream (zero2, zero3) and the gather stream
    (zero3) fork from the capture stream and join it; one hook a parameter
    in the capture and none in the eager call; one gather wait a
    parameter; the replays' losses, parameters and shards equal the
    unarmed arm's bit for bit after 3 calls; a replay still launches B3
    and B4 8 times and A1 once."""
    t0 = time.perf_counter()
    cfg = lm_config(torch.bfloat16)
    tokens = transformer.synthetic_tokens(LM_BATCH, LM_T, cfg.vocab_size,
                                          seed=SEED, device=device)
    model = transformer.init_params(cfg, seed=SEED, device=device)
    init = [p.detach().clone() for p in model.parameters()]
    runs = {mode: {arm: sharded_overlap_arm(model, init, cfg, tokens, mode,
                                            arm)
                   for arm in ("armed", "unarmed")}
            for mode in SHARDED_OVERLAP_MODES}
    del model, init
    free_cuda()
    for mode, arms in runs.items():
        armed, unarmed = arms["armed"], arms["unarmed"]
        n = armed["params"]
        waits = n if mode == "zero3" else 0
        if armed["hooks"][0] != (0, 0, 0) or armed["hooks"][1][0] != n \
                or armed["hooks"][1][2] != waits:
            raise RuntimeError(
                f"phase 27 {mode}: (hooks, units from backward, gather "
                f"waits) a call {armed['hooks']}, expected none in the eager "
                f"call and {n} hooks (one a parameter) and {waits} waits in "
                f"the capture")
        if armed["hooks"][1][1] < 1:
            raise RuntimeError(f"phase 27 {mode}: the capture issued no "
                               f"reduce-scatter from backward")
        if any(h != (0, 0, 0) for h in unarmed["hooks"]):
            raise RuntimeError(f"phase 27 {mode}: the unarmed arm took "
                               f"hooks or waits {unarmed['hooks']}")
        same = all(torch.equal(a, b) for a, b in zip(armed["losses"],
                                                     unarmed["losses"]))
        if not same or armed["crc"] != unarmed["crc"]:
            raise RuntimeError(
                f"phase 27 {mode}: the armed capture differs from the "
                f"unarmed one: losses {armed['loss_values']} vs "
                f"{unarmed['loss_values']}, CRCs {armed['crc']:08x} vs "
                f"{unarmed['crc']:08x}")
        for arm, r in arms.items():
            if r["replay_launches"] != REPLAY_COUNTS["lm"]:
                raise RuntimeError(
                    f"phase 27 {mode} {arm}: a replay launched "
                    f"{r['replay_launches']}, expected {REPLAY_COUNTS['lm']}")
    seconds = time.perf_counter() - t0
    if seconds > SHARDED_OVERLAP_BUDGET_S:
        raise RuntimeError(f"phase 27 took {seconds:.1f} s, over its "
                           f"{SHARDED_OVERLAP_BUDGET_S:.0f}-s budget")
    return {"runs": runs, "seconds": seconds}


def sharded_overlap_line(so: dict, ident: str) -> str:
    def mode_text(mode, arms):
        a, u = arms["armed"], arms["unarmed"]
        return (
            f"{mode}: the capture's defining pass took {a['hooks'][1][0]} "
            f"hooks (one a parameter) and issued {a['hooks'][1][1]} "
            f"reduce-scatter units from backward (forked to the exchange "
            f"stream while gradients were still owed, joined as backward "
            f"ended)"
            + (f" and waited {a['hooks'][1][2]} times for a gather (the "
               f"gather stream forked before the forward, each event "
               f"waited for at the parameter's first read)"
               if mode == "zero3" else "")
            + f" (the eager first call none); after "
            f"{SHARDED_OVERLAP_CALLS} calls the losses "
            + ", ".join(f"{v:.6f}" for v in a["loss_values"])
            + f" and the CRC {a['crc']:08x} of the parameters and shards "
            f"equal the unarmed arm's (nothing armed, no hook, no wait) "
            f"bit for bit; a replay launches {a['replay_launches']} in both "
            f"arms; launches over the {SHARDED_OVERLAP_CALLS} calls: armed "
            f"{a['launches']}, unarmed {u['launches']}")

    return (
        f"phase 27 sharded overlap: ok; phase 8's LM ({LM_LAYERS} layers, "
        f"B={LM_BATCH} T={LM_T}, bf16, AdamW on A1 over the shards) through "
        f"Trainer(sharding=zero2|zero3), world 1 (fsdp 1: each reduce-"
        f"scatter and gather the identity, zero3's gather a copy on the "
        f"gather stream); "
        + "; ".join(mode_text(m, r) for m, r in so["runs"].items())
        + f"; phase {so['seconds']:.1f} s (budget "
        f"{SHARDED_OVERLAP_BUDGET_S:.0f} s), on {ident}")


# -- phase 28: kernel A2, the fused head's logit tiles -------------------------

CE_SHAPE = (16_382, 1_024, 32_768, 8_192)  # N, E, V, chunk: the LM's head
CE_LOSS_TOL = 2e-6         # relative: the sums of exp in another order
CE_GRAD_TOL = 2.0 ** -7    # of the largest entry: one bf16 ulp bounds it
CE_HEAD_REPS = 5           # (c): head calls timed a side
CE_BUDGET_S = 30.0


def ce_head_call(x, w, t, chunk):
    """One forward and backward of the fused head: (loss, dx, dW)."""
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    loss = xent.fused_cross_entropy(xg, wg, t, chunk)
    loss.backward()
    return loss.detach(), xg.grad, wg.grad


def phase_ce_head(device) -> dict:
    """Phase 28: A2 (``csrc/ce_head.cu``) at the LM's head, (a) against the
    plain versions, (b) rerun bit for bit and counted 4 + 4, (c) each kernel
    a chunk timed (dirty-L2 flush) beside its byte bound, its plain version
    and, for the forward, ``torch.logsumexp`` over the tile, and the whole
    head's forward and backward with A2 and with the plain versions."""
    t0 = time.perf_counter()
    n, e, v, chunk = CE_SHAPE
    g = torch.Generator(device=device).manual_seed(SEED)
    x = torch.randn(n, e, generator=g, device=device).bfloat16()
    w = (torch.randn(e, v, generator=g, device=device) * e ** -0.5).bfloat16()
    t = torch.randint(0, v, (n,), generator=g, device=device)
    xent.reset_launch_counts()
    got = ce_head_call(x, w, t, chunk)
    torch.cuda.synchronize()
    launches = dict(xent.LAUNCHES)
    again = ce_head_call(x, w, t, chunk)
    with xent.plain_chunks():
        want = ce_head_call(x, w, t, chunk)
    torch.cuda.synchronize()
    out = {
        "launches": launches,
        "identical": all(torch.equal(a, b) for a, b in zip(got, again)),
        "loss": want[0].item(),
        "loss_rel": abs(got[0].item() - want[0].item()) / abs(
            want[0].item())}
    for name, a, b in (("dx", got[1], want[1]), ("dw", got[2], want[2])):
        out[f"{name}_err"] = ((a.float() - b.float()).abs().max()
                              / b.float().abs().max()).item()
    bad = []
    if launches != {"ce_chunk_fwd": LM_CHUNKS, "ce_chunk_bwd": LM_CHUNKS}:
        bad.append(f"launches {launches}, expected {LM_CHUNKS} + "
                   f"{LM_CHUNKS}")
    if not out["identical"]:
        bad.append("a rerun gave other bits")
    if not out["loss_rel"] <= CE_LOSS_TOL:
        bad.append(f"loss rel err {out['loss_rel']:.3e}")
    for name in ("dx", "dw"):
        if not out[f"{name}_err"] <= CE_GRAD_TOL:
            bad.append(f"{name} err {out[f'{name}_err']:.3e}")
    if bad:
        raise RuntimeError("phase 28: A2 against the plain versions: "
                           + "; ".join(bad))
    del got, again, want

    # (c) One chunk at the LM's shape, against the full rows' LSE.
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=device)
    logits = xent._mm_f32(x, w[:, :chunk])
    lse = torch.logsumexp(xent._mm_f32(x, w), -1)
    scale = torch.full((), 1.0 / n, device=device)
    m = torch.full((n,), float("-inf"), device=device)
    s, tl = torch.zeros(n, device=device), torch.zeros(n, device=device)
    tile = n * chunk * 4
    runs = {
        "ce_chunk_fwd": (
            lambda: xent.fold_kernel(m, s, tl, logits, t, 0),
            lambda: xent.fold_plain(m, s, tl, logits, t, 0),
            lambda: torch.logsumexp(logits, -1),
            tile + n * (8 + 8 + 12)),  # targets, m and s; m, s and tl
        "ce_chunk_bwd": (
            lambda: xent.dlogits_kernel(logits, t, 0, lse, scale,
                                          torch.bfloat16),
            lambda: xent.dlogits_plain(logits, t, 0, lse, scale,
                                         torch.bfloat16),
            None,
            tile + n * chunk * 2 + n * (8 + 4) + 4),  # targets, lse, scale
    }
    out["kernels"] = {}
    for name, (kernel, plain, library, nbytes) in runs.items():
        times = cuda_times(kernel, flush)
        rec = {"ms": sum(times) / len(times),
               "ms_median": statistics.median(times),
               "plain_ms": cuda_time_ms(plain, flush),
               "library_ms": (cuda_time_ms(library, flush)
                              if library is not None else None),
               "bytes": nbytes,
               "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
               "bound_by": "bytes"}
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        out["kernels"][name] = rec
    del logits, lse
    free_cuda()
    for side in ("a2", "plain"):
        with xent.plain_chunks() if side == "plain" else contextlib.nullcontext():
            out[f"head_{side}_ms"] = statistics.median(cuda_times(
                lambda: ce_head_call(x, w, t, chunk), flush,
                reps=CE_HEAD_REPS))
    out["seconds"] = time.perf_counter() - t0
    if out["seconds"] > CE_BUDGET_S:
        raise RuntimeError(f"phase 28 took {out['seconds']:.1f} s (budget "
                           f"{CE_BUDGET_S:.0f} s)")
    return out


def ce_head_line(ce: dict, ident: str) -> str:
    n, e, v, chunk = CE_SHAPE
    return (
        f"phase 28 fused head (A2): ok; N={n} E={e} V={v} chunk {chunk}, "
        f"bf16: A2 against the plain versions: loss {ce['loss']:.6f}, rel "
        f"err {ce['loss_rel']:.2e} (limit {CE_LOSS_TOL}), dx "
        f"{ce['dx_err']:.2e} and dW {ce['dw_err']:.2e} of the largest entry "
        f"(limit {CE_GRAD_TOL}); rerun bit-identical; launches "
        f"{ce['launches']}; per chunk: " + "; ".join(
            f"{k} {r['ms']:.4f} ms (median {r['ms_median']:.4f}), plain "
            f"{r['plain_ms']:.4f} ms"
            + (f", torch.logsumexp {r['library_ms']:.4f} ms"
               if r["library_ms"] is not None else "")
            + f", bound {r['bound_ms']:.4f} ms ({r['bytes']} bytes), "
            f"{100 * r['bound_share']:.1f}% of the bound"
            for k, r in ce["kernels"].items())
        + f"; the head's forward and backward (median of {CE_HEAD_REPS}): "
        f"A2 {ce['head_a2_ms']:.3f} ms, plain {ce['head_plain_ms']:.3f} ms; "
        f"phase {ce['seconds']:.1f} s (budget {CE_BUDGET_S:.0f} s), on "
        f"{ident}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs the port "
              "on a GPU.", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()

    ident = card_identity()
    say(ident)
    say(f"phase 1 card: {ident}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    libs = _build.build()
    say(f"phase 2 build: ok in {time.perf_counter() - t0:.1f} s: "
        f"{sorted(os.path.relpath(p, HERE) for p in libs.values())}")

    model = seeded_resnet50(torch.bfloat16, device)
    rec, distinct, worst_rel, worst_library_rel, fault_rel = phase_kernels(
        model, device)
    del model
    free_cuda()
    b1 = rec["channel_sums"]
    say(f"phase 3 kernels: ok at {len(distinct)} ResNet-50 shapes + 1 ragged, "
        f"bf16 and fp32, and B1 at {len(B1_EDGE_CASES)} edge cases in both "
        f"(each B1 run twice, bit-identical; one device kernel a call); "
        f"worst |kernel-plain|/sum|term| {worst_rel:.2e} (limit "
        f"{KERNEL_TOL}); B1 with one stage left out {fault_rel:.2e} "
        f"(caught); batch_norm_backward_reduce vs plain "
        f"{worst_library_rel:.2e} (limit {LIBRARY_TOL}); per step (53 "
        f"layers, bf16): " + "; ".join(
            f"{k} {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms (by "
            f"{r['bound_by']}), {100 * r['bound_ms'] / r['ms']:.1f}% of the "
            f"bound" for k, r in rec.items())
        + f"; B1 median {b1['ms_median']:.4f} ms, clean flush mean "
        f"{b1['ms_clean']:.4f} / median {b1['ms_clean_median']:.4f} ms "
        f"({100 * b1['bound_ms'] / b1['ms_clean']:.1f}% of the bound); "
        f"batch_norm_stats median {b1['library_ms_median']:.4f} ms, clean "
        f"flush mean {b1['library_ms_clean']:.4f} / median "
        f"{b1['library_ms_clean_median']:.4f} ms, on {ident}")

    cpu_loss, errs = phase_step_vs_cpu(device)
    say(f"phase 4 step vs cpu: ok; ResNet-50 224 px batch 2, CPU fp32 loss "
        f"{cpu_loss:.6f}; " + "; ".join(
            f"card {k}: loss rel err {e[0]:.2e}, gradient rel L2 err "
            f"{e[1]:.2e} (limits {lim}), worst tensor {e[2][1]} "
            f"{e[2][0]:.2e}" for (k, e), lim in zip(
                errs.items(), (STEP_FP32_TOL, STEP_BF16_TOL))))

    losses, launches, ips, steady = phase_main_path(device)
    say(f"phase 5 main path: ok; ResNet-50 bf16 fused BN batch {BATCH}, "
        f"{STEPS} steps; loss {losses[0]:.4f} -> {losses[-1]:.4f}; launches "
        f"{launches} ({BN_LAYERS} a step: the eager first call and "
        f"{STEPS - 1} replays); smoke throughput "
        f"{ips:.1f} images/s (steps 3-{STEPS}, mean step "
        f"{1e3 * sum(steady) / len(steady):.2f} ms) on {ident}; total "
        f"{time.perf_counter() - t_start:.0f} s")

    frec, f_worst, f_full, f_lib, f_faults = phase_flash_kernels(device)

    def row_errs(errs):
        return ", ".join(f"{n} {errs[n]:.2e}" for n in FLASH_OUTPUTS)

    say(f"phase 6 flash kernels: ok at {len(FLASH_CASES)} small shapes (every "
        f"masking mode, g_lse, fp32 operands, tile edges) and the LM's "
        f"{LM_ATTN_SHAPE} causal bf16, each run twice with bit-identical O, "
        f"LSE, dq, dk, dv; worst row err |kernel-plain|/|plain| (limit "
        f"{FLASH_ROW_TOL}): all cases {row_errs(f_worst)}; at the LM shape "
        f"{row_errs(f_full)}; worst lse err {f_worst['lse']:.2e} (limit "
        f"{LSE_TOL}); SDPA vs plain row err {f_lib:.2e} (limit "
        f"{LIBRARY_FLASH_TOL}); planted faults caught (row err, "
        f"max-normalized err): " + "; ".join(
            f"{where} {name} {r[0]:.2e}, {r[1]:.2e}"
            for where, fs in f_faults.items() for name, r in fs.items())
        + "; per call at the LM shape: " + "; ".join(
            f"{k} {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']:.4f} ms"
            + (f" (backward alone {r['library_bwd_ms']:.4f} ms)"
               if "library_bwd_ms" in r else "")
            + f", bound {r['bound_ms']:.4f} ms (by {r['bound_by']}), "
            f"{r['tflops']:.1f} TFLOP/s at the bound's operation count, "
            f"{100 * r['bound_share']:.1f}% of the bound"
            for k, r in frec.items()) + f", on {ident}")

    lm_cpu_loss, lm_errs = phase_lm_step_vs_cpu(device)
    say(f"phase 7 LM step vs cpu: ok; E=1024 H=8 Hkv=4 mlp 4096 V=32768, "
        f"{LM_STEP_LAYERS} layers, B=1 T={LM_STEP_T}, fused head; CPU fp32 "
        f"loss {lm_cpu_loss:.6f}; limits (loss, gradients, worst tensor) "
        f"fp32 {LM_STEP_FP32_TOL}, bf16 {LM_STEP_BF16_TOL}; " + "; ".join(
            f"card {k}: loss rel err {e[0]:.2e}, gradient rel L2 err "
            f"{e[1]:.2e}, worst tensor {e[2][1]} {e[2][0]:.2e}"
            for k, e in lm_errs.items()))

    (lm_losses, lm_launches, tps, lm_steady, n_params,
     peak_gib) = phase_lm_main_path(device)
    say(f"phase 8 LM main path: ok; {n_params / 1e6:.1f}M params, "
        f"{LM_LAYERS} layers, B={LM_BATCH} T={LM_T} bf16 fused head, "
        f"AdamW(3e-4, wd 0.1, bf16 moments), {STEPS} steps; loss "
        f"{lm_losses[0]:.4f} -> {lm_losses[-1]:.4f}; launches {lm_launches} "
        f"(flash {LM_LAYERS} a step each, A1 1 a step, A2 {LM_CHUNKS} + "
        f"{LM_CHUNKS} a step: the eager call and "
        f"{STEPS - 1} replays); smoke throughput "
        f"{tps:.1f} tokens/s "
        f"(steps 3-{STEPS}, mean step "
        f"{1e3 * sum(lm_steady) / len(lm_steady):.2f} ms), peak memory "
        f"{peak_gib:.1f} GiB, on {ident}; total "
        f"{time.perf_counter() - t_start:.0f} s")

    sv = phase_serving(device)
    n_same, differ, hits, n_tok = sv["batched"]
    pre_ids, n_pre, pre_same = sv["preempt"]
    load = sv["load"]

    def spread(rates):
        return (f"{statistics.median(rates):.1f} (min {min(rates):.1f}, max "
                f"{max(rates):.1f} over {len(rates)})")

    say(f"phase 9 serving: ok; bench.py's LM ({LM_LAYERS} layers, E=1024 "
        f"H=8 Hkv=4 mlp 4096 V=32768), bf16 weights and KV pages, block "
        f"{SERVE_BLOCK}, max_seq_len {SERVE_SEQ}; one-slot engine = "
        f"generate for {SERVE_B1[0]}+{SERVE_B1[1]} tokens, pool pages = "
        f"dense cache bit for bit; {SERVE_SLOTS} slots, {SERVE_REQUESTS} "
        f"requests ({n_tok} tokens, {hits} prompt tokens from the prefix "
        f"cache), pool invariants after every step, one decode and one "
        f"prefill capture (replays: " + ", ".join(
            f"{k} {v}" for k, v in sorted(sv["replays"].items()))
        + f"): {n_same}/{SERVE_REQUESTS} rows equal their "
        f"solo runs" + "".join(
            f"; row {i} differs first at step {k} (top-2 margin {m:.4f})"
            for i, k, m in differ)
        + f"; small pool: {n_pre} preemptions of requests {pre_ids}, each "
        f"equal to its solo run ({pre_same}/{SERVE_REQUESTS} rows equal); "
        f"int8_block pages: {100 * sv['int8']:.2f}% of tokens agree with "
        f"bf16; planted fault caught (tokens equal {sv['fault'][0]}, pages "
        f"equal {sv['fault'][1]}); teacher-forced decode vs the training "
        f"forward over {SERVE_B1[0]} positions: worst logits rel L2 err "
        f"{sv['forward'][0]:.3e} (limit {SERVE_FWD_TOL}), argmax agrees at "
        f"{100 * sv['forward'][1]:.1f}%; planted frontier fault "
        f"{sv['forward'][2]:.3e} (caught; argmax agrees at "
        f"{100 * sv['forward'][3]:.1f}%); decode tokens/s, median of "
        f"{SERVE_DECODE_STEPS}-step windows: B=1 {spread(sv['decode'][1])}, "
        f"B={SERVE_SLOTS} {spread(sv['decode'][SERVE_SLOTS])}; prefill "
        f"tokens/s ({SERVE_SLOTS} x {SERVE_PREFILL_PROMPT} a window) "
        f"{spread(sv['prefill'])}; open-loop "
        f"load ({SERVE_LOAD['n']} requests at {SERVE_LOAD['rate']}/s, "
        f"prompts {SERVE_LOAD['prompt_range']}, new "
        f"{SERVE_LOAD['output_range']}): p50 {load['serve_p50_ms']:.1f} ms, "
        f"max of {load['completed']} {load['serve_max_ms']:.1f} ms (too "
        f"few for a p99), {load['gen_tokens_per_sec']:.1f}"
        f" tokens/s; peak memory {sv['peak_gib']:.2f} GiB; phase "
        f"{sv['seconds']:.1f} s (no kernel of the port launched), on "
        f"{ident}; total "
        f"{time.perf_counter() - t_start:.0f} s")

    ck = phase_checkpoint(device)

    def drill(r):
        return (f"latest_epoch {r['latest']} with the warning \"{r['torn']}\"; "
                f"resumed at epoch {CKPT_TORN}, {r['tensors']} state tensors "
                f"equal bit for bit, first resumed loss {r['loss']:.6f} "
                f"equal to run A's; saves "
                + ", ".join(f"{t:.2f}" for t in r["save_s"])
                + f" s, resume {r['load_s']:.2f} s, checkpoint "
                f"{r['bytes']} bytes")

    say(f"phase 10 checkpoint: ok; {CKPT_EPOCHS} epochs of {CKPT_STEPS} "
        f"steps under HOROVOD_FAULT_INJECT=torn_write@epoch={CKPT_TORN}, "
        f"then fit(resume=) from seed {SEED + 1}; ResNet-50 (bf16, batch "
        f"{BATCH}, SGD): {drill(ck['resnet50'])}; LM ({LM_LAYERS} layers, "
        f"B={LM_BATCH} T={LM_T}, AdamW): {drill(ck['lm'])}; launches "
        f"{ck['launches']}; on {ident}; total "
        f"{time.perf_counter() - t_start:.0f} s")

    a1 = phase_adamw(device)
    ab = a1["lm_ab"]
    say(f"phase 11 adamw (A1): ok; vs plain (limits: parameters "
        f"{A1_UPD_TOL} of the update + one rounding, moments one ulp, "
        f"steps equal), each run twice, bit-identical: " + "; ".join(
            f"{k}: parameters {e['p_share']:.3f} of the limit, moments "
            f"{e['moment_ulps']:.1f} ulp, max |err| {e['max_abs_err']:.3e}"
            for k, e in a1["cases"].items())
        + f"; planted fault (one chunk left out) caught: parameters "
        f"{a1['fault']['p_share']:.3g} of the limit, steps equal "
        f"{a1['fault']['steps_equal']}; at the LM's {a1['params']} "
        f"parameters in {a1['tensors']} tensors, one launch: "
        f"{a1['ms']:.4f} ms, bound {a1['bound_ms']:.4f} ms "
        f"({a1['bytes']} bytes), {100 * a1['bound_ms'] / a1['ms']:.1f}% of "
        f"the bound; plain {a1['plain_ms']:.4f} ms; torch.optim.AdamW("
        f"fused=True), fp32 moments (not the same function) "
        f"{a1['nearest_library_ms']:.4f} ms; LM step tokens/s "
        f"(A1, plain, plain, A1; {LM_AB_STEPS} steps each): A1 "
        + ", ".join(f"{v:.1f}" for v in ab["a1"]) + "; plain "
        + ", ".join(f"{v:.1f}" for v in ab["plain"])
        + f"; on {ident}; total {time.perf_counter() - t_start:.0f} s")

    kernels = []
    for name, source, replaces, r, n in (
            ("channel_sums", "bn_sums.cu", "batchnorm.py:53", rec,
             launches),
            ("channel_grad_sums", "batchnorm.cu", "batchnorm.py:115", rec,
             launches),
            ("flash_fwd", "flash_fwd.cu", "flash_attention.py:234",
             frec, lm_launches),
            ("flash_bwd", "flash_bwd.cu", "flash_attention.py:447",
             frec, lm_launches),
            ("adamw", "adamw.cu", "optim.py:67", {"adamw": a1},
             lm_launches)):
        r = r[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"horovod_tpu_torch/csrc/{source}",
            "replaces": f"horovod_tpu/ops/{replaces}",
            "launches": n[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms")})
        kernels[-1].update({k: v for k, v in r.items()
                            if k.startswith(("ms_", "library_ms_"))
                            or k in ("library_bwd_ms",
                                     "nearest_library_ms")})
    for name, line in (("ce_chunk_fwd", 90), ("ce_chunk_bwd", 167)):
        # A2: launches from phase 8's main path; times from phase 28.
        kernels.append({
            "name": name, "route": "cuda",
            "source": "horovod_tpu_torch/csrc/ce_head.cu",
            "replaces": f"horovod_tpu/ops/losses.py:{line}",
            "launches": lm_launches[name], "max_abs_err": None})
    cs = phase_captured_step(device)
    say(captured_step_line(cs, ident) + f"; total "
        f"{time.perf_counter() - t_start:.0f} s")

    sg = phase_serving_graphs(device)
    say(serving_graphs_line(sg, ident) + f"; total "
        f"{time.perf_counter() - t_start:.0f} s")

    ex = phase_examples(device)
    say(examples_line(ex, ident) + f"; total "
        f"{time.perf_counter() - t_start:.0f} s")

    sp = phase_sparse(device)
    say(sparse_line(sp, ident) + f"; total "
        f"{time.perf_counter() - t_start:.0f} s")

    wr = phase_wire(device)
    lines = wire_lines(wr, ident)
    say(lines[0] + f"; total {time.perf_counter() - t_start:.0f} s")
    for line in lines[1:]:
        say(line)

    pl = phase_planner(device)
    say(planner_line(pl, ident) + f"; total "
        f"{time.perf_counter() - t_start:.0f} s")

    zr = phase_zero(device)
    say(zero_line(zr, ident) + f"; total "
        f"{time.perf_counter() - t_start:.0f} s")
    for k in kernels:
        runs = zr["lm"] if k["name"] in REPLAY_COUNTS["lm"] \
            else zr["resnet50"]
        k["launches_phase18"] = {arm: r["launches"][k["name"]]
                                 for arm, r in runs.items()}

    sq = phase_sequence(device, lm_losses[0])
    say(sequence_line(sq, ident) + f"; total "
        f"{time.perf_counter() - t_start:.0f} s")
    for k in kernels:
        if k["name"] in ("flash_fwd", "flash_bwd", "adamw"):
            k["launches_phase19"] = {arm: r["launches"][k["name"]]
                                     for arm, r in sq["lm"].items()}

    pr = phase_parallel(device)
    say(parallel_line(pr, ident) + f"; total "
        f"{time.perf_counter() - t_start:.0f} s")
    for k in kernels:
        if k["name"] in ("flash_fwd", "flash_bwd", "adamw"):
            k["launches_phase20"] = {
                **{f"tp_replay_{tp}": pr["tp_replay"][tp]["launches"].get(
                    k["name"], 0) for tp in TP_DEGREES},
                "tp_transformer": pr["tp_transformer"]["launches"][k["name"]],
                "moe_transformer": pr["moe_transformer"]["launches"][
                    k["name"]],
                "gpipe": pr["pipeline"]["gpipe_launches"].get(k["name"], 0),
                "1f1b": pr["pipeline"]["1f1b_launches"].get(k["name"], 0)}

    tn = phase_tuning(device)
    say(tuning_line(tn, ident) + f"; total "
        f"{time.perf_counter() - t_start:.0f} s")
    for k in kernels:
        for name, r in tn["timeline"].items():
            if k["name"] in r["counts"]:
                k["launches_phase21"] = r["counts"][k["name"]]

    rs = phase_resilience(device)
    say(resilience_line(rs, ident) + f"; total "
        f"{time.perf_counter() - t_start:.0f} s")
    for k in kernels:
        k["launches_phase22"] = {
            arm: counts[k["name"]] for arm, counts in {
                **rs["kv"]["launches"],
                **rs["liveness"]["launches"]}.items()}

    cp = phase_control_plane(device)
    say(control_plane_line(cp, ident) + f"; total "
        f"{time.perf_counter() - t_start:.0f} s")
    for k in kernels:
        k["launches_phase23"] = {arm: counts[k["name"]]
                                 for arm, counts in cp["launches"].items()}

    an = phase_analysis(device)
    say(analysis_line(an, ident) + f"; total "
        f"{time.perf_counter() - t_start:.0f} s")
    for k in kernels:
        if k["name"] in REPLAY_COUNTS["lm"]:
            k["launches_phase24"] = {
                arm: r["launches"][k["name"]]
                for arm, r in an["recorded"].items()}

    ss = phase_serve_split(device)
    say(serve_split_line(ss, ident) + f"; total "
        f"{time.perf_counter() - t_start:.0f} s")

    ov = phase_overlap(device)
    say(overlap_line(ov, ident) + f"; total "
        f"{time.perf_counter() - t_start:.0f} s")
    for k in kernels:
        if k["name"] in REPLAY_COUNTS["lm"]:
            k["launches_phase26"] = {
                arm: r["launches"][k["name"]]
                for arm, r in ov["arms"].items()}

    so = phase_sharded_overlap(device)
    say(sharded_overlap_line(so, ident) + f"; total "
        f"{time.perf_counter() - t_start:.0f} s")
    for k in kernels:
        if k["name"] in REPLAY_COUNTS["lm"]:
            k["launches_phase27"] = {
                f"{mode}/{arm}": r["launches"][k["name"]]
                for mode, arms in so["runs"].items()
                for arm, r in arms.items()}

    ce = phase_ce_head(device)
    say(ce_head_line(ce, ident) + f"; total "
        f"{time.perf_counter() - t_start:.0f} s")
    for k in kernels:
        r = ce["kernels"].get(k["name"])
        if r is not None:
            k.update({f: r[f] for f in ("ms", "ms_median", "plain_ms",
                                        "bound_ms", "bound_by",
                                        "library_ms")})
            k["launches_phase28"] = ce["launches"][k["name"]]

    say(json.dumps({"kernels": kernels}))
    hvd.shutdown()
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--resilience-child":
        sys.exit(resilience_child(sys.argv[2], sys.argv[3]))
    sys.exit(main())
