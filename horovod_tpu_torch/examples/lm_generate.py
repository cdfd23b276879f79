"""Train a tiny LM data-parallel, then generate from it and serve it — the
reference's ``examples/lm_generate.py``: ``DistributedOptimizer`` over
``training.adam`` (kernel A1 on the card) in one ``hvd.spmd`` step, a
rank-0 checkpoint, a restore into a single replica, autoregressive
generation with the KV cache (``transformer.generate``), then the same
checkpoint served by the continuous-batching ``serving.Engine``, whose
every request must equal ``generate`` token for token.

The corpus is a repeating pattern, so a CI-sized run visibly learns it.

Run:  python -m horovod_tpu_torch.examples.lm_generate [--steps 300]
          [--speculate 3] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import serving, training
from horovod_tpu_torch.models import transformer


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--seq-len", type=int, default=32)
    parser.add_argument("--batch-size", type=int, default=4)
    parser.add_argument("--embed-dim", type=int, default=64)
    parser.add_argument("--num-heads", type=int, default=4)
    parser.add_argument("--num-kv-heads", type=int, default=2)
    parser.add_argument("--max-new", type=int, default=24)
    parser.add_argument("--serve-batch", type=int, default=6,
                        help="concurrent requests for the serving-engine "
                             "demo after training")
    parser.add_argument("--speculate", type=int, default=0,
                        help="draft tokens per speculative step for the "
                             "serving demo (0 = plain decode; the draft "
                             "is the target model itself, so every "
                             "proposal is accepted and the output stays "
                             "bit-identical to generate)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)
    if args.speculate < 0:
        parser.error("--speculate must be >= 0")

    hvd.init(device=args.device)
    dev = hvd.device()
    cfg = transformer.TransformerConfig(
        vocab_size=64, num_layers=2, num_heads=args.num_heads,
        num_kv_heads=args.num_kv_heads, embed_dim=args.embed_dim,
        mlp_dim=2 * args.embed_dim, max_seq_len=2 * args.seq_len,
        dtype=torch.float32)
    model = transformer.init_params(cfg, device=dev)
    loss_fn = transformer.make_loss_fn(cfg)
    opt = hvd.DistributedOptimizer(training.adam(5e-3)(model.parameters()))

    pattern = np.tile(np.arange(8, dtype=np.int64),
                      -(-args.seq_len // 8))[:args.seq_len]
    batch = torch.from_numpy(pattern)[None].expand(
        args.batch_size, args.seq_len).contiguous().to(dev)

    @hvd.spmd
    def step(toks):
        opt.zero_grad(set_to_none=False)
        loss = loss_fn(model, toks)
        loss.backward()
        opt.step()
        return hvd.allreduce(loss.detach(), name="lm_generate.loss")

    hvd.broadcast_global_variables(model, root_rank=0)
    losses = []
    for it in range(args.steps):
        losses.append(step(batch))
        if it % 50 == 0 and hvd.rank() == 0:
            print(f"step {it}: loss = {float(losses[-1]):.4f}")
    out = {"losses": [float(v) for v in losses], "runs": step.runs,
           "replays": step.replays}
    if hvd.rank() != 0:
        return out

    # Rank-0 checkpoint -> restore into a single replica -> serve.
    ckdir = os.path.join(tempfile.mkdtemp(), "lm")
    training.checkpoint.save(ckdir, {"model": model.state_dict()}, epoch=1)
    single = transformer.init_params(cfg, seed=1, device=dev)
    single.load_state_dict(training.checkpoint.load(ckdir)["model"])

    prompt = torch.from_numpy(pattern[None, :8])
    gen = transformer.generate(cfg, single, prompt,
                               max_new_tokens=args.max_new,
                               device=dev)[0, 8:].cpu().numpy()
    # The pattern is arange(8) tiled, so position 8+i holds (8+i) % 8.
    want = (8 + np.arange(args.max_new)) % 8
    acc = float((gen == want).mean())
    print(f"prompt:    {pattern[:8].tolist()}")
    print(f"generated: {gen.tolist()}")
    print(f"pattern accuracy: {acc:.2f}")

    # Serve the same checkpoint through the continuous-batching engine: a
    # handful of concurrent prompts with staggered lengths through the
    # paged KV cache, reporting the aggregate decode rate.
    engine = serving.Engine(
        cfg, single, max_batch=args.serve_batch,
        max_prompt_len=args.seq_len, speculate=args.speculate,
        draft_kv_dtype="model" if args.speculate else None, device=dev)
    prompts = [pattern[:3 + 2 * (i % 3)] for i in range(args.serve_batch)]
    reqs = [engine.submit(p, args.max_new, tenant=f"user{i % 2}")
            for i, p in enumerate(prompts)]
    engine.step()  # admit + prefill + first decode (captures here)
    t0 = time.monotonic()
    tok0 = engine.stats["tokens_generated"]
    engine.run_until_idle()
    dt = time.monotonic() - t0
    served = engine.stats["tokens_generated"] - tok0
    ok = sum(
        np.array_equal(
            r.full_sequence(),
            transformer.generate(cfg, single, r.orig_prompt[None],
                                 max_new_tokens=args.max_new,
                                 device=dev)[0].cpu().numpy())
        for r in reqs)
    spec = (f", speculate={args.speculate} "
            f"accept_rate={engine.spec_accept_rate:.2f}"
            if args.speculate else "")
    print(f"served {len(reqs)} concurrent requests "
          f"({ok}/{len(reqs)} bit-identical to generate): "
          f"{served / dt:.0f} tokens/sec aggregate decode{spec}")
    if ok != len(reqs):
        raise RuntimeError(
            f"lm_generate: {len(reqs) - ok} of {len(reqs)} served requests "
            f"differ from generate")
    out.update(accuracy=acc, served_equal=ok, requests=len(reqs),
               tokens_per_sec=served / dt,
               accept_rate=engine.spec_accept_rate)
    return out


if __name__ == "__main__":
    main()
