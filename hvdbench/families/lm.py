"""The ``lm`` family on the program's side: the port's causal LM with its
fused cross-entropy head, the port's AdamW (kernel A1), the cell's token
batches and its counts."""

from __future__ import annotations

import torch

from hvdbench import work

UNIT = "tokens"


def _port_config(cfg: dict):
    from horovod_tpu_torch.models import transformer

    return transformer.TransformerConfig(
        vocab_size=cfg["vocab_size"], num_layers=cfg["num_layers"],
        num_heads=cfg["num_heads"], num_kv_heads=cfg["num_kv_heads"],
        embed_dim=cfg["embed_dim"], mlp_dim=cfg["mlp_dim"],
        max_seq_len=cfg["max_seq_len"], dtype=getattr(torch, cfg["dtype"]))


def build(cfg: dict, weights: dict, device):
    """The port's model holding ``weights``, its inner optimizer and its
    loss function."""
    from horovod_tpu_torch.models import transformer
    from horovod_tpu_torch.ops.optim import AdamW

    tcfg = _port_config(cfg)
    with torch.device("meta"):
        model = transformer.Transformer(tcfg)
    model = model.to_empty(device=device)
    model.load_state_dict(weights)
    o = cfg["optimizer"]
    opt = AdamW(model.parameters(), o["lr"], b1=o["b1"], b2=o["b2"],
                eps=o["eps"], weight_decay=o["weight_decay"],
                moment_dtype=getattr(torch, o["moment_dtype"]))
    loss_fn = transformer.make_loss_fn(tcfg, fused_head=cfg["fused_head"])
    return model, opt, loss_fn


def batches(cfg: dict, mix: dict, generator, n: int, device) -> list:
    """``n`` batches of ``(batch, seq_len)`` token ids uniform over the
    vocabulary, one after another from ``generator``."""
    return [torch.randint(0, cfg["vocab_size"], (mix["batch"],
                                                 mix["seq_len"]),
                          generator=generator, device=device)
            for _ in range(n)]


def half(batch):
    return batch[:batch.shape[0] // 2]


def _mus(opt, params):
    mus = [opt.state.get(p, {}).get("mu") for p in params]
    return None if any(m is None for m in mus) else mus


def moments(opt, params):
    """A copy, on the device, of AdamW's first moments; None where it
    holds none."""
    mus = _mus(opt, params)
    return None if mus is None else [m.clone() for m in mus]


def grads(opt, params, before=None):
    """The gradient AdamW took at its last step, leaf by leaf in float32,
    from its first moment: ``m_t = b1 m_(t-1) + (1 - b1) g_t``, with
    ``m_(t-1)`` the copy ``before`` (:func:`moments`), none at the first
    step. None where AdamW holds no moments."""
    b1 = opt.param_groups[0]["b1"]
    mus = _mus(opt, params)
    if mus is None:
        return None
    if before is None:
        return (m.float() / (1.0 - b1) for m in mus)
    return ((m.float() - b1 * b.float()) / (1.0 - b1)
            for m, b in zip(mus, before))


def counts(cfg: dict, mix: dict) -> dict:
    b, t = mix["batch"], mix["seq_len"]
    h = cfg["num_heads"]
    d = cfg["embed_dim"] // h
    layers = cfg["num_layers"]
    moment = torch.finfo(getattr(torch, cfg["optimizer"]["moment_dtype"]))
    return {"unit": UNIT, "items": b * t,
            "flops": work.lm_flops_per_step(cfg, b, t),
            "flash_fwd_flops": layers * work.flash_fwd_flops(b, t, h, d),
            "flash_bwd_flops": layers * work.flash_bwd_flops(b, t, h, d),
            "adamw_bytes": work.adamw_bytes(work.lm_param_sizes(cfg), 4,
                                            moment.bits // 8)}
