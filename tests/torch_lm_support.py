"""Shared by the port's LM serving tests: the small LM both frameworks
serve, with its weights drawn once from a seeded numpy generator."""

import numpy as np
import torch

import jax.numpy as jnp

from horovod_tpu.models import transformer as jt
from horovod_tpu_torch.models import transformer as tt

ARCH = dict(vocab_size=128, num_layers=2, num_heads=4, num_kv_heads=2,
            embed_dim=64, mlp_dim=128, max_seq_len=64)


def configs(dtype: str = "fp32", **kw):
    """(JAX config, port config) of the small LM (``tests/test_serving.py``'s
    ``_cfg``), in fp32 or bf16."""
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    base = dict(ARCH, **kw)
    return (jt.TransformerConfig(dtype=jdt, **base),
            tt.TransformerConfig(dtype=tdt, **base))


def numpy_params(cfg, seed: int = 0) -> dict:
    """A flax parameter tree for ``cfg`` drawn from numpy: kernels
    LeCun-normal, the embedding N(0, 0.02), norm scales 1 + U(0, 0.5) (so a
    misplaced scale shows)."""
    rng = np.random.default_rng(seed)
    e, h, m, v = cfg.embed_dim, cfg.num_heads, cfg.mlp_dim, cfg.vocab_size
    hkv, d = cfg.num_kv_heads or h, cfg.embed_dim // cfg.num_heads

    def kernel(shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
            np.float32)

    def scale():
        return {"scale": (1 + 0.5 * rng.random(e)).astype(np.float32)}

    params = {"Embed_0": {"embedding": (0.02 * rng.standard_normal((v, e)))
                          .astype(np.float32)}}
    for i in range(cfg.num_layers):
        params[f"block_{i}"] = {
            "RMSNorm_0": scale(), "RMSNorm_1": scale(),
            "attn": {"query": {"kernel": kernel((e, h, d), e)},
                     "key": {"kernel": kernel((e, hkv, d), e)},
                     "value": {"kernel": kernel((e, hkv, d), e)},
                     "out": {"kernel": kernel((h, d, e), h * d)}},
            "Dense_0": {"kernel": kernel((e, m), e)},
            "Dense_1": {"kernel": kernel((m, e), m)}}
    params["RMSNorm_0"] = scale()
    params["lm_head"] = {"kernel": kernel((e, v), e)}
    return params


def port_model(tcfg, params) -> "tt.Transformer":
    """The port's Transformer on the CPU holding ``params``."""
    model = tt.Transformer(tcfg)
    model.load_state_dict(tt.from_flax_params(params))
    return model


def tokens(b: int, t: int, seed: int = 0, vocab: int = ARCH["vocab_size"]):
    return np.random.RandomState(seed).randint(0, vocab, (b, t)).astype(
        np.int32)


def distilled_draft_pair(dtype: str = "fp32", seed: int = 0, **kw):
    """``tools/serve_bench.py::distilled_draft_pair`` over :func:`numpy_params`
    weights, for both frameworks: the target's blocks 1.. have their
    ``attn.out`` and ``Dense_1`` kernels zeroed, so it computes its first
    block only, and the 1-layer draft shares ``Embed_0``, ``block_0``,
    ``RMSNorm_0`` and ``lm_head``. Returns ``(jax_side, port_side)``, each
    ``(config, params or model, draft config, draft params or model)``."""
    jcfg, tcfg = configs(dtype, **kw)
    params = numpy_params(jcfg, seed)
    for i in range(1, jcfg.num_layers):
        block = params[f"block_{i}"]
        block["attn"]["out"]["kernel"] = np.zeros_like(
            block["attn"]["out"]["kernel"])
        block["Dense_1"]["kernel"] = np.zeros_like(block["Dense_1"]["kernel"])
    dparams = {k: params[k]
               for k in ("Embed_0", "block_0", "RMSNorm_0", "lm_head")}
    jd, td = jcfg._replace(num_layers=1), tcfg._replace(num_layers=1)
    return ((jcfg, params, jd, dparams),
            (tcfg, port_model(tcfg, params), td, port_model(td, dparams)))
