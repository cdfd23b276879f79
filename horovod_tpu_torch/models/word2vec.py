"""Skip-gram word2vec — the reference's sparse-gradient workload.

Counterpart of ``horovod_tpu/models/word2vec.py``, whose parity target is
the reference's ``examples/tensorflow_word2vec.py``: skip-gram with NCE
loss, vocabulary 50,000, embedding dim 128, 64 negative samples. Its
embedding gradients are sparse: :func:`value_and_sparse_grad`
differentiates with respect to the gathered rows only and packages the
row gradients as :class:`~horovod_tpu_torch.ops.sparse.IndexedSlices`,
which ``hvd.allreduce_gradients`` exchanges by allgather (and
dedup-and-merge) and :func:`apply_sparse_sgd` applies in place.

The tables are an ``nn.Module``'s parameters, drawn from a seeded
``torch.Generator`` with the reference's distributions (not its values);
:meth:`Word2Vec.from_jax_params` carries the JAX package's arrays across.
Indices are int32, widened to int64 only where torch indexes with them.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from horovod_tpu_torch.ops.sparse import IndexedSlices, scatter_add_


class Word2VecConfig(NamedTuple):
    vocab_size: int = 50_000     # examples/tensorflow_word2vec.py:69
    embedding_dim: int = 128     # :127
    num_sampled: int = 64        # :131


class Word2Vec(torch.nn.Module):
    """``embeddings`` ~ U(-1, 1), ``nce_weights`` ~ N(0, 1/√D),
    ``nce_biases`` zero — the reference's initializers."""

    def __init__(self, config: Word2VecConfig,
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        self.config = config
        v, d = config.vocab_size, config.embedding_dim
        emb = torch.rand((v, d), generator=generator) * 2 - 1
        w = torch.randn((v, d), generator=generator) / math.sqrt(d)
        self.embeddings = torch.nn.Parameter(emb, requires_grad=False)
        self.nce_weights = torch.nn.Parameter(w, requires_grad=False)
        self.nce_biases = torch.nn.Parameter(torch.zeros(v),
                                             requires_grad=False)

    @classmethod
    def from_jax_params(cls, params: dict, device=None) -> "Word2Vec":
        """The JAX package's parameter dict (numpy or JAX arrays) as a
        module."""
        emb = np.asarray(params["embeddings"], np.float32)
        model = cls(Word2VecConfig(emb.shape[0], emb.shape[1]))
        with torch.no_grad():
            for k in ("embeddings", "nce_weights", "nce_biases"):
                getattr(model, k).copy_(torch.from_numpy(
                    np.asarray(params[k], np.float32)))
        return model.to(device) if device is not None else model


def nce_loss_from_rows(emb_rows, w_pos, b_pos, w_neg, b_neg):
    """NCE objective on gathered rows: binary logistic loss scoring the true
    context word against the sampled noise words (tf.nn.nce_loss).

    Shapes: emb_rows (B, D); w_pos (B, D); b_pos (B,); w_neg (K, D); b_neg
    (K,)."""
    pos_logits = torch.sum(emb_rows * w_pos, dim=-1) + b_pos
    neg_logits = emb_rows @ w_neg.T + b_neg[None, :]
    pos_loss = -F.logsigmoid(pos_logits)
    neg_loss = -torch.sum(F.logsigmoid(-neg_logits), dim=-1)
    return torch.mean(pos_loss + neg_loss)


def value_and_sparse_grad(model: Word2Vec, centers, contexts, neg_samples):
    """Loss and gradients, each table's as IndexedSlices: the gradient with
    respect to the gathered rows, packaged with the rows' indices (what TF's
    ``embedding_lookup`` backward emits). Duplicate indices stay; the
    exchange merges them."""
    c, t, n = centers.long(), contexts.long(), neg_samples.long()
    rows = [model.embeddings[c], model.nce_weights[t], model.nce_biases[t],
            model.nce_weights[n], model.nce_biases[n]]
    rows = [r.detach().requires_grad_() for r in rows]
    with torch.enable_grad():
        loss = nce_loss_from_rows(*rows)
        g_emb, g_wpos, g_bpos, g_wneg, g_bneg = torch.autograd.grad(loss,
                                                                    rows)
    v, d = model.config.vocab_size, model.config.embedding_dim
    nce_idx = torch.cat([contexts, neg_samples])
    grads = {
        "embeddings": IndexedSlices(g_emb, centers, (v, d)),
        "nce_weights": IndexedSlices(torch.cat([g_wpos, g_wneg]), nce_idx,
                                     (v, d)),
        "nce_biases": IndexedSlices(torch.cat([g_bpos, g_bneg])[:, None],
                                    nce_idx, (v, 1)),
    }
    return loss.detach(), grads


@torch.no_grad()
def apply_sparse_sgd(model: Word2Vec, sparse_grads: dict, lr: float) -> None:
    """SGD by scatter-add of the IndexedSlices gradients, in place on the
    device (the reference's GradientDescentOptimizer sparse apply)."""
    for key, g in sparse_grads.items():
        table = getattr(model, key)
        scatter_add_(table.view(table.shape[0], -1), g, alpha=-lr)


def generate_batch(data, batch_size: int, num_skips: int, skip_window: int,
                   data_index: int):
    """Sliding-window skip-gram batch over an int token array (context
    positions cycle rather than random-sample).

    Returns (centers, contexts, new_data_index) as numpy arrays."""
    if num_skips > 2 * skip_window:
        raise ValueError("num_skips cannot exceed 2*skip_window.")
    batch_size = batch_size // num_skips * num_skips
    span = 2 * skip_window + 1
    centers = np.empty((batch_size,), np.int32)
    contexts = np.empty((batch_size,), np.int32)
    if data_index + span > len(data):
        data_index = 0
    offsets = [o for o in range(span) if o != skip_window]
    for i in range(batch_size // num_skips):
        window_start = data_index
        for j in range(num_skips):
            centers[i * num_skips + j] = data[window_start + skip_window]
            contexts[i * num_skips + j] = data[
                window_start + offsets[j % len(offsets)]]
        data_index = (data_index + 1) % (len(data) - span + 1)
    return centers, contexts, data_index
