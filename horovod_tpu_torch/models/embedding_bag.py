"""Embedding-bag classifier — the recommender-style sparse-gradient workload.

Counterpart of ``horovod_tpu/models/embedding_bag.py``: a large id table
looked up by bags of ids, mean-pooled, and classified by a small dense
head. Only the looked-up rows receive gradient, so the table's gradient is
an :class:`~horovod_tpu_torch.ops.sparse.IndexedSlices` with one row per bag
member (hot ids repeat across bags and ranks), while the head's gradients
stay dense: one step drives a mixed sparse and dense list through
``hvd.allreduce_gradients``, the padded gather wire and the
dedup-and-merge of the hot rows.

Parameters are drawn from a seeded ``torch.Generator`` with the reference's
distributions; :meth:`EmbeddingBag.from_jax_params` carries the JAX
package's arrays across. :func:`synthetic_batch` is the reference's numpy
generator, so the batches are the reference's exactly.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from horovod_tpu_torch.ops.sparse import IndexedSlices, scatter_add_


class EmbeddingBagConfig(NamedTuple):
    num_embeddings: int = 60_000   # table rows (id hash space)
    embedding_dim: int = 32
    bag_size: int = 8              # ids pooled per example
    num_classes: int = 2


class EmbeddingBag(torch.nn.Module):
    """``table`` ~ N(0, 1/√D), head ``w`` ~ N(0, 1/√D), ``b`` zero."""

    def __init__(self, config: EmbeddingBagConfig,
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        self.config = config
        n, d, c = (config.num_embeddings, config.embedding_dim,
                   config.num_classes)
        scale = 1 / math.sqrt(d)
        self.table = torch.nn.Parameter(
            torch.randn((n, d), generator=generator) * scale,
            requires_grad=False)
        self.w = torch.nn.Parameter(
            torch.randn((d, c), generator=generator) * scale,
            requires_grad=False)
        self.b = torch.nn.Parameter(torch.zeros(c), requires_grad=False)

    @classmethod
    def from_jax_params(cls, params: dict, bag_size: int = 8,
                        device=None) -> "EmbeddingBag":
        """The JAX package's parameter dict (numpy or JAX arrays) as a
        module."""
        table = np.asarray(params["table"], np.float32)
        w = np.asarray(params["w"], np.float32)
        model = cls(EmbeddingBagConfig(table.shape[0], table.shape[1],
                                       bag_size, w.shape[1]))
        with torch.no_grad():
            for k in ("table", "w", "b"):
                getattr(model, k).copy_(torch.from_numpy(
                    np.asarray(params[k], np.float32)))
        return model.to(device) if device is not None else model


def logits_from_rows(rows, w, b, bag_size: int):
    """(B·bag, D) gathered rows → (B, C) logits via mean pooling."""
    pooled = rows.reshape(-1, bag_size, rows.shape[-1]).mean(dim=1)
    return pooled @ w + b


def value_and_sparse_grad(model: EmbeddingBag, bags, labels):
    """Softmax cross-entropy and gradients: ``table``'s as IndexedSlices
    (one row gradient per bag member, duplicates kept), ``w`` and ``b``
    dense. ``bags`` (B, bag) int ids, ``labels`` (B,) int classes."""
    flat_ids = bags.reshape(-1)
    leaves = [model.table[flat_ids.long()], model.w, model.b]
    leaves = [t.detach().requires_grad_() for t in leaves]
    with torch.enable_grad():
        logits = logits_from_rows(leaves[0], leaves[1], leaves[2],
                                  bags.shape[1])
        loss = F.cross_entropy(logits, labels.long())
        g_rows, g_w, g_b = torch.autograd.grad(loss, leaves)
    grads = {"table": IndexedSlices(g_rows, flat_ids,
                                    tuple(model.table.shape)),
             "w": g_w, "b": g_b}
    return loss.detach(), grads


@torch.no_grad()
def apply_sgd(model: EmbeddingBag, grads: dict, lr: float) -> None:
    """SGD in place: IndexedSlices by scatter-add of the merged rows, dense
    leaves elementwise."""
    for key, g in grads.items():
        p = getattr(model, key)
        if isinstance(g, IndexedSlices):
            scatter_add_(p, g, alpha=-lr)
        else:
            p.sub_(lr * g)


def synthetic_batch(config: EmbeddingBagConfig, batch_size: int,
                    seed: int = 0, hot_ids: int = 64):
    """The reference's learnable synthetic workload: Zipf-hot bag ids (~80%
    of lookups hit a hot set of ``hot_ids``) and the label the parity of
    the id sum. Returns ``(bags (B, bag) int32, labels (B,) int32)`` numpy
    arrays, the reference's exactly."""
    rng = np.random.RandomState(seed)
    hot = rng.randint(0, config.num_embeddings, (hot_ids,))
    pick_hot = rng.rand(batch_size, config.bag_size) < 0.8
    cold = rng.randint(0, config.num_embeddings,
                       (batch_size, config.bag_size))
    hot_pick = hot[rng.randint(0, hot_ids,
                               (batch_size, config.bag_size))]
    bags = np.where(pick_hot, hot_pick, cold).astype(np.int32)
    labels = (bags.sum(axis=1) % config.num_classes).astype(np.int32)
    return bags, labels
