"""The frozen reference computes the port's function: at tiny widths on the
CPU, from the same weights and batch, one step's loss and gradients agree.
(A test may import both; the reference imports nothing of the port.)"""

import json
import os

import pytest
import torch

from hvdbench import cell, weights

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")

# The port's attention at T <= 2048 rounds queries and keys to bf16 before
# their product (``parallel/sequence.py::local_attention``'s ``xla`` path),
# so the LM agrees to bf16 rounding of the scores.
TOL = 2e-2


def _load(name):
    with open(os.path.join(DATA, f"{name}.json")) as f:
        return json.load(f)


def test_one_step_agrees():
    cfg, mix = _load("lm_tiny"), _load("tokens_tiny")
    dev = torch.device("cpu")
    spec = cell.ref_family(cfg).init_spec(cfg)
    w = weights.make(spec, 123, dev)
    batch = cell.family(cfg).batches(cfg, mix, cell.data_generator(7, 0,
                                                                   dev), 1,
                                     dev)[0]
    model, _, loss_fn = cell.family(cfg).build(cfg, w, dev)
    loss = loss_fn(model, batch)
    loss.backward()
    port = {n: p.grad for n, p in model.named_parameters()}

    ref = cell.ref_family(cfg).build(cfg)
    ref.load_state_dict(w)
    ref_loss = cell.ref_family(cfg).loss_and_grads(ref, cfg, batch)
    assert float(loss.detach()) == pytest.approx(ref_loss, rel=TOL)
    for name, p in ref.named_parameters():
        gap = float((port[name].float() - p.grad).norm())
        assert gap <= TOL * max(float(p.grad.norm()), 1e-12), name


def test_weights_repeat_and_follow_the_seed():
    cfg = _load("lm_tiny")
    spec = cell.ref_family(cfg).init_spec(cfg)
    a = weights.make(spec, 5, torch.device("cpu"))
    b = weights.make(spec, 5, torch.device("cpu"))
    c = weights.make(spec, 6, torch.device("cpu"))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["lm_head"], c["lm_head"])
    std = float(a["blocks.0.mlp_in"].std())
    assert std == pytest.approx((1 / cfg["embed_dim"]) ** 0.5, rel=0.1)
    assert float(a["blocks.0.mlp_in"].abs().max()) <= \
        2 * (1 / cfg["embed_dim"]) ** 0.5 / .8796256610342398 + 1e-6


def test_batches_follow_seed_and_rank():
    cfg, mix = _load("lm_tiny"), _load("tokens_tiny")
    fam, dev = cell.family(cfg), torch.device("cpu")
    first = fam.batches(cfg, mix, cell.data_generator(9, 0, dev), 4, dev)
    again = fam.batches(cfg, mix, cell.data_generator(9, 0, dev), 2, dev)
    other = fam.batches(cfg, mix, cell.data_generator(9, 1, dev), 1, dev)
    assert torch.equal(first[1], again[1])
    assert not torch.equal(first[0], first[1])
    assert not torch.equal(first[0], other[0])
    big = 2 ** 31 + 12345
    assert fam.batches(cfg, mix, cell.data_generator(big, 3, dev), 1,
                       dev)[0].shape == (mix["batch"], mix["seq_len"])
