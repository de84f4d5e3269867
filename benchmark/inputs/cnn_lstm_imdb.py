"""Inputs of a ``cnn_lstm_imdb`` configuration, made on the device from the seed.

Two modules of one network, the IMDB CNN-LSTM at the configuration's
sizes: ``port_module``, the port's own (``models/cnn_lstm.py``), which the
port's entry runs, and ``module``, the plain reference
(``reference/cnn_lstm_imdb.py``), with which the check and any stand-in
for the port compute.  Both take one flat vector of parameters in the same
order.

The reviews are token ids in the Keras IMDB encoding: each review's
length in words is log-normal (median ``review_median``, sigma
``review_sigma``), its words i.i.d. with a Zipf(1) law over the ranks of a
``word_index`` of words, a word of rank r has the id r + 3 and ranks past
the vocabulary the out-of-vocabulary id 2, and the review is the start id 1
then its words, padded with 0 at the front and cut from the front to
``seq_len`` tokens (``pad_sequences``' defaults).  The labels are half 0
and half 1, in a random order.  Every chain starts at He-normal weights
(standard deviation sqrt(2 / fan_in), fan_in the entries of a row: the
embedding's width, the convolution's embed x kernel, the LSTM's input and
hidden widths, the head's hidden width) and biases at 0, these plus 0.1
times a standard normal: one normal draw a parameter, of standard
deviation sqrt(2 / fan_in + 0.1^2) or 0.1.  One generator on the device, a
few large draws.
"""

from __future__ import annotations

import math

import torch

from benchmark.core import resolve
from benchmark.reference.cnn_lstm_imdb import CNNLSTMIMDB

PORT_MODEL = "hamiltorch_tpu_torch.models.cnn_lstm:cnn_lstm_imdb"
PAD, START, OOV, FIRST = 0, 1, 2, 3  # the Keras encoding: a word of rank r is r + FIRST


def _sizes(cfg: dict) -> dict:
    return {k: cfg[k] for k in ("vocab", "embed", "filters", "kernel", "pool", "hidden",
                                "classes")}


def _scale(module) -> torch.Tensor:
    """Every parameter's start's standard deviation, flat in ``parameters()``
    order: sqrt(2 / fan_in + 0.1^2) for a weight, 0.1 for a bias."""
    return torch.cat([torch.full((p.numel(),), math.sqrt(2.0 / p[0].numel() + 0.01)
                                 if p.dim() >= 2 else 0.1) for p in module.parameters()])


def reviews(cfg: dict, gen: torch.Generator, device) -> torch.Tensor:
    """(n_data, seq_len) token ids, int64."""
    n, length = cfg["n_data"], cfg["seq_len"]
    ranks = torch.arange(1, cfg["word_index"] + 1, dtype=torch.float64, device=device)
    cdf = torch.cumsum(1.0 / ranks, 0)
    u = torch.rand((n, length), generator=gen, dtype=torch.float64, device=device)
    rank = torch.searchsorted(cdf, u * cdf[-1], right=True).clamp_(max=len(ranks) - 1) + 1
    words = torch.where(rank + FIRST < cfg["vocab"], rank + FIRST, OOV)
    z = torch.randn((n, 1), generator=gen, dtype=torch.float64, device=device)
    count = torch.exp(math.log(cfg["review_median"]) + cfg["review_sigma"] * z).round()
    count = count.clamp_(min=1).long()  # words in the review
    back = torch.arange(length, 0, -1, device=device)  # a token's place from the end, 1..L
    return torch.where(back <= count, words,
                       torch.where(back == count + 1, START, PAD)).long()


def make(cfg: dict, chains: int, seed: int, device) -> dict:
    port = resolve(PORT_MODEL)(**_sizes(cfg))
    scale = _scale(port).to(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    x = reviews(cfg, gen, device)
    n = cfg["n_data"]
    y = (torch.randperm(n, generator=gen, device=device) % cfg["classes"]).long()
    theta = scale * torch.randn((chains, scale.numel()), generator=gen, dtype=torch.float32,
                                device=device)
    return {"x": x, "y": y, "theta": theta, "port_module": port,
            "module": CNNLSTMIMDB(**_sizes(cfg))}
