"""The CNN-LSTM of the IMDB reviews (CNN-LSTM-IMDB).

The network of Izmailov et al., *What Are Bayesian Neural Network
Posteriors Really Like?* (arXiv:2104.14421), whose full-batch HMC on the
IMDB reviews is a reference posterior of Bayesian deep learning; their code
names it ``cnn_lstm`` (google-research ``bnn_hmc``, ``make_cnn_lstm``), and
it is the IMDB model of Wenzel et al. 2020 (arXiv:2002.02405).  On token ids
(N, L):

* embedding: each id's row of a (vocab, embed) table;
* a 1-D convolution of ``filters`` filters of width ``kernel`` with a bias
  and no padding (L -> L - kernel + 1), swish (x sigmoid(x)), and a max-pool
  of window and stride ``pool`` (-> T = (L - kernel + 1) // pool steps);
* an LSTM of ``hidden`` cells over the T steps from a zero state, haiku's
  ``hk.LSTM``: [i, f, g, o] = W_ih x_t + W_hh h_{t-1} + b, one bias a gate,
  c_t = sigmoid(f + 1) c_{t-1} + sigmoid(i) tanh(g), h_t = sigmoid(o) tanh(c_t);
  the +1 on the forget gate is fixed, not a parameter;
* head: a linear layer from h_T to the logits.

At the published sizes (a vocabulary of 20,000, 128-wide embeddings, 64
filters of width 5, a pool of 4, 128 cells, 2 classes) it has 2,700,098
parameters.  The recurrence is one call of ``nn.LSTM`` (cuDNN's fused LSTM
on the card), whose second bias, ``bias_hh_l0``, is here a buffer that
holds the forget gate's constant 1 and 0 elsewhere.

Departures from ``make_cnn_lstm``: PyTorch's layouts and ``parameters()``
order define the flat parameter vector, not haiku's (the embedding
(vocab, embed), the convolution's kernel (filters, embed, kernel), the
LSTM's gates in the rows of ``weight_ih_l0``, ``weight_hh_l0`` and
``bias_ih_l0`` in PyTorch's order i, f, g, o where haiku's one (in + hidden,
4 hidden) matrix takes i, g, f, o in its columns; the head's weight
(classes, hidden)); the parameters start at PyTorch's default
initialisation, where a sampler's start is the caller's to set.

The recorder (``utils/profiling.py``) holds the spans ``cnn_lstm.embed``,
``cnn_lstm.conv`` (convolution, swish and pool), ``cnn_lstm.lstm`` and
``cnn_lstm.head`` around each stage's forward, and the counters
``cnn_lstm.tokens`` (ids looked up) and ``cnn_lstm.steps`` (recurrence
steps), a forward each.
"""

from __future__ import annotations

import torch
from torch import nn

from ..utils import profiling


class HaikuLSTM(nn.LSTM):
    """One-layer ``nn.LSTM`` (batch first) with haiku's cell: one bias a
    gate, and a constant 1 added to the forget gate (``bias_hh_l0``, a
    buffer)."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__(input_size, hidden_size, batch_first=True)
        del self.bias_hh_l0
        offset = torch.zeros(4 * hidden_size)
        offset[hidden_size:2 * hidden_size] = 1.0  # rows of f in PyTorch's order i, f, g, o
        self.register_buffer("bias_hh_l0", offset)
        self._init_flat_weights()


class CNNLSTM(nn.Module):
    """Embedding, convolution with swish and max-pool, LSTM, linear head."""

    def __init__(self, vocab: int, embed: int, filters: int, kernel: int, pool: int,
                 hidden: int, classes: int):
        super().__init__()
        self.embed = nn.Embedding(vocab, embed)
        self.conv = nn.Conv1d(embed, filters, kernel)
        self.act = nn.SiLU()
        self.pool = nn.MaxPool1d(pool)
        self.lstm = HaikuLSTM(filters, hidden)
        self.head = nn.Linear(hidden, classes)

    def forward(self, ids):
        with profiling.annotate("cnn_lstm.embed"):
            profiling.count("cnn_lstm.tokens", ids.numel())
            h = self.embed(ids)  # (N, L, embed)
        with profiling.annotate("cnn_lstm.conv"):
            h = self.pool(self.act(self.conv(h.transpose(1, 2))))  # (N, filters, T)
        with profiling.annotate("cnn_lstm.lstm"):
            out, _ = self.lstm(h.transpose(1, 2))  # (N, T, hidden)
            profiling.count("cnn_lstm.steps", out.shape[1])
        with profiling.annotate("cnn_lstm.head"):
            return self.head(out[:, -1])


def cnn_lstm_imdb(vocab: int = 20_000, embed: int = 128, filters: int = 64, kernel: int = 5,
                  pool: int = 4, hidden: int = 128, classes: int = 2) -> CNNLSTM:
    """The IMDB CNN-LSTM; the defaults are the published network."""
    return CNNLSTM(vocab, embed, filters, kernel, pool, hidden, classes)
