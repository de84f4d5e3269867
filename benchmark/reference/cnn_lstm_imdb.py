"""Plain reference of the IMDB CNN-LSTM (arXiv:2104.14421; google-research
``bnn_hmc``'s ``make_cnn_lstm``), written from its equations.

On token ids (N, L), which may arrive as floats (the float64 check casts
the data to its own dtype) and are cast back to integers here, exactly
below 2^24:

    e        = E[ids]                                    (N, L, embed)
    a        = swish(conv1d(e; K, b)), no padding        (N, filters, L - kernel + 1)
    x        = max-pool of window and stride ``pool``    (N, filters, T)
    for t in 1..T, from h = c = 0:
        [i, f, g, o] = W_ih x_t + b_ih + W_hh h           four blocks of ``hidden`` rows
        c = sigmoid(f + 1) c + sigmoid(i) tanh(g)
        h = sigmoid(o) tanh(c)
    logits   = W h + b

swish(x) = x sigmoid(x).  The convolution is ``F.conv2d`` over a height-1
image and every product ``F.linear``, so that the TF32 control of
``hmc_chains.py`` rounds each one.  The +1 on the forget gate is haiku's
``hk.LSTM``, fixed, not a parameter.

The parameters are registered in the order and the shapes that the
program's module gives them: the embedding (vocab, embed), the
convolution's kernel (filters, embed, kernel) and bias, the LSTM's W_ih
(4 hidden, filters), W_hh (4 hidden, hidden) and b_ih (4 hidden), with the
gates in the order i, f, g, o down the rows, then the head's weight
(classes, hidden) and bias, so that one flat vector of parameters means
the same network in both.  Their values here are placeholders: the
posterior sets them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class CNNLSTMIMDB(nn.Module):
    def __init__(self, vocab: int = 20_000, embed: int = 128, filters: int = 64,
                 kernel: int = 5, pool: int = 4, hidden: int = 128, classes: int = 2):
        super().__init__()
        self.pool = pool
        shapes = [(vocab, embed), (filters, embed, kernel), (filters,), (4 * hidden, filters),
                  (4 * hidden, hidden), (4 * hidden,), (classes, hidden), (classes,)]
        self.weights = nn.ParameterList([nn.Parameter(torch.zeros(s)) for s in shapes])

    def forward(self, ids):
        table, k, kb, w_ih, w_hh, b_ih, w, b = self.weights
        hidden = w_hh.shape[1]
        e = table[ids.long()]  # (N, L, embed)
        a = F.conv2d(e.transpose(1, 2).unsqueeze(2), k.unsqueeze(2), kb)  # (N, filters, 1, L')
        a = a * torch.sigmoid(a)
        x = F.max_pool2d(a, (1, self.pool)).squeeze(2).transpose(1, 2)  # (N, T, filters)
        xs = F.linear(x, w_ih, b_ih)  # every step's input part at once
        h = c = torch.zeros(x.shape[0], hidden, dtype=x.dtype, device=x.device)
        for t in range(x.shape[1]):
            i, f, g, o = (xs[:, t] + F.linear(h, w_hh)).split(hidden, dim=1)
            c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
        return F.linear(h, w, b)
