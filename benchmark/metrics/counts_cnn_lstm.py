"""The work of the IMDB CNN-LSTM's full-batch gradient, counted from the shapes.

Operations and bytes of the algorithm (``reference/cnn_lstm_imdb.py``'s
equations), never of one implementation, float32 throughout.  A product is
2 operations a multiply-add.  A gradient is the forward, the backward's
input gradients (the embedding's output needs one, so every product has
one) and its weight gradients, each 2 operations a multiply-add of the
forward's products: 6 a multiply-add.  A recurrence step is counted whole,
the first one's product with the zero state too.  Bytes: each input read
once and each output written once.
"""

from __future__ import annotations

F32 = 4
I64 = 8  # a token id as the data holds it


def steps(cfg: dict) -> int:
    """Recurrence steps of a review: the convolution's outputs over the pool."""
    return (cfg["seq_len"] - cfg["kernel"] + 1) // cfg["pool"]


def cnn_lstm_params(cfg: dict) -> int:
    """The embedding, the convolution's kernel and bias, the LSTM's W_ih,
    W_hh and one bias a gate, and the head's weight and bias."""
    e, f, h, c = cfg["embed"], cfg["filters"], cfg["hidden"], cfg["classes"]
    return (cfg["vocab"] * e + f * (e * cfg["kernel"] + 1) + 4 * h * (f + h + 1)
            + c * (h + 1))


def conv_macs(cfg: dict) -> int:
    """Multiply-adds of one review's convolution."""
    return (cfg["seq_len"] - cfg["kernel"] + 1) * cfg["filters"] * cfg["embed"] * cfg["kernel"]


def lstm_step_macs(cfg: dict) -> int:
    """Multiply-adds of one review's recurrence step: W_ih x_t and W_hh h."""
    h = cfg["hidden"]
    return 4 * h * (cfg["filters"] + h)


def review_macs(cfg: dict) -> int:
    """Multiply-adds of one review's forward: convolution, recurrence, head."""
    return conv_macs(cfg) + steps(cfg) * lstm_step_macs(cfg) + cfg["hidden"] * cfg["classes"]


def gradient_flops(cfg: dict, chains: int) -> int:
    """One full-batch gradient of every chain: 6 operations a multiply-add."""
    return 6 * chains * cfg["n_data"] * review_macs(cfg)


def conv_flops(cfg: dict, reviews: int) -> int:
    """The convolution's share of the gradients of ``reviews`` reviews."""
    return 6 * reviews * conv_macs(cfg)


def lstm_flops(cfg: dict, review_steps: int) -> int:
    """The recurrence's products over ``review_steps`` steps of a review."""
    return 6 * review_steps * lstm_step_macs(cfg)


def lstm_gate_bytes(cfg: dict, review_steps: int) -> int:
    """The gate pass over ``review_steps`` steps of a review, in hidden-wide
    vectors: forward, the 4 gate sums and c_{t-1} read, c_t and h_t
    written (7); backward, dh_t and dc_t, the 4 gate sums, c_{t-1} and c_t
    read, the 4 gate gradients and dc_{t-1} written (13)."""
    return 20 * F32 * cfg["hidden"] * review_steps


def embed_bytes(cfg: dict, tokens: int, forwards: int) -> int:
    """The embedding's gather and its gradient over ``tokens`` ids in
    ``forwards`` forwards: a forward reads its ids and the table and writes
    a row a token; the gradient reads the ids and a row's gradient a token
    and writes the table's gradient."""
    table = F32 * cfg["vocab"] * cfg["embed"]
    return tokens * 2 * (I64 + F32 * cfg["embed"]) + forwards * 2 * table
