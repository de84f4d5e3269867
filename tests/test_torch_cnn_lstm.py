"""The IMDB CNN-LSTM (``models/cnn_lstm.py``) and recurrent modules on the port's potentials.

The network is held against the benchmark's plain reference
(``benchmark/reference/cnn_lstm_imdb.py``, written from the equations, its
recurrence an explicit loop) on one flat vector of seeded parameters, in
float64, at narrow widths (a vocabulary of 50, 8-wide embeddings, 6
filters, 5 cells, 21 tokens, 23 reviews): the logits, and the potential's
value and gradient through ``define_model_log_prob`` with and without
``block_rows`` under ``vmap`` over chains, against the reference's float64
posterior; ``run_hmc_chains`` draw for draw, blocked against unblocked and
against the reference's HMC on the same noise.  haiku's cell (one bias a
gate, a constant 1 on the forget gate) is held against its equations
written out here.  The recorder's spans and counters are counted.  The
module copy that every module potential runs (``models/bnn.py``'s
``_private_copy``) holds recurrent layers in training mode with their
dropout at 0 and everything else in eval mode, and computes what the
module computes in eval mode.
"""

import math

import pytest
import torch
from torch import nn

from benchmark.reference import hmc_chains as ref
from benchmark.reference.cnn_lstm_imdb import CNNLSTMIMDB
from hamiltorch_tpu_torch.models import cnn_lstm_imdb
from hamiltorch_tpu_torch.models.bnn import _private_copy, define_model_log_prob
from hamiltorch_tpu_torch.models.cnn_lstm import HaikuLSTM
from hamiltorch_tpu_torch.samplers.driver import MCMCConfig
from hamiltorch_tpu_torch.samplers.hmc import run_hmc_chains
from hamiltorch_tpu_torch.utils import profiling

SMALL = dict(vocab=50, embed=8, filters=6, kernel=5, pool=4, hidden=5, classes=2)
N, LENGTH = 23, 21  # reviews (blocks of 5 and 7 do not divide it) and tokens: 4 steps
CFG = dict(model_loss="multi_class_linear_output", tau_out=1.0, prior_precision=5.0)


def _flat_start(module, seed):
    """He-normal weights and biases near 0, in float64."""
    gen = torch.Generator().manual_seed(seed)
    return torch.cat([torch.randn(p.numel(), generator=gen, dtype=torch.float64)
                      * (math.sqrt(2.0 / p[0].numel()) if p.dim() >= 2 else 0.1)
                      for p in module.parameters()])


def _data(n=N, seed=1):
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, SMALL["vocab"], (n, LENGTH), generator=gen)
    ids[: n // 3, : LENGTH // 2] = 0  # padded reviews: identical windows, pooled ties
    return ids, torch.randint(0, 2, (n,), generator=gen)


def _port(**kw):
    return cnn_lstm_imdb(**{**SMALL, **kw}).double()


def _potential(block_rows=None, model=None):
    x, y = _data()
    return define_model_log_prob(model if model is not None else _port(),
                                 "multi_class_linear_output", x, y, tau_list=5.0, device="cpu",
                                 block_rows=block_rows)


def _call(module, theta, x):
    names = [n for n, _ in module.named_parameters()]
    shapes = [p.shape for p in module.parameters()]
    params = dict(zip(names, (t.view(s) for t, s in
                              zip(theta.split([math.prod(s) for s in shapes]), shapes))))
    return torch.func.functional_call(module, {**params, **dict(module.named_buffers())}, (x,))


def test_parameters_of_the_published_network():
    """2,700,098 parameters at the published sizes, in the reference's shapes
    and order; the forget offset is a buffer, not a parameter."""
    with torch.device("meta"):
        port, plain = cnn_lstm_imdb(), CNNLSTMIMDB()
    assert sum(p.numel() for p in port.parameters()) == 2_700_098
    assert [p.shape for p in port.parameters()] == [p.shape for p in plain.parameters()]
    assert [n for n, _ in port.named_buffers()] == ["lstm.bias_hh_l0"]
    assert port(torch.zeros(3, 100, dtype=torch.long, device="meta")).shape == (3, 2)


def test_network_equals_the_plain_reference():
    port, plain = _port(), CNNLSTMIMDB(**SMALL).double()
    theta = _flat_start(port, 3)
    x, _ = _data()
    want = _call(plain, theta, x.double())  # the reference takes ids as floats
    torch.testing.assert_close(_call(port, theta, x), want, rtol=1e-13, atol=1e-13)
    assert want.std() > 0.05  # the logits move with the parameters


def test_haiku_cell_against_its_equations():
    """One bias a gate (``bias_ih_l0``) and sigmoid(f + 1) on the forget gate,
    PyTorch's gate order i, f, g, o down the rows."""
    torch.manual_seed(0)
    lstm = HaikuLSTM(3, 4).double()
    assert [n for n, _ in lstm.named_parameters()] == ["weight_ih_l0", "weight_hh_l0",
                                                      "bias_ih_l0"]
    torch.testing.assert_close(lstm.bias_hh_l0, torch.tensor([0.0] * 4 + [1.0] * 4 + [0.0] * 8,
                                                             dtype=torch.float64))
    with torch.no_grad():
        lstm.bias_ih_l0.normal_()
    x = torch.randn(2, 5, 3, dtype=torch.float64)
    h = c = torch.zeros(2, 4, dtype=torch.float64)
    for t in range(5):
        z = x[:, t] @ lstm.weight_ih_l0.T + h @ lstm.weight_hh_l0.T + lstm.bias_ih_l0
        i, f, g, o = z.split(4, dim=1)
        c = torch.sigmoid(f + 1) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
    out, (h_n, c_n) = lstm(x)
    torch.testing.assert_close(out[:, -1], h, rtol=1e-14, atol=1e-14)
    torch.testing.assert_close(c_n[0], c, rtol=1e-14, atol=1e-14)


@pytest.mark.parametrize("chains", [1, 3])
@pytest.mark.parametrize("block_rows", [None, 5, 7, 23, 100])
def test_potential_equals_the_reference(block_rows, chains):
    """Value and gradient under ``vmap`` over chains against the reference's
    float64 posterior (``reference/hmc_chains.Posterior``)."""
    lp, init, _ = _potential(block_rows)
    gen = torch.Generator().manual_seed(chains)
    theta = _flat_start(_port(), 5) + 0.01 * torch.randn(chains, init.numel(), generator=gen,
                                                         dtype=torch.float64)
    grad, value = torch.func.vmap(torch.func.grad_and_value(lp))(theta)
    x, y = _data()
    want_value, want_grad = ref.Posterior(CNNLSTMIMDB(**SMALL), x, y, CFG)(theta)
    torch.testing.assert_close(value, want_value, rtol=1e-13, atol=1e-10)
    torch.testing.assert_close(grad, want_grad, rtol=1e-12, atol=1e-10)
    assert float(want_grad.abs().max()) > 1.0


def test_blocked_hmc_draws_the_reference_chains():
    """``run_hmc_chains`` on the blocked and the whole potential draw the same
    chains, and the reference's HMC (``reference/hmc_chains.hmc``, the
    program's noise) draws them too."""
    lp, _, _ = _potential()
    lpb, _, _ = _potential(7)
    theta = _flat_start(_port(), 9).expand(3, -1).clone()
    config = MCMCConfig(num_samples=4, num_steps_per_sample=3, step_size=0.15)
    want = run_hmc_chains(17, lp, theta, config, 3)
    got = run_hmc_chains(17, lpb, theta, config, 3)
    assert torch.equal(got.stats.accepted, want.stats.accepted)
    assert 0 < int(want.stats.accepted.sum()) < 12  # both outcomes of the Metropolis test
    torch.testing.assert_close(got.samples, want.samples, rtol=0, atol=1e-12)
    torch.testing.assert_close(got.stats.energy_new, want.stats.energy_new, rtol=1e-13, atol=1e-9)
    x, y = _data()
    post = ref.Posterior(CNNLSTMIMDB(**SMALL), x, y, {**CFG, "reference_rows": 10})
    chain, final, count, h0, h1 = ref.hmc(17, post, theta, 4, 3, 0.15, theta.dtype)
    assert torch.equal(chain, torch.arange(3))
    torch.testing.assert_close(count, want.stats.accepted.double().sum(1))
    torch.testing.assert_close(final, got.final_state.theta, rtol=0, atol=1e-12)
    torch.testing.assert_close(h0, got.stats.energy_old, rtol=1e-13, atol=1e-9)
    torch.testing.assert_close(h1, got.stats.energy_new, rtol=1e-13, atol=1e-9)


@pytest.mark.parametrize("block_rows", [None, 7])
def test_recorder_counts_stages_tokens_and_steps(block_rows):
    lp, init, _ = _potential(block_rows)
    theta = _flat_start(_port(), 2).expand(2, -1).clone()
    config = MCMCConfig(num_samples=2, num_steps_per_sample=3, step_size=0.01)
    profiling.reset()
    try:
        run_hmc_chains(1, lp, theta, config, 2)  # not recording: nothing kept
        assert profiling.spans() == [] and profiling.counters() == {}
        with profiling.recording():
            run_hmc_chains(2, lp, theta, config, 2)
        spans, counters = profiling.spans(), profiling.counters()
    finally:
        profiling.reset()
    # the whole potential runs one forward for both chains (vmap), the
    # blocked one a forward a chain and block
    grads = 2 * 3 + 1
    forwards = grads * (1 if block_rows is None else 2 * math.ceil(N / block_rows))
    stages = ("cnn_lstm.embed", "cnn_lstm.conv", "cnn_lstm.lstm", "cnn_lstm.head")
    names = [s.name for s in spans if s.name.startswith("cnn_lstm.")]
    assert names == list(stages) * forwards
    rows = N * (1 if block_rows is None else 2)  # reviews a gradient's forwards see
    assert counters["cnn_lstm.tokens"] == grads * rows * LENGTH
    assert counters["cnn_lstm.steps"] == forwards * ((LENGTH - 4) // 4)


class _Recurrent(nn.Module):
    def __init__(self):
        super().__init__()
        self.lstm = nn.LSTM(3, 4, num_layers=2, dropout=0.5, batch_first=True)
        self.drop = nn.Dropout(0.5)
        self.gru = nn.GRU(4, 5, batch_first=True)
        self.head = nn.Linear(5, 2)

    def forward(self, x):
        return self.head(self.gru(self.drop(self.lstm(x)[0]))[0][:, -1])


def test_private_copy_runs_recurrent_layers_in_training_mode_without_dropout():
    torch.manual_seed(0)
    module = _Recurrent().double()
    x = torch.randn(6, 7, 3, dtype=torch.float64)
    copy = _private_copy(module, "cpu")
    assert module.training and all(m.training for m in module.modules())  # the caller's
    modes = {name: (m.training, getattr(m, "dropout", None)) for name, m in copy.named_modules()}
    assert modes == {"": (False, None), "lstm": (True, 0.0), "drop": (False, None),
                     "gru": (True, 0.0), "head": (False, None)}
    assert copy.drop.p == 0.5 and module.lstm.dropout == 0.5
    want = module.eval()(x)
    torch.testing.assert_close(copy(x), want, rtol=0, atol=0)
    torch.testing.assert_close(copy(x), copy(x), rtol=0, atol=0)  # no dropout drawn
    lp, init, _ = define_model_log_prob(module, "multi_class_linear_output", x,
                                        torch.tensor([0, 1, 1, 0, 1, 0]), device="cpu")
    assert torch.isfinite(torch.func.grad(lp)(init)).all()


def test_recurrent_module_on_cuda_takes_block_rows():
    """On a CUDA device the whole potential cannot differentiate cuDNN's fused
    RNN under ``torch.func``: ``define_model_log_prob`` asks for
    ``block_rows`` before it touches the device (so this runs on the CPU)."""
    x, y = _data()
    for model in (_port(), _Recurrent()):
        with pytest.raises(ValueError, match="block_rows"):
            define_model_log_prob(model, "multi_class_linear_output", x, y, device="cuda")
    lp, init, _ = define_model_log_prob(_port(), "multi_class_linear_output", x, y, device="cpu")
    assert torch.isfinite(torch.func.grad(lp)(init)).all()


def test_prior_keeps_a_number_tau_on_the_host(monkeypatch):
    """A number tau makes no tensor: on the card that would be a blocking
    host-to-device copy a leaf and gradient, which holds the host until the
    card has run everything queued.  The value is the formula's, and a
    tensor tau gives it too."""
    from hamiltorch_tpu_torch.models import bnn

    w = torch.randn(7, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    want = 3.5 * math.log(5.0) - 3.5 * math.log(2 * math.pi) - 2.5 * torch.sum(w * w)

    def refuse(*args, **kwargs):
        raise AssertionError("a tensor was made of tau")

    with monkeypatch.context() as m:
        m.setattr(torch, "as_tensor", refuse)
        m.setattr(torch, "tensor", refuse)
        got = bnn._normal_log_prob(w, 5.0)
    torch.testing.assert_close(got, want, rtol=1e-15, atol=0)
    torch.testing.assert_close(bnn._normal_log_prob(w, torch.tensor(5.0)), want,
                               rtol=1e-15, atol=0)
