"""ResNet-20-FRN (``models/resnet_frn.py``) and the blocked, float32-held potential.

The network is held against the benchmark's plain reference
(``benchmark/reference/resnet20_frn.py``, written from the equations) on
one flat vector of seeded parameters, in float64, at every layer of the
network with narrow widths and 8x8 images.  The potential with
``block_rows`` is held against the one without, in float64: values and
gradients to float64 rounding, under ``torch.func.grad_and_value`` and
``vmap`` over chains, and through ``run_hmc_chains`` draw for draw.  The
TF32 switches are read inside the potential's forward and backward, and
after it; the recorder's spans and counters are counted.
"""

import math

import pytest
import torch
from torch import nn

from benchmark.reference.resnet20_frn import ResNet20FRN
from hamiltorch_tpu_torch.models import FilterResponseNorm, resnet20_frn_swish
from hamiltorch_tpu_torch.models.bnn import define_model_log_prob, sample_model
from hamiltorch_tpu_torch.samplers.driver import MCMCConfig
from hamiltorch_tpu_torch.samplers.hmc import run_hmc_chains
from hamiltorch_tpu_torch.utils import profiling
from hamiltorch_tpu_torch.utils.precision import full_float32

SMALL = dict(num_classes=10, widths=(4, 8, 8))
N = 23  # rows: blocks of 5 and 7 do not divide it, 23 does


def _flat_start(module, seed):
    """He-normal weights, FRN's gamma near 1 and tau near -3, the rest near 0."""
    gen = torch.Generator().manual_seed(seed)
    parts = []
    for name, p in module.named_parameters():
        z = torch.randn(p.numel(), generator=gen, dtype=torch.float64)
        if name.endswith("weight"):
            parts.append(z * math.sqrt(2.0 / p[0].numel()))
        else:
            base = {"gamma": 1.0, "tau": -3.0}.get(name.rsplit(".", 1)[-1], 0.0)
            parts.append(base + 0.1 * z)
    return torch.cat(parts)


def _data(n=N, side=8, seed=1):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(n, 3, side, side, generator=gen, dtype=torch.float64),
            torch.randint(0, 10, (n,), generator=gen))


def _potential(block_rows=None, model=None, x=None, y=None):
    model = model if model is not None else resnet20_frn_swish(**SMALL).double()
    if x is None:
        x, y = _data()
    return define_model_log_prob(model, "multi_class_linear_output", x, y, tau_list=5.0,
                                 device="cpu", block_rows=block_rows)


def test_parameters_of_the_published_network():
    """273,754 parameters at 32x32 and 10 classes, in the reference's shapes and order."""
    port, plain = resnet20_frn_swish(), ResNet20FRN()
    assert sum(p.numel() for p in port.parameters()) == 273_754
    assert [p.shape for p in port.parameters()] == [p.shape for p in plain.parameters()]
    assert port(torch.randn(2, 3, 32, 32)).shape == (2, 10)


def test_network_equals_the_plain_reference():
    port = resnet20_frn_swish(**SMALL).double()
    plain = ResNet20FRN(**SMALL).double()
    theta = _flat_start(port, 3)
    x, _ = _data()

    def run(module):
        names = [n for n, _ in module.named_parameters()]
        shapes = [p.shape for p in module.parameters()]
        params = dict(zip(names, (t.view(s) for t, s in
                                  zip(theta.split([math.prod(s) for s in shapes]), shapes))))
        return torch.func.functional_call(module, params, (x,))

    want = run(plain)
    torch.testing.assert_close(run(port), want, rtol=1e-13, atol=1e-13)
    assert want.std() > 0.1  # the logits move with the parameters


def test_filter_response_norm():
    frn = FilterResponseNorm(2, eps=1e-6).double()
    with torch.no_grad():
        frn.gamma.copy_(torch.tensor([2.0, 0.5]).view(1, 2, 1, 1))
        frn.tau.fill_(-0.25)
    x = torch.randn(3, 2, 4, 4, dtype=torch.float64)
    nu2 = (x * x).mean(dim=(2, 3), keepdim=True)
    want = torch.maximum(frn.gamma * x / torch.sqrt(nu2 + 1e-6), torch.full_like(x, -0.25))
    torch.testing.assert_close(frn(x), want)


@pytest.mark.parametrize("chains", [1, 3])
@pytest.mark.parametrize("block_rows", [5, 7, 23, 100])
def test_blocked_potential_equals_the_whole(block_rows, chains):
    lp, init, _ = _potential()
    lpb, _, _ = _potential(block_rows)
    gen = torch.Generator().manual_seed(chains)
    theta = _flat_start(resnet20_frn_swish(**SMALL), 5) + 0.01 * torch.randn(
        chains, init.numel(), generator=gen, dtype=torch.float64)
    want = torch.func.vmap(torch.func.grad_and_value(lp))(theta)
    got = torch.func.vmap(torch.func.grad_and_value(lpb))(theta)
    torch.testing.assert_close(got[1], want[1], rtol=1e-13, atol=1e-10)
    torch.testing.assert_close(got[0], want[0], rtol=1e-12, atol=1e-10)
    torch.testing.assert_close(lpb(theta[0]), lp(theta[0]), rtol=1e-13, atol=1e-10)


def test_blocked_hmc_draws_the_same_chains():
    lp, _, _ = _potential()
    lpb, _, _ = _potential(7)
    theta = _flat_start(resnet20_frn_swish(**SMALL), 9).expand(3, -1).clone()
    config = MCMCConfig(num_samples=4, num_steps_per_sample=3, step_size=0.01)
    want = run_hmc_chains(17, lp, theta, config, 3)
    got = run_hmc_chains(17, lpb, theta, config, 3)
    assert torch.equal(got.stats.accepted, want.stats.accepted)
    assert 0 < int(want.stats.accepted.sum()) < 12  # both outcomes of the Metropolis test
    torch.testing.assert_close(got.samples, want.samples, rtol=0, atol=1e-12)
    torch.testing.assert_close(got.stats.energy_old, want.stats.energy_old, rtol=1e-13, atol=1e-9)
    torch.testing.assert_close(got.stats.energy_new, want.stats.energy_new, rtol=1e-13, atol=1e-9)


def test_sample_model_forwards_block_rows():
    x, y = _data(n=9)
    model = nn.Sequential(nn.Flatten(), nn.Linear(3 * 8 * 8, 10)).double()
    kw = dict(num_samples=3, num_steps_per_sample=2, step_size=0.01, key=4, verbose=False,
              tau_list=5.0, device="cpu")
    torch.testing.assert_close(sample_model(model, x, y, block_rows=4, **kw),
                               sample_model(model, x, y, **kw), rtol=0, atol=1e-12)


def test_blocks_refuse_predict_and_hessians():
    x, y = _data()
    with pytest.raises(ValueError, match="predict"):
        define_model_log_prob(resnet20_frn_swish(**SMALL), "multi_class_linear_output", x, y,
                              predict=True, device="cpu", block_rows=5)
    with pytest.raises(ValueError, match="positive"):
        _potential(0)
    model = nn.Sequential(nn.Flatten(), nn.Linear(3 * 8 * 8, 10)).double()
    lpb, init, _ = _potential(5, model, x, y)
    with pytest.raises((NotImplementedError, RuntimeError)):
        torch.func.hessian(lpb)(init)


class _Switches(torch.autograd.Function):
    """Identity that notes the TF32 switches in its forward and its backward."""

    generate_vmap_rule = True
    seen = []

    @staticmethod
    def forward(a):
        _Switches.seen.append(("forward",) + _switches())
        return a.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        _Switches.seen.append(("backward",) + _switches())
        return g


def _switches():
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


class _Probe(nn.Module):
    def __init__(self, fail=False):
        super().__init__()
        self.lin = nn.Linear(3 * 8 * 8, 10)
        self.fail = fail

    def forward(self, x):
        if self.fail:
            raise FloatingPointError("a forward that fails")
        return _Switches.apply(self.lin(x.flatten(1)))


@pytest.fixture
def tf32_on():
    saved = _switches()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    _Switches.seen.clear()
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.parametrize("block_rows", [None, 5])
def test_tf32_is_held_off_inside_the_potential(tf32_on, block_rows):
    x, y = _data()
    lp, init, _ = define_model_log_prob(_Probe(), "multi_class_linear_output", x.float(), y,
                                        device="cpu", block_rows=block_rows)
    torch.func.vmap(torch.func.grad_and_value(lp))(init.expand(2, -1))
    lp(init)
    both = [("forward", False, False), ("backward", False, False)]
    if block_rows is None:  # one forward and backward, then a forward
        assert _Switches.seen == both + both[:1]
    else:  # a forward and backward a block and chain, for the value too
        assert _Switches.seen == both * 5 * 2 + both * 5
    assert _switches() == (True, True)


@pytest.mark.parametrize("block_rows", [None, 5])
def test_tf32_switches_are_restored_after_an_error(tf32_on, block_rows):
    x, y = _data()
    lp, init, _ = define_model_log_prob(_Probe(fail=True), "multi_class_linear_output",
                                        x.float(), y, device="cpu", block_rows=block_rows)
    with pytest.raises(FloatingPointError):
        torch.func.grad(lp)(init)
    assert _switches() == (True, True)
    with pytest.raises(KeyError), full_float32():
        assert _switches() == (False, False)
        raise KeyError("inside")
    assert _switches() == (True, True)


@pytest.mark.parametrize("block_rows", [5, 23])
def test_recorder_counts_calls_gradients_and_blocks(block_rows):
    lpb, init, _ = _potential(block_rows)
    theta = _flat_start(resnet20_frn_swish(**SMALL), 2).expand(2, -1).clone()
    config = MCMCConfig(num_samples=2, num_steps_per_sample=3, step_size=0.01)
    profiling.reset()
    try:
        run_hmc_chains(1, lpb, theta, config, 2)  # not recording: nothing kept
        assert profiling.spans() == [] and profiling.counters() == {}
        with profiling.recording():
            for key in (2, 3):
                run_hmc_chains(key, lpb, theta, config, 2)
        spans = profiling.spans()
        counters = profiling.counters()
    finally:
        profiling.reset()
    calls = [s for s in spans if s.name == "run_hmc_chains"]
    grads = 2 * 2 * (2 * 3 + 1)  # calls x chains x (the start's gradient, then L a draw)
    potentials = [s for s in spans if s.name == "potential"]
    blocks = [s for s in spans if s.name == "potential.block"]
    assert len(calls) == 2 and all(s.parent is None for s in calls)
    assert len(potentials) == grads and len(blocks) == grads * math.ceil(N / block_rows)
    ids = {s.id: s for s in spans}
    assert all(ids[b.parent].name == "potential" for b in blocks)
    assert all(ids[p.parent].name == "run_hmc_chains" for p in potentials)
    assert {p.call for p in potentials} == {s.id for s in calls}
    assert counters == {"potential.blocks": grads * math.ceil(N / block_rows),
                        "potential.rows": grads * N}
