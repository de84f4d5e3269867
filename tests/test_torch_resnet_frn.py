"""ResNet-20-FRN (``models/resnet_frn.py``) and the blocked, float32-held potential.

The network is held against the benchmark's plain reference
(``benchmark/reference/resnet20_frn.py``, written from the equations) on
one flat vector of seeded parameters, in float64, at every layer of the
network with narrow widths and 8x8 images.  The potential with
``block_rows`` is held against the one without, in float64: values and
gradients to float64 rounding, under ``torch.func.grad_and_value`` and
``vmap`` over chains, and through ``run_hmc_chains`` draw for draw.  The
TF32 switches are read inside the potential's forward and backward, and
after it; the recorder's spans and counters are counted.  FRN with TLU's
``torch.autograd.Function`` (``kernels/frn_tlu.py``), which the card's
kernels sit behind, is held on its plain path against the formula that the
CPU runs: forward and gradients with ties, under ``torch.func.grad`` over
the potential and ``vmap`` over the model.
"""

import math

import pytest
import torch
from torch import nn

from benchmark.reference.resnet20_frn import ResNet20FRN
from hamiltorch_tpu_torch.kernels import frn_tlu as ft
from hamiltorch_tpu_torch.models import FilterResponseNorm, resnet20_frn_swish, resnet_frn
from hamiltorch_tpu_torch.models.bnn import define_model_log_prob, predict_model, sample_model
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


# ---------------------------------------------------------------------------
# FRN with TLU's Function on its plain path


def _frn_args(dtype, side=6, seed=0):
    """x, gamma, beta, tau and an upstream gradient; channel 1 has tau = beta
    and zeros in its first row, so those responses tie (y = beta = tau)."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(3, 4, side, side, generator=gen, dtype=torch.float64)
    gamma = 1 + 0.3 * torch.randn(1, 4, 1, 1, generator=gen, dtype=torch.float64)
    beta = 0.2 * torch.randn(1, 4, 1, 1, generator=gen, dtype=torch.float64)
    tau = beta - 0.3
    tau[0, 1] = beta[0, 1]
    x[:, 1, 0] = 0.0
    dz = torch.randn(x.shape, generator=gen, dtype=torch.float64)
    return [t.to(dtype) for t in (x, gamma, beta, tau, dz)]


def _through(fn, x, gamma, beta, tau, dz):
    leaves = [t.clone().requires_grad_(True) for t in (x, gamma, beta, tau)]
    z = fn(*leaves, 1e-6)
    return (z.detach(), *torch.autograd.grad(z, leaves, dz))


@pytest.mark.parametrize("side", [6, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_frn_function_equals_the_formula(dtype, side):
    """Forward, and the gradients of x, gamma, beta and tau, ties included:
    the kernels' backward algebra (``_backward_reference``) against
    autograd's of the formula; float32 within its rounding."""
    args = _frn_args(dtype, side)
    got = _through(ft._FrnTlu.apply, *args)
    want = _through(ft.frn_tlu_reference, *args)
    tol = {torch.float32: 1e-5, torch.float64: 1e-13}[dtype]
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == dtype and a.shape == b.shape
        assert float((a - b).abs().max()) <= tol * float(b.abs().max())


def test_frn_ties_split_the_gradient_in_halves():
    x, gamma, beta, tau, dz = _frn_args(torch.float64)
    x[:, 1] = 0.0  # every response of channel 1 ties
    z, dx, dgamma, dbeta, dtau = _through(ft._FrnTlu.apply, x, gamma, beta, tau, dz)
    assert torch.equal(z[:, 1], tau[0, 1].expand_as(z[:, 1]))
    half = 0.5 * dz[:, 1].sum()
    torch.testing.assert_close(dbeta[0, 1, 0, 0], half, rtol=1e-14, atol=1e-14)
    torch.testing.assert_close(dtau[0, 1, 0, 0], half, rtol=1e-14, atol=1e-14)
    want = _through(ft.frn_tlu_reference, x, gamma, beta, tau, dz)
    for a, b in zip((dx, dgamma, dbeta, dtau), want[1:]):
        torch.testing.assert_close(a, b, rtol=1e-13, atol=1e-13)


def test_the_cpu_module_runs_the_formula():
    """On CPU tensors the module is the formula under autograd, as before
    the kernels: no Function, no launch."""
    frn = FilterResponseNorm(3).double()
    before = ft.frn_tlu.launches
    out = frn(torch.randn(2, 3, 4, 4, dtype=torch.float64, requires_grad=True))
    assert "Maximum" in out.grad_fn.name()
    assert ft.frn_tlu.launches == before


@pytest.fixture
def frn_function(monkeypatch):
    """The model's FRN layers through the Function's plain path, as the
    card runs them through its kernels."""
    monkeypatch.setattr(resnet_frn, "frn_tlu", ft._FrnTlu.apply)


@pytest.mark.parametrize("block_rows", [None, 7])
def test_frn_function_under_grad_and_vmap_of_the_potential(frn_function, block_rows):
    lp, init, _ = _potential()
    theta = _flat_start(resnet20_frn_swish(**SMALL), 4) + 0.01 * torch.randn(
        2, init.numel(), generator=torch.Generator().manual_seed(6), dtype=torch.float64)
    got = torch.func.vmap(torch.func.grad_and_value(_potential(block_rows)[0]))(theta)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(resnet_frn, "frn_tlu", ft.frn_tlu_reference)
        want = torch.func.vmap(torch.func.grad_and_value(lp))(theta)
    torch.testing.assert_close(got[1], want[1], rtol=1e-13, atol=1e-10)
    torch.testing.assert_close(got[0], want[0], rtol=1e-12, atol=1e-10)
    torch.testing.assert_close(torch.func.grad(lp)(theta[0]), want[0][0], rtol=1e-12, atol=1e-10)


def test_frn_function_under_vmap_over_the_model(frn_function):
    """``predict_model`` vmaps the model over samples."""
    x, y = _data(n=5)
    model = resnet20_frn_swish(**SMALL).double()
    samples = torch.stack([_flat_start(model, s) for s in (1, 2, 3)])
    got = predict_model(model, samples, x, y, tau_list=5.0, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(resnet_frn, "frn_tlu", ft.frn_tlu_reference)
        want = predict_model(model, samples, x, y, tau_list=5.0, device="cpu")
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-13, atol=1e-12)


def test_frn_function_refuses_second_derivatives(frn_function):
    x, gamma, beta, tau, _ = _frn_args(torch.float64)
    x.requires_grad_(True)
    (g,) = torch.autograd.grad(ft._FrnTlu.apply(x, gamma, beta, tau, 1e-6).square().sum(), x,
                               create_graph=True)
    with pytest.raises(RuntimeError, match="first derivatives only"):
        g.sum().backward()
    with pytest.raises(NotImplementedError, match="forward-mode"):
        torch.func.jvp(lambda v: ft._FrnTlu.apply(v, gamma, beta, tau, 1e-6), (x.detach(),),
                       (torch.ones_like(x),))
    lp, init, _ = _potential()
    with pytest.raises(NotImplementedError, match="forward-mode"):
        torch.func.hessian(lp)(_flat_start(resnet20_frn_swish(**SMALL), 1))
