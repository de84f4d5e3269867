"""FRN with TLU's CUDA kernels (``kernels/frn_tlu.py``) on the card.

These tests need a CUDA device and skip without one.  They import no JAX:

    python -m pytest tests/test_torch_frn_tlu.py -m gpu --noconftest -q

The kernels are held against the formula (``frn_tlu_reference``) in float64
on the same inputs, forward and every gradient, at the register path's
planes (8x8, 16x16, 32x32) and the generic variant's (4x4, 7x7, 28x28,
64x64), with ragged N and C and planted ties y == tau (x = 0 where tau =
beta), at which the gradient splits in halves.  Tolerances relative to the
largest entry of each output: float32 sums of up to 4,096 terms a plane in
another order, 2e-5; float64, 1e-12.
"""

import math
import re

import pytest
import torch

from hamiltorch_tpu_torch.kernels import frn_tlu as ft
from hamiltorch_tpu_torch.models import resnet20_frn_swish
from hamiltorch_tpu_torch.models.bnn import define_model_log_prob
from hamiltorch_tpu_torch.utils import profiling

RTOL = {torch.float32: 2e-5, torch.float64: 1e-12}
# (N, C, side): the register path's planes, then the generic variant's
SHAPES = [(3, 5, 8), (2, 3, 16), (5, 7, 32), (3, 5, 4), (2, 3, 7), (2, 5, 28), (2, 3, 64)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(n, c, side, dtype, device, seed=0):
    """x, gamma, beta, tau and an upstream gradient; channel 1 (or 0) has
    tau = beta and zeros in x, so its first row's zeros tie."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(n, c, side, side, generator=gen, dtype=torch.float64)
    gamma = 1 + 0.2 * torch.randn(1, c, 1, 1, generator=gen, dtype=torch.float64)
    beta = 0.1 * torch.randn(1, c, 1, 1, generator=gen, dtype=torch.float64)
    tau = beta - 0.5 + 0.1 * torch.randn(1, c, 1, 1, generator=gen, dtype=torch.float64)
    tie = min(1, c - 1)
    tau[0, tie] = beta[0, tie]
    x[:, tie, 0, : max(1, side // 2)] = 0.0
    dz = torch.randn(n, c, side, side, generator=gen, dtype=torch.float64)
    return [t.to(device=device, dtype=dtype) for t in (x, gamma, beta, tau, dz)]


def _kernel_outputs(x, gamma, beta, tau, dz, eps=1e-6):
    leaves = [t.clone().requires_grad_(True) for t in (x, gamma, beta, tau)]
    z = ft.frn_tlu(*leaves, eps)
    return (z.detach(), *torch.autograd.grad(z, leaves, dz))


def _formula_outputs(x, gamma, beta, tau, dz, eps=1e-6):
    leaves = [t.double().requires_grad_(True) for t in (x, gamma, beta, tau)]
    z = ft.frn_tlu_reference(*leaves, eps)
    return (z.detach(), *torch.autograd.grad(z, leaves, dz.double()))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernels_match_the_formula(cuda_device, shape, dtype):
    args = _inputs(*shape, dtype, cuda_device)
    before = ft.frn_tlu.launches
    got = _kernel_outputs(*args)
    torch.cuda.synchronize()
    assert ft.frn_tlu.launches == before + 3
    want = _formula_outputs(*args)
    for name, a, b in zip(("z", "dx", "dgamma", "dbeta", "dtau"), got, want):
        assert a.dtype == dtype and a.shape == b.shape, name
        err = float((a.double() - b).abs().max() / b.abs().max())
        assert err <= RTOL[dtype], (name, err)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 3, 8), (2, 3, 7)])
def test_ties_split_the_gradient_in_halves(cuda_device, shape):
    x, gamma, beta, tau, dz = _inputs(*shape, torch.float64, cuda_device)
    x[:, 1] = 0.0  # every response of channel 1 ties: y = beta = tau
    z, dx, dgamma, dbeta, dtau = _kernel_outputs(x, gamma, beta, tau, dz)
    torch.testing.assert_close(z[:, 1], torch.full_like(z[:, 1], float(tau[0, 1])))
    half = 0.5 * dz[:, 1].sum()
    torch.testing.assert_close(dbeta[0, 1, 0, 0], half, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(dtau[0, 1, 0, 0], half, rtol=1e-12, atol=1e-12)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(37, 16, 32), (29, 32, 16), (41, 64, 8), (5, 3, 28)])
def test_kernels_give_the_same_bits_twice(cuda_device, shape, dtype):
    args = _inputs(*shape, dtype, cuda_device, seed=3)
    first, second = _kernel_outputs(*args), _kernel_outputs(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
def test_an_unaligned_or_strided_input_takes_the_generic_variant(cuda_device):
    x, gamma, beta, tau, dz = _inputs(4, 3, 8, torch.float32, cuda_device, seed=4)
    flat = torch.cat([x.new_zeros(1), x.flatten()]).requires_grad_(True)
    shifted = flat[1:].view_as(x)  # 4 bytes past a 16-byte boundary
    params = [t.clone().requires_grad_(True) for t in (gamma, beta, tau)]
    strided = dz.transpose(2, 3).contiguous().transpose(2, 3)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        z = ft.frn_tlu(shifted, *params, 1e-6)
        got = (z.detach(), *torch.autograd.grad(z, [shifted, *params], strided))
        torch.cuda.synchronize()
    want = _formula_outputs(x, gamma, beta, tau, dz)
    for a, b in zip(got, want):
        assert float((a.double() - b).abs().max() / b.abs().max()) <= RTOL[torch.float32]
    kernels = {e.key for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
    assert any("frn_tlu_fwd_any_kernel" in k for k in kernels), sorted(kernels)
    assert any("frn_tlu_bwd_any_kernel" in k for k in kernels), sorted(kernels)


@pytest.mark.gpu
def test_double_backward_and_forward_mode_raise(cuda_device):
    x, gamma, beta, tau, _ = _inputs(2, 3, 8, torch.float64, cuda_device)
    x.requires_grad_(True)
    (g,) = torch.autograd.grad(ft.frn_tlu(x, gamma, beta, tau, 1e-6).square().sum(), x,
                               create_graph=True)
    with pytest.raises(RuntimeError, match="first derivatives only"):
        g.sum().backward()
    with pytest.raises(NotImplementedError, match="forward-mode"):
        torch.func.jvp(lambda v: ft.frn_tlu(v, gamma, beta, tau, 1e-6), (x.detach(),),
                       (torch.ones_like(x),))


def _small_resnet(device, dtype):
    model = resnet20_frn_swish(num_classes=10, widths=(4, 8, 8)).to(device=device, dtype=dtype)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(23, 3, 8, 8, generator=gen, dtype=dtype)
    y = torch.randint(0, 10, (23,), generator=gen)
    return model, x.to(device), y.to(device)


@pytest.mark.gpu
def test_a_traced_blocked_gradient_runs_every_frn_layer_through_the_kernels(cuda_device):
    """19 FRN layers x 5 blocks x (1 forward + 2 backward kernels) = 285
    launches, and no where, masked_fill or maximum kernel in the trace."""
    model, x, y = _small_resnet(cuda_device, torch.float32)
    lp, init, _ = define_model_log_prob(model, "multi_class_linear_output", x, y, tau_list=5.0,
                                        device=cuda_device, block_rows=5)
    torch.func.grad(lp)(init)  # warm: the kernels are built
    torch.cuda.synchronize()
    profiling.reset()
    try:
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            torch.func.grad(lp)(init)
            torch.cuda.synchronize()
        launches = profiling.counters().get("frn_tlu.launches")
    finally:
        profiling.reset()
    layers = sum(isinstance(m, type(model[1])) for m in model.modules())
    assert layers == 19
    assert launches == layers * math.ceil(23 / 5) * 3 == 285
    kernels = {e.key for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
    assert any("frn_tlu_bwd" in k for k in kernels), sorted(kernels)
    assert not [k for k in kernels if re.search(r"(?i)where|masked_fill|maximum", k)]


@pytest.mark.gpu
def test_the_network_on_the_card_equals_the_cpu(cuda_device):
    """The unblocked potential's value and gradient (``torch.func.grad``),
    and the model vmapped over samples (``predict_model``'s shape), on the
    card through the kernels against the CPU through the formula, float64."""
    model, x, y = _small_resnet("cpu", torch.float64)
    lp_h, init, _ = define_model_log_prob(model, "multi_class_linear_output", x, y, tau_list=5.0,
                                          device="cpu")
    lp_c, _, _ = define_model_log_prob(model, "multi_class_linear_output", x.to(cuda_device),
                                       y.to(cuda_device), tau_list=5.0, device=cuda_device)
    theta = init + 0.05 * torch.randn(3, init.numel(), generator=torch.Generator().manual_seed(2),
                                      dtype=torch.float64)
    before = ft.frn_tlu.launches
    got = torch.func.vmap(torch.func.grad_and_value(lp_c))(theta.to(cuda_device))
    assert ft.frn_tlu.launches == before + 3 * 19 * 3
    want = torch.func.vmap(torch.func.grad_and_value(lp_h))(theta)
    torch.testing.assert_close(got[1].cpu(), want[1], rtol=1e-12, atol=1e-9)
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-10, atol=1e-9)

    names = [n for n, _ in model.named_parameters()]
    shapes = [p.shape for p in model.parameters()]

    def logits(t, data):
        parts = t.split([math.prod(s) for s in shapes])
        return torch.func.functional_call(
            model, {n: p.view(s) for n, p, s in zip(names, parts, shapes)}, (data,))

    got = torch.func.vmap(lambda t: logits(t, x.to(cuda_device)))(theta.to(cuda_device))
    want = torch.stack([logits(t, x) for t in theta])
    torch.testing.assert_close(got.cpu(), want, rtol=1e-10, atol=1e-10)
