"""The same-width 3x3 convolution (``kernels/conv3x3.py``) and ResNet-20-FRN's ``Conv3x3``.

On the CPU: the plain path (``_Conv3x3`` runs ``F.conv2d`` forward and
``_backward_reference`` backward) against ``F.conv2d`` under autograd in
float64, at the three widths of ResNet-20-FRN, under ``torch.func.grad``
and ``vmap`` too; ``Conv3x3``'s parameters against ``nn.Conv2d``'s; the
network's flat parameter vector; the shapes and types the wrapper refuses.

On the card (``gpu``; skipped without a CUDA device; no JAX imported):

    python -m pytest tests/test_torch_conv3x3.py -m gpu --noconftest -q

the kernels against the formula in float64 (cuDNN in float64) at the
``resnet20_frn`` cell's blocks of 10,000 rows and at ragged batches, twice
the same bits, the launch counts, and one blocked ResNet-20-FRN gradient
against the float64 gradient of ``F.conv2d``.  Tolerances relative to the
largest entry of each output: float32 at the tensor-core shapes, 2e-5
(3xTF32 products, each ~2^-21 of its value off, summed in float32 over 9 C
terms, or over up to 10,000 x 1,024 / 264 pixels a partial of the weight
gradient); the generic variant, float32 2e-6 (fused multiply-adds over 9 C
terms) and float64 1e-12.
"""

import math
import types

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from hamiltorch_tpu_torch.kernels import conv3x3 as cv
from hamiltorch_tpu_torch.models import resnet20_frn_swish
from hamiltorch_tpu_torch.models.bnn import define_model_log_prob
from hamiltorch_tpu_torch.models.resnet_frn import Conv3x3
from hamiltorch_tpu_torch.utils import profiling

WIDTHS = [(16, 8), (32, 6), (64, 5)]  # (C, side) on the CPU
# (N, C, side): the cell's three stages at a block's rows, then ragged batches
CELL = [(10_000, 16, 32), (10_000, 32, 16), (10_000, 64, 8)]
RAGGED = [(37, 16, 32), (29, 32, 16), (41, 64, 8)]
RTOL_FAST = 2e-5
RTOL_ANY = {torch.float32: 2e-6, torch.float64: 1e-12}


def _inputs(n, c, side, dtype=torch.float64, device="cpu", seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(n, c, side, side, generator=gen, dtype=torch.float64)
    w = math.sqrt(2 / (9 * c)) * torch.randn(c, c, 3, 3, generator=gen, dtype=torch.float64)
    b = 0.1 * torch.randn(c, generator=gen, dtype=torch.float64)
    dy = torch.randn(n, c, side, side, generator=gen, dtype=torch.float64)
    return [t.to(device=device, dtype=dtype) for t in (x, w, b, dy)]


def _autograd(fn, x, w, b, dy):
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, w, b)]
    out = fn(*leaves)
    return (out.detach(), *torch.autograd.grad(out, leaves, dy))


def _conv2d(x, w, b):
    return F.conv2d(x, w, b, padding=1)


@pytest.mark.parametrize("c,side", WIDTHS)
def test_plain_path_equals_conv2d_under_autograd(c, side):
    x, w, b, dy = _inputs(3, c, side)
    got = _autograd(cv._Conv3x3.apply, x, w, b, dy)
    want = _autograd(_conv2d, x, w, b, dy)
    for name, a, v in zip(("out", "dx", "dw", "db"), got, want):
        torch.testing.assert_close(a, v, rtol=1e-12, atol=1e-12, msg=name)


@pytest.mark.parametrize("need_dx", [True, False])
@pytest.mark.parametrize("c,side", WIDTHS + [(3, 7)])
def test_backward_reference_equals_autograd(c, side, need_dx):
    x, w, b, dy = _inputs(2, c, side, seed=1)
    dx, dw, db = cv._backward_reference(dy, x, w, need_dx)
    _, want_dx, want_dw, want_db = _autograd(_conv2d, x, w, b, dy)
    assert (dx is None) == (not need_dx)
    if need_dx:
        torch.testing.assert_close(dx, want_dx, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(dw, want_dw, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(db, want_db, rtol=1e-12, atol=1e-12)


def test_plain_path_under_grad_and_vmap():
    """Per-chain weights under ``vmap`` of ``torch.func.grad``, and an input
    that needs no gradient (the backward skips dx)."""
    x, _, _, _ = _inputs(2, 16, 4, seed=2)
    gen = torch.Generator().manual_seed(3)
    ws = 0.1 * torch.randn(3, 16, 16, 3, 3, generator=gen, dtype=torch.float64)
    bs = torch.randn(3, 16, generator=gen, dtype=torch.float64)

    def loss(fn):
        return lambda w, b: torch.tanh(fn(x, w, b)).square().sum()

    got = torch.func.vmap(torch.func.grad(loss(cv._Conv3x3.apply), argnums=(0, 1)))(ws, bs)
    want = torch.func.vmap(torch.func.grad(loss(_conv2d), argnums=(0, 1)))(ws, bs)
    for a, v in zip(got, want):
        torch.testing.assert_close(a, v, rtol=1e-12, atol=1e-12)


def test_double_backward_and_forward_mode_raise():
    x, w, b, _ = _inputs(2, 16, 4, seed=4)
    x.requires_grad_(True)
    (g,) = torch.autograd.grad(cv._Conv3x3.apply(x, w, b).square().sum(), x, create_graph=True)
    with pytest.raises(RuntimeError, match="first derivatives only"):
        g.sum().backward()
    with pytest.raises(NotImplementedError, match="forward-mode"):
        torch.func.jvp(lambda v: cv._Conv3x3.apply(v, w, b), (x.detach(),), (torch.ones_like(x),))


@pytest.mark.parametrize("c", [16, 32, 64])
def test_conv3x3_module_has_the_parameters_of_conv2d(c):
    torch.manual_seed(c)
    got = Conv3x3(c)
    torch.manual_seed(c)
    want = nn.Conv2d(c, c, 3, padding=1)
    assert [(n, p.shape) for n, p in got.named_parameters()] == \
        [(n, p.shape) for n, p in want.named_parameters()] == \
        [("weight", (c, c, 3, 3)), ("bias", (c,))]
    for a, v in zip(got.parameters(), want.parameters()):
        assert torch.equal(a, v)  # the same initialisation, drawn in the same order
    x = torch.randn(2, c, 8, 8)
    torch.testing.assert_close(got(x), want(x), rtol=0, atol=0)


def test_network_keeps_its_flat_parameter_vector():
    """273,754 parameters in ``named_parameters()`` order: the stem, then per
    block conv1, norm1, conv2, norm2 (and the shortcut in stride-2 blocks),
    then the head; the 16 same-width stride-1 convolutions are Conv3x3."""
    model = resnet20_frn_swish()
    norm = ["gamma", "beta", "tau"]
    want = ["0.weight", "0.bias"] + [f"1.{k}" for k in norm]
    for i in range(3, 12):
        want += [f"{i}.conv1.weight", f"{i}.conv1.bias"] + [f"{i}.norm1.{k}" for k in norm]
        want += [f"{i}.conv2.weight", f"{i}.conv2.bias"] + [f"{i}.norm2.{k}" for k in norm]
        if i in (6, 9):
            want += [f"{i}.shortcut.weight", f"{i}.shortcut.bias"]
    want += ["14.weight", "14.bias"]
    assert [n for n, _ in model.named_parameters()] == want
    assert sum(p.numel() for p in model.parameters()) == 273_754
    same = [n for n, m in model.named_modules() if isinstance(m, Conv3x3)]
    assert len(same) == 16
    assert sorted(same) == sorted([f"{i}.conv2" for i in range(3, 12)]
                                  + [f"{i}.conv1" for i in range(3, 12) if i not in (6, 9)])
    plain = [m for m in model.modules() if type(m) is nn.Conv2d]
    assert [tuple(m.weight.shape) for m in plain] == [
        (16, 3, 3, 3), (32, 16, 3, 3), (32, 16, 1, 1), (64, 32, 3, 3), (64, 32, 1, 1)]


def test_refused_shapes_and_types():
    x, w, b, _ = _inputs(2, 16, 8, dtype=torch.float32)
    with pytest.raises(TypeError, match="float32 or float64"):
        cv.conv3x3(x.half(), w.half(), b.half())
    with pytest.raises(ValueError, match=r"\(16, 16, 3, 3\) weight"):
        cv.conv3x3(x, torch.randn(32, 16, 3, 3), torch.randn(32))  # Cin != Cout
    with pytest.raises(ValueError, match="bias"):
        cv.conv3x3(x, w, torch.randn(32))
    with pytest.raises(ValueError, match="square planes"):
        cv.conv3x3(x[..., :4], w, b)
    strided = Conv3x3(16)
    strided.stride = (2, 2)
    with pytest.raises(ValueError, match="stride 1"):
        strided(x)


# ---- on the card ----


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _kernel_outputs(x, w, b, dy):
    return (cv._forward_cuda(x, w, b), cv._dgrad_cuda(dy, w), *cv._wgrad_cuda(dy, x))


def _formula_outputs(x, w, b, dy):
    return _autograd(_conv2d, *(t.double() for t in (x, w, b, dy)))


def _rel_errs(got, want):
    return [float((a.double() - v).abs().max() / v.abs().max()) for a, v in zip(got, want)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", CELL + RAGGED)
def test_kernels_match_the_formula(cuda_device, shape):
    args = _inputs(*shape, dtype=torch.float32, device=cuda_device, seed=5)
    errs = _rel_errs(_kernel_outputs(*args), _formula_outputs(*args))
    assert max(errs) <= RTOL_FAST, errs


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(3, 16, 32), (4, 8, 8), (2, 5, 7), (3, 64, 16)])
def test_the_generic_variant_matches_the_formula(cuda_device, shape, dtype):
    """Float64 at every shape, float32 at shapes the tensor cores do not take."""
    if dtype == torch.float32 and shape == (3, 16, 32):
        pytest.skip("a tensor-core shape: test_kernels_match_the_formula")
    args = _inputs(*shape, dtype=dtype, device=cuda_device, seed=6)
    got = _kernel_outputs(*args)
    assert all(a.dtype == dtype for a in got)
    errs = _rel_errs(got, _formula_outputs(*args))
    assert max(errs) <= RTOL_ANY[dtype], errs


@pytest.mark.gpu
@pytest.mark.parametrize("shape", CELL[:1] + RAGGED + [(5, 8, 8)])
def test_kernels_give_the_same_bits_twice(cuda_device, shape):
    args = _inputs(*shape, dtype=torch.float32, device=cuda_device, seed=7)
    first, second = _kernel_outputs(*args), _kernel_outputs(*args)
    assert all(torch.equal(a, v) for a, v in zip(first, second))


@pytest.mark.gpu
@pytest.mark.parametrize("need_dx", [True, False])
def test_launches_a_forward_and_backward(cuda_device, need_dx):
    """1 kernel forward; backward 1 for dx, 2 for the weight and bias (the
    partials and their sum)."""
    x, w, b, dy = _inputs(3, 32, 16, dtype=torch.float32, device=cuda_device, seed=8)
    leaves = [x.requires_grad_(need_dx), w.requires_grad_(True), b.requires_grad_(True)]
    profiling.reset()
    try:
        with profiling.recording():
            before = cv.conv3x3.launches
            out = cv.conv3x3(*leaves)
            assert cv.conv3x3.launches == before + 1
            grads = torch.autograd.grad(out, [t for t in leaves if t.requires_grad], dy)
            assert cv.conv3x3.launches == before + (4 if need_dx else 3)
        assert profiling.counters()["conv3x3.launches"] == (4 if need_dx else 3)
    finally:
        profiling.reset()
    want = _formula_outputs(x.detach(), w.detach(), b.detach(), dy)
    assert max(_rel_errs(grads, want[1 if need_dx else 2:])) <= RTOL_FAST


@pytest.mark.gpu
def test_a_blocked_resnet_gradient_matches_float64(cuda_device):
    """One gradient of the blocked potential of the published network at
    32x32 on 300 rows in two blocks, float32 on the card through the
    kernels (16 convolutions x 4 kernels x 2 blocks), against the float64
    gradient on the CPU, where Conv3x3 is ``F.conv2d``.  Tolerance: twice
    the error of the same float32 network with cuDNN's float32 convolutions
    (TF32 off) in place of the kernels, ~1e-4 of the largest entry: float32
    activations through 20 layers and FRN's normalisations."""
    torch.manual_seed(9)
    gen = torch.Generator().manual_seed(9)
    x = torch.randn(300, 3, 32, 32, generator=gen)
    y = torch.randint(0, 10, (300,), generator=gen)

    def gradient(model, device, theta):
        lp, _, _ = define_model_log_prob(model, "multi_class_linear_output", x.to(device),
                                         y.to(device), tau_list=5.0, device=device, block_rows=150)
        return torch.func.grad(lp)(theta.to(device)).double().cpu()

    theta = torch.cat([p.detach().flatten() for p in resnet20_frn_swish().parameters()])
    want = gradient(resnet20_frn_swish().double(), "cpu", theta.double())
    before = cv.conv3x3.launches
    got = gradient(resnet20_frn_swish().to(cuda_device), cuda_device, theta)
    assert cv.conv3x3.launches == before + 16 * 4 * 2
    plain = resnet20_frn_swish().to(cuda_device)
    for m in plain.modules():
        if isinstance(m, Conv3x3):
            m.forward = types.MethodType(nn.Conv2d.forward, m)
    cudnn = gradient(plain, cuda_device, theta)
    assert cv.conv3x3.launches == before + 16 * 4 * 2

    def err(g):
        return float((g - want).abs().max() / want.abs().max())

    assert err(got) <= 2 * err(cudnn), (err(got), err(cudnn))
