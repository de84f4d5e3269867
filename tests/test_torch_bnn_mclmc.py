"""The fused flagship MCLMC sampler: ``bnn_mclmc`` and its plain version.

(a) Against the Pallas kernel itself, run in interpret mode as the JAX
    package's own tests run it (``tests/test_mclmc_kernel.py:91-141``'s
    shapes, H=128, L=2).  Interpret mode's PRNG returns constant bits, so
    every refresh normal is one constant; the port's plain version takes it
    through its noise hook.  Two settings:

    * eps=2e-2, tau=1 (the JAX test's): parameters within 2e-6 and var_e
      at rtol 1e-3, atol 1e-9, as there.  Here the gradient's part of the
      move is ~1e-8, below the tolerance, and var_e (~1e-11 in the JAX
      kernel) is float32 rounding noise, so this case checks the velocity
      algebra and the refresh, not the gradient.
    * eps=1, tau=10: the gradient's part of the move (the result less the
      same run at tau=0) is >= 50x the 2e-6 tolerance in every parameter
      block, so a wrong likelihood gradient fails.  Parameters within
      2e-6; var_e (~3e-6) at rtol 1e-2: the JAX kernel computes the
      rotation's scalars in float32, where dk = (d-1)(delta - ln 2 + ...)
      loses (d-1) * 2^-24 * ln 2 ~ 1e-3 to cancellation per rotation
      against dE ~ 0.2 (the port computes them in float64).
(b) On CPU tensors the wrapper routes to the plain version and launches
    nothing; it rejects what it does not take.
(c) The CUDA kernel's order of arithmetic, emulated in plain PyTorch here
    (``emulate_fused_passes``), against the plain version: each rotation's
    dots come from where the gradient is produced, |w| follows from them
    without a pass over w, and the refresh's normalisation is applied by
    the next draw's first pass.  Parameters within 1e-6 at three small
    shapes and from u = -g/|g| at a step where zeta <= 0.05 in the first
    rotation (ce g nearly cancels 2 zeta u there).

The kernel itself runs only on a card: ``tests/test_torch_gpu.py``.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hamiltorch_tpu.kernels.bnn_mclmc import bnn_mclmc as j_bnn_mclmc
from hamiltorch_tpu_torch.kernels import bnn_mclmc, bnn_mclmc_reference
from hamiltorch_tpu_torch.kernels.bnn_grad import _bnn_gradient_reference
from hamiltorch_tpu_torch.kernels.bnn_mclmc import _B1, _refresh_weight
from test_torch_bnn_hmc import interpret_prng_constants

NAMES = ("x", "y", "w1", "b1", "w2", "b2", "u")
ATOL = 2e-6
VAR_E_FUSED_RTOL = 1e-3


def mclmc_inputs(i_dim, h, n, c, seed=0):
    rng = np.random.RandomState(seed)
    d = i_dim * h + 2 * h + 1
    return dict(
        x=rng.randn(n, i_dim).astype(np.float32),
        y=rng.randn(n, 1).astype(np.float32),
        w1=(0.01 * rng.randn(c, i_dim, h)).astype(np.float32),
        b1=np.zeros((c, h), np.float32),
        w2=(0.01 * rng.randn(c, h)).astype(np.float32),
        b2=np.zeros((c,), np.float32),
        u=rng.randn(c, d).astype(np.float32),
    )


def torch_args(inp):
    return [torch.as_tensor(inp[k]) for k in NAMES]


@pytest.mark.parametrize("eps,tau,var_rtol", [(2e-2, 1.0, 1e-3), (1.0, 10.0, 1e-2)])
@pytest.mark.parametrize("i_dim,n,c,draws", [(128, 64, 1, 3), (100, 60, 2, 3)])
def test_reference_matches_pallas_kernel_in_interpret_mode(i_dim, n, c, draws, eps, tau, var_rtol):
    h, length = 128, 2.0
    inp = mclmc_inputs(i_dim, h, n, c)
    kw = dict(num_samples=draws, step_size=eps, length=length)
    want = j_bnn_mclmc(0, *(jnp.asarray(inp[k]) for k in NAMES), tau=tau, interpret=True, **kw)
    z, _ = interpret_prng_constants()
    noise = torch.full((draws, c, inp["u"].shape[1]), z)
    got = bnn_mclmc_reference(0, *torch_args(inp), tau=tau, _noise=noise, **kw)
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]), rtol=var_rtol, atol=1e-9)
    if eps == 1.0:
        drift_only = bnn_mclmc_reference(0, *torch_args(inp), tau=0.0, _noise=noise, **kw)
        for a, b, name in zip(got[:4], drift_only[:4], NAMES[2:]):
            assert float((a - b).abs().max()) > 50 * ATOL, name
        assert float(got[4].min()) > 1e3 * 1e-9  # var_e is far above the atol floor


def test_cpu_wrapper_routes_to_plain_version():
    inp = mclmc_inputs(12, 128, 10, 2, seed=3)
    kw = dict(num_samples=3, step_size=0.05, length=1.0, tau=10.0)
    bnn_mclmc.launches = 0
    got = bnn_mclmc(5, *torch_args(inp), **kw)
    want = bnn_mclmc_reference(5, *torch_args(inp), **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert bnn_mclmc.launches == 0
    again = bnn_mclmc(5, *torch_args(inp), **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(bool(torch.isfinite(t).all()) for t in got)
    assert not torch.equal(got[0][0], got[0][1])  # chains draw different refresh noise


@pytest.mark.parametrize("bad", ["dtype", "shape", "u_shape", "device", "samples", "scale", "noise"])
def test_wrapper_rejects_what_it_does_not_take(bad):
    x, y, w1, b1, w2, b2, u = torch_args(mclmc_inputs(12, 8, 10, 2))
    kw = dict(num_samples=2, step_size=0.1, length=1.0)
    if bad == "dtype":
        u = u.double()
    elif bad == "shape":
        y = y[:, 0]
    elif bad == "u_shape":
        u = u[:, :-1].contiguous()
    elif bad == "device":
        x, y, w1, b1, w2, b2, u = (t.to("meta") for t in (x, y, w1, b1, w2, b2, u))
    elif bad == "samples":
        kw["num_samples"] = 0
    elif bad == "scale":
        kw["length"] = 0.0
    else:
        kw["_noise"] = torch.zeros(2, 2, 5)
    with pytest.raises((TypeError, ValueError)):
        bnn_mclmc(0, x, y, w1, b1, w2, b2, u, **kw)


def _dots(a, b):
    """Per-chain a.b in float64, as the kernel's epilogues and passes reduce it."""
    return torch.sum(a.double() * b.double(), dim=1)


def _fused_rotation(u, g, gg, ug, uu, coef, dims):
    """One rotation as the CUDA kernel's passes compute it: the scalars from
    the dots alone, |w|^2 = ce^2 |g|^2 + 2 ce s u.g + s^2 |u|^2 for the
    float32 ce and s applied, no pass over w for its norm."""
    g_norm = torch.sqrt(gg)
    inv_g = 1.0 / torch.clamp(g_norm, min=1e-30)
    delta = coef * g_norm / (dims - 1.0)
    ue = torch.clamp(ug * inv_g, -1.0, 1.0)
    zeta = torch.exp(-delta)
    ce = ((1.0 - zeta) * (1.0 + zeta + ue * (1.0 - zeta)) * inv_g).float()
    s = (2.0 * zeta).float()
    ww = ce.double() ** 2 * gg + 2.0 * ce.double() * s.double() * ug + s.double() ** 2 * uu
    inv = (1.0 / torch.sqrt(ww)).float()
    dk = (dims - 1.0) * (delta - math.log(2.0)
                         + torch.log(torch.clamp(1.0 + ue + (1.0 - ue) * zeta * zeta, min=1e-12)))
    return (g * ce[:, None] + s[:, None] * u) * inv[:, None], dk, zeta


def emulate_fused_passes(x, y, w1, b1, w2, b2, u, num_samples, step_size, length, tau, noise):
    """``bnn_mclmc`` in the CUDA kernel's order of arithmetic; returns its
    results and each draw's zeta of the first rotation."""
    c, i_dim, h = w1.shape
    dims = i_dim * h + 2 * h + 1
    nu = _refresh_weight(step_size, length, dims)
    th = torch.cat([t.reshape(c, -1) for t in (w1, b1, w2, b2)], dim=1)

    def gradient(th, u):  # the gradient, with the dots of its epilogues
        g, logp = _bnn_gradient_reference(x, y, th, tau)
        return g, logp, _dots(g, g), _dots(u, g), _dots(u, u)

    # the start: the gradient's dots against the given velocity v = u
    v = u
    g, logp, gg, vg, vv = gradient(th, v)
    sum_de2 = torch.zeros(c, dtype=torch.float64)
    zetas = []
    for n in range(num_samples):
        scale = (1.0 / torch.sqrt(vv)).float()  # the first pass reads u = v / |v|
        u = v * scale[:, None]
        u, dk1, zeta = _fused_rotation(u, g, gg, vg * scale.double(),
                                       vv * scale.double() ** 2, _B1 * step_size, dims)
        zetas.append(zeta)
        th = th + (0.5 * step_size) * u
        g, _, gg, ug, uu = gradient(th, u)
        u, dk2, _ = _fused_rotation(u, g, gg, ug, uu, (1.0 - 2.0 * _B1) * step_size, dims)
        th = th + (0.5 * step_size) * u
        g, logp2, gg, ug, uu = gradient(th, u)
        u, dk3, _ = _fused_rotation(u, g, gg, ug, uu, _B1 * step_size, dims)
        de = dk1 + dk2 + dk3 + (logp - logp2)
        sum_de2 += de * de
        logp = logp2
        v = u + nu * noise[n]  # the refresh; its |v|^2 and v.g go to the next draw
        vv, vg = _dots(v, v), _dots(v, g)
    s0, s1 = i_dim * h, i_dim * h + h
    var_e = (sum_de2 / num_samples / dims).float()
    out = (th[:, :s0].reshape(c, i_dim, h), th[:, s0:s1], th[:, s1:s1 + h], th[:, -1], var_e)
    return out, zetas


FUSED_ATOL = 1e-6


@pytest.mark.parametrize("i_dim,h,n,c,eps,draws", [
    (20, 8, 30, 3, 0.5, 6), (50, 128, 100, 2, 2.0, 4), (13, 16, 40, 1, 1.0, 5)])
def test_fused_pass_order_matches_plain_version(i_dim, h, n, c, eps, draws):
    inp = mclmc_inputs(i_dim, h, n, c, seed=2)
    d = inp["u"].shape[1]
    noise = torch.as_tensor(np.random.RandomState(9).randn(draws, c, d).astype(np.float32))
    kw = dict(num_samples=draws, step_size=eps, length=5.0, tau=10.0)
    want = bnn_mclmc_reference(0, *torch_args(inp), _noise=noise, **kw)
    got, _ = emulate_fused_passes(*torch_args(inp), noise=noise, **kw)
    for a, b in zip(got[:4], want[:4]):
        torch.testing.assert_close(a, b, atol=FUSED_ATOL, rtol=0)
    torch.testing.assert_close(got[4], want[4], atol=0, rtol=VAR_E_FUSED_RTOL)
    drift_only = bnn_mclmc_reference(0, *torch_args(inp), _noise=noise, **{**kw, "tau": 0.0})
    assert max(float((a - b).abs().max()) for a, b in zip(want[:4], drift_only[:4])) > 100 * FUSED_ATOL


def anti_parallel_start(i_dim, h, n, c, zeta=0.04, seed=2):
    """Inputs with u = -g/|g| and the step at which every chain's first
    rotation has zeta = exp(-b1 eps |g| / (d - 1)) <= zeta.  The targets sit
    10 above the network's output and w2 is O(1), so |g| is in the
    thousands and that step is below 1: the run stays where float32 can
    follow it (at |g| ~ 40 the step would be ~100, and a drift of 50 units
    turns any rounding difference into 1e-4)."""
    inp = mclmc_inputs(i_dim, h, n, c, seed=seed)
    inp["y"] = inp["y"] + 10.0
    inp["w2"] = 100.0 * inp["w2"]
    x, y, w1, b1, w2, b2, _ = torch_args(inp)
    th = torch.cat([t.reshape(c, -1) for t in (w1, b1, w2, b2)], dim=1)
    g, _ = _bnn_gradient_reference(x, y, th, 10.0)
    g_norm = torch.sqrt(_dots(g, g))
    u = (-g.double() / g_norm[:, None]).float()
    d = u.shape[1]
    eps = float((-math.log(zeta) * (d - 1) / (_B1 * g_norm)).max())
    return (x, y, w1, b1, w2, b2, u), eps


@pytest.mark.parametrize("i_dim,h,n,c", [(20, 8, 30, 3), (13, 16, 40, 1), (50, 128, 100, 2)])
def test_fused_pass_order_from_an_anti_parallel_velocity(i_dim, h, n, c):
    """u = -g/|g| and a step at which zeta <= 0.05 in the first rotation:
    w = ce g + 2 zeta u is 2 zeta^2 long, from terms 2 zeta long."""
    args, eps = anti_parallel_start(i_dim, h, n, c)
    draws, d = 2, args[-1].shape[1]
    noise = torch.as_tensor(np.random.RandomState(9).randn(draws, c, d).astype(np.float32))
    kw = dict(num_samples=draws, step_size=eps, length=5.0 * eps, tau=10.0)
    want = bnn_mclmc_reference(0, *args, _noise=noise, **kw)
    got, zetas = emulate_fused_passes(*args, noise=noise, **kw)
    assert float(zetas[0].max()) <= 0.05
    for a, b in zip(got[:4], want[:4]):
        torch.testing.assert_close(a, b, atol=FUSED_ATOL, rtol=0)
    torch.testing.assert_close(got[4], want[4], atol=0, rtol=VAR_E_FUSED_RTOL)
    drift_only = bnn_mclmc_reference(0, *args, _noise=noise, **{**kw, "tau": 0.0})
    assert max(float((a - b).abs().max()) for a, b in zip(want[:4], drift_only[:4])) > 100 * FUSED_ATOL
