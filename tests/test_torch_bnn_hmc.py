"""The fused flagship sampler: ``bnn_hmc`` and its plain version.

(a) Against the Pallas kernel itself, run in interpret mode as the JAX
    package's own tests run it.  Interpret mode's PRNG returns constant
    bits, so every momentum entry is one constant normal and every
    Metropolis uniform one constant; a probe kernel reads both, and the
    port's plain version takes them through its noise hook.  At an input
    width that is a multiple of 128 the JAX kernel pads nothing, so the two
    compute the same thing: atol 2e-5, as ``tests/test_bnn_kernel.py``.
    The step and tau are large enough that the gradient's part of the move
    is far above atol, and one draw of each chain is rejected.
(b) With random numpy momenta, the plain version equals a leapfrog built on
    ``jax.grad`` of the same potential (atol 2e-5).
(c) On CPU tensors the wrapper routes to the plain version and launches
    nothing; it rejects tensors it does not take.

The kernel itself runs only on a card: ``tests/test_torch_gpu.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hamiltorch_tpu.kernels.bnn_hmc import bnn_hmc as j_bnn_hmc
from hamiltorch_tpu_torch.kernels import bnn_hmc, bnn_hmc_reference


def bnn_inputs(i_dim, h, n, c, seed=0):
    rng = np.random.RandomState(seed)
    return dict(
        x=rng.randn(n, i_dim).astype(np.float32),
        y=rng.randn(n, 1).astype(np.float32),
        w1=(0.01 * rng.randn(c, i_dim, h)).astype(np.float32),
        b1=(0.01 * rng.randn(c, h)).astype(np.float32),
        w2=(0.01 * rng.randn(c, h)).astype(np.float32),
        b2=(0.01 * rng.randn(c)).astype(np.float32),
    )


def torch_args(inp, device="cpu"):
    return [torch.as_tensor(inp[k]).to(device) for k in ("x", "y", "w1", "b1", "w2", "b2")]


def interpret_prng_constants():
    """The constant normal and uniform of the interpret-mode PRNG."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from hamiltorch_tpu.kernels.gaussian_hmc import _normals, _uniforms

    def probe_kernel(seed_ref, nrm_ref, uni_ref):
        pltpu.prng_seed(seed_ref[0])
        nrm_ref[:] = _normals(nrm_ref.shape)
        uni_ref[:] = _uniforms(uni_ref.shape)

    nrm, uni = pl.pallas_call(
        probe_kernel,
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM)],
        out_specs=[pl.BlockSpec(memory_space=pltpu.VMEM), pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_shape=[jax.ShapeDtypeStruct((8, 128), jnp.float32),
                   jax.ShapeDtypeStruct((8, 128), jnp.float32)],
        interpret=pltpu.InterpretParams(),
    )(jnp.zeros(1, jnp.int32))
    nrm, uni = np.asarray(nrm), np.asarray(uni)
    assert np.all(nrm == nrm[0, 0]) and np.all(uni == uni[0, 0])
    return float(nrm[0, 0]), float(uni[0, 0])


def test_reference_matches_pallas_kernel_in_interpret_mode():
    i_dim = h = 128
    n, c, draws, steps, eps, tau, atol = 16, 2, 2, 3, 0.02, 10.0, 2e-5
    inp = bnn_inputs(i_dim, h, n, c)
    got_j = j_bnn_hmc(0, *(jnp.asarray(inp[k]) for k in ("x", "y", "w1", "b1", "w2", "b2")),
                      num_samples=draws, num_steps=steps, step_size=eps, tau=tau, interpret=True)
    z, u = interpret_prng_constants()
    d = i_dim * h + 2 * h + 1
    noise = (torch.full((draws, c, d), z), torch.full((draws, c), u))
    got_t = bnn_hmc_reference(0, *torch_args(inp), num_samples=draws, num_steps=steps,
                              step_size=eps, tau=tau, _noise=noise)
    for a, b in zip(got_t[:4], got_j[:4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol)
    np.testing.assert_array_equal(got_t[4].numpy(), np.asarray(got_j[4]))
    # The comparison sees the gradient: every momentum entry is z, so after
    # k accepted draws the drift alone would put each parameter at
    # theta0 + k * eps * L * z.  At this step and tau the gradient moves every
    # block far more than atol from there (a gradient wrong by 4% would fail).
    accepted = got_t[4].numpy() * draws
    assert 0 < accepted.min() and accepted.max() < draws  # both MH outcomes occur
    for got, name in zip(got_t[:4], ("w1", "b1", "w2", "b2")):
        k = accepted.reshape((c,) + (1,) * (inp[name].ndim - 1))
        drift_only = inp[name] + k * eps * steps * z
        assert np.abs(got.numpy() - drift_only).max() > 25 * atol, name


def autodiff_sampler(inp, momenta, uniforms, steps, eps, tau):
    """Per chain: HMC draws whose gradient is jax.grad of the potential."""
    x, y = jnp.asarray(inp["x"]), jnp.asarray(inp["y"])

    def logp(params):
        w1, b1, w2, b2 = params
        o = jnp.tanh(x @ w1 + b1) @ w2[:, None] + b2
        return (-0.5 * tau * jnp.sum((o - y) ** 2)
                - 0.5 * (jnp.sum(w1**2) + jnp.sum(b1**2) + jnp.sum(w2**2) + b2**2))

    vg = jax.value_and_grad(logp)
    i_dim, h = inp["w1"].shape[1:]
    s0, s1 = i_dim * h, i_dim * h + h
    out, acc = [], []
    for c in range(inp["w1"].shape[0]):
        theta = (jnp.asarray(inp["w1"][c]), jnp.asarray(inp["b1"][c]),
                 jnp.asarray(inp["w2"][c]), jnp.asarray(inp["b2"][c]))
        lp, g = vg(theta)
        accepted = 0
        for n in range(momenta.shape[0]):
            m = jnp.asarray(momenta[n, c])
            p = (m[:s0].reshape(i_dim, h), m[s0:s1], m[s1:s1 + h], m[s1 + h])
            kin = lambda q: sum(float(np.sum(np.asarray(t, np.float64) ** 2)) for t in q) / 2  # noqa: E731
            h0 = -float(lp) + kin(p)
            p = jax.tree_util.tree_map(lambda a, b: a + 0.5 * eps * b, p, g)
            th, lp1, g1 = theta, lp, g
            for _ in range(steps):
                th = jax.tree_util.tree_map(lambda a, b: a + eps * b, th, p)
                lp1, g1 = vg(th)
                p = jax.tree_util.tree_map(lambda a, b: a + eps * b, p, g1)
            p = jax.tree_util.tree_map(lambda a, b: a - 0.5 * eps * b, p, g1)
            if h0 - (-float(lp1) + kin(p)) >= np.log(float(uniforms[n, c])):
                theta, lp, g = th, lp1, g1
                accepted += 1
        out.append(theta)
        acc.append(accepted / momenta.shape[0])
    return [np.stack([np.asarray(o[k]) for o in out]) for k in range(4)], np.asarray(acc)


def test_reference_matches_autodiff_leapfrog():
    i_dim, h, n, c, draws, steps, eps, tau = 12, 8, 10, 3, 3, 4, 0.02, 10.0
    inp = bnn_inputs(i_dim, h, n, c, seed=1)
    rng = np.random.RandomState(2)
    momenta = rng.randn(draws, c, i_dim * h + 2 * h + 1).astype(np.float32)
    uniforms = rng.rand(draws, c).astype(np.float32)
    want, want_acc = autodiff_sampler(inp, momenta, uniforms, steps, eps, tau)
    got = bnn_hmc_reference(0, *torch_args(inp), num_samples=draws, num_steps=steps,
                            step_size=eps, tau=tau,
                            _noise=(torch.as_tensor(momenta), torch.as_tensor(uniforms)))
    for a, b in zip(got[:4], want):
        np.testing.assert_allclose(a.numpy(), b, atol=2e-5)
    np.testing.assert_allclose(got[4].numpy(), want_acc)
    assert 0 < want_acc.mean() < 1  # both outcomes of the Metropolis test occur


def test_cpu_wrapper_routes_to_plain_version():
    inp = bnn_inputs(12, 8, 10, 2, seed=3)
    kw = dict(num_samples=3, num_steps=4, step_size=0.02, tau=10.0)
    bnn_hmc.launches = 0
    got = bnn_hmc(5, *torch_args(inp), **kw)
    want = bnn_hmc_reference(5, *torch_args(inp), **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert bnn_hmc.launches == 0
    # the plain version's own noise is a deterministic function of the seed
    again = bnn_hmc(5, *torch_args(inp), **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(bool(torch.isfinite(t).all()) for t in got)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "device", "steps", "noise"])
def test_wrapper_rejects_what_it_does_not_take(bad):
    x, y, w1, b1, w2, b2 = torch_args(bnn_inputs(12, 8, 10, 2))
    kw = dict(num_samples=2, num_steps=3)
    if bad == "dtype":
        x = x.double()
    elif bad == "shape":
        y = y[:, 0]
    elif bad == "contiguity":
        w1 = w1.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "device":
        x, y, w1, b1, w2, b2 = (t.to("meta") for t in (x, y, w1, b1, w2, b2))
    elif bad == "steps":
        kw["num_steps"] = 0
    else:
        kw["_noise"] = (torch.zeros(2, 2, 5), torch.zeros(2, 2))
    with pytest.raises((TypeError, ValueError)):
        bnn_hmc(0, x, y, w1, b1, w2, b2, **kw)
