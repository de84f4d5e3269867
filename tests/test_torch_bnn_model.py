"""Port vs JAX package: the BNN layer on ``torch.nn.Module``s (``models/bnn.py``).

The same module goes through the JAX package's ``define_model_log_prob``
(its interop bridge translates the module into jnp, on the CPU) and through
the port (``torch.func.functional_call`` on a copy of the module).  Both
keep ``module.parameters()`` order and each tensor's own layout, so one
flat vector, drawn here with numpy from a seed, feeds both.

Tolerances: log-probabilities within 1e-5 relative and gradients within
1e-5 of the largest gradient entry (float32 on both sides, sums in another
order); predictions within 1e-5 absolute or 1e-4 relative.  HMC on a module's potential is held draw for draw on the JAX
driver's own noise: identical accept decisions, samples within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import hamiltorch_tpu as jht
from hamiltorch_tpu.models import bnn as jbnn
import hamiltorch_tpu_torch as tht
from hamiltorch_tpu_torch.models import bnn as tbnn

N = 12


def net_for(kind, out=3):
    torch.manual_seed(0)
    if kind == "mlp":
        return nn.Sequential(nn.Linear(4, 8), nn.Tanh(), nn.Linear(8, out))
    if kind == "log_softmax":
        return nn.Sequential(nn.Linear(4, 8), nn.Tanh(), nn.Linear(8, out), nn.LogSoftmax(dim=-1))
    if kind == "bn1d":
        return nn.Sequential(nn.Linear(4, 6), nn.BatchNorm1d(6), nn.Tanh(), nn.Linear(6, out))
    if kind == "conv_bn2d":
        return nn.Sequential(nn.Conv2d(1, 4, 3, padding=1), nn.BatchNorm2d(4), nn.ReLU(),
                             nn.Flatten(), nn.Linear(4 * 6 * 6, out))
    if kind == "transformer":
        return nn.Sequential(
            nn.TransformerEncoderLayer(8, 2, dim_feedforward=16, dropout=0.0, batch_first=True),
            nn.Flatten(), nn.Linear(5 * 8, out))
    raise ValueError(kind)


def inputs_for(kind, seed=0):
    rng = np.random.RandomState(seed)
    shape = {"conv_bn2d": (N, 1, 6, 6), "transformer": (N, 5, 8)}.get(kind, (N, 4))
    return rng.randn(*shape).astype(np.float32)


# (model_loss, output width, targets)
ZOO = {
    "binary_class_linear_output": (1, lambda r: r.randint(0, 2, (N, 1)).astype(np.float32)),
    "multi_class_linear_output": (3, lambda r: r.randint(0, 3, N).astype(np.float32)),
    "multi_class_log_softmax_output": (3, lambda r: r.randint(0, 3, N).astype(np.float32)),
    "regression": (2, lambda r: r.randn(N, 2).astype(np.float32)),
    "callable": (1, lambda r: r.randn(N, 1).astype(np.float32)),
}


def half_square(out, y):  # works on jnp arrays and torch tensors alike
    return 0.5 * (out - y) ** 2


def both_potentials(net, loss, x, y, **kw):
    j_lp, j_flat, _ = jbnn.define_model_log_prob(net, loss, jnp.asarray(x), jnp.asarray(y), **kw)
    t_lp, t_flat, _ = tbnn.define_model_log_prob(net, loss, x, y, device="cpu", **kw)
    np.testing.assert_array_equal(t_flat.numpy(), np.asarray(j_flat))
    return j_lp, t_lp, t_flat


def assert_value_and_grad(j_lp, t_lp, theta, rtol=1e-5, grad_tol=1e-5):
    j_val, j_grad = jax.value_and_grad(j_lp)(jnp.asarray(theta))
    t_grad, t_val = torch.func.grad_and_value(t_lp)(torch.as_tensor(theta))
    np.testing.assert_allclose(float(t_val), float(j_val), rtol=rtol)
    j_grad = np.asarray(j_grad)
    np.testing.assert_allclose(t_grad.numpy(), j_grad, rtol=0,
                               atol=grad_tol * np.abs(j_grad).max())


def perturbed(flat, seed=1, scale=0.1):
    flat = np.asarray(flat)
    return (flat + scale * np.random.RandomState(seed).randn(*flat.shape)).astype(np.float32)


@pytest.mark.parametrize("tau_list", ["none", "scalar", "per_leaf"])
@pytest.mark.parametrize("loss", sorted(ZOO))
def test_log_prob_matches_jax_for_the_zoo(loss, tau_list):
    width, targets = ZOO[loss]
    net = net_for("log_softmax" if loss == "multi_class_log_softmax_output" else "mlp", width)
    x, y = inputs_for("mlp"), targets(np.random.RandomState(2))
    taus = {"none": None, "scalar": 2.0, "per_leaf": [0.5, 1.0, 2.0, 4.0]}[tau_list]
    model_loss = half_square if loss == "callable" else loss
    j_lp, t_lp, t_flat = both_potentials(net, model_loss, x, y, tau_list=taus, tau_out=3.0)
    assert_value_and_grad(j_lp, t_lp, perturbed(t_flat))


@pytest.mark.parametrize("train_mode", [False, True])
@pytest.mark.parametrize("kind", ["mlp", "bn1d", "conv_bn2d", "transformer"])
def test_log_prob_matches_jax_across_architectures(kind, train_mode):
    """BatchNorm normalises with the batch's moments in both packages,
    whatever mode the caller's module is in."""
    net = net_for(kind)
    net.train(train_mode)
    x = inputs_for(kind)
    y = np.random.RandomState(3).randint(0, 3, N).astype(np.float32)
    j_lp, t_lp, t_flat = both_potentials(net, "multi_class_linear_output", x, y, tau_out=2.0)
    assert_value_and_grad(j_lp, t_lp, perturbed(t_flat))


def test_remat_and_prior_scale_match_jax():
    net = net_for("bn1d")
    x, y = inputs_for("bn1d"), np.random.RandomState(4).randint(0, 3, N).astype(np.float32)
    kw = dict(tau_out=2.0, prior_scale=4.0)
    j_lp, t_lp, t_flat = both_potentials(net, "multi_class_linear_output", x, y, **kw)
    t_remat, _, _ = tbnn.define_model_log_prob(net, "multi_class_linear_output", x, y,
                                               remat=True, device="cpu", **kw)
    theta = perturbed(t_flat)
    assert_value_and_grad(j_lp, t_remat, theta)
    g_plain = torch.func.grad(t_lp)(torch.as_tensor(theta))
    g_remat = torch.func.vmap(torch.func.grad(t_remat))(torch.as_tensor(theta)[None])[0]
    torch.testing.assert_close(g_remat, g_plain)  # float32 defaults: rtol 1.3e-6, atol 1e-5


def test_predict_flag_returns_the_output():
    net = net_for("mlp", 2)
    x, y = inputs_for("mlp"), np.random.RandomState(5).randn(N, 2).astype(np.float32)
    j_lp, j_flat, _ = jbnn.define_model_log_prob(net, "regression", jnp.asarray(x),
                                                 jnp.asarray(y), predict=True)
    t_lp, t_flat, _ = tbnn.define_model_log_prob(net, "regression", x, y, predict=True,
                                                 device="cpu")
    (j_val, j_out), (t_val, t_out) = j_lp(j_flat), t_lp(t_flat)
    np.testing.assert_allclose(float(t_val), float(j_val), rtol=1e-5)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=1e-5)


@pytest.mark.parametrize("kind", ["mlp", "bn1d"])
def test_tree_log_prob_matches_flat_and_jax(kind):
    net = net_for(kind)
    x, y = inputs_for(kind), np.random.RandomState(6).randint(0, 3, N).astype(np.float32)
    kw = dict(tau_list=[1.0, 2.0, 3.0, 4.0] if kind == "mlp" else 2.0, tau_out=1.5)
    t_tree, template = tbnn.define_model_tree_log_prob(net, "multi_class_linear_output", x, y,
                                                       device="cpu", **kw)
    t_flat_lp, t_flat, unravel = tbnn.define_model_log_prob(net, "multi_class_linear_output",
                                                            x, y, device="cpu", **kw)
    j_tree, j_template = jbnn.define_model_tree_log_prob(net, "multi_class_linear_output",
                                                         jnp.asarray(x), jnp.asarray(y), **kw)
    theta = torch.as_tensor(perturbed(t_flat))
    params = unravel(theta)
    assert isinstance(template, list) and len(template) == len(params)
    torch.testing.assert_close(t_tree(params), t_flat_lp(theta), rtol=0, atol=0)
    g_tree = torch.func.grad(t_tree)(params)
    j_val, j_grad = jax.value_and_grad(j_tree)([jnp.asarray(p.numpy()) for p in params])
    np.testing.assert_allclose(float(t_tree(params)), float(j_val), rtol=1e-5)
    scale = max(float(np.abs(np.asarray(g)).max()) for g in j_grad)
    for t_g, j_g in zip(g_tree, j_grad):
        np.testing.assert_allclose(t_g.numpy(), np.asarray(j_g), rtol=0, atol=1e-5 * scale)


def test_prior_and_lik_match_jax():
    net = net_for("mlp", 2)
    x, y = inputs_for("mlp"), np.random.RandomState(7).randn(N, 2).astype(np.float32)
    taus = [0.5, 1.0, 4.0, 2.0]
    j_prior, j_lik, _, j_template = jbnn.define_model_prior_and_lik(
        net, "regression", jnp.asarray(x), jnp.asarray(y), tau_list=taus, tau_out=3.0)
    t_prior, t_lik, t_sample, template = tbnn.define_model_prior_and_lik(
        net, "regression", x, y, tau_list=taus, tau_out=3.0, device="cpu")
    flat = perturbed(torch.cat([p.reshape(-1) for p in template]).numpy())
    sizes = [p.numel() for p in template]
    params = [torch.as_tensor(a).reshape(p.shape)
              for a, p in zip(np.split(flat, np.cumsum(sizes)[:-1]), template)]
    j_params = [jnp.asarray(p.numpy()) for p in params]
    np.testing.assert_allclose(float(t_prior(params)), float(j_prior(j_params)), rtol=1e-6)
    np.testing.assert_allclose(float(t_lik(params)), float(j_lik(j_params)), rtol=1e-5)
    half = (x[: N // 2], y[: N // 2])
    np.testing.assert_allclose(
        float(t_lik(params, tuple(map(torch.as_tensor, half)))),
        float(j_lik(j_params, tuple(map(jnp.asarray, half)))), rtol=1e-5)
    # prior draws: the JAX package's shapes, each leaf's spread 1/sqrt(tau);
    # an integer seed and a torch.Generator seeded alike draw the same
    draws = t_sample(3, 4000)
    for leaf, t_leaf, tau in zip(draws, template, taus):
        assert leaf.shape == (4000,) + tuple(t_leaf.shape)
        np.testing.assert_allclose(float(leaf.std()), tau ** -0.5, rtol=0.05)
    again = t_sample(torch.Generator().manual_seed(3), 4000)
    assert all(torch.equal(a, b) for a, b in zip(draws, again))


def test_predict_model_matches_jax_on_x_loader_stream_and_trees():
    net = net_for("bn1d", 2)
    x = inputs_for("bn1d")
    y = np.random.RandomState(8).randn(N, 2).astype(np.float32)
    flat0 = torch.cat([p.detach().reshape(-1) for p in net.parameters()]).numpy()
    samples = np.stack([perturbed(flat0, seed=s) for s in range(4)])
    kw = dict(model_loss="regression", tau_out=2.0, tau_list=0.5)
    loader = [(x[:5], y[:5]), (x[5:10], y[5:10]), (x[10:], y[10:])]  # a ragged last batch

    def check(t_out, j_out):
        for t, j in zip(t_out, j_out):
            assert t.device.type == "cpu"
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4, atol=1e-5)

    j_x = jbnn.predict_model(net, jnp.asarray(samples), x=jnp.asarray(x), y=jnp.asarray(y), **kw)
    t_x = tbnn.predict_model(net, torch.as_tensor(samples), x=x, y=y, device="cpu", **kw)
    check(t_x, j_x)
    assert tuple(t_x[0].shape) == (4, N, 2) and tuple(t_x[1].shape) == (4,)
    j_l = jbnn.predict_model(net, jnp.asarray(samples), test_loader=loader, **kw)
    t_l = tbnn.predict_model(net, torch.as_tensor(samples), test_loader=loader, device="cpu", **kw)
    check(t_l, j_l)
    j_s = jbnn.predict_model(net, jnp.asarray(samples), test_loader=loader, stream_batches=2, **kw)
    t_s = tbnn.predict_model(net, torch.as_tensor(samples), test_loader=loader, stream_batches=2,
                             device="cpu", **kw)
    check(t_s, j_s)
    # a tree trace: one (S, ...) leaf per parameter
    sizes = [p.numel() for p in net.parameters()]
    tree = [torch.as_tensor(a).reshape((4,) + tuple(p.shape)) for a, p in
            zip(np.split(samples, np.cumsum(sizes)[:-1], axis=1), net.parameters())]
    j_t = jbnn.predict_model(net, [jnp.asarray(l.numpy()) for l in tree], x=jnp.asarray(x),
                             y=jnp.asarray(y), **kw)
    t_t = tbnn.predict_model(net, tree, x=x, y=y, device="cpu", **kw)
    check(t_t, j_t)
    with pytest.raises(TypeError, match="stream_batches"):
        tbnn.predict_model(net, tree, test_loader=loader, stream_batches=2, device="cpu", **kw)


def test_predict_model_takes_a_dataloader():
    net = net_for("mlp", 3)
    x = inputs_for("mlp")
    y = np.random.RandomState(9).randint(0, 3, N).astype(np.float32)
    samples = torch.as_tensor(np.stack([perturbed(tht.util.flatten(net).numpy(), seed=s)
                                        for s in range(3)]))
    loader = torch.utils.data.DataLoader(
        torch.utils.data.TensorDataset(torch.as_tensor(x), torch.as_tensor(y)), batch_size=5)
    on_x = tbnn.predict_model(net, samples, x=x, y=y, device="cpu")
    on_loader = tbnn.predict_model(net, samples, test_loader=loader, device="cpu")
    torch.testing.assert_close(on_loader[0], on_x[0], rtol=0, atol=1e-6)
    torch.testing.assert_close(on_loader[1], on_x[1], rtol=1e-5, atol=0)


def jax_chain_noise(key, num_samples, dim):
    """run_hmc's own per-draw (z, log u): split(fold_in(key, n))."""
    keys = [jax.random.split(jax.random.fold_in(key, n)) for n in range(num_samples)]
    z = np.stack([np.asarray(jax.random.normal(k[0], (dim,))) for k in keys])
    log_u = np.stack([np.log(np.asarray(jax.random.uniform(k[1], ()))) for k in keys])
    return torch.as_tensor(z), torch.as_tensor(log_u)


@pytest.mark.parametrize("kind,loss", [("mlp", "regression"), ("bn1d", "multi_class_linear_output")])
def test_hmc_on_a_module_matches_jax_draw_for_draw(kind, loss):
    net = net_for(kind, 2)
    x = inputs_for(kind)
    r = np.random.RandomState(10)
    y = r.randn(N, 2).astype(np.float32) if loss == "regression" else \
        r.randint(0, 2, N).astype(np.float32)
    j_lp, t_lp, t_flat = both_potentials(net, loss, x, y, tau_out=5.0)
    cfg = dict(num_samples=15, num_steps_per_sample=5, step_size=0.05)
    key = jax.random.key(11)
    j_res = jht.run_hmc(key, j_lp, jnp.asarray(t_flat.numpy()), jht.MCMCConfig(**cfg))
    t_res = tht.run_hmc(0, t_lp, t_flat, tht.MCMCConfig(**cfg),
                        _noise=jax_chain_noise(key, 15, t_flat.numel()))
    j_acc = np.asarray(j_res.stats.accepted)
    np.testing.assert_array_equal(t_res.stats.accepted.numpy(), j_acc)
    assert 0 < j_acc.mean() < 1  # both Metropolis outcomes occur
    np.testing.assert_allclose(t_res.samples.numpy(), np.asarray(j_res.samples), atol=1e-5)


@pytest.mark.parametrize("burn,sampler", [(0, "HMC"), (5, "HMC"), (-1, "HMC"), (6, "HMC_NUTS")])
def test_sample_model_return_convention(burn, sampler):
    net = net_for("mlp", 1)
    x = inputs_for("mlp")
    y = np.random.RandomState(12).randn(N, 1).astype(np.float32)
    kw = dict(model_loss="regression", num_samples=20, num_steps_per_sample=3, step_size=0.01,
              burn=burn, verbose=False, debug=2)
    j_s, j_aux = jbnn.sample_model(net, jnp.asarray(x), jnp.asarray(y),
                                   sampler=getattr(jht.Sampler, sampler),
                                   key=jax.random.key(0), **kw)
    t_s, t_aux = tbnn.sample_model(net, x, y, sampler=getattr(tht.Sampler, sampler), key=0,
                                   device="cpu", **kw)
    assert tuple(t_s.shape) == tuple(j_s.shape)
    assert torch.equal(t_s[0], tht.util.flatten(net))
    assert isinstance(t_aux, float) and isinstance(j_aux, float)
    plain = tbnn.sample_model(net, x, y, sampler=getattr(tht.Sampler, sampler), key=0,
                              device="cpu", **{**kw, "debug": 0})
    assert torch.equal(plain, t_s)


def test_sample_model_offload_and_params_init():
    net = net_for("mlp", 1)
    x = inputs_for("mlp")
    y = np.random.RandomState(13).randn(N, 1).astype(np.float32)
    kw = dict(model_loss="regression", num_samples=8, num_steps_per_sample=3, step_size=0.01,
              verbose=False, key=4, device="cpu")
    on_device = tbnn.sample_model(net, x, y, **kw)
    offloaded = tbnn.sample_model(net, x, y, store_on_GPU=False, **kw)
    assert torch.equal(offloaded, on_device)
    start = tht.util.flatten(net) + 0.01
    moved = tbnn.sample_model(net, x, y, params_init=start.numpy(), **kw)
    assert torch.equal(moved[0], start)


def test_callers_module_is_left_unchanged():
    net = net_for("bn1d", 2)
    net.train()
    x = inputs_for("bn1d")
    y = np.random.RandomState(14).randn(N, 2).astype(np.float32)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    samples = tbnn.sample_model(net, x, y, model_loss="regression", num_samples=4,
                                step_size=0.01, verbose=False, key=1, device="cpu")
    tbnn.predict_model(net, samples, x=x, y=y, model_loss="regression", device="cpu")
    tht.util.make_functional(net)(torch.as_tensor(x), list(net.parameters()))
    after = net.state_dict()
    assert set(after) == set(before)  # running statistics and their counter included
    assert all(torch.equal(after[k], before[k]) for k in before)
    assert net.training and net[1].track_running_stats and net[1].running_mean is not None


def test_build_model_forms():
    with pytest.raises(TypeError, match="Unsupported"):
        tbnn.build_model(object(), device="cpu")
    with pytest.raises(ValueError, match="params_template"):
        tbnn.build_model(lambda p, x: x, device="cpu")
    # a plain callable with a dict template, the JAX package's other form
    template = {"w": np.ones((4, 2), np.float32), "b": np.zeros(2, np.float32)}

    def apply_fn(p, xb):
        return xb @ p["w"] + p["b"]

    x = inputs_for("mlp")
    y = np.random.RandomState(15).randn(N, 2).astype(np.float32)
    j_lp, j_flat, _ = jbnn.define_model_log_prob(
        apply_fn, "regression", jnp.asarray(x), jnp.asarray(y),
        params_template={k: jnp.asarray(v) for k, v in template.items()})
    t_lp, t_flat, _ = tbnn.define_model_log_prob(apply_fn, "regression", x, y,
                                                 params_template=template, device="cpu")
    np.testing.assert_array_equal(t_flat.numpy(), np.asarray(j_flat))
    assert_value_and_grad(j_lp, t_lp, perturbed(t_flat))


def test_sample_split_model_is_not_ported():
    """sample_split_model is ported now (tests/test_torch_splitting.py holds
    it against the JAX package): an empty loader is refused, as there, and a
    small one samples."""
    with pytest.raises(ValueError, match="no batches"):
        tht.sample_split_model(net_for("mlp"), [], device="cpu")
    x = inputs_for("mlp")
    y = np.random.RandomState(5).randint(0, 3, N).astype(np.float32)
    batches = [(x[i::2], y[i::2]) for i in range(2)]
    s = tht.sample_split_model(net_for("mlp"), batches, num_samples=3, num_steps_per_sample=2,
                               step_size=1e-3, key=0, verbose=False, device="cpu")
    assert s.shape[0] == 3 and bool(torch.isfinite(s).all())
