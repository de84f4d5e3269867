"""Port vs JAX package: the ``hamiltorch.util`` namespace (``util.py``,
``utils/compat.py``, ``utils/progress.py``, ``utils/profiling.py``,
``parallel/chains.py``) and the rest of ``utils/pytree.py``.

``flatten`` is exact (the same parameters in the same order).  ``gradient``,
``hessian`` and ``jacobian`` of the same function at the same point agree
within 1e-5 relative (float32 autodiff in each framework); ``make_functional``
matches the JAX bridge's translation of the module within 1e-5.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import hamiltorch_tpu as jht
import hamiltorch_tpu.util as jutil
import hamiltorch_tpu_torch as tht
import hamiltorch_tpu_torch.util as tutil
from hamiltorch_tpu_torch.utils import profiling, progress, pytree


def small_net():
    torch.manual_seed(0)
    return nn.Sequential(nn.Conv2d(1, 2, 3), nn.BatchNorm2d(2), nn.ReLU(), nn.Flatten(),
                         nn.Linear(2 * 4 * 4, 3))


def test_namespace_mirrors_the_jax_package():
    assert tutil.__all__ == jutil.__all__
    assert all(getattr(tutil, name) is not None for name in tutil.__all__)
    assert tht.util is tutil


def test_flatten_unflatten_round_trip_matches_jax():
    net = small_net()
    flat = tutil.flatten(net)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jutil.flatten(net)))
    assert flat.numel() == sum(p.numel() for p in net.parameters())
    parts = tutil.unflatten(net, flat)
    assert [tuple(p.shape) for p in parts] == [tuple(p.shape) for p in net.parameters()]
    assert all(torch.equal(a, b.detach()) for a, b in zip(parts, net.parameters()))
    tree = {"w": torch.arange(6.0).reshape(2, 3), "b": torch.ones(2)}
    flat_tree = tutil.flatten(tree)
    np.testing.assert_array_equal(
        flat_tree.numpy(), np.asarray(jutil.flatten({k: jnp.asarray(v.numpy()) for k, v in tree.items()})))
    back = tutil.unflatten(tree, flat_tree)
    assert all(torch.equal(back[k], tree[k]) for k in tree)
    with pytest.raises(ValueError, match="1d"):
        tutil.unflatten(net, flat[None])


def test_param_sizes_shapes_and_tree_rejection():
    from hamiltorch_tpu.utils import pytree as jpytree

    tree = {"w": np.zeros((2, 3), np.float32), "b": np.zeros(4, np.float32), "s": np.zeros((), np.float32)}
    t_tree = {k: torch.as_tensor(v) for k, v in tree.items()}
    j_tree = {k: jnp.asarray(v) for k, v in tree.items()}
    assert pytree.param_sizes(t_tree) == [int(s) for s in jpytree.param_sizes(j_tree)]
    assert pytree.param_shapes(t_tree) == jpytree.param_shapes(j_tree)
    with pytest.raises(TypeError, match="flat"):
        pytree.reject_param_tree(t_tree, "entry", "why", "alternative")
    pytree.reject_param_tree(torch.zeros(3), "entry", "why", "alternative")


def test_make_functional_matches_the_jax_bridge():
    net = small_net()
    x = np.random.RandomState(0).randn(5, 1, 6, 6).astype(np.float32)
    params = [p.detach() + 0.01 for p in net.parameters()]
    t_out = tutil.make_functional(net)(torch.as_tensor(x), params)
    j_out = jutil.make_functional(net)(jnp.asarray(x), [jnp.asarray(p.numpy()) for p in params])
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out), rtol=1e-5, atol=1e-5)
    plain = lambda p, xb: xb  # noqa: E731  (not a module: returned as it is)
    assert tutil.make_functional(plain) is plain


def _rosen_t(v):
    return torch.sum(100.0 * (v[1:] - v[:-1] ** 2) ** 2 + (1 - v[:-1]) ** 2)


def _rosen_j(v):
    return jnp.sum(100.0 * (v[1:] - v[:-1] ** 2) ** 2 + (1 - v[:-1]) ** 2)


def test_gradient_hessian_jacobian_match_jax():
    v = np.random.RandomState(1).randn(5).astype(np.float32)
    np.testing.assert_allclose(tutil.gradient(_rosen_t, v).numpy(),
                               np.asarray(jutil.gradient(_rosen_j, v)), rtol=1e-5)
    np.testing.assert_allclose(tutil.hessian(_rosen_t, v).numpy(),
                               np.asarray(jutil.hessian(_rosen_j, v)), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tutil.jacobian(lambda t: torch.sin(t) * t[0], v).numpy(),
                               np.asarray(jutil.jacobian(lambda t: jnp.sin(t) * t[0], v)),
                               rtol=1e-5, atol=1e-6)


def test_has_nan_or_inf_and_eval_print(capsys):
    assert not tutil.has_nan_or_inf(torch.ones(3))
    assert tutil.has_nan_or_inf(torch.tensor([1.0, float("inf")]))
    assert tutil.has_nan_or_inf([float("nan")])
    assert issubclass(tutil.LogProbError, Exception)
    answer = 6 * 7  # noqa: F841  (read by eval_print from this frame)
    tutil.eval_print("answer", "answer + 1")
    out = capsys.readouterr().out
    assert "test_has_nan_or_inf_and_eval_print" in out
    assert re.search(r"answer\s+= 42", out) and re.search(r"answer \+ 1 = 43", out)


def test_progress_bar_lines(capsys, monkeypatch):
    monkeypatch.setattr(progress, "_REFRESH", -1.0)  # a line at every update
    bar = tutil.ProgressBar("Sampling", 10, rejections=True)
    bar.update(4, rejections=0.25)
    bar.end("done")
    out = capsys.readouterr().out
    header, cols, rest = out.split("\n", 2)
    assert header == "Sampling"
    assert cols.startswith("Time spent  | Time remain.| Progress") and cols.endswith("Rejected Samples")
    lines = rest.split("\r")
    assert re.search(r"\| #{8}-{12} \|  4/10 \| [\d,.]+ \| 0\.25", lines[0])
    assert re.search(r"\| #{18}-{2} \|  9/10 \|", lines[1])
    assert lines[-1] == "\ndone\n"
    with pytest.raises(ValueError):
        tutil.ProgressBar("x", 0)


def test_setup_chain_and_multi_chain():
    def prior(key):
        return torch.randn(3, generator=torch.Generator().manual_seed(key))

    kwargs = dict(log_prob_func=lambda t: -0.5 * torch.sum(t ** 2), num_samples=6,
                  step_size=0.3, verbose=False)
    chain = tutil.setup_chain(tht.sample, prior, kwargs)
    seeds = [0, 1, 2, 3]
    sequential = tutil.multi_chain(chain, 2, seeds)
    threaded = tutil.multi_chain(chain, 3, seeds, parallel=True)
    assert len(threaded) == 4 and all(tuple(s.shape) == (6, 3) for s in threaded)
    assert all(torch.equal(a, b) for a, b in zip(sequential, threaded))  # seed order kept
    assert not torch.equal(sequential[0], sequential[1])
    # a prior without arguments, the reference's style
    assert tuple(tutil.setup_chain(tht.sample, lambda: torch.zeros(3), kwargs)(5).shape) == (6, 3)

    def failing(seed):
        raise RuntimeError(f"chain {seed}")

    with pytest.raises(RuntimeError, match="chain"):
        tutil.multi_chain(failing, 2, seeds, parallel=True)


def test_timed_and_throughput_match_jax():
    """The same draws (the JAX driver's noise injected) give the same
    counters; ``timed`` fills its seconds on exit."""
    scale = np.array([0.5, 1.0, 2.0], np.float32)
    cfg = dict(num_samples=12, num_steps_per_sample=4, step_size=0.9)
    key = jax.random.key(3)
    j_res = jht.run_hmc(key, lambda t: -0.5 * jnp.sum((t / scale) ** 2), jnp.ones(3),
                        jht.MCMCConfig(**cfg))
    keys = [jax.random.split(jax.random.fold_in(key, n)) for n in range(12)]
    noise = (torch.as_tensor(np.stack([np.asarray(jax.random.normal(k[0], (3,))) for k in keys])),
             torch.as_tensor(np.stack([np.log(np.asarray(jax.random.uniform(k[1], ())))
                                       for k in keys])))
    with profiling.timed() as t:
        t_res = tht.run_hmc(0, lambda v: -0.5 * torch.sum((v / torch.as_tensor(scale)) ** 2),
                            torch.ones(3), tht.MCMCConfig(**cfg), _noise=noise)
    assert t["seconds"] > 0
    from hamiltorch_tpu.utils.profiling import throughput as j_throughput

    got = profiling.throughput(t_res, 2.0, num_steps_per_sample=4)
    want = j_throughput(j_res, 2.0, num_steps_per_sample=4)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
    chains = tht.run_hmc_chains(0, lambda v: -0.5 * torch.sum(v ** 2), torch.ones(3),
                                tht.MCMCConfig(num_samples=5), num_chains=3)
    assert profiling.throughput(chains, 1.0)["chains"] == 3


def test_trace_writes_a_profile(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("phase"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert any(e.key == "phase" for e in prof.key_averages())
    assert any(name.endswith(".json") for name in os.listdir(tmp_path))
