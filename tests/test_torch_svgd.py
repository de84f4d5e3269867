"""The port's SVGD (``hamiltorch_tpu_torch/svgd.py``) against the JAX
package's ``run_svgd`` on the same ``particles0``.

SVGD is deterministic after the initial cloud, so both packages start from
one numpy-drawn cloud (or JAX's ``jax.random.normal`` cloud handed to the
port's ``_noise``) and must agree within 1e-5 relative in float32.  The
update divides by the square root of its AdaGrad accumulator, so a
last-bit difference between XLA's and PyTorch's float32 products grows
step by step (measured on the CPU: 2e-6 relative after 2 steps, 5e-6 after
10, 7e-5 after 50); the comparisons run 10 steps, where the two agree
within the gate, and resume, counting and validation are checked on their
own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hamiltorch_tpu import svgd as jsv
from hamiltorch_tpu_torch import svgd as tsv

COV = np.array([[1.0, 0.8], [0.8, 2.0]])
PREC = np.linalg.inv(COV)
N = 32  # an even particle count: n^2 is even, so the median averages two


def j_lp(t):
    return -0.5 * t @ jnp.asarray(PREC, t.dtype) @ t


def t_lp(t):
    return -0.5 * t @ torch.tensor(PREC, dtype=t.dtype) @ t


def cloud(n=N, d=2, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def assert_close(got, want, rtol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


def both(cfg_kw, p0=None, steps=10, n=N):
    p0 = cloud(n) if p0 is None else p0
    jr = jsv.run_svgd(jax.random.key(0), j_lp, jnp.zeros(2),
                      jsv.SVGDConfig(num_steps=steps, **cfg_kw), n,
                      particles0=jnp.asarray(p0))
    tr = tsv.run_svgd(0, t_lp, torch.zeros(2), tsv.SVGDConfig(num_steps=steps, **cfg_kw), n,
                      particles0=torch.tensor(p0))
    return jr, tr


@pytest.mark.parametrize("cfg", [dict(step_size=0.2), dict(step_size=0.2, bandwidth=0.7),
                                 dict(step_size=0.05, optimizer="sgd"),
                                 dict(step_size=0.2, adagrad_alpha=0.5, fudge=1e-3)],
                         ids=["adagrad-median", "adagrad-fixed", "sgd-median", "adagrad-knobs"])
def test_matches_jax_from_the_same_cloud(cfg):
    jr, tr = both(cfg)
    assert_close(tr.particles, jr.particles)
    assert_close(tr.bandwidth_trace, jr.bandwidth_trace)
    assert_close(tr.phi_norm_trace, jr.phi_norm_trace)
    # the accumulator averages phi**2: a square doubles phi's relative error
    assert_close(tr.final_aux, jr.final_aux, rtol=2e-5)
    assert int(tr.num_rejected) == int(jr.num_rejected) == 0
    assert int(tr.final_step) == int(jr.final_step) == 10
    assert tr.particles.dtype == torch.float32 and tr.final_aux.dtype == torch.float32


def test_sgd_agrees_over_a_longer_run():
    """Without the accumulator's division nothing amplifies the last bit:
    50 sgd steps stay within the gate."""
    jr, tr = both(dict(step_size=0.05, optimizer="sgd"), steps=50)
    assert_close(tr.particles, jr.particles)


def test_tree_state_matches_jax_and_the_flat_run():
    """A dict state ravels at the boundary (leaf order a, b): the same cloud
    gives JAX's tree result, and the flat run's numbers bit for bit."""
    p0 = cloud()
    cfg = dict(step_size=0.2)

    def j_tree(p):
        return j_lp(jnp.concatenate([p["a"], p["b"]]))

    def t_tree(p):
        return t_lp(torch.cat([p["a"], p["b"]]))

    jr = jsv.run_svgd(jax.random.key(0), j_tree, {"a": jnp.zeros(1), "b": jnp.zeros(1)},
                      jsv.SVGDConfig(num_steps=10, **cfg), N,
                      particles0={"a": jnp.asarray(p0[:, :1]), "b": jnp.asarray(p0[:, 1:])})
    tr = tsv.run_svgd(0, t_tree, {"a": torch.zeros(1), "b": torch.zeros(1)},
                      tsv.SVGDConfig(num_steps=10, **cfg), N,
                      particles0={"a": torch.tensor(p0[:, :1]), "b": torch.tensor(p0[:, 1:])})
    assert tr.particles["a"].shape == (N, 1)
    assert_close(torch.cat([tr.particles["a"], tr.particles["b"]], 1),
                 np.concatenate([np.asarray(jr.particles["a"]), np.asarray(jr.particles["b"])], 1))
    flat = tsv.run_svgd(0, t_lp, torch.zeros(2), tsv.SVGDConfig(num_steps=10, **cfg), N,
                        particles0=torch.tensor(p0))
    assert torch.equal(torch.cat([tr.particles["a"], tr.particles["b"]], 1), flat.particles)


def test_jax_initial_cloud_through_the_noise_hook():
    """``_noise`` takes JAX's ``jax.random.normal(key, (n, D))``: the port's
    run then is JAX's run from its own key (the cloud theta0 + init_scale
    * noise included)."""
    key = jax.random.key(4)
    cfg = dict(step_size=0.2, init_scale=0.5)
    theta0 = np.array([0.3, -0.2], np.float32)
    jr = jsv.run_svgd(key, j_lp, jnp.asarray(theta0), jsv.SVGDConfig(num_steps=10, **cfg), N)
    noise = np.asarray(jax.random.normal(key, (N, 2), jnp.float32))
    tr = tsv.run_svgd(0, t_lp, torch.tensor(theta0), tsv.SVGDConfig(num_steps=10, **cfg), N,
                      _noise=torch.tensor(noise))
    assert_close(tr.particles, jr.particles)


def test_own_stream_draws_the_initial_cloud_from_the_key():
    cfg = tsv.SVGDConfig(num_steps=1, step_size=1e-9, optimizer="sgd", init_scale=0.5)
    a = tsv.run_svgd(3, t_lp, torch.zeros(2), cfg, 8)
    b = tsv.run_svgd(3, t_lp, torch.zeros(2), cfg, 8)
    c = tsv.run_svgd(4, t_lp, torch.zeros(2), cfg, 8)
    assert torch.equal(a.particles, b.particles)
    assert not torch.equal(a.particles, c.particles)
    spread = a.particles.std(dim=0)
    assert torch.all((spread > 0.2) & (spread < 1.0))


def test_median_averages_the_two_middle_elements():
    """The heuristic takes ``jnp.median`` of the n^2 squared distances.  With
    an even count that is the mean of the two middle elements, where
    ``torch.median`` returns the lower one: the two differ here, and the
    port's ``_median`` is JAX's."""
    x = torch.tensor(cloud(N))
    d2 = tsv._pairwise_sq(x)
    assert d2.numel() % 2 == 0
    want = float(jnp.median(jnp.asarray(d2.numpy())))
    got = float(tsv._median(d2))
    assert got == pytest.approx(want, rel=1e-7)
    assert float(torch.median(d2)) < got - 1e-4 * got
    h = tsv._median_h(d2, N)
    jh = jsv._median_h(jnp.asarray(d2.numpy()), N)
    assert float(h) == pytest.approx(float(jh), rel=1e-6)
    # an odd count has one middle element, and both agree
    d2o = d2.reshape(-1)[:-1]
    assert float(tsv._median(d2o)) == float(torch.median(d2o))


@pytest.mark.parametrize("optimizer", ["adagrad", "sgd"])
def test_chunked_resume_is_bit_for_bit(optimizer):
    """Two chunks through (particles0, init_aux, start_step) equal one run:
    the accumulator and the global-step-0 seeding both ride the carry."""
    full = tsv.run_svgd(0, t_lp, torch.zeros(2),
                        tsv.SVGDConfig(num_steps=20, step_size=0.2, optimizer=optimizer), N)
    half = tsv.SVGDConfig(num_steps=8, step_size=0.2, optimizer=optimizer)
    r1 = tsv.run_svgd(0, t_lp, torch.zeros(2), half, N)
    rest = tsv.SVGDConfig(num_steps=12, step_size=0.2, optimizer=optimizer)
    r2 = tsv.run_svgd(0, t_lp, torch.zeros(2), rest, N, particles0=r1.particles,
                      init_aux=r1.final_aux, start_step=r1.final_step)
    assert torch.equal(r2.particles, full.particles)
    assert torch.equal(r2.final_aux, full.final_aux)
    assert torch.equal(torch.cat([r1.phi_norm_trace, r2.phi_norm_trace]), full.phi_norm_trace)
    assert int(r2.final_step) == int(full.final_step) == 20


def test_nan_cliff_is_counted_and_skipped():
    """A NaN cliff never corrupts the cloud: the bad steps are skipped,
    counted in ``num_rejected`` as JAX counts them, and nothing raises."""

    def j_cliff(t):
        return jnp.where(t[0] > 0.35, jnp.nan * jnp.sum(t), -0.5 * jnp.sum(t * t))

    def t_cliff(t):
        return torch.where(t[0] > 0.35, torch.nan * torch.sum(t), -0.5 * torch.sum(t * t))

    p0 = 0.3 * cloud(16)
    cfg = dict(num_steps=20, step_size=0.5)
    jr = jsv.run_svgd(jax.random.key(0), j_cliff, jnp.zeros(2), jsv.SVGDConfig(**cfg), 16,
                      particles0=jnp.asarray(p0))
    tr = tsv.run_svgd(0, t_cliff, torch.zeros(2), tsv.SVGDConfig(**cfg), 16,
                      particles0=torch.tensor(p0))
    assert torch.isfinite(tr.particles).all()
    assert int(tr.num_rejected) == int(jr.num_rejected) > 0
    assert_close(tr.particles, jr.particles)


def test_data_operand_equals_the_closure():
    x = torch.linspace(-1, 1, 16)
    y = 2.0 * x + 0.1

    def lp_data(t, d):
        xs, ys = d
        r = ys - t[0] * xs - t[1]
        return -0.5 * torch.sum(r * r) - 0.5 * torch.sum(t * t)

    cfg = tsv.SVGDConfig(num_steps=10, step_size=0.2)
    rd = tsv.run_svgd(1, lp_data, torch.zeros(2), cfg, 16, data=(x, y))
    rc = tsv.run_svgd(1, lambda t: lp_data(t, (x, y)), torch.zeros(2), cfg, 16)
    assert torch.equal(rd.particles, rc.particles)


def test_float64_particles_update_in_float32():
    """The update runs in float32 whatever the particles' dtype, as the JAX
    package's does; the cloud keeps its dtype."""
    p0 = cloud().astype(np.float64)
    r64 = tsv.run_svgd(0, t_lp, torch.zeros(2, dtype=torch.float64),
                       tsv.SVGDConfig(num_steps=5, step_size=0.2), N,
                       particles0=torch.tensor(p0))
    assert r64.particles.dtype == torch.float64 and r64.final_aux.dtype == torch.float32
    r32 = tsv.run_svgd(0, t_lp, torch.zeros(2), tsv.SVGDConfig(num_steps=5, step_size=0.2), N,
                       particles0=torch.tensor(p0.astype(np.float32)))
    assert_close(r64.particles.float(), r32.particles.numpy(), rtol=1e-4)


@pytest.mark.parametrize("kw,match", [(dict(num_steps=0), "num_steps"),
                                      (dict(num_steps=1, optimizer="adamw"), "optimizer"),
                                      (dict(num_steps=1, bandwidth=-1.0), "bandwidth"),
                                      (dict(num_steps=1, step_size=0.0), "step_size")])
def test_config_validation(kw, match):
    for mod in (jsv, tsv):
        with pytest.raises(ValueError, match=match):
            mod.SVGDConfig(**kw)


def test_particle_count_validation():
    cfg = tsv.SVGDConfig(num_steps=1)
    with pytest.raises(ValueError, match="num_particles"):
        tsv.run_svgd(0, t_lp, torch.zeros(2), cfg, num_particles=1)
    with pytest.raises(ValueError, match="particles0"):
        tsv.run_svgd(0, t_lp, torch.zeros(2), cfg, num_particles=8,
                     particles0=torch.zeros((4, 2)))


def test_a_start_that_is_not_a_tensor_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsv.run_svgd(0, t_lp, np.zeros(2, np.float32), tsv.SVGDConfig(num_steps=1), 4)
