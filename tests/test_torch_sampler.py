"""PyTorch port, the sampler workload's trainer (``train/sampler.py``), its
loss registry (``train/losses.py``) and temperature annealer
(``train/schedules.py``), against the JAX package.

Train-step parity: both sides start from JAX's ``init_sampler_state`` (its
MLP leaves carried over by name), and the port replays JAX's draws per
step: ``kx, kz, kzi = split(key, 3)``; each transition ``kv, kd, ka =
split(k, 3)``, ``v = normal(kv)``, ``direction = uniform(kd) > 0.5``,
``u = uniform(ka)``; ``z = normal(kzi)``.  JAX's step runs jitted.

Tolerances: float32 on both sides through K=3 trajectories on targets
with exactly representable precision matrices (the mixtures' 1/var, a
diagonal Gaussian): loss rtol 1e-5; every parameter within 1e-5 relative
to its largest entry, over three steps (Adam's early updates are ~lr x
sign(g), so a difference in g's rounding moves a parameter far less);
the chains atol 1e-5.  The loss registry: 1e-6 of the size of its terms
(two of its losses are differences of two means, which float32 summation
in another order moves by that much); the annealer rtol 1e-6 (float32
scalar arithmetic, equal in practice).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from l2hmc_tpu import targets as J
from l2hmc_tpu.train import losses as jlosses
from l2hmc_tpu.train import sampler as jsampler
from l2hmc_tpu.train import schedules as jsched
from l2hmc_tpu_torch import targets as T
from l2hmc_tpu_torch.train import losses as tlosses
from l2hmc_tpu_torch.train import sampler as tsampler
from l2hmc_tpu_torch.train import schedules as tsched
from l2hmc_tpu_torch.train.checkpoint import _net_arrays
from l2hmc_tpu_torch.train.gauge import TrainDraws

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# Loss registry and the temperature annealer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(jlosses.LOSS_REGISTRY))
def test_torch_loss_registry_matches_jax(name):
    rng = np.random.default_rng(1)
    x, xp = rng.standard_normal((2, 16, 3)).astype(np.float32)
    p = rng.uniform(size=16).astype(np.float32)
    for scale in (1.0, 0.3):
        want = float(jlosses.get_loss(name)(x, xp, p, scale=scale))
        got = float(tlosses.get_loss(name)(
            torch.from_numpy(x), torch.from_numpy(xp), torch.from_numpy(p),
            scale=scale))
        # relative to the size of the terms: "mixed" and "standard" are
        # differences of two means
        v = np.asarray(jlosses.loss_vec(x, xp, p), np.float64)
        size = max(abs(want), np.mean(scale / v) + np.mean(v / scale))
        assert abs(got - want) <= 1e-6 * size
    np.testing.assert_allclose(
        tlosses.loss_vec(torch.from_numpy(x), torch.from_numpy(xp),
                         torch.from_numpy(p)).numpy(),
        np.asarray(jlosses.loss_vec(x, xp, p)), rtol=1e-6)
    assert sorted(tlosses.LOSS_REGISTRY) == sorted(jlosses.LOSS_REGISTRY)
    with pytest.raises(ValueError, match="loss="):
        tlosses.get_loss("nope")


@pytest.mark.parametrize("rates", [(0.1, 0.5, 0.05, 0.9, 0.3),
                                   (0.25, 0.25, 0.0, 1.0, 0.19)])
def test_torch_temperature_schedule_matches_jax(rates):
    js = jsched.init_temperature(10.0, 0.98)
    ts = tsched.init_temperature(10.0, 0.98)
    for i in range(250):
        js = jsched.temperature_step(js, 7)
        ts = tsched.temperature_step(ts, 7)
        if i % 50 == 49:
            r = rates[i // 50]
            js = jsched.adapt_temperature_schedule(js, jnp.asarray(r))
            ts = tsched.adapt_temperature_schedule(ts, r)
        assert float(ts.temperature) == pytest.approx(
            float(js.temperature), rel=1e-6)
        assert float(ts.annealing_factor) == pytest.approx(
            float(js.annealing_factor), rel=1e-6)
        assert ts.steps_since_update == int(js.steps_since_update)
    # the floor at T = 1 and the fast-factor clip
    s = tsched.TemperatureSchedule(np.float32(1.01), np.float32(0.5), 0)
    assert float(tsched.temperature_step(s, 1).temperature) == 1.0
    assert float(tsched.adapt_temperature_schedule(
        s, 0.9).annealing_factor) == 0.5


# ---------------------------------------------------------------------------
# The train step against JAX's, with JAX's draws replayed
# ---------------------------------------------------------------------------


def _targets(name):
    if name == "gmm":
        return (J.gmm_single_axis(2, sep=2.0, var=0.1),
                T.gmm_single_axis(2, sep=2.0, var=0.1, device="cpu"))
    sigma = np.diag([0.5, 2.0, 4.0]).astype(np.float32)
    mu = np.array([0.25, -0.5, 1.0], np.float32)
    return (J.Gaussian.create(mu, sigma),
            T.Gaussian.create(mu, sigma, "cpu"))


def _port_state(jstate, cfg, energy):
    """The port's state holding JAX's params and chains."""
    state = tsampler.init_sampler_state(cfg, energy,
                                        torch.Generator().manual_seed(0),
                                        device="cpu")
    p = jstate.params
    for net, arrays in ((state.params.xnet, p.xnet),
                        (state.params.vnet, p.vnet)):
        net.load_state_dict({k: torch.tensor(np.asarray(v, np.float32))
                             for k, v in _net_arrays(arrays).items()})
    with torch.no_grad():
        state.params.raw_eps.copy_(torch.tensor(float(p.raw_eps)))
        state.params.masks.copy_(torch.tensor(np.asarray(p.masks)))
    return state._replace(x=torch.tensor(np.asarray(jstate.x)))


def _jax_draws(key, x_shape):
    """The randomness JAX's train step draws from ``key``."""
    kx, kz, kzi = jax.random.split(key, 3)

    def chain(k):
        kv, kd, ka = jax.random.split(k, 3)
        v = jax.random.normal(kv, x_shape, jnp.float32)
        d = jnp.where(jax.random.uniform(kd, (x_shape[0],)) > 0.5, 1.0, -1.0)
        return v, d, jax.random.uniform(ka, (x_shape[0],))

    v_x, d_x, u_x = chain(kx)
    z = jax.random.normal(kzi, x_shape, jnp.float32)
    v_z, d_z, u_z = chain(kz)
    return TrainDraws(*(torch.tensor(np.asarray(a, np.float32))
                        for a in (v_x, d_x, u_x, z, v_z, d_z, u_z)))


def _rel(a, b):
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(np.asarray(a, np.float64) - b))
                 / max(np.max(np.abs(b)), 1e-12))


@pytest.mark.parametrize("target,annealing", [("gmm", True),
                                              ("gaussian", False)])
def test_torch_sampler_train_step_matches_jax(target, annealing):
    jt, tt = _targets(target)
    kw = dict(x_dim=jt.mus.shape[-1] if target == "gmm" else 3,
              num_chains=16, num_steps=3, eps_init=0.15, num_hidden=8,
              use_annealing=annealing, annealing_steps=2, temp_init=4.0)
    jcfg = jsampler.SamplerConfig(**kw)
    tcfg = tsampler.SamplerConfig(**kw)
    jstate = jsampler.init_sampler_state(jcfg, jt.energy,
                                         jax.random.PRNGKey(3))
    tstate = _port_state(jstate, tcfg, tt.energy)
    jstep = jax.jit(jsampler.make_sampler_train_step(jcfg, jt.energy))
    _, tstep = tsampler.make_sampler_train_step(tcfg, tt.energy)
    key = jax.random.PRNGKey(9)
    for _ in range(3):
        key, sub = jax.random.split(key)
        draws = _jax_draws(sub, tuple(tstate.x.shape))
        jstate, jm = jstep(jstate, sub)
        tstate, tm = tstep(tstate, draws)
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-5)
        for k in ("accept_prob", "eps", "temperature"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5,
                                                 abs=1e-6), k
        np.testing.assert_allclose(tstate.x.numpy(), np.asarray(jstate.x),
                                   atol=1e-5)
        assert float(tstate.temp.temperature) == float(
            jstate.temp.temperature)
        for net in ("xnet", "vnet"):
            want = _net_arrays(getattr(jstate.params, net))
            got = getattr(tstate.params, net).state_dict()
            for k, v in want.items():
                assert _rel(got[k].numpy(), v) <= 1e-5, (net, k)
        assert _rel(float(tstate.params.raw_eps.detach()),
                    float(jstate.params.raw_eps)) <= 1e-5
        np.testing.assert_array_equal(tstate.params.masks.numpy(),
                                      np.asarray(jstate.params.masks))
    assert tstate.step == int(jstate.step) == 3


def test_torch_sampler_dynamics_config():
    cfg = tsampler.SamplerConfig(x_dim=2, num_hidden=6)
    dyn_cfg, dyn, make_nets = tsampler.build_sampler_dynamics(
        cfg, T.scg_2d("cpu").energy)
    assert dyn_cfg.use_log_eps and dyn_cfg.group == "r1"
    xnet, vnet = make_nets(torch.Generator().manual_seed(0), "cpu")
    assert xnet.spec.bounded_q and vnet.spec.bounded_q
    assert (xnet.spec.factor, vnet.spec.factor) == (2.0, 1.0)
    state = tsampler.init_sampler_state(cfg, T.scg_2d("cpu").energy,
                                        torch.Generator().manual_seed(0),
                                        device="cpu")
    assert float(state.params.raw_eps) == pytest.approx(np.log(0.1))
    assert "masks" not in state.opt_state.mu
    assert float(state.temp.temperature) == 1.0     # no annealing


def test_torch_sampler_chunk_and_sample_chain():
    """A chunk stacks its metrics; the sample chain returns (T, chains, d)
    samples and acceptances in [0, 1]; the HMC-mode sampler (zero nets)
    keeps its eps and samples a Gaussian."""
    tt = T.gmm_single_axis(2, device="cpu")
    cfg = tsampler.SamplerConfig(x_dim=2, num_chains=8, num_steps=3,
                                 num_hidden=6, use_annealing=True,
                                 annealing_steps=2)
    gen = torch.Generator().manual_seed(4)
    state = tsampler.init_sampler_state(cfg, tt.energy, gen, device="cpu")
    chunk = tsampler.make_sampler_train_chunk(cfg, tt.energy, 4)
    state, m = chunk(state, gen)
    assert set(m) == {"loss", "accept_prob", "eps", "temperature"}
    assert all(v.shape == (4,) for v in m.values())
    np.testing.assert_allclose(m["temperature"].numpy(),
                               [10.0, 10.0, 9.8, 9.8], rtol=1e-6)
    sample = tsampler.make_sample_chain(cfg, tt.energy)
    xs, probs = sample(state.params, state.x, gen, 5)
    assert xs.shape == (5, 8, 2) and probs.shape == (5, 8)
    assert bool(((probs >= 0) & (probs <= 1)).all())
    assert not xs.requires_grad


def test_torch_sampler_state_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tsampler.SamplerConfig(x_dim=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsampler.init_sampler_state(cfg, lambda x: x.sum(-1),
                                    torch.Generator().manual_seed(0))
