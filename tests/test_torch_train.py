"""PyTorch port, train/: schedules, dual averaging, losses, surrogate charges
and the train step against JAX (the training loops are in
tests/test_torch_train_loops.py).

Train-step parity: both sides start from the same state (the JAX
``init_train_state``, nets perturbed by a seeded N(0, 0.05^2), carried over
with ``train_state_from_numpy``), and the test replays JAX's draws per step:
``kx, kz, kzi = split(key, 3)``; each transition ``kv, kd, ka = split(k, 3)``;
``z = normal(kzi)``; the hop key ``fold_in(key, 77)``.  JAX's
``make_train_step`` is called jitted (one compile per config, a few
seconds at this size).

Tolerances: float32 on both sides with different libm and summation order,
through K=2 trajectories: loss rtol 1e-4; accept probabilities and the
chain state atol 2e-4 (as tests/test_torch_dynamics.py); gradients
max|d| <= 1e-4 max|g| per tensor; the updated params within 5e-3 lr of
JAX's, since Adam's first update is ~lr*sign(g) and the float32 rounding of
the trajectories moves it by far less (~1e-3 lr over three steps); in the
cases of the image nets, r1, the improved action and both directions only
where the clipped gradient is at least 1e-6 (100x Adam's eps), within lr
elsewhere, where the update follows the rounding of g itself.
Schedules and dual averaging are scalar float32 math: rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from l2hmc_tpu.dynamics import nuts as jnuts
from l2hmc_tpu.lattice import u1 as ju1
from l2hmc_tpu.train import gauge as jgauge
from l2hmc_tpu.train import losses as jlosses
from l2hmc_tpu.train import schedules as jsched
from l2hmc_tpu_torch.dynamics import nuts as tnuts
from l2hmc_tpu_torch.lattice import u1 as tu1
from l2hmc_tpu_torch.train import gauge as tgauge
from l2hmc_tpu_torch.train import losses as tlosses
from l2hmc_tpu_torch.train import schedules as tsched
from l2hmc_tpu_torch.train.checkpoint import _find_adam, train_state_from_numpy

torch.set_num_threads(1)

LT, LX, K, H, B = 4, 4, 2, 16, 8


# ---------------------------------------------------------------------------
# Schedules, dual averaging, losses, surrogate charges
# ---------------------------------------------------------------------------


def test_torch_beta_schedule_matches_jax():
    for step in (0, 1, 37, 100, 250):
        want = float(jsched.beta_schedule(jnp.asarray(step, jnp.int32), 200,
                                          2.0, 5.0))
        assert tsched.beta_schedule(step, 200, 2.0, 5.0) == pytest.approx(
            want, rel=1e-6)


@pytest.mark.parametrize("warmup", [0, 5])
def test_torch_lr_schedule_matches_jax(warmup):
    want = jsched.make_lr_schedule(3e-3, 7, 0.9, warmup)
    got = tsched.make_lr_schedule(3e-3, 7, 0.9, warmup)
    for count in (0, 1, 4, 5, 6, 12, 40):
        assert got(count) == pytest.approx(
            float(want(jnp.asarray(count, jnp.int32))), rel=1e-6, abs=1e-12)
    if warmup:
        assert got(0) == 0.0


def test_torch_dual_averaging_matches_jax():
    js = jnuts.dual_averaging_init(0.1)
    ts = tnuts.dual_averaging_init(0.1, device="cpu")
    for acc in (0.2, 0.9, 0.5, 0.75, 0.1):
        js = jnuts.dual_averaging_update(js, jnp.asarray([acc, acc / 2]))
        ts = tnuts.dual_averaging_update(ts, torch.tensor([acc, acc / 2]))
        for a, b in zip(ts, js):
            assert float(a) == pytest.approx(float(b), rel=1e-6, abs=1e-7)


def _pair(seed, b=B, d=2 * LT * LX):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-np.pi, np.pi, (b, d)).astype(np.float32)
            for _ in range(2)]


@pytest.mark.parametrize("metric", ["l1", "l2", "cos", "cos2", "cos_diff"])
def test_torch_metric_fns_match_jax(metric):
    x1, x2 = _pair(1)
    want = np.asarray(jlosses.get_metric_fn(metric)(jnp.asarray(x1),
                                                    jnp.asarray(x2)))
    got = tlosses.get_metric_fn(metric)(torch.from_numpy(x1),
                                        torch.from_numpy(x2))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


@pytest.mark.parametrize("reward", [False, True])
def test_torch_esjd_and_charge_losses_match_jax(reward):
    rng = np.random.default_rng(2)
    x, xp = _pair(3)
    z, zp = _pair(4)
    px, pz = rng.uniform(size=(2, B)).astype(np.float32)
    dqx, dqz = rng.uniform(0, 2, (2, B)).astype(np.float32)
    kw = dict(loss_scale=0.3, aux_weight=0.7, std_weight=1.3)
    want = float(jlosses.esjd_loss(
        *map(jnp.asarray, (x, xp, px, z, zp, pz)),
        metric_fn=jlosses.get_metric_fn("cos_diff"), **kw))
    got = float(tlosses.esjd_loss(
        *map(torch.from_numpy, (x, xp, px, z, zp, pz)),
        metric_fn=tlosses.get_metric_fn("cos_diff"), **kw))
    assert got == pytest.approx(want, rel=1e-5)
    want = float(jlosses.charge_loss(*map(jnp.asarray, (dqx, px, dqz, pz)),
                                     charge_weight=2.0, aux_weight=0.5,
                                     reward=reward))
    got = float(tlosses.charge_loss(*map(torch.from_numpy, (dqx, px, dqz,
                                                            pz)),
                                    charge_weight=2.0, aux_weight=0.5,
                                    reward=reward))
    assert got == pytest.approx(want, rel=1e-5)
    with pytest.raises(ValueError, match="metric"):
        tlosses.get_metric_fn("l3")


def test_torch_surrogate_charges_match_jax():
    x1, x2 = _pair(5)
    js, ts = ju1.LatticeShape(LT, LX), tu1.LatticeShape(LT, LX)
    jx1, jx2 = jnp.asarray(x1), jnp.asarray(x2)
    tx1, tx2 = torch.from_numpy(x1), torch.from_numpy(x2)
    np.testing.assert_allclose(
        tu1.project_angle_approx(tx1).numpy(),
        np.asarray(ju1.project_angle_approx(jx1)), atol=1e-5)
    np.testing.assert_allclose(
        tu1.topological_charge_approx(tu1.to_links(tx1, ts), 7).numpy(),
        np.asarray(ju1.topological_charge_approx(ju1.to_links(jx1, js), 7)),
        atol=1e-5)
    np.testing.assert_allclose(
        tu1.charge_diff(tx1, tx2, ts).numpy(),
        np.asarray(ju1.charge_diff(jx1, jx2, js)), atol=1e-5)
    np.testing.assert_allclose(
        tu1.charge_diff_approx(tx1, tx2, ts).numpy(),
        np.asarray(ju1.charge_diff_approx(jx1, jx2, js)), atol=1e-5)


# ---------------------------------------------------------------------------
# Loss, gradients and train steps against JAX
# ---------------------------------------------------------------------------


def _kw(**over):
    kw = dict(time_size=LT, space_size=LX, num_chains=B, num_steps=K,
              network_arch="mlp", num_hidden=H, merge_v_halves=True,
              eps_init=0.15, beta_init=2.0, beta_final=3.0, train_steps=40,
              charge_reward=True, lr_warmup_steps=0, eps_trainable=False)
    kw.update(over)
    return kw


def _states(kw, seed=3):
    """The JAX init state with perturbed nets, and its port copy."""
    jcfg = jgauge.GaugeConfig(**kw)
    js = jgauge.init_train_state(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def bump(t):
        return jax.tree.map(lambda a: jnp.asarray(
            np.asarray(a) + 0.05 * rng.standard_normal(a.shape),
            jnp.float32), t)

    js = js._replace(params=js.params._replace(xnet=bump(js.params.xnet),
                                               vnet=bump(js.params.vnet)))
    tcfg = tgauge.GaugeConfig(**kw)
    ts = train_state_from_numpy(jax.tree.map(np.asarray, js), tcfg, "cpu")
    return jcfg, js, tcfg, ts


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _transition_draws(key, b, d):
    kv, kd, ka = jax.random.split(key, 3)
    v = jax.random.normal(kv, (b, d), jnp.float32)
    direction = jnp.where(jax.random.uniform(kd, (b,)) > 0.5, 1.0, -1.0)
    return v, direction, jax.random.uniform(ka, (b,))


def _jax_draws(key, b, d, hop):
    """TrainDraws replaying one JAX train step's key."""
    kx, kz, kzi = jax.random.split(key, 3)
    out = [*_transition_draws(kx, b, d),
           jax.random.normal(kzi, (b, d), jnp.float32),
           *_transition_draws(kz, b, d)]
    if hop:
        k_nu, k_acc = jax.random.split(jax.random.fold_in(key, 77))
        mag = jax.random.randint(k_nu, (b,), 1, 2)
        sign = jax.random.rademacher(jax.random.fold_in(k_nu, 1), (b,))
        out += [mag * sign, jax.random.uniform(k_acc, (b,))]
    return tgauge.TrainDraws(*map(_t, out))


def _jax_leaves(params):
    return {jax.tree_util.keystr(p, simple=True, separator="/"): np.asarray(a)
            for p, a in jax.tree_util.tree_leaves_with_path(params)}


def _port_layout(params, name, array):
    """A reference leaf (params, grads) in the layout of the port's tensor
    of that name (the image nets' conv weights and dense rows differ)."""
    head, _, rest = name.partition("/")
    if head in ("xnet", "vnet"):
        return getattr(params, head).from_reference_leaf(
            rest.replace("/", "."), array)
    return array


def test_torch_loss_and_grads_match_jax():
    kw = _kw(metric="plaq_cos", ref_z_term=True)
    jcfg, js, tcfg, ts = _states(kw)
    _, jdyn, _ = jgauge.build_dynamics(jcfg)
    jloss = jgauge.make_loss_fn(jcfg, jdyn)
    key = jax.random.PRNGKey(11)
    (want, jaux), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        js.params, js.x, 2.5, key)
    _, tdyn = tgauge.build_dynamics(tcfg)
    loss_fn, loss_fn_with = tgauge.make_loss_fn(tcfg, tdyn)
    got, taux = loss_fn_with(ts.params, ts.x, 2.5,
                             _jax_draws(key, B, tcfg.x_dim, False))
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-4)
    assert float(taux["accept_prob"]) == pytest.approx(
        float(jaux["accept_prob"]), abs=2e-4)
    leaves = tgauge.named_leaves(ts.params)
    wrt = [k for k, v in leaves.items() if v.requires_grad]
    grads = torch.autograd.grad(got, [leaves[k] for k in wrt])
    jg = _jax_leaves(jgrads)
    for name, g in zip(wrt, grads):
        scale = np.abs(jg[name]).max()
        assert np.abs(g.numpy() - jg[name]).max() <= 1e-4 * scale, name
    # the random form runs and is reproducible from a generator
    a, _ = loss_fn(ts.params, ts.x, 2.5, torch.Generator().manual_seed(0))
    b, _ = loss_fn(ts.params, ts.x, 2.5, torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and bool(torch.isfinite(a))


# the port's remat (checkpointed leapfrog steps) is on unless a case says
# remat=False; the JAX step checkpoints always (values are the same)
STEP_CASES = {
    "eps_fixed_hops": dict(train_hops=True),
    "eps_trainable": dict(eps_trainable=True),
    "eps_warmup": dict(eps_trainable=True, eps_warmup_steps=2),
    "lr_warmup": dict(lr_warmup_steps=200, train_hops=True),
    "summaries": dict(grad_summaries=True, clip_value=0.0),
    "conv_split": dict(network_arch="conv", merge_v_halves=False,
                       eps_trainable=True, num_filters=4),
    "conv_split_no_remat": dict(network_arch="conv", merge_v_halves=False,
                                eps_trainable=True, num_filters=4,
                                remat=False),
    "local_r1": dict(network_arch="local", group="r1", num_filters=4,
                     train_hops=True),
    "improved_split": dict(action="improved", merge_v_halves=False,
                           remat=False),
    "both_directions": dict(both_directions=True, merge_v_halves=False,
                            eps_trainable=True),
}


# the cases of the image nets, r1, the improved action and both directions:
# their first step's params are compared at 5e-3 lr where Adam's update is
# ~lr*sign(g) (clipped |g| >= 1e-6), at lr elsewhere
SMALL_G_CASES = {"conv_split", "conv_split_no_remat", "local_r1",
                 "improved_split", "both_directions"}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_torch_train_steps_match_jax(case):
    """1 step (3 where the case crosses a boundary) from the same state and
    draws: loss, metrics, grad summaries, updated params and chain state."""
    kw = dict(STEP_CASES[case])
    remat = kw.pop("remat", True)
    kw = _kw(**kw)
    n_steps = 3 if case in ("eps_fixed_hops", "eps_warmup") else 1
    jcfg, js, tcfg, ts = _states(kw)
    jstep = jax.jit(jgauge.make_train_step(jcfg))
    _, tstep_with = tgauge.make_train_step(tcfg, remat=remat)
    for i in range(n_steps):
        key = jax.random.fold_in(jax.random.PRNGKey(5), i)
        before = {k: v.detach().clone()
                  for k, v in tgauge.named_leaves(ts.params).items()}
        js, jm = jstep(js, key)
        ts, tm = tstep_with(ts, _jax_draws(key, B, tcfg.x_dim,
                                           tcfg.train_hops))
        assert set(tm) == set(jm)
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-4)
        # during the eps warmup, dual averaging drives eps from the mean
        # acceptance, amplified ~20x (sqrt(t) / gamma): rtol 1e-3 there
        eps_rtol = 1e-3 if tcfg.eps_warmup_steps else 1e-6
        for k, rtol in (("beta", 1e-6), ("lr", 1e-6), ("eps", eps_rtol)):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=rtol), k
        for k in ("accept_prob", "dq", "actions", "plaqs", "charges2"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), abs=2e-4), k
        for k in (k for k in jm if "/" in k):
            assert float(tm[k]) == pytest.approx(
                float(jm[k]), rel=1e-3, abs=1e-6), k
        lr = float(jm["lr"])
        jl = _jax_leaves(js.params)
        jmu = _jax_leaves(_find_adam(js.opt_state).mu)
        for name, v in tgauge.named_leaves(ts.params).items():
            jl[name] = _port_layout(ts.params, name, jl[name])
            if name == "raw_eps":
                np.testing.assert_allclose(v.detach().numpy(), jl[name],
                                           rtol=eps_rtol, atol=5e-3 * lr)
                continue
            got, want = v.detach().numpy(), jl[name]
            if case in SMALL_G_CASES and i == 0 and name in jmu:
                # Adam's first update is ~lr*sign(g) only where the clipped
                # gradient |g| = |mu| / (1 - b1) is far above Adam's eps
                # (1e-8); below 1e-6 it follows the rounding of g itself
                g = np.abs(_port_layout(ts.params, name, jmu[name])) / 0.1
                small = g < 1e-6
                np.testing.assert_allclose(got[small], want[small],
                                           atol=lr + 1e-7, err_msg=name)
                got, want = got[~small], want[~small]
            np.testing.assert_allclose(got, want, atol=5e-3 * lr + 1e-7,
                                       err_msg=name)
            if lr == 0.0 or name == "masks" or (
                    name == "raw_eps" and not tcfg.eps_trainable):
                if not (case == "eps_warmup" and name == "raw_eps"):
                    assert torch.equal(v.detach(), before[name]), name
        np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), atol=2e-4)
        assert ts.step == int(js.step) == i + 1
        for a, b in zip(ts.da, js.da):
            assert float(a) == pytest.approx(float(b), rel=eps_rtol,
                                             abs=1e-6)
