"""PyTorch port, the ensemble samplers against JAX: the generic HMC chain,
multinomial HMC (``dynamics/nuts.py``), AIS, SMC and parallel tempering.

Exact parity: the JAX function draws from a key; the test re-creates those
draws exactly as the JAX code splits the key and injects them into the
port's function, on the same inputs (numpy, seeded).  Tolerances: 1e-5 on
states, weights and statistics of the Gaussian targets (float32 on both
sides, the same operations in the same order); on U(1) 4x4 the port's
Wilson potential (the kernels' plain version, with the analytic force)
stands against JAX's autograd of ``lattice/u1.py``: 1e-4 on states and
accept probabilities, as tests/test_torch_dynamics.py's 2e-4 at larger
sizes.  Oracles, as JAX's tests/test_samplers.py and test_tempering.py:
Gaussian moments and log Z, per-rung plaquettes, swap invariants.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from l2hmc_tpu.dynamics import ais as jais
from l2hmc_tpu.dynamics import hmc as jhmc
from l2hmc_tpu.dynamics import nuts as jnuts
from l2hmc_tpu.dynamics import smc as jsmc
from l2hmc_tpu.dynamics import tempering as jpt
from l2hmc_tpu.lattice import u1 as ju1
from l2hmc_tpu_torch.dynamics import ais as tais
from l2hmc_tpu_torch.dynamics import hmc as thmc
from l2hmc_tpu_torch.dynamics import nuts as tnuts
from l2hmc_tpu_torch.dynamics import smc as tsmc
from l2hmc_tpu_torch.dynamics import tempering as tpt
from l2hmc_tpu_torch.lattice import u1 as tu1
from l2hmc_tpu_torch.ops.wilson import make_potential_fn as t_wilson_pot

torch.set_num_threads(1)

EXACT = 1e-5
U1_ATOL = 1e-4
SHAPE4 = ju1.LatticeShape(4, 4)
TSHAPE4 = tu1.LatticeShape(4, 4)
SCALES = np.array([1.0, 4.0, 0.25], np.float32)


def _t(a):
    return torch.tensor(np.asarray(a))


def _np(t):
    return t.detach().cpu().numpy()


def _gauss_pots():
    js = jnp.asarray(SCALES)
    ts = torch.tensor(SCALES)
    return (lambda x: 0.5 * jnp.sum(js * x * x, axis=-1),
            lambda x: 0.5 * torch.sum(ts * x * x, dim=-1))


def _u1_x(seed, b):
    """Flat 4x4 links near equilibrium under a random gauge transform."""
    rng = np.random.default_rng(seed)
    a = rng.normal(0.0, 0.5, (b, 4, 4, 2))
    g = rng.uniform(-np.pi, np.pi, (b, 4, 4))
    a[..., 0] += g - np.roll(g, -1, axis=1)
    a[..., 1] += g - np.roll(g, -1, axis=2)
    a = a - 2 * np.pi * np.floor((a + np.pi) / (2 * np.pi))
    return a.reshape(b, -1).astype(np.float32)


def _hmc_draws(key, shape):
    """``(v, u)`` as JAX's hmc_transition draws them from ``key``."""
    kv, ka = jax.random.split(key)
    return (_t(jax.random.normal(kv, shape, jnp.float32)),
            _t(jax.random.uniform(ka, shape[:1])))


def _multinomial_draws(key, b, d, steps):
    kv, kf, ks = jax.random.split(key, 3)
    us = jnp.stack([jax.random.uniform(jax.random.fold_in(ks, t), (b,))
                    for t in range(steps)])
    return tnuts.MultinomialDraws(
        _t(jax.random.normal(kv, (b, d), jnp.float32)),
        _t(jax.random.randint(kf, (b,), 0, steps + 1)), _t(us))


# ---------------------------------------------------------------------------
# The generic HMC chain
# ---------------------------------------------------------------------------


def test_torch_hmc_chain_matches_jax():
    jpot, tpot = _gauss_pots()
    x0 = np.random.default_rng(0).normal(size=(16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    xs, probs = jhmc.hmc_chain(jpot, jnp.asarray(x0), 1.3, key, 0.3, 4, 5,
                               wrap_fn=jnp.tanh)
    draws = [_hmc_draws(k, x0.shape) for k in jax.random.split(key, 5)]
    txs, tprobs = thmc.hmc_chain(tpot, _t(x0), 1.3, None, 0.3, 4, 5,
                                 wrap_fn=torch.tanh, draws=draws)
    np.testing.assert_allclose(_np(txs), np.asarray(xs), atol=EXACT)
    np.testing.assert_allclose(_np(tprobs), np.asarray(probs), atol=EXACT)


# ---------------------------------------------------------------------------
# Multinomial HMC
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("target", ["gauss", "u1"])
def test_torch_multinomial_hmc_transitions_match_jax(target):
    """Three chained transitions: selected states, accept statistics and
    u-turn fractions."""
    if target == "gauss":
        jpot, tpot = _gauss_pots()
        x = np.random.default_rng(1).normal(size=(16, 3)).astype(np.float32)
        beta, eps, steps, atol = 1.0, 0.3, 8, EXACT
    else:
        jpot, tpot = ju1.make_potential_fn(SHAPE4), t_wilson_pot(TSHAPE4)
        x = _u1_x(2, 16)
        beta, eps, steps, atol = 2.0, 0.15, 6, U1_ATOL
    jx, tx = jnp.asarray(x), _t(x)
    for i in range(3):
        key = jax.random.fold_in(jax.random.PRNGKey(7), i)
        want = jnuts.multinomial_hmc_transition(jpot, jx, beta, key, eps,
                                                steps)
        got = tnuts.multinomial_hmc_transition(
            tpot, tx, beta, eps, steps,
            draws=_multinomial_draws(key, x.shape[0], x.shape[1], steps))
        np.testing.assert_allclose(_np(got.x_out), np.asarray(want.x_out),
                                   atol=atol)
        np.testing.assert_allclose(_np(got.accept_stat),
                                   np.asarray(want.accept_stat), atol=atol)
        assert float(got.uturn_frac) == float(want.uturn_frac)
        jx, tx = want.x_out, got.x_out


def test_torch_nuts_gaussian_moments():
    """The oracle of JAX's test_nuts_gaussian_moments: the multinomial
    chain with dual-averaging warmup recovers the marginal variances."""
    _, tpot = _gauss_pots()
    g = torch.Generator().manual_seed(0)
    x0 = torch.randn((64, 3), generator=g) / torch.sqrt(torch.tensor(SCALES))
    xs, acc, uturn = tnuts.nuts_chain(tpot, x0, 1.0, g, 300, eps0=0.3,
                                      max_steps=16, adapt_steps=100)
    est = _np(xs)[150:].reshape(-1, 3).var(axis=0)
    np.testing.assert_allclose(est, 1.0 / SCALES, rtol=0.15)
    assert float(acc[150:].mean()) > 0.4
    assert xs.shape == (300, 64, 3) and uturn.shape == (300,)


# ---------------------------------------------------------------------------
# AIS
# ---------------------------------------------------------------------------


def test_torch_ais_log_weights_match_jax():
    e0 = (lambda x: 0.5 * jnp.sum(x * x, axis=-1),
          lambda x: 0.5 * torch.sum(x * x, dim=-1))
    e1 = (lambda x: 0.5 * jnp.sum(x * x, axis=-1) / 4.0,
          lambda x: 0.5 * torch.sum(x * x, dim=-1) / 4.0)
    x0 = np.random.default_rng(4).normal(size=(32, 2)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    want = jais.ais_log_weights(key, jnp.asarray(x0), e0[0], e1[0],
                                num_betas=10, eps=0.3, num_leapfrog=5)
    draws = [_hmc_draws(k, x0.shape) for k in jax.random.split(key, 10)]
    got = tais.ais_log_weights(None, _t(x0), e0[1], e1[1], num_betas=10,
                               eps=0.3, num_leapfrog=5, draws=draws)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=EXACT)
    assert float(tais.log_mean_exp(got)) == pytest.approx(
        float(jais.log_mean_exp(want)), abs=EXACT)


def test_torch_ais_gaussian_logz():
    """JAX's test_ais_gaussian_logz: log Z1/Z0 = d log s."""
    d, s = 2, 2.0
    g = torch.Generator().manual_seed(1)
    logw = tais.ais_log_weights(
        g, torch.randn((512, d), generator=g),
        lambda x: 0.5 * torch.sum(x * x, dim=-1),
        lambda x: 0.5 * torch.sum(x * x, dim=-1) / (s * s),
        num_betas=200, eps=0.3, num_leapfrog=5)
    assert float(tais.log_mean_exp(logw)) == pytest.approx(d * np.log(s),
                                                           abs=0.1)


# ---------------------------------------------------------------------------
# SMC
# ---------------------------------------------------------------------------


def test_torch_ess_and_weighted_mean_match_jax():
    rng = np.random.default_rng(5)
    lw = (rng.normal(size=64) * 2).astype(np.float32)
    vals = rng.normal(size=64).astype(np.float32)
    assert float(tsmc.effective_sample_size(_t(lw))) == pytest.approx(
        float(jsmc.effective_sample_size(jnp.asarray(lw))), rel=EXACT)
    assert float(tsmc.weighted_mean(_t(lw), _t(vals))) == pytest.approx(
        float(jsmc.weighted_mean(jnp.asarray(lw), jnp.asarray(vals))),
        abs=EXACT)


def _jax_u0(key, n):
    return jax.random.uniform(key, (), minval=0.0, maxval=1.0 / n)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_torch_systematic_resample_matches_jax(seed):
    rng = np.random.default_rng(seed)
    lw = (rng.normal(size=32) * 2).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want = jsmc.systematic_resample(key, jnp.asarray(lw))
    got = tsmc.systematic_resample(None, _t(lw), _t(_jax_u0(key, 32)))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_torch_systematic_resample_clamps_the_rounding_edge():
    """float32 rounding leaves the last cumulative weight below the last
    systematic point: searchsorted gives n.  JAX's ``jnp.take`` turns that
    into a NaN particle; the port clamps the index to n - 1 (on the card an
    index n is a device-side assert)."""
    lw = np.array([2.351926326751709, 4.480293273925781, -3.7771966457366943,
                   4.541771411895752, 4.037626266479492], np.float32)
    n = lw.shape[0]
    u0 = np.nextafter(np.float32(1.0 / n), np.float32(0.0))
    cum = torch.cumsum(torch.softmax(_t(lw), 0), 0)
    assert float(cum[-1]) < float(torch.tensor(u0) + (n - 1) / n)
    j_cum = jnp.cumsum(jax.nn.softmax(jnp.asarray(lw)))
    j_idx = jnp.searchsorted(j_cum, jnp.float32(u0) + jnp.arange(n) / n)
    assert int(j_idx[-1]) == n
    x = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    assert np.isnan(np.asarray(jnp.take(jnp.asarray(x), j_idx, axis=0))[-1]
                    ).all()
    idx = tsmc.systematic_resample(None, _t(lw), torch.tensor(u0))
    np.testing.assert_array_equal(_np(idx)[:-1], np.asarray(j_idx)[:-1])
    assert int(idx[-1]) == n - 1
    assert torch.isfinite(_t(x).index_select(0, idx)).all()


def test_torch_systematic_resample_unbiased():
    lw = torch.log(torch.tensor([0.1, 0.2, 0.3, 0.4]))
    g = torch.Generator().manual_seed(0)
    counts = np.zeros(4)
    for _ in range(200):
        counts += np.bincount(_np(tsmc.systematic_resample(g, lw)),
                              minlength=4)
    np.testing.assert_allclose(counts / counts.sum(), [0.1, 0.2, 0.3, 0.4],
                               atol=0.02)


@pytest.mark.parametrize("threshold", [0.5, 2.0])
def test_torch_smc_rung_matches_jax(threshold):
    """One rung (beta 1.5 -> 2.0) on U(1) 4x4 with the HMC move: reweight,
    resample (always, at threshold 2.0) and two moves."""
    n, moves, lf = 16, 2, 3
    x0 = _u1_x(6, n)
    jpot, tpot = ju1.make_potential_fn(SHAPE4), t_wilson_pot(TSHAPE4)
    key = jax.random.PRNGKey(11)
    jmove = jsmc.make_u1_hmc_move(jpot, ju1.wrap, 16, lf, moves)
    want, want_ess = jsmc.smc_beta_ladder(
        key, jnp.asarray(x0), jpot, jnp.asarray([1.5, 2.0]), jmove,
        ess_threshold=threshold)
    (k,) = jax.random.split(key, 1)
    kr, km = jax.random.split(k)
    draws = [_hmc_draws(kk, x0.shape) for kk in jax.random.split(km, moves)]
    tmove = tsmc.make_u1_hmc_move(tpot, tu1.wrap, 16, lf, moves)
    got, got_ess = tsmc.smc_beta_ladder(
        None, _t(x0), tpot, [1.5, 2.0],
        lambda x, b, g: tmove(x, b, g, draws=draws),
        ess_threshold=threshold, u0s=[_t(_jax_u0(kr, n))])
    np.testing.assert_allclose(_np(got.x), np.asarray(want.x), atol=U1_ATOL)
    np.testing.assert_allclose(_np(got.log_w), np.asarray(want.log_w),
                               atol=U1_ATOL)
    assert float(got.log_z) == pytest.approx(float(want.log_z), abs=U1_ATOL)
    np.testing.assert_allclose(_np(got_ess), np.asarray(want_ess), rtol=1e-5)


def test_torch_smc_logz_gaussian():
    """JAX's test_smc_logz_gaussian: log Z(4)/Z(1) = -(d/2) log 4, and the
    particles have the beta=4 variance."""
    d = 2
    pot = lambda x: 0.5 * torch.sum(x * x, dim=-1)  # noqa: E731

    def move(x, b, g):
        for _ in range(4):
            x = thmc.hmc_transition(pot, x, b, 0.4 / np.sqrt(b), 5, g).x_out
        return x

    g = torch.Generator().manual_seed(2)
    x0 = torch.randn((1024, d), generator=g)
    final, ess = tsmc.smc_beta_ladder(g, x0, pot,
                                      np.linspace(1.0, 4.0, 31), move)
    assert float(final.log_z) == pytest.approx(-(d / 2) * np.log(4.0),
                                               abs=0.1)
    np.testing.assert_allclose(_np(final.x).var(axis=0), 0.25, rtol=0.2)
    assert ess.shape == (30,)


def test_torch_u1_smc_moves_and_log_z_anchor():
    """The fused move on a CPU tensor is the plain chain with the HMC
    move's step; the analytic anchor equals JAX's."""
    assert tsmc.u1_log_z_exact_factorized(256, 1.0, 4.0) == \
        jsmc.u1_log_z_exact_factorized(256, 1.0, 4.0)
    assert tsmc._eps(256, 2.5) == pytest.approx(
        float((64.0 / 256) ** 0.25 * 0.4 / jnp.sqrt(jnp.float32(2.5))),
        rel=1e-7)
    g = torch.Generator().manual_seed(3)
    x = _t(_u1_x(8, 4))
    out = tsmc.make_u1_fused_move(TSHAPE4, 3, 2)(x, 2.0, g)
    assert out.shape == x.shape and torch.isfinite(out).all()
    assert float(out.abs().max()) <= np.pi + 1e-6


# ---------------------------------------------------------------------------
# Parallel tempering
# ---------------------------------------------------------------------------


def test_torch_ptconfig_validation():
    with pytest.raises(ValueError):
        tpt.PTConfig(betas=(1.0, 2.0), eps=(0.1, 0.1))
    with pytest.raises(ValueError):
        tpt.PTConfig(betas=(2.0, 1.0), eps=(0.1,))
    assert tpt.PTConfig(betas=(2.0, 1.0), eps=(0.1, 0.2)).num_rungs == 2


@pytest.mark.parametrize("parity", [0, 1])
def test_torch_pt_transition_matches_jax(parity):
    """One round on U(1) 4x4, 3 rungs x 8 chains: the flat HMC transition
    with per-chain beta and eps, then the swap phase."""
    betas, eps = (2.0, 1.5, 1.0), (0.15, 0.17, 0.2)
    jcfg = jpt.PTConfig(betas=betas, eps=eps, num_steps=3)
    tcfg = tpt.PTConfig(betas=betas, eps=eps, num_steps=3)
    x = _u1_x(9, 24).reshape(3, 8, -1)
    key = jax.random.PRNGKey(13 + parity)
    want = jpt.pt_transition(ju1.make_potential_fn(SHAPE4), jnp.asarray(x),
                             jcfg, key, jnp.asarray(parity))
    k_hmc, k_swap = jax.random.split(key)
    v, u = _hmc_draws(k_hmc, (24, x.shape[-1]))
    got = tpt.pt_transition(t_wilson_pot(TSHAPE4), _t(x), tcfg, None, parity,
                            v=v, u=u,
                            u_swap=_t(jax.random.uniform(k_swap, (2, 8))))
    for name in ("x", "accept_prob", "swap_prob"):
        np.testing.assert_allclose(_np(getattr(got, name)),
                                   np.asarray(getattr(want, name)),
                                   atol=U1_ATOL, err_msg=name)
    np.testing.assert_array_equal(_np(got.swap_mask),
                                  np.asarray(want.swap_mask))
    assert float(got.swap_mask.sum()) > 0


def test_torch_pt_swap_preserves_config_multiset():
    cfg = tpt.PTConfig(betas=(2.0, 1.5, 1.0), eps=(0.1, 0.12, 0.15),
                       num_steps=3)
    pot = t_wilson_pot(TSHAPE4)
    g = torch.Generator().manual_seed(4)
    x = tu1.random_links(g, 24, TSHAPE4, device="cpu").reshape(3, 8, -1)
    out = tpt.pt_transition(pot, x, cfg, g, 0)
    x_unswapped = out.x.clone()
    for i in range(2):
        m = out.swap_mask[i].bool()
        a, b = x_unswapped[i].clone(), x_unswapped[i + 1].clone()
        x_unswapped[i][m], x_unswapped[i + 1][m] = b[m], a[m]
    u_after = np.sort(_np(pot(out.x.reshape(24, -1))))
    u_before = np.sort(_np(pot(x_unswapped.reshape(24, -1))))
    np.testing.assert_allclose(u_after, u_before, rtol=1e-6)
    assert float(out.swap_mask.sum()) > 0


def test_torch_pt_equal_betas_always_swap_and_off_parity_never():
    pot = t_wilson_pot(TSHAPE4)
    g = torch.Generator().manual_seed(5)
    cfg = tpt.PTConfig(betas=(2.0, 2.0), eps=(0.1, 0.1), num_steps=2)
    x = tu1.random_links(g, 32, TSHAPE4, device="cpu").reshape(2, 16, -1)
    out = tpt.pt_transition(pot, x, cfg, g, 0)
    assert float(out.swap_prob.min()) == 1.0
    assert float(out.swap_mask.mean()) == 1.0
    cfg = tpt.PTConfig(betas=(2.0, 1.5, 1.0), eps=(0.1, 0.1, 0.1),
                       num_steps=2)
    x = tu1.random_links(g, 24, TSHAPE4, device="cpu").reshape(3, 8, -1)
    out = tpt.pt_transition(pot, x, cfg, g, 1)
    assert float(out.swap_prob[0].max()) == 0.0
    assert float(out.swap_mask[0].max()) == 0.0


def test_torch_pt_rungs_on_their_oracles():
    """JAX's test_pt_rungs_stationary_on_oracles at 4x4: every rung holds
    its own plaquette under swaps, and swaps happen."""
    betas = (2.0, 1.5, 1.0)
    cfg = tpt.PTConfig(betas=betas, eps=(0.2, 0.22, 0.25), num_steps=5)
    pot = t_wilson_pot(TSHAPE4)
    g = torch.Generator().manual_seed(6)
    rungs = []
    for b, e in zip(betas, cfg.eps):
        x0 = tu1.random_links(g, 64, TSHAPE4, device="cpu")
        xs, _ = thmc.hmc_chain(pot, x0, b, g, e, 5, 200, wrap_fn=tu1.wrap)
        rungs.append(xs[-1])
    x = torch.stack(rungs)

    def obs(x0):
        return {"plaqs": tu1.observables(x0, TSHAPE4)["plaqs"]}

    chunk = tpt.make_pt_chunk(pot, cfg, 300, wrap_fn=tu1.wrap,
                              observables_fn=obs)
    x, m = chunk(x, g, 0)
    assert float(m["swap_rate"].mean()) > 0.05
    assert m["accept_prob"].shape == (300, 3)
    assert m["swap_rate"].shape == (300, 2) and m["plaqs"].shape == (300, 64)
    plaqs = []
    for r in range(2):
        x, m = chunk(x, g, 300 * (r + 1))
        plaqs.append(x)
        assert abs(float(m["plaqs"].mean())
                   - tu1.u1_plaq_exact(betas[0])) < 1e-2
    for i, b in enumerate(betas):
        p = float(torch.stack([tu1.observables(xx[i], TSHAPE4)["plaqs"]
                               for xx in plaqs]).mean())
        assert abs(p - tu1.u1_plaq_exact(b)) < 3e-2, (i, b, p)


@pytest.mark.parametrize("move", ["hmc", "fused"])
def test_torch_smc_u1_driver_prints_the_jax_keys(move, capsys):
    """``python -m l2hmc_tpu_torch.benchmarks.smc_u1`` prints one JSON line
    with the keys of the JAX package's ``benchmarks/smc_u1.py``, in order
    (a tiny ladder on the CPU; the fused move runs its plain version)."""
    import importlib.util
    import json
    from pathlib import Path

    from l2hmc_tpu_torch.benchmarks import smc_u1

    tiny = ["--size", "4", "--particles", "8", "--betas", "3",
            "--thermalize", "5", "--moves_per_rung", "1", "--leapfrog", "2"]
    spec = importlib.util.spec_from_file_location(
        "jax_smc_u1", Path(__file__).resolve().parents[1] / "benchmarks"
        / "smc_u1.py")
    jmod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jmod)
    assert jmod.main(tiny) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert smc_u1.main(tiny + ["--move", move, "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(got) == list(want)
    assert got["move"] == move and np.isfinite(got["log_z"])
