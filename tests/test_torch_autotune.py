"""PyTorch port, train/autotune.py against the JAX package's.

Exact parity (numpy or float32 on both sides, tolerance 1e-12 relative on
numpy statistics): ``_lag1_ess``, ``_probe_score`` on the same trace and
wall (both estimators), ``_tile_chains``, ``_hmc_cfg`` and the eps grid of
``tune_l2hmc`` (lambda*/K x mult).  The search on the CPU, where every probe
route runs its plain version: ``tune_hmc`` at 4x4 meets the assertions of
JAX's ``test_tune_hmc_small``; the probe routes (the fused chains' plain
versions, and ``make_eval_chunk``) sample the same plaquette and
acceptance within statistics.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from l2hmc_tpu.train import autotune as jtune
from l2hmc_tpu.train.gauge import GaugeConfig as JGaugeConfig
from l2hmc_tpu_torch.lattice import u1 as tu1
from l2hmc_tpu_torch.train import autotune as ttune
from l2hmc_tpu_torch.train import gauge as tgauge

torch.set_num_threads(1)

BASE = dict(time_size=4, space_size=4, num_chains=32, num_steps=3,
            network_arch="mlp", num_hidden=16, eps_init=0.2, beta_init=2.0,
            beta_final=2.0, train_steps=300)


def _ar_traces(rng, t=400, c=8, rho=0.9):
    ar = np.zeros((t, c))
    for i in range(1, t):
        ar[i] = rho * ar[i - 1] + rng.normal(size=c)
    return ar


def test_torch_lag1_ess_matches_jax_and_ranks_mixing():
    rng = np.random.default_rng(0)
    white = rng.normal(size=(400, 8))
    ar = _ar_traces(rng)
    for tr in (white, ar):
        assert ttune._lag1_ess(tr) == pytest.approx(jtune._lag1_ess(tr),
                                                    rel=1e-12)
    assert ttune._lag1_ess(white) > 5 * ttune._lag1_ess(ar)
    assert 0.8 < ttune._lag1_ess(white) <= 1.3


@pytest.mark.parametrize("estimator", ["sokal", "lag1"])
def test_torch_probe_score_matches_jax(estimator):
    trace = _ar_traces(np.random.default_rng(1), t=600, c=16, rho=0.7)
    want = jtune._probe_score(trace, 0.37, 512, estimator)
    assert ttune._probe_score(trace, 0.37, 512, estimator) == pytest.approx(
        want, rel=1e-12)


@pytest.mark.parametrize("n", [5, 8, 21])
def test_torch_tile_chains_matches_jax(n):
    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    np.testing.assert_array_equal(
        ttune._tile_chains(torch.tensor(x), n).numpy(),
        np.asarray(jtune._tile_chains(jnp.asarray(x), n)))


def test_torch_hmc_cfg_matches_jax():
    want = dataclasses.asdict(jtune._hmc_cfg(JGaugeConfig(**BASE), 4, 0.13))
    got = dataclasses.asdict(ttune._hmc_cfg(tgauge.GaugeConfig(**BASE), 4,
                                            0.13))
    assert got == want


def test_torch_probe_routes():
    cfg = tgauge.GaugeConfig(**BASE)
    assert ttune.probe_route(ttune._hmc_cfg(cfg, 4, 0.1)) == "hmc_chain"
    served = dataclasses.replace(cfg, merge_v_halves=True,
                                 eps_trainable=False)
    assert ttune.probe_route(served) == "l2hmc_chain"
    for other in (dataclasses.replace(served, network_arch="conv"),
                  dataclasses.replace(served, merge_v_halves=False),
                  dataclasses.replace(served, eps_trainable=True),
                  dataclasses.replace(served, network_arch="local")):
        assert ttune.probe_route(other) == "eval_chunk"


def _probe(cfg, params, x, route, g, steps=1200):
    run = ttune._make_probe_chunk(cfg, 200, route=route)
    trace, acc, wall, _ = ttune._timed_probe(cfg, params, x, 2.0, g, steps,
                                             run=run)
    assert trace.shape == (steps, 32) and wall > 0 and run.route == route
    return trace, acc


def _stderr(trace):
    """Standard error of the mean plaquette from the spread of per-chain
    means (each chain's own correlations are inside its mean)."""
    means = trace[trace.shape[0] // 4:].mean(axis=0)
    return means.std(ddof=1) / np.sqrt(means.size)


@pytest.mark.parametrize("family", ["hmc", "l2hmc"])
def test_torch_probe_routes_sample_alike(family):
    """The fused chain's route (its plain version on the CPU) and
    ``make_eval_chunk`` sample the same 4x4 plaquette and acceptance at
    beta=2, within 5 standard errors."""
    base = tgauge.GaugeConfig(**dict(BASE, num_steps=2))
    if family == "hmc":
        cfg, route = ttune._hmc_cfg(base, 4, 0.2), "hmc_chain"
    else:
        cfg = dataclasses.replace(base, merge_v_halves=True,
                                  eps_trainable=False, eps_init=0.25)
        route = "l2hmc_chain"
    g = torch.Generator().manual_seed(7)
    params = tgauge.init_params(cfg, g, "cpu")
    x = tu1.random_links(g, 32, cfg.shape, device="cpu")
    out = {r: _probe(cfg, params, x, r, g) for r in (route, "eval_chunk")}
    (t1, a1), (t2, a2) = out[route], out["eval_chunk"]
    se = np.hypot(_stderr(t1), _stderr(t2))
    d = t1[300:].mean() - t2[300:].mean()
    assert abs(d) < 5 * se, (d, se)
    assert abs(t1[300:].mean() - tu1.u1_plaq_exact(2.0)) < 0.03
    assert a1 == pytest.approx(a2, abs=0.05)


def test_torch_tune_hmc_small():
    """The assertions of JAX's test_tune_hmc_small, on the CPU."""
    cfg = tgauge.GaugeConfig(**BASE)
    g = torch.Generator().manual_seed(0)
    x = tu1.random_links(g, cfg.num_chains, cfg.shape, device="cpu")
    res = ttune.tune_hmc(cfg, x, beta=2.0, generator=g, k_grid=(2, 4),
                         da_steps=80, probe_steps=200, target_accept=0.75,
                         eps_grid=(0.9, 1.1), estimator="lag1")
    assert isinstance(res, ttune.TuneResult)
    assert res.num_steps in (2, 4) and res.eps > 0
    assert len(res.cells) == 4
    for c in res.cells:
        assert 0.3 < c["accept"] <= 1.0, c
        assert np.isfinite(c["score"]) and c["score"] >= 0
        assert c["route"] == "hmc_chain"
    by_k = {}
    for c in res.cells:
        by_k.setdefault(c["K"], []).append(c["eps"])
    for k, eps_list in by_k.items():
        lo, hi = sorted(eps_list)
        np.testing.assert_allclose(hi / lo, 1.1 / 0.9, rtol=1e-3)


def test_torch_tune_l2hmc_eps_grid_matches_jax(monkeypatch):
    """The cells' eps are JAX's ``mult * lambda*/K`` (rounded to 5
    decimals), the JAX test's values; probe trainings cut to chunks of 5
    steps (the search's own training code, shortened)."""
    make_chunk = tgauge.make_train_chunk
    monkeypatch.setattr(tgauge, "make_train_chunk",
                        lambda cfg, n, *a, **k: make_chunk(cfg, 5, *a, **k))
    cfg = tgauge.GaugeConfig(**dict(BASE, merge_v_halves=True, num_chains=8))
    hmc_opt = ttune.TuneResult(num_steps=4, eps=0.2, score=1.0, accept=0.8,
                               cells=())
    g = torch.Generator().manual_seed(1)
    res = ttune.tune_l2hmc(cfg, g, hmc_opt, k_grid=(2, 4),
                           probe_train_steps=250, probe_steps=200,
                           eps_grid=(1.0, 1.2), estimator="lag1",
                           device="cpu")
    lam = 4 * 0.2
    want = [round(m * lam / k, 5) for k in (2, 4) for m in (1.0, 1.2)]
    assert [c["eps"] for c in res.cells] == want
    assert want == [0.4, 0.48, 0.2, 0.24]
    assert res.num_steps in (2, 4)
    for c in res.cells:
        assert np.isfinite(c["score"]) and c["score"] >= 0
        assert c["route"] == "l2hmc_chain"
