"""PyTorch port, analysis/: the statistics and the offline re-analysis
against the JAX package's (both numpy; rtol 1e-12), on numpy-seeded
chains: an AR(1) trace with tau_int ~ 10, integer charge traces, and a
synthetic run dir.
"""

import json

import numpy as np
import pytest

from l2hmc_tpu.analysis import observables as jobs
from l2hmc_tpu.analysis import stats as jstats
from l2hmc_tpu_torch.analysis import observables as tobs
from l2hmc_tpu_torch.analysis import stats as tstats

RTOL = 1e-12


def _ar1(seed, t=2000, c=6, rho=0.8):
    rng = np.random.default_rng(seed)
    x = np.zeros((t, c))
    for i in range(1, t):
        x[i] = rho * x[i - 1] + rng.standard_normal(c)
    return x


def _charges(seed, t=300, c=5):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.choice([-1, 0, 0, 0, 1], (t, c)), axis=0).astype(
        np.float32)


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, (bool, np.bool_, str)) or a is None:
        assert a == b
    else:
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64), rtol=RTOL,
                                   atol=0)


CALLS = {
    "autocorr_fft": lambda s, x: s.autocorr_fft(x[:, 0]),
    "autocovariance": lambda s, x: [s.autocovariance(x[:, :, None], tau)
                                    for tau in (0, 1, 7)],
    "calc_ess": lambda s, x: [s.calc_ess(x[:, i]) for i in range(3)],
    "integrated_time": lambda s, x: s.integrated_time(x[:, 1]),
    "batch_means_ess": lambda s, x: [s.batch_means_ess(x[:, 2], nb)
                                     for nb in (10, 20)],
    "jackknife": lambda s, x: [s.jackknife(x[:, 3], nb) for nb in (5, 10)],
    "sem": lambda s, x: s.sem(x),
    "pooled_autocorr": lambda s, x: s.pooled_autocorr(x),
    "pooled_integrated_time": lambda s, x: s.pooled_integrated_time(x),
    "pooled_ess": lambda s, x: s.pooled_ess(x),
    "step_distances": lambda s, x: s.step_distances(x[:100, :4]),
    "nearest_mode": lambda s, x: s.nearest_mode(x[:200, :2],
                                                np.array([[0., 0.],
                                                          [2., -1.]])),
    "tunneling_rate": lambda s, x: s.tunneling_rate(x[:200, :2],
                                                    np.array([[0., 0.],
                                                              [2., -1.]])),
    "tunneling_events": lambda s, x: s.tunneling_events(_charges(1)),
    "charge_histogram": lambda s, x: s.charge_histogram(_charges(2)),
    "therm_cut": lambda s, x: [s.therm_cut(x, f) for f in (0.25, 0.1)],
    "observables_stats": lambda s, x: s.observables_stats(
        {"plaqs": x[:, 0], "charges": _charges(3)[:, 0]}),
}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_torch_stats_match_jax(name):
    x = _ar1(7)
    _same(CALLS[name](tstats, x), CALLS[name](jstats, x))


def test_torch_stats_edge_cases_match_jax():
    const = np.ones(50)
    for s in (tstats, jstats):
        assert s.calc_ess(const) == 1.0 or np.isnan(s.calc_ess(const))
    _same(tstats.autocorr_fft(const), jstats.autocorr_fft(const))
    _same(tstats.sem(np.ones(1)), jstats.sem(np.ones(1)))
    _same(tstats.batch_means_ess(np.arange(10.0)),
          jstats.batch_means_ess(np.arange(10.0)))
    _same(tstats.tunneling_rate(np.zeros((1, 2)), np.zeros((1, 2))),
          jstats.tunneling_rate(np.zeros((1, 2)), np.zeros((1, 2))))


def _run_dir(path):
    rng = np.random.default_rng(11)
    path.mkdir()
    with open(path / "metrics.jsonl", "w") as f:
        for step in (50, 100, 150):
            f.write(json.dumps({"step": step, "loss": float(rng.normal()),
                                "plaqs": float(rng.uniform())}) + "\n")
    t, c = 400, 6
    for beta in (4, 3):
        np.savez_compressed(
            path / f"eval_beta{beta}.npz",
            plaqs=(0.8 + 0.01 * _ar1(beta, t, c)).astype(np.float32),
            charges=_charges(beta, t, c),
            accept_prob=rng.uniform(size=(t, c)).astype(np.float32))
    return path


def test_torch_observables_match_jax(tmp_path):
    a = tobs.analyze_run(_run_dir(tmp_path / "a"))
    b = jobs.analyze_run(_run_dir(tmp_path / "b"))
    a.pop("run_dir"), b.pop("run_dir")
    _same(a, b)
    assert json.loads((tmp_path / "a" / "analysis.json").read_text()).keys() \
        == json.loads((tmp_path / "b" / "analysis.json").read_text()).keys()
    traces = {"plaqs": _ar1(5, 300, 4), "charges": _charges(5, 300, 4)}
    _same(tobs.analyze_observable_traces(traces, 0.2, 5),
          jobs.analyze_observable_traces(traces, 0.2, 5))
    _same(tobs.thermalization_step(_ar1(6, 500, 3)),
          jobs.thermalization_step(_ar1(6, 500, 3)))
    la, lb = tobs.load_run(tmp_path / "a"), jobs.load_run(tmp_path / "b")
    _same(la, lb)
