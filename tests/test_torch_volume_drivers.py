"""PyTorch port, the volume drivers (``l2hmc_tpu_torch/benchmarks/
local64_h2h.py``, ``local_cost_sweep.py``, ``volume_sweep.py``,
``scaling.py``) against the JAX scripts in ``benchmarks/``.

- ``volume_sweep`` and ``scaling`` print JSON whose keys equal the JAX
  scripts' at the same tiny flags (JAX's loaded by ``importlib``; its
  scaling run on conftest's 8 virtual CPU devices); the power-law fit
  equals JAX's on JAX's rows.
- ``local64_h2h``'s fused tier is JAX's Pallas stencil kernel outside
  interpret mode, and ``local_cost_sweep`` compiles nine samplers for ~40 s
  in JAX here, so their keys are held to the lists in their sources.
- ``scaling`` on two gloo ranks (``parallel/dryrun.spawn_local``): the two
  topology checks pass on the group, and a mis-wired reduction fails them.
- Plaquettes against I1/I0 within 0.05.
"""

import contextlib
import importlib.util
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from l2hmc_tpu_torch.benchmarks import local64_h2h as t_l64
from l2hmc_tpu_torch.benchmarks import local_cost_sweep as t_lcs
from l2hmc_tpu_torch.benchmarks import scaling as t_scaling
from l2hmc_tpu_torch.benchmarks import volume_sweep as t_vol
from l2hmc_tpu_torch.lattice import u1

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PLAQ_TOL = 0.05


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_bench_{name}", REPO / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json_lines(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert fn(argv) in (0, None)
    return [json.loads(line) for line in buf.getvalue().splitlines()
            if line.startswith("{")]


# benchmarks/local64_h2h.py's keys (:209-262)
L64_KEYS = {"benchmark", "config", "plaq_exact", "per_seed", "summary"}
L64_CONFIG_KEYS = {"size", "beta", "seeds", "trained", "hmc", "train_steps",
                   "eval_steps", "eval_chains"}
L64_SEED_KEYS = {"seed", "end_accept", "eps", "train_s", "trained_fused",
                 "hmc_fused"}
L64_SAMPLER_KEYS = {"plaq", "plaq_mean", "accept", "q_tau_pooled",
                    "q_tau_pooled_reliable", "q_ess_per_s_pooled",
                    "tunneling_per_s", "us_per_transition"}
L64_TIER_KEYS = {"ratio_plaq_ess_per_s", "ratio_ess_per_step",
                 "ratio_q_ess_per_s_pooled"}
STATS_KEYS = {"ess_ratio", "tau_int", "tau_reliable_frac",
              "eff_samples_per_s", "steps_per_s"}


@pytest.mark.parametrize("xla_tier", [True, False])
def test_torch_local64_h2h_json_keys_and_plaquette(xla_tier):
    """Two seeds of a local_flat c4L1 cell at 8x8, beta 2: the stencil
    chain and the HMC chain (their plain versions on CPU tensors) and, with
    the 'xla' tier, HMC on the eager harness."""
    argv = ("--size 8 --beta 2.0 --seeds 2 --train_steps 4 "
            "--train_chains 4 --eval_steps 40 --eval_chains 16 --chunk 20 "
            "--therm_sweeps 50 --trace_chains 16 --device cpu").split()
    (got,) = _json_lines(t_l64.main, argv + ([] if xla_tier
                                             else ["--no_xla_tier"]))
    tiers = {"vs_xla", "vs_fused"} if xla_tier else {"vs_fused"}
    samplers = {"trained_fused", "hmc_fused"} | (
        {"hmc_xla"} if xla_tier else set())
    assert set(got) == L64_KEYS
    assert set(got["config"]) == L64_CONFIG_KEYS
    assert got["config"]["trained"] == ("local_flat c4 L1 K=4 eps=0.10014 "
                                        "fixed merge_v charge_reward, fused "
                                        "kernel")
    assert set(got["summary"]) == tiers
    for tier in tiers:
        assert set(got["summary"][tier]) == L64_TIER_KEYS
    exact = u1.u1_plaq_exact(2.0)
    assert [r["seed"] for r in got["per_seed"]] == [5000, 5001]
    for rec in got["per_seed"]:
        assert set(rec) == L64_SEED_KEYS | samplers | tiers
        for s in samplers:
            assert set(rec[s]) == L64_SAMPLER_KEYS
            assert set(rec[s]["plaq"]) == STATS_KEYS
            assert abs(rec[s]["plaq_mean"] - exact) < PLAQ_TOL
            assert 0.0 < rec[s]["accept"] <= 1.0


# benchmarks/local_cost_sweep.py's variants (:69-97) and keys (:114-135)
LCS_TAGS = ["hmc_K8", "mlp_h64", "local_c8_L2_k3", "local_c8_L1_k3",
            "local_c4_L1_k3", "local_c8_L1_k5", "local_c16_L1_k3",
            "localflat_c8_L2", "localflat_c8_L1"]
LCS_KEYS = {"benchmark", "config", "variants", "note"}
LCS_CONFIG_KEYS = {"size", "chains", "K_trained", "K_hmc", "steps"}
LCS_ROW_KEYS = {"steps_per_s", "us_per_transition", "thr_vs_hmc"}


def test_torch_local_cost_sweep_json_keys_and_rates():
    (got,) = _json_lines(t_lcs.main, ("--size 8 --chains 4 --steps 3 "
                                      "--device cpu").split())
    assert set(got) == LCS_KEYS
    assert set(got["config"]) == LCS_CONFIG_KEYS
    assert list(got["variants"]) == LCS_TAGS
    for row in got["variants"].values():
        assert set(row) == LCS_ROW_KEYS
        assert all(np.isfinite(v) and v > 0 for v in row.values())
    assert got["variants"]["hmc_K8"]["thr_vs_hmc"] == 1.0
    src = (REPO / "benchmarks" / "local_cost_sweep.py").read_text()
    assert all(f'"{tag}"' in src for tag in LCS_TAGS)


def test_torch_volume_sweep_json_keys_and_fit_match_jax():
    argv = "--sizes 4 8 --num_chains 4 --chunk 3".split()
    (want,) = _json_lines(_jax_script("volume_sweep").main, argv)
    (got,) = _json_lines(t_vol.main, argv + ["--device", "cpu"])
    assert set(got) == set(want)
    assert [set(r) for r in got["rows"]] == [set(r) for r in want["rows"]]
    assert [(r["l"], r["x_dim"]) for r in got["rows"]] == [
        (r["l"], r["x_dim"]) for r in want["rows"]]
    assert got["platform"] == want["platform"] == "cpu"
    assert got["metric"] == want["metric"]
    b, a = t_vol.power_law_fit([r["x_dim"] for r in want["rows"]],
                               [r["ms_per_transition"] for r in want["rows"]])
    assert round(b, 3) == want["exponent_b"]
    assert round(a, 6) == pytest.approx(want["coeff_a_ms"], rel=1e-5)
    assert np.isfinite(got["exponent_b"]) and got["coeff_a_ms"] > 0


SCALING_ARGV = ("--time_size 4 --space_size 4 --chains_per_device 4 "
                "--chunk 3 --repeats 2").split()


def _scaling_ranks(extra):
    from l2hmc_tpu_torch.parallel.dryrun import spawn_local

    return spawn_local(t_scaling.rank_lines, 2,
                       args=(SCALING_ARGV + extra + ["--device", "cpu"],))


def test_torch_scaling_on_two_gloo_ranks_matches_jax_keys():
    """Two gloo ranks, sampling and training: rank 0 prints the topology
    line and the rate line (the other rank prints nothing), each with the
    keys of the JAX script's lines; the baseline line too."""
    want = _json_lines(_jax_script("scaling").main,
                       SCALING_ARGV + ["--baseline_rate", "100"])
    kinds = {}
    for line in want:
        kinds.setdefault(next(iter(line)), set(line))
    sample, train = (
        _scaling_ranks(["--baseline_rate", "100"]),
        _scaling_ranks(["--mode", "train", "--network_arch", "mlp"]))
    for lines, n in ((sample, 3), (train, 2)):
        assert lines[1] == []
        assert len(lines[0]) == n
        for line in lines[0]:
            assert set(line) == kinds[next(iter(line))]
        topo, rate = lines[0][:2]
        assert topo == {"psum_topology_ok": True, "devices_checked": 2,
                        "processes": 2}
        assert rate["devices"] == rate["processes"] == 2
        assert rate["chains"] == 8 and rate["transitions_per_s"] > 0
    base = sample[0][2]
    assert base["processes"] == 2 and base["baseline_rate"] == 100.0


class _Miswired:
    """A two-rank mesh whose all-reduce drops the other rank's share."""

    def __init__(self, coord):
        self.coords = {"data": coord}

    def size(self, axis):
        return 2

    def all_reduce(self, t, axis="data", op="sum"):
        return t


@pytest.mark.parametrize("coord", [0, 1])
def test_torch_scaling_topology_check_fails_on_a_miswired_group(coord):
    # rank 1's own index is the expected sum of two: its mean check fails
    with pytest.raises(AssertionError,
                       match="psum topology broken|mean reduction off"):
        t_scaling.verify_psum_topology(_Miswired(coord), "cpu")


def test_torch_scaling_alone_is_one_rank():
    lines = _json_lines(t_scaling.main, SCALING_ARGV + ["--device", "cpu"])
    assert lines[0]["devices_checked"] == 1
    assert lines[1]["devices"] == 1 and lines[1]["chains"] == 4


def test_torch_volume_drivers_default_to_the_card(monkeypatch):
    """Without ``--device`` the drivers resolve ``cuda:0`` and raise with no
    card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (t_l64.main, t_lcs.main, t_vol.main, t_scaling.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn([])
