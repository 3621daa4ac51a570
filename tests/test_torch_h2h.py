"""PyTorch port, the head-to-head scripts (``l2hmc_tpu_torch/benchmarks/
trained_vs_hmc.py``, ``h2h_seeds.py``, ``hmc_ess_sweep.py``) against the
JAX scripts in ``benchmarks/``.

- ``trace_stats`` and ``jackknife_mean_err`` equal JAX's exactly (numpy on
  both sides, the same estimators).
- The eager harness (``run_eval``), the fused tier (``run_eval_fused``, the
  chain wrappers' plain versions on CPU tensors) and ``interleaved_eval`` at
  4x4 with 8 chains: trace shapes, and the plaquette against I1(2)/I0(2)
  within 0.05 (the average plaquette of one 4x4 config has sd ~0.1; 8
  chains x 100 transitions at tau ~ 1-5 give a standard error under 0.01).
- Each script's ``main`` prints one JSON line whose keys (nested) equal the
  JAX script's at the same tiny flags; JAX skips the fused tier off its
  TPU, so the port's ``fused_tier`` keys are held to the keys the JAX
  script writes there (its source).
- ``--save_npz`` writes the champion format that JAX's loader reads:
  ``tree_flatten`` of JAX's params of that arch, leaf for leaf.
"""

import contextlib
import dataclasses
import importlib.util
import io
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from l2hmc_tpu.train import gauge as jgauge
from l2hmc_tpu_torch.benchmarks import h2h_seeds as t_seeds
from l2hmc_tpu_torch.benchmarks import hmc_ess_sweep as t_sweep
from l2hmc_tpu_torch.benchmarks import trained_vs_hmc as t_h2h
from l2hmc_tpu_torch.lattice import u1
from l2hmc_tpu_torch.train import checkpoint as tckpt
from l2hmc_tpu_torch.train.gauge import (GaugeConfig, config_from_dict,
                                         init_params, init_train_state)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
BETA = 2.0
PLAQ_TOL = 0.05
CFG = GaugeConfig(time_size=4, space_size=4, num_chains=8, num_steps=2,
                  network_arch="mlp", num_hidden=8, merge_v_halves=True,
                  eps_init=0.2, beta_final=BETA)


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_bench_{name}", REPO / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json_line(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert fn(argv) == 0
    return [json.loads(line) for line in buf.getvalue().splitlines()
            if line.startswith("{")]


def _keys(obj, prefix=""):
    """Every key path of a nested JSON object (list items by index)."""
    out = set()
    items = (obj.items() if isinstance(obj, dict)
             else enumerate(obj) if isinstance(obj, list) else ())
    for k, v in items:
        path = f"{prefix}/{k}"
        out.add(path)
        out |= _keys(v, path)
    return out


def _trace(seed, t=300, c=16):
    rng = np.random.default_rng(seed)
    ar = np.zeros((t, c))
    for i in range(1, t):
        ar[i] = 0.8 * ar[i - 1] + rng.standard_normal(c)
    return ar


@pytest.mark.parametrize("total", [None, 2048])
def test_torch_trace_stats_equals_jax(total):
    want = _jax_script("trained_vs_hmc").trace_stats(
        _trace(1), 1.7, total_chains=total)
    assert t_h2h.trace_stats(_trace(1), 1.7, total_chains=total) == want


def test_torch_jackknife_mean_err_equals_jax():
    j = _jax_script("h2h_seeds").jackknife_mean_err
    for vals in ([1.02, 0.98, 1.07, 1.01, 0.95], [0.5, 0.7]):
        assert t_seeds.jackknife_mean_err(vals) == j(vals)
    mean, err = t_seeds.jackknife_mean_err([1.3])
    assert mean == 1.3 and np.isnan(err)


def _start(seed):
    gen = torch.Generator().manual_seed(seed)
    params = init_params(CFG, gen, "cpu")
    x = u1.random_links(gen, CFG.num_chains, CFG.shape, device="cpu")
    return params, x, gen


def _plaq_ok(plaq):
    assert abs(float(plaq.mean()) - u1.u1_plaq_exact(BETA)) < PLAQ_TOL


def test_torch_run_eval_traces_and_plaquette():
    params, x, gen = _start(1)
    plaq, q, acc, wall, x_end = t_h2h.run_eval(CFG, params, x, BETA, gen,
                                               100, chunk_size=50)
    assert plaq.shape == q.shape == (100, CFG.num_chains)
    assert x_end.shape == x.shape and wall > 0 and 0 < acc <= 1
    assert np.all(q == np.round(q))
    _plaq_ok(plaq)
    # a chunk longer than the run is cut to it
    plaq, *_ = t_h2h.run_eval(CFG, params, x, BETA, gen, 30)
    assert plaq.shape == (30, CFG.num_chains)


@pytest.mark.parametrize("kind", ["l2hmc", "hmc"])
def test_torch_run_eval_fused_traces_and_plaquette(kind):
    params, x, gen = _start(2)
    kw = {} if kind == "l2hmc" else dict(eps=0.2, hmc_k=3)
    plaq, q, acc, wall, x_end = t_h2h.run_eval_fused(
        kind, CFG, params, x, BETA, gen, 100, chunk_size=50, **kw)
    assert plaq.shape == q.shape == (100, CFG.num_chains)
    assert x_end.shape == x.shape and wall > 0 and 0 < acc <= 1
    _plaq_ok(plaq)


def test_torch_run_eval_fused_refuses_other_families():
    params, x, gen = _start(3)
    conv = dataclasses.replace(CFG, network_arch="conv")
    with pytest.raises(ValueError, match="MLP"):
        t_h2h.run_eval_fused("l2hmc", conv, params, x, BETA, gen, 10)


def test_torch_interleaved_eval_traces_and_plaquette():
    params, x, _ = _start(4)
    hcfg = dataclasses.replace(CFG, hmc=True, network_arch="zero",
                               eps_init=0.2, eps_trainable=False,
                               num_steps=3, merge_v_halves=False)
    hparams = init_params(hcfg, torch.Generator().manual_seed(5), "cpu")
    out, wall = t_seeds.interleaved_eval(CFG, params, hcfg, hparams, x, x,
                                         BETA, 7, 100, chunk_size=50)
    for tag in ("t", "h"):
        assert set(out[tag]) == {"plaqs", "charges", "accept"}
        for v in out[tag].values():
            assert v.shape == (100, CFG.num_chains)
        assert wall[tag] > 0
        _plaq_ok(out[tag]["plaqs"])
    # one seed draws the same streams again; another seed others
    again, _ = t_seeds.interleaved_eval(CFG, params, hcfg, hparams, x, x,
                                        BETA, 7, 100, chunk_size=50)
    other, _ = t_seeds.interleaved_eval(CFG, params, hcfg, hparams, x, x,
                                        BETA, 8, 100, chunk_size=50)
    np.testing.assert_array_equal(again["t"]["plaqs"], out["t"]["plaqs"])
    assert not np.array_equal(other["h"]["plaqs"], out["h"]["plaqs"])


def test_torch_stream_generators_are_distinct():
    draws = {(seed, s): float(torch.rand(
                 (), generator=t_seeds.stream_generator(seed, s, "cpu")))
             for seed in (1000, 1001) for s in (1, 2, 9, 999901, 999902)}
    assert len(set(draws.values())) == len(draws)


TVH_TINY = ("--arch mlp --num_hidden 8 --num_steps 2 --merge_v --size 4 "
            "--num_chains 8 --train_steps 0 --eval_steps 20 --seed 3").split()
# the keys the JAX script writes under "fused_tier" (its TPU branch)
FUSED_KEYS = {"l2hmc", "hmc", "plaq_ess_per_s_ratio", "q_ess_per_s_ratio",
              "l2hmc_fused_vs_xla_speedup"}


@pytest.mark.parametrize("tier", ["xla", "both"])
def test_torch_trained_vs_hmc_json_keys_match_jax(tier):
    argv = TVH_TINY + ["--tier", tier]
    (want,) = _json_line(_jax_script("trained_vs_hmc").main, argv)
    (got,) = _json_line(t_h2h.main, argv + ["--device", "cpu"])
    assert "fused_tier" not in want      # JAX runs it on its TPU only
    fused = got.pop("fused_tier", None)
    assert _keys(got) == _keys(want)
    assert got["config"] == want["config"]
    if tier == "xla":
        assert fused is None
        return
    assert set(fused) == FUSED_KEYS
    for s in ("l2hmc", "hmc"):
        assert _keys(fused[s]) == _keys(want[s])
    assert fused["hmc"]["sampler"] == "hmc_fused_K5_eps0.08"
    # the fused tier's default chunks (600, 1500) set its trace lengths
    for s in ("l2hmc", "hmc"):
        assert abs(fused[s]["plaq_mean"] - got["plaq_exact"]) < 0.05


def test_torch_h2h_seeds_json_keys_match_jax():
    argv = ("--size 4 --seeds 2 --train_steps 4 --eval_steps 20 "
            "--eval_chains 8 --num_chains 8 --num_hidden 8").split()
    (want,) = _json_line(_jax_script("h2h_seeds").main, argv)
    (got,) = _json_line(t_seeds.main, argv + ["--device", "cpu"])
    assert _keys(got) == _keys(want)
    assert got["config"] == want["config"]
    assert [r["seed"] for r in got["per_seed"]] == [1000, 1001]


def test_torch_hmc_ess_sweep_json_keys_match_jax(monkeypatch):
    argv = "--size 4 --chains 8 --therm 4 --record 20".split()
    want = _json_line(_jax_script("hmc_ess_sweep").main, argv)
    got = _json_line(t_sweep.main, argv + ["--device", "cpu"])
    assert len(got) == len(want) == sum(map(len, t_sweep.GRID.values())) + 1
    for g, w in zip(got, want):
        assert set(g) - {"frozen"} == set(w) - {"frozen"}
        if "best" not in w:
            assert (g["num_leapfrog"], g["eps"]) == (w["num_leapfrog"],
                                                     w["eps"])
    # a cut grid (chip_smoke's) prints its points and the best
    monkeypatch.setattr(t_sweep, "GRID", {5: (0.08, 0.10)})
    got = _json_line(t_sweep.main, argv + ["--device", "cpu"])
    assert [(r["num_leapfrog"], r["eps"]) for r in got[:2]] == [
        (5, 0.08), (5, 0.10)]
    assert set(got[2]) == {"best"}


@pytest.mark.parametrize("arch", ["mlp", "conv"])
def test_torch_save_npz_read_by_jax_loader(tmp_path, arch):
    """``--save_npz`` after a (zero-step) training: JAX's loader logic
    (``benchmarks/trained_vs_hmc.py``: ``tree_flatten`` of its init params
    of the file's config, ``arr_i`` in order) finds every leaf in its
    shape and dtype; the leaves are the port's params in JAX's layouts
    (``params_from_leaves``, the tested JAX-to-port map, gives them back
    exactly); the port's ``--params_from`` reads the file."""
    path = tmp_path / "p.npz"
    argv = ["--arch", arch, "--num_hidden", "8", "--num_filters", "2",
            "--num_steps", "2", "--size", "4", "--num_chains", "8",
            "--train_steps", "0", "--eval_steps", "4", "--device", "cpu",
            "--save_npz", str(path)]
    _json_line(t_h2h.main, argv)
    z = np.load(path, allow_pickle=False)
    cfg_d = json.loads(str(z["config"]))
    jcfg = jgauge.GaugeConfig(**cfg_d)
    jstate = jgauge.init_train_state(jcfg, jax.random.PRNGKey(0))
    flat, treedef = jax.tree_util.tree_flatten(jstate.params)
    leaves = [np.asarray(z[f"arr_{i}"]) for i in range(len(flat))]
    assert f"arr_{len(flat)}" not in z.files
    for a, b in zip(leaves, flat):
        assert a.shape == b.shape and a.dtype == b.dtype
    jax.tree_util.tree_unflatten(treedef, leaves)
    # the port's params of the run (its init from --seed 42)
    tcfg = config_from_dict(cfg_d)
    state = init_train_state(tcfg, torch.Generator().manual_seed(42), "cpu")
    for a, b in zip(leaves, tckpt.leaves_from_params(state.params, tcfg)):
        np.testing.assert_array_equal(a, b)
    back = tckpt.params_from_leaves(leaves, tcfg, "cpu")
    for (k, a), b in zip(back.state_dict().items(),
                         state.params.state_dict().values()):
        assert torch.equal(a, b), k
    got = _json_line(t_h2h.main, argv[:-2] + ["--params_from", str(path)])
    assert got[0]["train_wall_s"] == 0.0


def test_torch_scripts_default_to_the_card(monkeypatch):
    """Without ``--device`` the scripts resolve ``cuda:0`` and raise with
    no card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (t_h2h.main, t_seeds.main, t_sweep.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn([])


@pytest.mark.parametrize("target", ["scg", "mog"])
def test_torch_chip_smoke_moment_gate(target):
    """chip_smoke.py phase 14's moment gate: exact draws of the target,
    laid out as (T, chains, d) with the mixture's modes held unevenly by
    the chains (as a cut training leaves them), pass within 5 standard
    errors; the same draws scaled by 1.2 fail."""
    import chip_smoke
    from l2hmc_tpu_torch import targets as T

    tgt = (T.scg_2d(device="cpu") if target == "scg"
           else T.gmm_axes(2, device="cpu"))
    gen = torch.Generator().manual_seed(3)
    xs = tgt.sample(gen, 200 * 400).reshape(400, 200, 2).numpy()
    if target == "mog":
        xs[..., 0] = np.abs(xs[..., 0])       # every chain in the + mode
        xs[:, :40, 0] *= -1                    # 40 of 200 in the - mode
    samples, mean, sd = chip_smoke.exact_moments(tgt, xs)
    err_mean, err_sd = chip_smoke.moment_errors(samples, mean, sd)
    assert np.all(err_mean <= chip_smoke.MOMENT_NSE)
    assert np.all(err_sd <= chip_smoke.MOMENT_NSE)
    wide = chip_smoke.exact_moments(tgt, 1.2 * xs)
    assert np.any(chip_smoke.moment_errors(*wide)[1] > chip_smoke.MOMENT_NSE)
