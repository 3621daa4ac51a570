"""PyTorch port, the topological drivers (``l2hmc_tpu_torch/benchmarks/
topo_ensemble.py``, ``fused_hop.py``, ``charge_mixing.py``,
``pt_vs_hop.py``, ``freeze_line.py``, ``beta_campaign.py``) against the
JAX scripts in ``benchmarks/``.

- Each ``main`` prints JSON whose keys (nested) equal the JAX script's at
  the same tiny flags (4x4, a few chains), the JAX script loaded by
  ``importlib``.  ``fused_hop`` runs JAX's Pallas chains outside interpret
  mode, so its keys are held to the list in its source (:38-170), as the
  key lists of ``beta_campaign`` (:178-195; its h2h part is the port's
  ``h2h_seeds`` line, held to JAX's in ``tests/test_torch_h2h.py``), whose
  JAX tuners compile for minutes here.
- Plaquettes against I1/I0 within 0.05; the hop's tunneling per step above
  the plain chain's at 4x4 (the fused chains' plain versions on the CPU).
- The chains draw from other streams than JAX's, so they are held to the
  analytic oracles, not sample for sample.
"""

import contextlib
import importlib.util
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from l2hmc_tpu_torch.benchmarks import beta_campaign as t_beta
from l2hmc_tpu_torch.benchmarks import charge_mixing as t_cm
from l2hmc_tpu_torch.benchmarks import freeze_line as t_freeze
from l2hmc_tpu_torch.benchmarks import fused_hop as t_fhop
from l2hmc_tpu_torch.benchmarks import pt_vs_hop as t_pt
from l2hmc_tpu_torch.benchmarks import topo_ensemble as t_topo
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


TOPO_TINY = ("--size 4 --beta 3.0 --reps 2 --eval_steps 60 --chunk_size 20 "
             "--eval_chains 16 --therm_sweeps 50 --trace_chains 16").split()


def test_torch_topo_ensemble_json_keys_match_jax():
    (want,) = _json_lines(_jax_script("topo_ensemble").main, TOPO_TINY)
    (got,) = _json_lines(t_topo.main, TOPO_TINY + ["--device", "cpu"])
    assert _keys(got) == _keys(want)
    assert got["config"] == want["config"]
    assert got["plaq_exact"] == want["plaq_exact"]
    assert got["q2_exact"] == want["q2_exact"]
    exact = u1.u1_plaq_exact(3.0)
    for tag in ("hmc", "hmc+hop"):
        assert abs(got["summary"][tag]["plaq_mean"] - exact) < PLAQ_TOL
    for rep in got["per_rep"]:
        assert rep["hmc+hop"]["accept"] > 0.05
        assert 0.0 < rep["hmc+hop"]["hop_accept"] <= 1.0


def test_torch_topo_ensemble_champion_by_size():
    """The shipped champion is 16x16: loaded there, ``None`` elsewhere."""
    cfg, params = t_topo.load_champion(16, "cpu")
    assert (cfg.time_size, cfg.num_steps, cfg.hidden) == (16, 3, 64)
    assert params.xnet.in_w.device.type == "cpu"
    assert t_topo.load_champion(4, "cpu") is None


# the keys benchmarks/fused_hop.py writes (:95-106, :142-169)
FHOP_RES_KEYS = {"lf_steps_per_s", "us_per_transition", "tunneling_per_step",
                 "tunneling_per_s", "q_tau_pooled", "q_tau_reliable",
                 "q_ess_per_s_pooled", "plaq_mean", "q2_mean"}
FHOP_TOP_KEYS = {"benchmark", "config", "plaq_exact", "q2_exact",
                 "hop_cost_pct", "tunneling_ratio", "q_ess_ratio_pooled"}
FHOP_CHAMP_KEYS = {"champ_hop_tunneling_vs_hmc",
                   "champ_hop_q_ess_vs_hmc_pooled", "champ_hop_cost_pct"}
FHOP_CONFIG_KEYS = {"size", "beta", "chains", "hmc", "transitions"}


def _fhop_keys(tags, champion):
    return (FHOP_TOP_KEYS | {f"{k}_{t}" for k in FHOP_RES_KEYS for t in tags}
            | (FHOP_CHAMP_KEYS if champion else set()))


def test_torch_fused_hop_hop_tunnels_more_at_4x4():
    """HMC with and without the fused hop (the chain's plain version on
    CPU tensors) at 4x4, beta 4: the JSON keys of the JAX source, the
    plaquettes on I1/I0 and the hop's tunneling per step above the plain
    chain's.  No champion at 4x4: its tiers are skipped as in JAX."""
    (got,) = _json_lines(t_fhop.main, (
        "--size 4 --chains 64 --nt 100 --calls 2 --therm_sweeps 50 "
        "--champion --device cpu").split())
    assert set(got) == _fhop_keys(("plain", "hop"), False)
    assert set(got["config"]) == FHOP_CONFIG_KEYS
    assert got["config"]["transitions"] == 200
    for tag in ("plain", "hop"):
        assert abs(got[f"plaq_mean_{tag}"] - got["plaq_exact"]) < PLAQ_TOL
    assert got["tunneling_per_step_hop"] > got["tunneling_per_step_plain"]


def test_torch_fused_hop_champion_tiers():
    """The champion tiers at 16x16 on a few chains: the JAX source's
    chunking of nt into calls of at most 500 transitions and its keys."""
    assert t_fhop.champion_calls(1500, 4) == (500, 12)
    assert t_fhop.champion_calls(200, 2) == (200, 2)
    (got,) = _json_lines(t_fhop.main, (
        "--chains 8 --nt 20 --calls 2 --therm_sweeps 20 --champion "
        "--device cpu").split())
    assert set(got) == _fhop_keys(("plain", "hop", "champ", "champ_hop"),
                                  True)
    for tag in ("champ", "champ_hop"):
        assert np.isfinite(got[f"plaq_mean_{tag}"])
        assert got[f"lf_steps_per_s_{tag}"] > 0


def test_torch_charge_mixing_json_keys_match_jax():
    argv = ("--size 4 --train_steps 4 --eval_steps 20 "
            "--num_chains 8").split()
    (want,) = _json_lines(_jax_script("charge_mixing").main, argv)
    (got,) = _json_lines(t_cm.main, argv + ["--device", "cpu"])
    assert _keys(got) == _keys(want)
    assert got["config"] == want["config"]
    assert got["q2_exact"] == want["q2_exact"]
    assert got["hmc"]["sampler"] == want["hmc"]["sampler"] == "hmc_eps0.1"


def test_torch_charge_stats_equals_jax():
    rng = np.random.default_rng(5)
    q = np.cumsum(rng.integers(-1, 2, (300, 6)), axis=0).astype(float)
    want = _jax_script("charge_mixing").charge_stats(q, 2.5, "x")
    assert t_cm.charge_stats(q, 2.5, "x") == want


PT_TINY = ("--size 4 --reps 2 --eval_steps 60 --chunk_size 20 --chains 16 "
           "--pt_chains 8 --therm_sweeps 50 --trace_chains 8").split()


def test_torch_pt_vs_hop_json_keys_match_jax():
    (want,) = _json_lines(_jax_script("pt_vs_hop").main, PT_TINY)
    (got,) = _json_lines(t_pt.main, PT_TINY + ["--device", "cpu"])
    assert _keys(got) == _keys(want)
    assert got["config"] == want["config"]
    exact = u1.u1_plaq_exact(5.0)
    for tag in ("hmc", "hmc+hop", "pt"):
        for rep in got["per_rep"]:
            assert abs(rep[tag]["plaq_mean"] - exact) < PLAQ_TOL
    for rep in got["per_rep"]:
        assert all(0.0 < s < 1.0 for s in rep["pt"]["swap_rate_per_pair"])
        assert rep["pt"]["usable_chains"] == 8


def _with_chunk(main, chunk):
    """topo_ensemble's ``main`` with ``--chunk_size`` appended: freeze_line
    runs it at the default chunk of 1000 transitions."""
    def run(argv):
        return main(list(argv) + ["--chunk_size", str(chunk)])
    return run


FREEZE_TINY = ("--points 4:2.0 --reps 2 --eval_steps 40 --eval_chains 8 "
               "--trace_chains 8 --therm_sweeps 20 "
               "--hmc_cache 4:3:0.2").split()


def test_torch_freeze_line_json_keys_match_jax(tmp_path, monkeypatch):
    import benchmarks.topo_ensemble as j_topo

    jax_freeze = _jax_script("freeze_line")
    monkeypatch.setattr(j_topo, "main", _with_chunk(j_topo.main, 20))
    monkeypatch.setattr(t_topo, "main", _with_chunk(t_topo.main, 20))
    (jdir, tdir) = (tmp_path / "jax", tmp_path / "torch")
    jdir.mkdir()
    want = _json_lines(jax_freeze.main,
                       FREEZE_TINY + ["--out_dir", str(jdir)])
    got = _json_lines(t_freeze.main, FREEZE_TINY + [
        "--out_dir", str(tdir), "--device", "cpu"])
    assert len(got) == len(want) == 2         # the point's line, the line's
    for g, w in zip(got, want):
        assert _keys(g) == _keys(w)
    assert got[1]["rows"][0]["hmc"] == "K=3 eps=0.2"
    assert got[1]["protocol"] == want[1]["protocol"]
    assert {p.name for p in tdir.iterdir()} == {p.name for p in
                                                jdir.iterdir()} == {
        "freeze_4_2.json", "freeze_line.json"}


def test_torch_freeze_line_tunes_uncached_points(tmp_path, monkeypatch):
    """Without a cached optimum a point is tuned by ``tune_hmc`` (its grid
    cut here) and topo_ensemble runs at the winner."""
    from l2hmc_tpu_torch.train import autotune

    tune = autotune.tune_hmc
    monkeypatch.setattr(autotune, "tune_hmc", lambda *a, **k: tune(
        *a, **k, k_grid=(3,), da_steps=5, probe_steps=20, eps_grid=(1.0,)))
    monkeypatch.setattr(t_topo, "main", _with_chunk(t_topo.main, 20))
    argv = [a for a in FREEZE_TINY if not a.startswith("4:3")]
    argv.remove("--hmc_cache")
    got = _json_lines(t_freeze.main, argv + ["--out_dir", str(tmp_path),
                                             "--probe_chains", "8",
                                             "--device", "cpu"])
    row = got[-1]["rows"][0]
    assert row["hmc"].startswith("K=3 eps=")
    assert abs(json.loads((tmp_path / "freeze_4_2.json").read_text())[
        "summary"]["hmc"]["plaq_mean"] - u1.u1_plaq_exact(2.0)) < PLAQ_TOL


def test_torch_freeze_line_parsers_match_jax():
    src = (REPO / "benchmarks" / "freeze_line.py").read_text()
    assert 'split(":")' in src and 'split(";")' in src
    assert t_freeze.parse_points("8:2.5,16:5.0") == [(8, 2.5), (16, 5.0)]
    assert t_freeze.parse_cache("16:4:0.079;;8:3:0.1") == {
        16: (4, 0.079), 8: (3, 0.1)}


# the keys benchmarks/beta_campaign.py writes (:178-195); its tuners'
# trained cells (l2hmc_tpu/train/autotune.py:317-320)
BETA_KEYS = {"benchmark", "size", "beta", "arch", "train_hops",
             "retrain_acc", "lr_init", "hmc_opt", "trained_cell",
             "h2h_summary", "h2h_per_seed", "plaq_exact"}
BETA_CELL_KEYS = {"K", "eps", "accept", "accept_train_end", "score",
                  "seed_scores"}


def test_torch_beta_campaign_json_keys(tmp_path, monkeypatch):
    """The campaign at 4x4 with its tuners cut (one K, a few probe
    transitions, train chunks of 2 steps): the JAX source's keys, the
    h2h line written beside it, the trained cell from the tuned grid."""
    from l2hmc_tpu_torch.train import autotune, gauge

    tune_l2 = autotune.tune_l2hmc
    chunk = gauge.make_train_chunk

    def small_l2(*a, **k):
        k.update(probe_steps=20)
        monkeypatch.setattr(gauge, "make_train_chunk",
                            lambda cfg, n, *b, **kw: chunk(cfg, 2, *b, **kw))
        try:
            return tune_l2(*a, **k)
        finally:
            monkeypatch.setattr(gauge, "make_train_chunk", chunk)

    monkeypatch.setattr(autotune, "tune_l2hmc", small_l2)
    out = tmp_path / "b.json"
    argv = ("--size 4 --seeds 2 --train_steps 4 --eval_steps 20 "
            "--eval_chains 8 --num_chains 8 --num_hidden 8 "
            "--probe_train_steps 4 --probe_seeds 1 --probe_chains 8 "
            "--therm_sweeps 5 --l2hmc_k_grid 2 --hmc_k 3 --hmc_eps 0.2 "
            f"--out {out} --device cpu").split()
    lines = _json_lines(t_beta.main, argv)     # h2h_seeds' line, then its own
    assert len(lines) == 2
    got = lines[-1]
    assert set(got) == BETA_KEYS
    assert got["hmc_opt"] == {"K": 3, "eps": 0.2, "accept": 0.0}
    assert set(got["trained_cell"]) == {"K", "eps", "cells"}
    assert all(set(c) == BETA_CELL_KEYS for c in got["trained_cell"]["cells"])
    assert got["trained_cell"]["K"] == 2
    # eps = mult * lambda* / K over (0.8, 1, 1.2), and the refine pass's
    # (0.9, 1.1) x the winner's
    grid = {round(m * 3 * 0.2 / 2, 5) for m in (0.8, 1.0, 1.2)}
    refine = {round(m * e, 5) for e in grid for m in (0.9, 1.1)}
    cells = got["trained_cell"]["cells"]
    assert len(cells) == 4
    assert {c["eps"] for c in cells} <= grid | refine
    assert cells[0]["eps"] == got["trained_cell"]["eps"]
    h2h = json.loads((tmp_path / "b.json.h2h").read_text())
    assert h2h["benchmark"] == "h2h_seeds"
    assert got["h2h_summary"] == h2h["summary"]
    assert json.loads(out.read_text()) == got


def test_torch_beta_campaign_refuses_half_cached_optimum():
    with pytest.raises(SystemExit):
        t_beta.main(["--hmc_k", "4", "--device", "cpu"])


def test_torch_topo_drivers_default_to_the_card(monkeypatch):
    """Without ``--device`` the drivers resolve ``cuda:0`` and raise with no
    card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (t_topo.main, t_fhop.main, t_cm.main, t_pt.main,
               t_freeze.main, t_beta.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn([])
