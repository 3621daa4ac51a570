"""PyTorch port, cli/: the training CLI against the JAX package's.

- ``flags_to_config``: the port's config equals the JAX CLI's, field by
  field, for the README's commands.
- A tiny end-to-end run on the CPU (4x4, conv nets, split integrator, two
  logging chunks, ``--restore``, ``--eval_hops 1``): its run-dir files have
  the keys of the JAX CLI's committed run dir ``runs/quickstart_b5/run_1``;
  ``cli/analyze_run.py`` (JAX) and the port's give equal ``analysis.json``
  on it; a restored run continues exactly (the same metrics record, bit
  for bit, as the run that was not interrupted); the CLI's training equals
  ``train_to_convergence`` with the same seed.
- A fresh interpreter runs the port's CLIs and loads neither jax nor the
  JAX package.
"""

import dataclasses
import importlib.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from l2hmc_tpu_torch.cli import analyze_run as t_analyze
from l2hmc_tpu_torch.cli import train_gauge as t_cli
from l2hmc_tpu_torch.train import gauge as tgauge

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]

# README.md "Quick start" and "The topological sampler"
README_COMMANDS = {
    "canonical8": "--space_size 8 --time_size 8 --num_samples 128 "
                  "--num_steps 3 --eps 0.35 --beta_init 2 --beta_final 4 "
                  "--train_steps 5000",
    "hmc": "--hmc --eps 0.2921 --space_size 16 --time_size 16",
    "topo": "--time_size 16 --space_size 16 --num_samples 128 --num_steps 4 "
            "--eps 0.079 --eps_fixed --network_arch mlp --num_hidden 64 "
            "--merge_v_halves --charge_reward --train_hops --beta_final 5.0 "
            "--train_steps 12000 --retrain_acc 0.7 --eval_hops 1 "
            "--run_steps 8000 --eval_init metropolis",
    "hmc_baseline": "--time_size 16 --space_size 16 --num_samples 128 "
                    "--num_steps 4 --eps 0.079 --eps_fixed --hmc "
                    "--beta_init 5.0 --beta_final 5.0 --train_steps 0 "
                    "--run_steps 8000 --eval_init metropolis",
    "auto_eps_local": "--network_arch local --eps auto --space_size 12 "
                      "--group r1 --action improved --bf16",
}

TINY = ["--device", "cpu", "--time_size", "4", "--space_size", "4",
        "--num_samples", "8", "--num_steps", "2", "--num_hidden", "16",
        "--num_filters", "4", "--logging_steps", "2", "--save_steps", "2",
        "--eval_hops", "1", "--seed", "3"]


def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_train_gauge_cli", REPO / "cli" / "train_gauge.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", sorted(README_COMMANDS))
def test_torch_flags_to_config_matches_jax(name):
    argv = README_COMMANDS[name].split()
    jcli = _jax_cli()
    want = dataclasses.asdict(jcli.flags_to_config(
        jcli.build_parser().parse_args(argv)))
    got = dataclasses.asdict(t_cli.flags_to_config(
        t_cli.build_parser().parse_args(argv)))
    assert list(got) == list(want)
    for k in want:
        assert got[k] == want[k], k
    # the parsers agree on every flag but the port's --device
    ja = vars(jcli.build_parser().parse_args(argv))
    ta = vars(t_cli.build_parser().parse_args(argv))
    assert ta.pop("device") is None
    assert ta == ja


def _keys(tree, prefix=""):
    out = set()
    for k, v in tree.items():
        if isinstance(v, dict) and k != "histogram":
            out |= _keys(v, f"{prefix}{k}.")
        else:
            out.add(prefix + k)
    return out


def _run(tmp, *extra):
    assert t_cli.main(TINY + ["--log_dir", str(tmp)] + list(extra)) == 0
    return max(Path(tmp).glob("run_*"), key=lambda p: int(p.name[4:]))


def _records(run_dir):
    return [json.loads(line) for line in
            (run_dir / "metrics.jsonl").read_text().splitlines()]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """One run of 6 steps; the same run interrupted after step 4 (a
    KeyboardInterrupt in its third chunk, which SIGTERM becomes), and its
    resumption with --restore."""
    root = tmp_path_factory.mktemp("cli")
    argv = ["--train_steps", "6", "--run_steps", "40"]
    full = _run(root / "full", *argv)
    make_chunk = tgauge.make_train_chunk

    def interrupted_chunk(*args, **kwargs):
        chunk, calls = make_chunk(*args, **kwargs), []

        def wrapped(state, gen):
            calls.append(1)
            if len(calls) == 3:
                raise KeyboardInterrupt
            return chunk(state, gen)
        return wrapped

    mp = pytest.MonkeyPatch()
    mp.setattr(tgauge, "make_train_chunk", interrupted_chunk)
    with pytest.raises(KeyboardInterrupt):
        _run(root / "cut", *argv)
    mp.undo()
    first = max((root / "cut").glob("run_*"))
    resumed = _run(root / "cut", *argv, "--restore")
    return full, first, resumed


def test_torch_cli_run_dir_has_the_jax_keys(cli_runs):
    full, _, resumed = cli_runs
    ref = REPO / "runs" / "quickstart_b5" / "run_1"
    for run_dir in (full, resumed):
        names = {p.name for p in run_dir.iterdir()}
        assert {"params.json", "metrics.jsonl", "checkpoints",
                "eval_beta4.json", "eval_beta3.json", "eval_beta4.npz",
                "eval_beta3.npz"} <= names
        ev = json.loads((run_dir / "eval_beta4.json").read_text())
        want = _keys(json.loads((ref / "eval_beta5.json").read_text()))
        assert _keys(ev) == want
        params = json.loads((run_dir / "params.json").read_text())
        ref_params = json.loads((ref / "params.json").read_text())
        assert set(params) | {"train_attempts"} == set(ref_params) | {
            "device"}
        cfg = json.loads((run_dir / "checkpoints" / "config.json")
                         .read_text())
        assert list(cfg) == list(json.loads(
            (ref / "checkpoints" / "config.json").read_text()))
        with np.load(run_dir / "eval_beta4.npz") as z:
            assert set(z.files) == {"accept_prob", "actions", "plaqs",
                                    "charges", "wloop22", "hop_accept",
                                    "hop_dq"}
            assert z["plaqs"].shape == (40, 8)
        rec = _records(run_dir)[-1]
        assert {"step", "dt", "loss", "accept_prob", "eps", "beta", "lr",
                "actions", "plaqs", "charges2", "dq", "plaq_exact"} == set(rec)
    assert [p.name for p in sorted((full / "checkpoints").iterdir())] == [
        "2", "4", "6", "config.json"]


def test_torch_cli_restore_continues_exactly(cli_runs):
    full, first, resumed = cli_runs
    want = {r["step"]: r for r in _records(full)}
    assert [r["step"] for r in _records(first)] == [2, 4]
    got = _records(resumed)
    assert [r["step"] for r in got] == [6]
    for k, v in got[0].items():
        if k != "dt":
            assert v == want[6][k], k
    for beta in (4, 3):
        with np.load(full / f"eval_beta{beta}.npz") as a, \
                np.load(resumed / f"eval_beta{beta}.npz") as b:
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_torch_cli_training_is_train_to_convergence(cli_runs):
    full, _, _ = cli_runs
    args = t_cli.build_parser().parse_args(TINY + ["--train_steps", "6"])
    cfg = t_cli.flags_to_config(args)
    state, m, _ = tgauge.train_to_convergence(cfg, args.seed, chunk_size=2,
                                              device="cpu")
    rec = _records(full)[-1]
    assert rec["loss"] == float(m["loss"][-1])
    assert rec["plaqs"] == float(m["plaqs"][-1])


def test_torch_analyze_run_matches_jax(cli_runs, tmp_path):
    """The JAX package's cli/analyze_run.py and the port's, on a port run
    dir, write the same analysis.json."""
    full, _, _ = cli_runs
    spec = importlib.util.spec_from_file_location(
        "jax_analyze_run_cli", REPO / "cli" / "analyze_run.py")
    jmod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jmod)
    assert jmod.main([str(full)]) == 0
    want = json.loads((full / "analysis.json").read_text())
    (full / "analysis.json").unlink()
    assert t_analyze.main([str(full)]) == 0
    got = json.loads((full / "analysis.json").read_text())
    assert got == want
    assert {"training", "eval_beta4", "eval_beta3"} <= set(got)
    # --plots: the plot families under plots/, JAX's file names, in a copy
    # of the run dir for each CLI
    for name, main in (("jax", jmod.main), ("torch", t_analyze.main)):
        shutil.copytree(full, tmp_path / name)
        assert main([str(tmp_path / name), "--plots", "--beta", "4"]) == 0
    names = {d: sorted(p.name for p in (tmp_path / d / "plots").iterdir())
             for d in ("jax", "torch")}
    assert names["torch"] == names["jax"]
    assert {"train_plaqs.png", "eval_beta4_charges.png",
            "eval_beta4_plaqs_autocorr.png"} <= set(names["torch"])


def test_torch_cli_imports_no_jax(tmp_path):
    """A fresh interpreter runs both of the port's CLIs on the CPU (local
    nets, r1, the improved action) and loads neither jax nor the JAX
    package."""
    code = f"""
import sys
before = {{m for m in sys.modules if m == "jax" or m.startswith("jax.")}}
import torch
torch.set_num_threads(1)
from l2hmc_tpu_torch import analysis
from l2hmc_tpu_torch.analysis import observables, stats
from l2hmc_tpu_torch.cli import analyze_run, train_gauge
from l2hmc_tpu_torch.train import autotune
from l2hmc_tpu_torch.utils import flags, io
assert train_gauge.main({TINY!r} + ["--network_arch", "local", "--group",
    "r1", "--action", "improved", "--train_steps", "2", "--run_steps", "4",
    "--log_dir", {str(tmp_path)!r}]) == 0
assert analyze_run.main([{str(tmp_path / "run_1")!r}]) == 0
jax_mods = {{m for m in sys.modules if m == "jax" or m.startswith("jax.")}}
assert jax_mods == before, sorted(jax_mods - before)[:5]
ref = [m for m in sys.modules if m == "l2hmc_tpu" or m.startswith("l2hmc_tpu.")]
assert not ref, ref
print("NOJAX_OK")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "NOJAX_OK" in proc.stdout
    assert (tmp_path / "run_1" / "analysis.json").exists()


# ---------------------------------------------------------------------------
# Resuming across retraining attempts
# ---------------------------------------------------------------------------

RETRAIN = ["--train_steps", "6", "--run_steps", "20", "--retrain_acc", "2.0",
           "--network_arch", "mlp"]


def _interrupt_step(monkeypatch, at_call):
    """Make the CLI's train step raise KeyboardInterrupt (what SIGTERM
    becomes) on its ``at_call``-th call, inside a chunk whose earlier steps
    already updated the params in place."""
    make_step = tgauge.make_train_step

    def patched(*args, **kwargs):
        step, step_with = make_step(*args, **kwargs)
        calls = []

        def wrapped(state, gen):
            calls.append(1)
            if len(calls) == at_call:
                raise KeyboardInterrupt
            return step(state, gen)
        return wrapped, step_with

    monkeypatch.setattr(tgauge, "make_train_step", patched)


@pytest.fixture(scope="module")
def retrain_runs(tmp_path_factory):
    """With --retrain_acc 2.0 every attempt fails: attempt 0 trains 6 steps,
    attempt 1 (a fresh seed) 6 more, then attempt 1 is evaluated.  The same
    run interrupted in the middle of attempt 1's second chunk (call 10 of
    the train step; call 9 has updated the params in place), then resumed
    with --restore."""
    root = tmp_path_factory.mktemp("retrain")
    argv = RETRAIN + ["--max_retrains", "1"]
    full = _run(root / "full", *argv)
    mp = pytest.MonkeyPatch()
    _interrupt_step(mp, 10)
    with pytest.raises(KeyboardInterrupt):
        _run(root / "cut", *argv)
    mp.undo()
    cut = max((root / "cut").glob("run_*"))
    ckpts = sorted(p.name for p in (cut / "checkpoints").iterdir())
    resumed = _run(root / "cut", *argv, "--restore")
    return full, cut, ckpts, resumed


def _assert_same_eval(a_dir, b_dir):
    for beta in (4, 3):
        with np.load(a_dir / f"eval_beta{beta}.npz") as a, \
                np.load(b_dir / f"eval_beta{beta}.npz") as b:
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_torch_cli_restore_continues_a_retraining_attempt(retrain_runs):
    """The resumed run re-enters attempt 1 at step 2 with its generator
    state and continues it bit for bit; the params it evaluates are
    attempt 1's, never the failed attempt 0's."""
    full, cut, _, resumed = retrain_runs
    recs = _records(full)
    assert [r["step"] for r in recs] == [2, 4, 6, 2, 4, 6]
    assert [r["step"] for r in _records(cut)] == [2, 4, 6, 2]
    got = _records(resumed)
    assert [r["step"] for r in got] == [4, 6]
    for r, want in zip(got, recs[-2:]):
        for k, v in r.items():
            if k != "dt":
                assert v == want[k], k
    _assert_same_eval(full, resumed)
    attempts = json.loads((full / "params.json").read_text())[
        "train_attempts"]
    assert [a["attempt"] for a in attempts] == [0, 1]
    assert json.loads((resumed / "params.json").read_text())[
        "train_attempts"] == attempts


def test_torch_checkpoints_prune_by_attempt_then_step(retrain_runs):
    """Keep-3 keeps the newest by (attempt, step): attempt 1's step-2
    checkpoint survives attempt 0's steps 4 and 6, and the checkpoint the
    interrupt wrote is attempt 1's last consistent state, step 2."""
    from l2hmc_tpu_torch.train import checkpoint as tckpt

    full, cut, ckpts, _ = retrain_runs
    assert ckpts == ["4", "6", "attempt1_2", "config.json"]
    assert tckpt.latest_checkpoint(cut / "checkpoints") == (1, 2)
    assert tckpt.latest_step(cut / "checkpoints") == 2
    attempt, done = tckpt.checkpoint_attempts(cut / "checkpoints")
    assert attempt == 1 and [a["attempt"] for a in done] == [0]
    assert sorted(p.name for p in (full / "checkpoints").iterdir()) == [
        "attempt1_2", "attempt1_4", "attempt1_6", "config.json"]


def test_torch_cli_restored_failed_attempt_retrains(tmp_path):
    """A finished attempt restored with an end acceptance below
    --retrain_acc is not evaluated: the resumed run goes on to attempt 1,
    as the run that retrained without stopping did."""
    full = _run(tmp_path / "full", *RETRAIN, "--max_retrains", "1")
    first = _run(tmp_path / "cut", *RETRAIN, "--max_retrains", "0")
    assert [a["attempt"] for a in json.loads(
        (first / "params.json").read_text())["train_attempts"]] == [0]
    resumed = _run(tmp_path / "cut", *RETRAIN, "--max_retrains", "1",
                   "--restore")
    got = _records(resumed)
    want = _records(full)[3:]
    assert [r["step"] for r in got] == [2, 4, 6]
    for r, w in zip(got, want):
        assert r["loss"] == w["loss"] and r["plaqs"] == w["plaqs"]
    _assert_same_eval(full, resumed)


def test_torch_cli_segment_prunes_to_the_newest_attempt(tmp_path):
    """benchmarks/cli_segment.sh's prune keeps the newest checkpoint by
    (attempt, step): attempt 1's step 150 over attempt 0's step 12000."""
    import re

    script = (REPO / "l2hmc_tpu_torch" / "benchmarks" / "cli_segment.sh"
              ).read_text()
    lines = [ln.strip() for ln in script.splitlines()
             if re.match(r"\s*(ckpts|last)=|\s*for d in \$ckpts", ln)]
    assert len(lines) == 3, lines
    out = tmp_path / "checkpoints"
    for d in ("11950", "12000", "attempt1_100", "attempt1_150",
              "config.json"):
        (out / d).mkdir(parents=True)
    subprocess.run(["bash", "-c", f"out={out}\n" + "\n".join(lines)],
                   check=True)
    assert sorted(p.name for p in out.iterdir()) == [
        "attempt1_150", "config.json"]


def test_torch_cli_autotune_runs(tmp_path, monkeypatch, capsys):
    """--autotune (it raised before the tuner was ported) runs the search
    before training, its grids cut to one cell each here, and trains the
    winner with its K and fixed eps."""
    from l2hmc_tpu_torch.train import autotune as ttune

    tune_hmc, tune_l2hmc = ttune.tune_hmc, ttune.tune_l2hmc
    make_chunk = tgauge.make_train_chunk
    small = dict(probe_steps=200, estimator="lag1")

    def small_hmc(*a, **kw):
        return tune_hmc(*a, **kw, k_grid=(3,), da_steps=5, eps_grid=(1.0,),
                        **small)

    def small_l2hmc(*a, **kw):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tgauge, "make_train_chunk",
                       lambda cfg, n, *b, **k: make_chunk(cfg, 5, *b, **k))
            return tune_l2hmc(*a, **kw, k_grid=(2,), eps_grid=(1.0,),
                              **small)

    monkeypatch.setattr(ttune, "tune_hmc", small_hmc)
    monkeypatch.setattr(ttune, "tune_l2hmc", small_l2hmc)
    run = _run(tmp_path, "--network_arch", "mlp", "--merge_v_halves",
               "--autotune", "--train_steps", "4", "--run_steps", "4")
    out = capsys.readouterr().out
    assert "autotune: HMC optimum K=3" in out
    assert "autotune: trained cell K=2" in out
    cfg = json.loads((run / "checkpoints" / "config.json").read_text())
    assert cfg["num_steps"] == 2 and cfg["eps_trainable"] is False
    assert cfg["eps_init"] > 0
    assert [r["step"] for r in _records(run)] == [2, 4]


def test_torch_cli_restore_extends_a_finished_attempt(tmp_path, capsys):
    """A finished attempt restored with a larger --train_steps trains on
    (the checkpoint's end-of-attempt record does not stop it), as the
    chip_smoke.py CLI phase resumes 200 steps to 300."""
    _run(tmp_path, "--train_steps", "4", "--run_steps", "0")
    capsys.readouterr()
    run = _run(tmp_path, "--train_steps", "6", "--run_steps", "0",
               "--restore")
    assert "restored step 4 of training attempt 0" in capsys.readouterr().out
    assert [r["step"] for r in _records(run)] == [6]
    attempts = json.loads((run / "params.json").read_text())[
        "train_attempts"]
    assert [a["attempt"] for a in attempts] == [0]
