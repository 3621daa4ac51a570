"""PyTorch port, ``l2hmc_tpu_torch/cli/train_sampler.py`` and the examples
(``l2hmc_tpu_torch/examples``), against the JAX CLI ``cli/train_sampler.py``.

- The parser reads ``configs/scg_2d.txt`` and ``configs/mog_2d.txt`` (and
  the defaults) to the JAX parser's values; the port adds ``--device``.
- ``--target gmm_axes`` builds the pair of modes on the first axis, as the
  JAX CLI does (``gmm_single_axis``).
- A tiny CPU run of each config writes ``params.json``, ``metrics.jsonl``
  and ``summary.json`` with the keys of the JAX CLI's run at the same
  flags; SIGTERM checkpoints the state at the start of the interrupted
  chunk and exits non-zero.
- Each example's ``main`` at tiny flags (``--device cpu``) runs to its end
  and returns 0 or 1 (1: its physics check missed, as it may at these
  sizes; the card runs them at their defaults).
"""

import contextlib
import importlib
import importlib.util
import io
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from l2hmc_tpu_torch.cli import train_sampler as tcli
from l2hmc_tpu_torch.train import checkpoint as tckpt

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CONFIGS = {"scg": "@configs/scg_2d.txt", "mog": "@configs/mog_2d.txt"}
TINY = ["--num_samples", "8", "--num_steps", "2", "--train_steps", "20",
        "--logging_steps", "10", "--tunneling_rate_steps", "10",
        "--eval_steps", "20", "--seed", "5"]


def _jax_cli():
    sys.path.insert(0, str(REPO))
    spec = importlib.util.spec_from_file_location(
        "jax_train_sampler_cli", REPO / "cli" / "train_sampler.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("argv", [[], [CONFIGS["scg"]], [CONFIGS["mog"]],
                                  [CONFIGS["mog"], "--target", "funnel",
                                   "--dim", "5"]])
def test_torch_sampler_parser_matches_jax(argv, monkeypatch):
    monkeypatch.chdir(REPO)
    want = vars(_jax_cli().build_parser().parse_args(argv))
    got = vars(tcli.build_parser().parse_args(argv))
    assert got.pop("device") is None
    assert got == want


@pytest.mark.parametrize("target", ["gmm_axes", "gmm_single_axis",
                                    "gmm_one_per_axis", "gmm_diagonal",
                                    "gmm_ring", "scg", "tilted", "rough_well",
                                    "funnel"])
def test_torch_sampler_targets_match_jax(target):
    argv = ["--target", target, "--dim", "3"]
    jt, jmodes = _jax_cli().make_target(
        _jax_cli().build_parser().parse_args(argv))
    tt, tmodes = tcli.make_target(tcli.build_parser().parse_args(argv), "cpu")
    assert type(tt).__name__ == type(jt).__name__
    assert (tmodes is None) == (jmodes is None)
    if jmodes is not None:
        np.testing.assert_array_equal(tmodes, jmodes)
    if target == "gmm_axes":
        assert tmodes.tolist() == [[2.0, 0, 0], [-2.0, 0, 0]]


def _keys(obj, prefix=""):
    out = set()
    if isinstance(obj, dict):
        for k, v in obj.items():
            out.add(f"{prefix}/{k}")
            out |= _keys(v, f"{prefix}/{k}")
    return out


def _run_dir_keys(run_dir):
    records = [json.loads(line) for line in
               (run_dir / "metrics.jsonl").read_text().splitlines()]
    summary = json.loads((run_dir / "summary.json").read_text())
    params = json.loads((run_dir / "params.json").read_text())
    return [sorted(r) for r in records], _keys(summary), params, summary


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_torch_sampler_run_dir_has_the_jax_keys(config, tmp_path,
                                                monkeypatch):
    monkeypatch.chdir(REPO)
    argv = [CONFIGS[config]] + TINY
    with contextlib.redirect_stdout(io.StringIO()):
        assert _jax_cli().main(argv + ["--log_dir",
                                       str(tmp_path / "jax")]) == 0
        assert tcli.main(argv + ["--log_dir", str(tmp_path / "port"),
                                 "--device", "cpu"]) == 0
    want = _run_dir_keys(tmp_path / "jax" / "run_1")
    got = _run_dir_keys(tmp_path / "port" / "run_1")
    assert got[0] == want[0]                         # metrics.jsonl
    assert got[1] == want[1]                         # summary.json
    assert got[2].pop("device") == "cpu"
    assert {k: v for k, v in got[2].items() if k != "log_dir"} == {
        k: v for k, v in want[2].items() if k != "log_dir"}
    summary = got[3]
    assert 0 <= summary["l2hmc"]["accept"] <= 1
    assert len(summary["l2hmc"]["mean"]) == 2
    assert all(np.isfinite(summary["l2hmc"]["std"]))


def test_torch_sampler_sigterm_checkpoints(tmp_path):
    """SIGTERM during training checkpoints the state at the start of the
    interrupted chunk (params, Adam's state, chains, temperature,
    generator) and the process exits non-zero."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    log_dir = tmp_path / "term"
    proc = subprocess.Popen(
        [sys.executable, "-m", "l2hmc_tpu_torch.cli.train_sampler",
         CONFIGS["mog"], "--device", "cpu", "--num_samples", "8",
         "--num_steps", "2", "--logging_steps", "2",
         "--tunneling_rate_steps", "1000", "--train_steps", "100000",
         "--log_dir", str(log_dir)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    metrics = log_dir / "run_1" / "metrics.jsonl"
    deadline = time.time() + 120
    while time.time() < deadline and (
            not metrics.exists()
            or len(metrics.read_text().splitlines()) < 3):
        time.sleep(0.2)
    proc.send_signal(signal.SIGTERM)
    out, err = proc.communicate(timeout=120)
    assert proc.returncode != 0, err[-2000:]
    assert "interrupted at step" in out
    run = log_dir / "run_1"
    step = tckpt.latest_step(run / "checkpoints")
    assert step is not None and step >= 4 and step % 2 == 0
    saved = tckpt.load_tensors(run / "checkpoints")
    assert set(saved) == {"params", "opt_count", "mu", "nu", "x", "step",
                          "temp", "generator"}
    assert saved["step"] == step and saved["opt_count"] == step
    assert saved["x"].shape == (8, 2)
    records = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert step in [r["step"] for r in records]
    assert not (run / "summary.json").exists()


def test_torch_sampler_cli_defaults_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--log_dir", str(tmp_path)])


EXAMPLES = {
    "scg_experiment": ["--train_steps", "10", "--num_chains", "8",
                       "--eval_steps", "20"],
    "mog_tunneling": ["--train_steps", "20", "--eval_steps", "20"],
    "generic_hmc_demo": ["--num_chains", "8", "--num_samples", "20"],
    "u1_gauge_demo": ["--l", "4", "--train_steps", "4", "--eval_steps", "8",
                      "--num_chains", "8"],
    "flow_sampler_demo": ["--size", "4", "--train_steps", "2", "--batch",
                          "8"],
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_torch_example_main_runs(name, tmp_path, capsys):
    mod = importlib.import_module(f"l2hmc_tpu_torch.examples.{name}")
    argv = EXAMPLES[name] + ["--device", "cpu"]
    if name == "mog_tunneling":
        argv += ["--log_dir", str(tmp_path)]
    assert mod.main(argv) in (0, 1)
    out = capsys.readouterr().out
    last = out.strip().splitlines()[-1]
    assert ("MISMATCH" in out or "OK" in out or "gain" in out
            or "gmm_ring" in last), out[-500:]
    if name == "mog_tunneling":
        summary = json.loads((tmp_path / "run_1" / "summary.json")
                             .read_text())
        assert "tunneling_rate" in summary["hmc"]
