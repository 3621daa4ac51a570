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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_analyze.main([str(full), "--plots"])


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
