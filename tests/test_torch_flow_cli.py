"""PyTorch port, the flow CLI (``python -m l2hmc_tpu_torch.cli.train_flow``)
and the flow-hybrid benchmark against the JAX package's ``cli/train_flow.py``
and ``benchmarks/flow_hybrid.py``.

The JAX scripts' flags and output keys are read from their sources (the
parser, the summary dict, the result dict), so the port is held to what
the reference writes; the runs are tiny CPU runs (4x4, 4-8 layers).
``--resume`` must continue bit for bit: a run of 4 steps resumed for 2
more ends where a run of 6 steps does (same parameters, metrics and
summary).  SIGTERM checkpoints the last whole chunk and exits 1.
"""

import ast
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import torch

from l2hmc_tpu_torch.benchmarks import flow_hybrid
from l2hmc_tpu_torch.cli import train_flow
from l2hmc_tpu_torch.dynamics import flow as TF
from l2hmc_tpu_torch.train import checkpoint as tckpt

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
TINY = ["--device", "cpu", "--size", "4", "--num_layers", "8", "--n_mix",
        "2", "--hidden_channels", "4", "--batch", "32", "--logging_steps",
        "2", "--warmup_steps", "2", "--eval_batch", "64", "--mh_steps", "8",
        "--seed", "5"]


def _literal_dict_keys(path: Path, target: str):
    """String keys of the dict literal assigned to ``target`` in
    ``path``."""
    for node in ast.walk(ast.parse(path.read_text())):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == target
                        for t in node.targets)):
            return [k.value for k in node.value.keys]
    raise AssertionError(f"no dict {target} in {path}")


def _jax_flags():
    sys.path.insert(0, str(REPO))
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "jax_train_flow", REPO / "cli" / "train_flow.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.build_parser()


def _dests(parser):
    return {a.dest: a.default for a in parser._actions if a.dest != "help"}


def test_torch_flow_cli_flags_match_jax():
    """The JAX CLI's flags and defaults, plus ``--device``; the canonical
    argfiles parse to the same values."""
    jp, tp = _jax_flags(), train_flow.build_parser()
    want, got = _dests(jp), _dests(tp)
    assert set(got) == set(want) | {"device"}
    assert {k: got[k] for k in want} == want
    for cfg in ("flow_8x8.txt", "flow_16x16.txt"):
        argv = [f"@{REPO / 'configs' / cfg}"]
        a, b = vars(jp.parse_args(argv)), vars(tp.parse_args(argv))
        assert {k: b[k] for k in a} == a


def _run(tmp_path, extra, log_dir="runs"):
    assert train_flow.main(TINY + ["--log_dir", str(tmp_path / log_dir)]
                           + extra) == 0


def _records(run_dir):
    return [json.loads(line) for line in
            (run_dir / "metrics.jsonl").read_text().splitlines()]


def test_torch_flow_cli_writes_the_jax_run_dir(tmp_path):
    """A tiny run with the fKL phase: params.json, metrics.jsonl,
    checkpoints (with config.json) and opt_state at the last step, and a
    summary.json with exactly the JAX CLI's keys."""
    _run(tmp_path, ["--train_steps", "4", "--fkl_steps", "2",
                    "--fkl_buffer", "16", "--fkl_batch", "4"])
    run = tmp_path / "runs" / "run_1"
    assert sorted(p.name for p in run.iterdir()) == [
        "checkpoints", "metrics.jsonl", "opt_state", "params.json",
        "summary.json"]
    summary = json.loads((run / "summary.json").read_text())
    assert list(summary) == _literal_dict_keys(REPO / "cli" / "train_flow.py",
                                               "summary")
    assert summary["lattice"] == "4x4" and summary["mh_accept"] is not None
    recs = _records(run)
    assert [r["step"] for r in recs] == [2, 4, 6]
    assert set(recs[0]) == {"step", "dt", "beta", "loss", "ess_frac",
                            "plaq"}
    assert set(recs[-1]) == set(recs[0]) | {"fkl"}
    assert tckpt.latest_step(run / "checkpoints") == 6
    assert tckpt.latest_step(run / "opt_state") == 6
    cfg = TF.FlowConfig(**tckpt.load_config_dict(run / "checkpoints"))
    assert cfg.num_layers == 8 and cfg.n_mix == 2
    params = json.loads((run / "params.json").read_text())
    assert params["fkl_steps"] == 2 and params["device"] == "cpu"


def test_torch_flow_cli_resume_continues_bit_for_bit(tmp_path):
    """4 steps, then ``--resume`` for 2 more, against 6 straight: the same
    parameters, optimizer state, metrics records and summary."""
    _run(tmp_path, ["--train_steps", "4"], "split")
    split = tmp_path / "split" / "run_1"
    assert train_flow.main(TINY + ["--resume", str(split),
                                   "--train_steps", "2"]) == 0
    _run(tmp_path, ["--train_steps", "6"], "whole")
    whole = tmp_path / "whole" / "run_1"
    a = tckpt.load_tensors(split / "checkpoints")
    b = tckpt.load_tensors(whole / "checkpoints")
    for k in b["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
    oa, ob = (tckpt.load_tensors(d / "opt_state") for d in (split, whole))
    assert oa["count"] == ob["count"] == 6
    for k in ob["mu"]:
        assert torch.equal(oa["mu"][k], ob["mu"][k])
        assert torch.equal(oa["nu"][k], ob["nu"][k])

    def strip(recs):
        return [{k: v for k, v in r.items() if k != "dt"} for r in recs]

    assert strip(_records(split)) == strip(_records(whole))
    assert (json.loads((split / "summary.json").read_text())
            == json.loads((whole / "summary.json").read_text()))


def test_torch_flow_cli_sigterm_saves_and_exits_1(tmp_path):
    """SIGTERM during training checkpoints the last whole chunk (params,
    optimizer state, generator) and exits 1; ``--resume`` picks it up."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    log_dir = tmp_path / "term"
    proc = subprocess.Popen(
        [sys.executable, "-m", "l2hmc_tpu_torch.cli.train_flow", *TINY,
         "--logging_steps", "1", "--train_steps", "100000", "--log_dir",
         str(log_dir)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    metrics = log_dir / "run_1" / "metrics.jsonl"
    deadline = time.time() + 120
    # a chunk's record is written before its snapshot is taken: with 3
    # records out, the snapshot of step 2 exists
    while time.time() < deadline and (
            not metrics.exists() or len(metrics.read_text().splitlines()) < 3):
        time.sleep(0.2)
    proc.send_signal(signal.SIGTERM)
    out, err = proc.communicate(timeout=120)
    assert proc.returncode == 1, err[-2000:]
    assert "interrupted at step" in out
    run = log_dir / "run_1"
    step = tckpt.latest_step(run / "checkpoints")
    assert step is not None and step >= 2
    assert tckpt.latest_step(run / "opt_state") == step
    saved = tckpt.load_tensors(run / "checkpoints")
    assert set(saved) == {"params", "generator"}
    assert train_flow.main(TINY + ["--resume", str(run), "--train_steps",
                                   "2", "--mh_steps", "0"]) == 0
    assert tckpt.latest_step(run / "checkpoints") == step + 2


def test_torch_flow_hybrid_benchmark_prints_the_jax_keys(tmp_path, capsys):
    """The hybrid-vs-control benchmark on a port run dir: one JSON line with
    the JAX script's keys."""
    _run(tmp_path, ["--train_steps", "2", "--mh_steps", "0"])
    capsys.readouterr()
    assert flow_hybrid.main([
        "--checkpoint", str(tmp_path / "runs" / "run_1"), "--device", "cpu",
        "--beta", "2.0", "--chains", "4", "--rounds", "4",
        "--chunk_rounds", "2", "--hmc_per_round", "2", "--therm", "5"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line) == _literal_dict_keys(
        REPO / "benchmarks" / "flow_hybrid.py", "result")
    assert line["rounds"] == 4 and 0.0 <= line["flow_accept"] <= 1.0
