"""PyTorch port, ``l2hmc_tpu_torch/cli/train_sun.py`` and
``l2hmc_tpu_torch/benchmarks/sun_nd_bench.py``, against the JAX CLI
``cli/train_sun.py`` and the JAX script ``benchmarks/sun_nd_bench.py``.

- The parser's values equal the JAX parser's; the port adds ``--device``.
- The ``--dims`` path's ``eval.json`` has the keys of the JAX CLI's at the
  same tiny flags.  The JAX CLI's 2-D path raises a ``TypeError`` (it
  passes ``learn_position=`` to a config without that field), so the 2-D
  ``eval.json`` keys are held against the summary its source writes.
- ``--learn_position`` and ``real_pairs=True`` raise.
- The benchmark's JSON keys equal the JAX script's at the same tiny flags.
- A fresh interpreter runs the CLI's three paths and the benchmark at tiny
  flags and imports neither jax nor the JAX package.
"""

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from l2hmc_tpu_torch.benchmarks import sun_nd_bench as tbench
from l2hmc_tpu_torch.cli import train_sun as tcli

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
DIMS = ["--dims", "2", "2", "2", "2", "--num_samples", "2", "--run_steps",
        "4", "--num_steps", "2", "--beta", "0.5", "--eps", "0.25"]
TWO_D = ["--time_size", "4", "--space_size", "4", "--num_samples", "4",
         "--num_steps", "2", "--num_hidden", "8", "--run_steps", "6"]
BENCH = ["--l", "2", "--batch", "2", "--chunk", "2", "--chunks", "2",
         "--num_steps", "2"]
# the summary cli/train_sun.py writes on its 2-D path (its lines 225-233)
TWO_D_KEYS = {"n", "beta", "plaq", "plaq_exact", "plaq_err", "accept_prob",
              "esjd_plaq_trace", "mode"}


def _load(name, path):
    sys.path.insert(0, str(REPO))
    spec = importlib.util.spec_from_file_location(name, REPO / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_cli():
    return _load("jax_train_sun_cli", "cli/train_sun.py")


@pytest.mark.parametrize("argv", [[], DIMS, TWO_D + ["--hmc"],
                                  ["--n", "3", "--beta", "4.0",
                                   "--learn_position"]])
def test_torch_sun_parser_matches_jax(argv):
    want = vars(_jax_cli().build_parser().parse_args(argv))
    got = vars(tcli.build_parser().parse_args(argv))
    assert got.pop("device") is None
    assert got == want


def test_torch_sun_dims_eval_keys_match_jax(tmp_path):
    with contextlib.redirect_stdout(io.StringIO()):
        assert _jax_cli().main(DIMS + ["--log_dir",
                                       str(tmp_path / "jax")]) == 0
        assert tcli.main(DIMS + ["--log_dir", str(tmp_path / "port"),
                                 "--device", "cpu"]) == 0
    want = json.loads((tmp_path / "jax" / "run_1" / "eval.json").read_text())
    got = json.loads((tmp_path / "port" / "run_1" / "eval.json").read_text())
    assert sorted(got) == sorted(want)
    assert got["mode"] == want["mode"] == "hmc_nd"
    assert got["dims"] == want["dims"] == [2, 2, 2, 2]
    assert got["plaq_strong_coupling_lo"] == want["plaq_strong_coupling_lo"]
    assert 0.0 <= got["accept_prob"] <= 1.0
    params = json.loads((tmp_path / "port" / "run_1" / "params.json")
                        .read_text())
    assert params.pop("device") == "cpu"


def test_torch_sun_jax_2d_path_raises(tmp_path):
    """The recorded fault of the JAX CLI: every 2-D run raises."""
    with contextlib.redirect_stdout(io.StringIO()):
        with pytest.raises(TypeError, match="learn_position"):
            _jax_cli().main(TWO_D + ["--hmc", "--log_dir", str(tmp_path)])


@pytest.mark.parametrize("mode", ["hmc", "l2hmc"])
def test_torch_sun_2d_eval_keys(mode, tmp_path):
    argv = TWO_D + (["--hmc"] if mode == "hmc" else
                    ["--train_steps", "3", "--warmup_steps", "1"])
    with contextlib.redirect_stdout(io.StringIO()):
        assert tcli.main(argv + ["--log_dir", str(tmp_path),
                                 "--device", "cpu"]) == 0
    run = tmp_path / "run_1"
    got = json.loads((run / "eval.json").read_text())
    assert set(got) == TWO_D_KEYS
    assert got["mode"] == mode
    assert 0.0 <= got["accept_prob"] <= 1.0
    assert got["plaq_err"] == pytest.approx(abs(got["plaq"]
                                                - got["plaq_exact"]))
    if mode == "l2hmc":
        recs = [json.loads(line) for line in
                (run / "metrics.jsonl").read_text().splitlines()]
        assert [r["step"] for r in recs] == [3]
        assert set(recs[0]) == {"loss", "accept_prob", "eps", "step",
                                "wall_s"}


def test_torch_sun_unported_options_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="no learned"):
        tcli.main(TWO_D + ["--learn_position", "--device", "cpu",
                           "--log_dir", str(tmp_path)])
    from l2hmc_tpu_torch.dynamics.sun_l2hmc import (SUNL2HMCConfig,
                                                    make_sun_dynamics)

    with pytest.raises(NotImplementedError, match="real_pairs"):
        make_sun_dynamics(SUNL2HMCConfig(real_pairs=True), 2.0)


def test_torch_sun_nd_bench_keys_match_jax(capsys):
    _load("jax_sun_nd_bench", "benchmarks/sun_nd_bench.py").main(BENCH)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = tbench.main(BENCH + ["--device", "cpu"])
    out = capsys.readouterr()
    assert json.loads(out.out.strip().splitlines()[-1]) == got
    assert "device: cpu" in out.err
    assert sorted(got) == sorted(want)
    assert got["metric"] == want["metric"]
    assert got["config"] == want["config"]
    assert got["plaq_strong_coupling_lo"] == want["plaq_strong_coupling_lo"]
    assert got["value"] > 0 and 0 <= got["accept_prob"] <= 1


def test_torch_sun_modules_import_no_jax(tmp_path):
    """A fresh interpreter runs the SU(N) CLI's three paths and the
    benchmark at tiny flags and imports neither jax nor the JAX package."""
    code = f"""
import sys
before = {{m for m in sys.modules if m == "jax" or m.startswith("jax.")}}
import torch
torch.set_num_threads(1)
from l2hmc_tpu_torch.benchmarks import sun_nd_bench
from l2hmc_tpu_torch.cli import train_sun
from l2hmc_tpu_torch.lattice import su2, sun, sun_nd
from l2hmc_tpu_torch.dynamics import su2_hmc, sun_hmc, sun_l2hmc
from l2hmc_tpu_torch.ops import su_matrix
tail = ["--device", "cpu", "--log_dir", {str(tmp_path)!r}]
assert train_sun.main({DIMS!r} + tail) == 0
assert train_sun.main({TWO_D!r} + ["--hmc"] + tail) == 0
assert train_sun.main({TWO_D!r} + ["--train_steps", "2"] + tail) == 0
sun_nd_bench.main({BENCH!r} + ["--device", "cpu"])
g = torch.Generator().manual_seed(0)
plaqs, _ = su2_hmc.su2_hmc_chain(g, 2, 2, 2.0, 2, batch=2, num_steps=2,
                                 device="cpu")
assert bool(torch.isfinite(plaqs).all())
jax_mods = {{m for m in sys.modules if m == "jax" or m.startswith("jax.")}}
assert jax_mods == before, sorted(jax_mods - before)[:5]
ref = [m for m in sys.modules if m == "l2hmc_tpu" or m.startswith("l2hmc_tpu.")]
assert not ref, ref
print("NOJAX_OK")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "NOJAX_OK" in proc.stdout
