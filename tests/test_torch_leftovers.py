"""PyTorch port, the leftovers: ``lattice/ising.py`` and
``examples/ising_demo.py``, ``lattice/u1.py creutz_ratio``,
``utils/dtypes.py``, ``analysis/plots.py`` and ``analysis/profile_digest.py``
(with ``cli/train_gauge.py --profile``), against the JAX package.

- The Ising energy and magnetization equal JAX's on the same spins; the
  chain's hot and cold limits as ``tests/test_samplers.py:76``.
- ``creutz_ratio`` equals JAX's on the same loops; the Metropolis ensemble
  at beta=2 meets the area law and -log(I1/I0) as
  ``tests/test_lattice.py:190-208``.
- The dtype switch as ``tests/test_infra.py:174-184``.
- ``make_run_plots`` writes JAX's file names on the synthetic run dir of
  ``tests/test_observables.py``.
- ``format_table`` equals JAX's on the same rows; ``train_gauge --profile``
  on the CPU writes ``profile_top_ops.txt``.
"""

import importlib
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from l2hmc_tpu.lattice import ising as j_ising
from l2hmc_tpu_torch.lattice import ising as t_ising
from l2hmc_tpu_torch.lattice import u1 as tu1

torch.set_num_threads(1)


def _spins(seed, shape):
    rng = np.random.default_rng(seed)
    return np.where(rng.random(shape) > 0.5, 1.0, -1.0).astype(np.float32)


def test_torch_ising_energy_and_magnetization_equal_jax():
    s = _spins(0, (3, 6, 6))
    np.testing.assert_array_equal(
        t_ising.ising_energy(torch.tensor(s), 0.7).numpy(),
        np.asarray(j_ising.ising_energy(jnp.asarray(s), 0.7)))
    np.testing.assert_allclose(
        t_ising.magnetization(torch.tensor(s)).numpy(),
        np.asarray(j_ising.magnetization(jnp.asarray(s))), atol=1e-7)
    soft = np.random.default_rng(1).normal(size=(4, 25)).astype(np.float32)
    np.testing.assert_allclose(
        t_ising.make_energy_fn(5)(torch.tensor(soft)).numpy(),
        np.asarray(j_ising.make_energy_fn(5)(jnp.asarray(soft))), rtol=1e-6)


def test_torch_ising_half_sweep_flips_one_colour():
    """A half-sweep at beta=0 flips every site of its colour and none of the
    other (every flip is accepted)."""
    s = torch.tensor(_spins(2, (2, 4, 4)))
    out = t_ising.metropolis_half_sweep(s, 0.0, torch.Generator().manual_seed(0),
                                        1)
    ii, jj = np.indices((4, 4))
    odd = torch.tensor((ii + jj) % 2 == 1)
    assert torch.equal(out[:, odd], -s[:, odd])
    assert torch.equal(out[:, ~odd], s[:, ~odd])


def test_torch_ising_high_low_temperature():
    """Ordered at low T (|m| ~ 1), disordered at high T."""
    g = torch.Generator().manual_seed(42)
    e_hot, m_hot = t_ising.ising_chain(g, 16, 0.2, 300, batch=4, device="cpu")
    e_cold, m_cold = t_ising.ising_chain(g, 16, 1.0, 300, batch=4,
                                         device="cpu")
    assert e_hot.shape == m_cold.shape == (300, 4)
    assert float(m_cold[200:].mean()) > 0.9
    assert float(m_hot[200:].mean()) < 0.3


def test_torch_ising_demo_runs():
    from l2hmc_tpu_torch.examples import ising_demo

    assert ising_demo.main(["--l", "8", "--num_sweeps", "300", "--batch",
                            "4", "--device", "cpu"]) == 0


def test_torch_creutz_ratio_equals_jax():
    from l2hmc_tpu.lattice import creutz_ratio as j_creutz
    from l2hmc_tpu_torch.lattice import creutz_ratio

    w = np.random.default_rng(3).uniform(0.2, 0.9, (4, 5)).astype(np.float32)
    got = creutz_ratio(*(torch.tensor(v) for v in w))
    np.testing.assert_allclose(got.numpy(), np.asarray(
        j_creutz(*(jnp.asarray(v) for v in w))), rtol=1e-6)
    assert float(creutz_ratio(0.5, 0.8, 0.6, 0.7)) == pytest.approx(
        float(j_creutz(0.5, 0.8, 0.6, 0.7)), rel=1e-6)


def test_torch_wilson_loop_area_law_and_creutz_ratio():
    """Metropolis ensemble at beta=2 on 8x8: <W(RxT)> = (I1/I0)^{RT} and the
    Creutz ratio -log(I1/I0)."""
    from l2hmc_tpu_torch.lattice import (creutz_ratio, wilson_loop,
                                         wilson_loop_exact)
    from l2hmc_tpu_torch.lattice.metropolis import metropolis_sweep

    beta, shape = 2.0, tu1.LatticeShape(8, 8)
    g = torch.Generator().manual_seed(42)
    links = tu1.to_links(tu1.random_links(g, 16, shape, device="cpu"), shape)
    ws = []
    with torch.no_grad():
        for i in range(400):
            links, _ = metropolis_sweep(links, beta, g)
            if i >= 200:
                ws.append(torch.stack([wilson_loop(links, 2, 2),
                                       wilson_loop(links, 1, 1),
                                       wilson_loop(links, 1, 2),
                                       wilson_loop(links, 2, 1)]))
    w22, w11, w12, w21 = torch.stack(ws).mean(dim=(0, 2)).tolist()
    assert abs(w22 - wilson_loop_exact(beta, 4)) < 0.02, w22
    assert abs(w12 - wilson_loop_exact(beta, 2)) < 0.02, w12
    chi = float(creutz_ratio(w22, w11, w12, w21))
    exact_chi = -float(np.log(tu1.u1_plaq_exact(beta)))
    assert abs(chi - exact_chi) < 0.06, (chi, exact_chi)


def test_torch_lattice_exports_match_jax():
    import l2hmc_tpu.lattice as jl
    import l2hmc_tpu_torch.lattice as tl

    names = {n for n in vars(jl) if not n.startswith("_")
             and n not in ("u1", "ising", "metropolis", "su2", "sun",
                           "sun_nd")}
    assert names <= set(vars(tl))


def test_torch_dtypes_switch(monkeypatch):
    """FLOAT/NP_FLOAT from L2HMC_FLOAT, read at import."""
    from l2hmc_tpu_torch.utils import dtypes

    assert dtypes.FLOAT == torch.float32 and dtypes.NP_FLOAT == np.float32
    monkeypatch.setenv("L2HMC_FLOAT", "f64")
    assert dtypes._from_env() == "float64"
    monkeypatch.setenv("L2HMC_FLOAT", "bogus")
    with pytest.raises(ValueError):
        dtypes._from_env()
    assert torch.zeros(2, dtype=dtypes.FLOAT).dtype == torch.float32
    monkeypatch.setenv("L2HMC_FLOAT", "double")
    try:
        f64 = importlib.reload(dtypes)
        assert f64.FLOAT == torch.float64 and f64.NP_FLOAT == np.float64
        before = torch.get_default_dtype()
        f64.set_default_dtype()
        assert torch.zeros(1).dtype == torch.float64
        torch.set_default_dtype(before)
    finally:
        monkeypatch.delenv("L2HMC_FLOAT")
        importlib.reload(dtypes)
    assert dtypes.FLOAT == torch.float32


@pytest.fixture
def run_dir(tmp_path):
    """tests/test_observables.py's synthetic run dir, plus a beta column."""
    rng = np.random.default_rng(0)
    with open(tmp_path / "metrics.jsonl", "w") as f:
        for step in range(10):
            f.write(json.dumps({"step": step * 50, "loss": -10.0 - step,
                                "plaqs": 0.6 + 0.001 * step,
                                "beta": 2.0 + 0.2 * step}) + "\n")
    t = 400
    plaqs = 0.68 + 0.01 * rng.standard_normal((t, 8))
    plaqs[:50] -= np.linspace(0.2, 0.0, 50)[:, None]
    charges = rng.integers(-2, 3, (t, 8)).astype(float)
    accept = rng.uniform(0.4, 0.9, (t, 8))
    np.savez_compressed(tmp_path / "eval_beta2.npz", plaqs=plaqs,
                        charges=charges, accept_prob=accept)
    return tmp_path


def test_torch_make_run_plots_writes_jax_file_names(run_dir, tmp_path_factory):
    import shutil

    from l2hmc_tpu.analysis.plots import make_run_plots as j_plots
    from l2hmc_tpu_torch.analysis.plots import make_run_plots

    jdir = tmp_path_factory.mktemp("jax_run")
    for p in run_dir.iterdir():
        shutil.copy(p, jdir / p.name)
    want = [Path(p).relative_to(jdir) for p in j_plots(jdir, 0.6978)]
    got = [Path(p).relative_to(run_dir) for p in
           make_run_plots(run_dir, exact_plaq=0.6978)]
    assert got == want
    assert len(got) >= 5
    for p in got:
        assert (run_dir / p).stat().st_size > 1000


def test_torch_plots_without_matplotlib_name_it(run_dir, monkeypatch):
    import sys

    from l2hmc_tpu_torch.analysis import plots

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        plots.make_run_plots(run_dir)


def test_torch_format_table_equals_jax():
    from l2hmc_tpu.analysis import profile_digest as j_pd
    from l2hmc_tpu_torch.analysis import profile_digest as t_pd

    rows = [("aten::mm", 12.5, 30, 61.2), ("wilson_force_kernel", 3.25, 900,
                                           15.9),
            ("x" * 120, 0.001, 1, 0.0)]
    assert t_pd.format_table(rows) == j_pd.format_table(rows)
    assert t_pd.format_table([]) == j_pd.format_table([])


def test_torch_profile_digest_of_a_cpu_profile(tmp_path):
    from l2hmc_tpu_torch.analysis import profile_digest as pd

    with pd.trace(tmp_path / "t") as prof:
        a = torch.randn(64, 64)
        for _ in range(3):
            a = torch.tanh(a @ a)
    rows = pd.digest_profile(prof, top_k=5)
    assert 0 < len(rows) <= 5
    assert [r[1] for r in rows] == sorted((r[1] for r in rows), reverse=True)
    assert sum(r[3] for r in rows) <= 100.0 + 1e-6
    assert any(name == "aten::mm" and n == 3 for name, _, n, _ in rows)
    assert (tmp_path / "t" / "trace.json.gz").stat().st_size > 0
    assert pd.write_digest(prof, tmp_path) == tmp_path / "profile_top_ops.txt"


def test_torch_train_gauge_profile_writes_the_digest(tmp_path):
    """``--profile --profile_every 2`` over 3 chunks traces chunks 0 and 2,
    as the JAX CLI does: ``profile/`` with the digest in the run dir, and
    ``timeline_<step>/`` with its own."""
    from l2hmc_tpu_torch.cli import train_gauge

    argv = ["--device", "cpu", "--time_size", "4", "--space_size", "4",
            "--num_samples", "4", "--num_steps", "2", "--num_hidden", "8",
            "--logging_steps", "2", "--train_steps", "6", "--run_steps",
            "20", "--profile", "--profile_every", "2", "--log_dir",
            str(tmp_path)]
    assert train_gauge.main(argv) == 0
    run = tmp_path / "run_1"
    table = (run / "profile_top_ops.txt").read_text().splitlines()
    assert table[0].split() == ["op", "total_ms", "count", "pct"]
    assert len(table) > 3
    assert (run / "profile" / "trace.json.gz").exists()
    assert (run / "timeline_4" / "profile_top_ops.txt").exists()
    assert not (run / "timeline_2").exists()
