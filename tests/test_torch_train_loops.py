"""PyTorch port, train/: the training loops on the CPU (mirrors of
tests/test_training.py), the entry points' device default, and a fresh
interpreter running the training slice without JAX.

The loops draw from ``torch.Generator``s, so they are checked for what the
JAX tests check (the loss falls, the hop moves sectors, fixed eps stays
bit-identical, the retrain detector fires), not sample by sample; the
step-level parity against JAX is tests/test_torch_train.py.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from l2hmc_tpu_torch.lattice import u1 as tu1
from l2hmc_tpu_torch.train import gauge as tgauge

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _loop_cfg(**kw):
    base = dict(time_size=4, space_size=4, num_chains=32, num_steps=2,
                network_arch="mlp", num_hidden=32, train_steps=150,
                beta_init=2.0, beta_final=2.0, merge_v_halves=True)
    base.update(kw)
    return tgauge.GaugeConfig(**base)


def test_torch_gauge_train_chunk_runs_and_loss_falls():
    cfg = _loop_cfg()
    gen = torch.Generator().manual_seed(0)
    state = tgauge.init_train_state(cfg, gen, device="cpu")
    chunk = tgauge.make_train_chunk(cfg, 75)
    state, m1 = chunk(state, gen)
    state, m2 = chunk(state, gen)
    assert m2["loss"].shape == (75,)
    assert float(m2["loss"].mean()) < float(m1["loss"].mean())
    assert bool(torch.isfinite(m2["loss"]).all())
    assert float(state.x.abs().max()) <= np.pi
    assert state.step == 150 and state.opt_state.count == 150


def test_torch_train_hops_move_the_training_chain_sectors():
    charges = {}
    for hops in (False, True):
        cfg = _loop_cfg(num_hidden=16, train_steps=60, train_hops=hops)
        gen = torch.Generator().manual_seed(1)
        state = tgauge.init_train_state(cfg, gen, device="cpu")
        state, m = tgauge.make_train_chunk(cfg, 30)(state, gen)
        assert bool(torch.isfinite(m["charges2"]).all())
        assert float(state.x.abs().max()) <= np.pi
        charges[hops] = float(m["charges2"].mean())
    assert charges[True] > 0.05


def test_torch_fixed_eps_training_freezes_eps():
    cfg = _loop_cfg(num_chains=16, num_hidden=16, train_steps=60,
                    eps_init=0.1, eps_trainable=False, lr_warmup_steps=5)
    gen = torch.Generator().manual_seed(2)
    state = tgauge.init_train_state(cfg, gen, device="cpu")
    eps0 = state.params.raw_eps.detach().clone()
    w0 = state.params.xnet.in_w.detach().clone()
    state, m = tgauge.make_train_chunk(cfg, 30)(state, gen)
    assert torch.equal(state.params.raw_eps.detach(), eps0)
    assert not torch.allclose(state.params.xnet.in_w.detach(), w0)
    assert bool(torch.isfinite(m["loss"]).all())
    assert set(state.opt_state.mu) == {
        k for k in tgauge.named_leaves(state.params)
        if k.startswith(("xnet/", "vnet/"))}


def test_torch_champion_recipe_trains():
    """The shipped champion's own recipe (its npz ``config``: 16x16, h64,
    K=3, fixed eps 0.125, no hops) trains at full width, from a fresh init
    and from the champion's params, on 8 chains."""
    from l2hmc_tpu_torch.train.checkpoint import load_champion

    cfg, champion = load_champion(device="cpu")
    cfg = dataclasses.replace(cfg, num_chains=8)
    gen = torch.Generator().manual_seed(4)
    fresh = tgauge.init_train_state(cfg, gen, device="cpu")
    chunk = tgauge.make_train_chunk(cfg, 2)
    for state in (fresh, fresh._replace(params=champion)):
        eps0 = state.params.raw_eps.detach().clone()
        state, m = chunk(state, gen)
        assert bool(torch.isfinite(m["loss"]).all())
        assert torch.equal(state.params.raw_eps.detach(), eps0)
        assert float(m["eps"][-1]) == pytest.approx(0.125)
        assert float(state.x.abs().max()) <= np.pi


def test_torch_train_to_convergence_retrains_on_low_acceptance():
    cfg = _loop_cfg(num_chains=8, num_hidden=8, train_steps=4)
    state, m, attempts = tgauge.train_to_convergence(
        cfg, 0, chunk_size=2, retrain_acc=0.0, device="cpu")
    assert len(attempts) == 1
    assert 0.0 <= attempts[0]["end_accept"] <= 1.0
    state, m, attempts = tgauge.train_to_convergence(
        cfg, 0, chunk_size=2, retrain_acc=2.0, max_retrains=2, device="cpu")
    assert len(attempts) == 3
    assert all(a["end_accept"] < 2.0 for a in attempts)
    assert m["accept_prob"].shape == (2,)


def test_torch_entry_points_default_to_the_card():
    """``device=None`` means the first CUDA device; without one the entry
    points raise and name the fix instead of falling back to the CPU."""
    cfg = _loop_cfg()
    calls = {
        "init_params": lambda: tgauge.init_params(cfg),
        "init_train_state": lambda: tgauge.init_train_state(cfg),
        "random_links": lambda: tu1.random_links(None, 2, cfg.shape),
        "train_to_convergence": lambda: tgauge.train_to_convergence(
            dataclasses.replace(cfg, train_steps=1), chunk_size=1),
    }
    if torch.cuda.is_available():
        assert tgauge.init_params(cfg).raw_eps.is_cuda
        return
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    from l2hmc_tpu_torch.train.checkpoint import load_champion
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_champion()


def test_torch_train_path_imports_no_jax():
    """A fresh interpreter imports every module of the training slice, runs
    two train steps with hops on the CPU, and loads neither jax nor the JAX
    package."""
    code = r"""
import sys
before = {m for m in sys.modules if m == "jax" or m.startswith("jax.")}
import torch
torch.set_num_threads(1)
import chip_smoke
from l2hmc_tpu_torch import _device
from l2hmc_tpu_torch.dynamics import nuts, topo
from l2hmc_tpu_torch.ops import wilson
from l2hmc_tpu_torch.train import checkpoint, gauge, losses, schedules
cfg = gauge.GaugeConfig(time_size=4, space_size=4, num_chains=4,
                        num_steps=2, network_arch="mlp", num_hidden=8,
                        merge_v_halves=True, train_hops=True)
g = torch.Generator().manual_seed(0)
state = gauge.init_train_state(cfg, g, device="cpu")
state, m = gauge.make_train_chunk(cfg, 2)(state, g)
assert bool(torch.isfinite(m["loss"]).all())
jax_mods = {m for m in sys.modules if m == "jax" or m.startswith("jax.")}
assert jax_mods == before, sorted(jax_mods - before)[:5]
ref = [m for m in sys.modules if m == "l2hmc_tpu" or m.startswith("l2hmc_tpu.")]
assert not ref, ref
print("NOJAX_OK")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "NOJAX_OK" in proc.stdout
