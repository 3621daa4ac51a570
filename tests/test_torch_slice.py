"""PyTorch port, the sampling slice end to end at the champion's full width.

The shipped champion (benchmarks/champion_16x16.npz: 16x16 U(1), MLP h64,
K=3, eps 0.125, merge_v_halves, bounded_q) loads through
``train.checkpoint.load_champion``; its leaf order is pinned against the JAX
``DynamicsParams`` pytree; the port's chain entry points on CPU tensors then
reproduce the JAX plain references on the same injected randomness.

Tolerance: atol 2e-4 on states and accept probabilities, as in
tests/test_l2hmc_kernel.py (different libm, the reference's polynomial
arctan against atan2, H0 - H1 summed per site in the port).
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from l2hmc_tpu.ops import l2hmc_kernel as jl2
from l2hmc_tpu.ops import leapfrog as jlf
from l2hmc_tpu.train import gauge as jgauge
from l2hmc_tpu_torch.dynamics.hmc import hmc_chain_u1_fused
from l2hmc_tpu_torch.lattice.u1 import typical_links
from l2hmc_tpu_torch.ops import l2hmc_kernel as tl2
from l2hmc_tpu_torch.ops import leapfrog as tlf
from l2hmc_tpu_torch.train import checkpoint as tck
from l2hmc_tpu_torch.train import gauge as tgauge

torch.set_num_threads(1)

ATOL = 2e-4
REPO = Path(__file__).resolve().parents[1]
CHAMPION = REPO / "benchmarks" / "champion_16x16.npz"


def _jax_champion():
    """The JAX champion params: npz leaves unflattened into the pytree of
    ``init_train_state(cfg, key).params`` (benchmarks/topo_ensemble.py
    load_champion), with the pytree taken abstractly (no init compute)."""
    z = np.load(CHAMPION, allow_pickle=False)
    cfg_d = json.loads(str(z["config"]))
    known = {f.name for f in dataclasses.fields(jgauge.GaugeConfig)}
    cfg = jgauge.GaugeConfig(**{k: v for k, v in cfg_d.items() if k in known})
    template = jax.eval_shape(
        lambda k: jgauge.init_train_state(cfg, k).params,
        jax.random.PRNGKey(0))
    pairs, treedef = jax.tree_util.tree_flatten_with_path(template)
    leaves = [jnp.asarray(z[f"arr_{i}"]) for i in range(len(pairs))]
    for (_, spec), leaf in zip(pairs, leaves):
        assert spec.shape == leaf.shape
    return (cfg, jax.tree_util.tree_unflatten(treedef, leaves),
            [path for path, _ in pairs])


def _path_name(path):
    return ".".join(str(getattr(p, "key", getattr(p, "name", p)))
                    for p in path)


def test_torch_champion_loads_with_the_jax_leaf_order():
    jcfg, jparams, paths = _jax_champion()
    names = [_path_name(p) for p in paths]
    order = list(tck.NET_LEAF_ORDER)
    assert names == ([f"xnet.{n}" for n in order]
                     + [f"vnet.{n}" for n in order] + ["raw_eps", "masks"])
    cfg, params = tck.load_champion(CHAMPION, device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.time_size, cfg.hidden, cfg.num_steps, cfg.group) == (
        16, 64, 3, "u1")
    assert cfg.merge_v_halves and cfg.bounded_q
    for net in ("xnet", "vnet"):
        state = getattr(params, net).state_dict()
        for n in order:
            leaf = getattr(jparams, net)
            for part in n.split("."):
                leaf = leaf[part]
            np.testing.assert_array_equal(state[n].numpy(), np.asarray(leaf))
    assert float(params.raw_eps.detach()) == float(jparams.raw_eps) == 0.125
    np.testing.assert_array_equal(params.masks.numpy(),
                                  np.asarray(jparams.masks))
    assert [f.name for f in dataclasses.fields(tgauge.GaugeConfig)] == [
        f.name for f in dataclasses.fields(jgauge.GaugeConfig)]


@pytest.mark.parametrize("hop", [False, True])
def test_torch_champion_chain_matches_jax_reference(hop):
    """``l2hmc_chain`` on CPU tensors at full width (16x16, h64) equals the
    JAX ``l2hmc_chain_reference`` on the same arrays."""
    _, jparams, _ = _jax_champion()
    cfg, params = tck.load_champion(CHAMPION, device="cpu")
    b, n, d = 8, 4, 256
    rng = np.random.default_rng(11)
    links = typical_links(rng, b, 16, 16, sigma=0.3)
    rand = [rng.standard_normal((n, b, d)), rng.standard_normal((n, b, d)),
            rng.choice([-1.0, 1.0], (n, b)), rng.uniform(size=(n, b))]
    if hop:
        rand += [rng.choice([-1.0, 1.0], (n, b)), rng.uniform(size=(n, b))]
    rand = [a.astype(np.float32) for a in rand]
    eps, beta = 0.125, 4.0
    want = jl2.l2hmc_chain_reference(
        jnp.asarray(links), jparams, *rand[:4], eps, beta, cfg.num_steps,
        hop_arrays=tuple(rand[4:]) if hop else None)
    got = tl2.l2hmc_chain(torch.from_numpy(links), params, None, eps, beta,
                          cfg.num_steps, n, hop=hop,
                          rand_arrays=[torch.from_numpy(a) for a in rand])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    assert 0.2 < float(got[3].mean()) <= 1.0


def test_torch_hmc_baseline_chain_matches_jax_reference():
    """The HMC baseline at its shipped setting (K=5, eps=0.08, beta=4)."""
    b, n, d = 8, 3, 256
    rng = np.random.default_rng(12)
    links = typical_links(rng, b, 16, 16, sigma=0.3)
    rand = [rng.standard_normal((n, b, d)).astype(np.float32),
            rng.standard_normal((n, b, d)).astype(np.float32),
            rng.uniform(size=(n, b)).astype(np.float32),
            rng.choice([-1.0, 1.0], (n, b)).astype(np.float32),
            rng.uniform(size=(n, b)).astype(np.float32)]
    want = jlf.hmc_chain_reference(jnp.asarray(links), *rand[:3], 0.08, 4.0,
                                   5, hop_arrays=tuple(rand[3:]))
    got = tlf.hmc_chain(torch.from_numpy(links), None, 0.08, 4.0, 5, n,
                        hop=True,
                        rand_arrays=[torch.from_numpy(a) for a in rand])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    out = hmc_chain_u1_fused(torch.from_numpy(links),
                             torch.Generator().manual_seed(0), 0.08, 4.0, 5,
                             2)
    assert out[0].shape == links.shape and out[1].shape == (2, b)


def test_torch_port_imports_no_jax():
    """A fresh interpreter runs the CPU slice (champion chain with hop, HMC
    thermalizer, a short SMC ladder on the fused move, a PT round,
    multinomial HMC and AIS, a sampler train step on an analytic target, an
    Ising chain), imports the head-to-head, topological and volume drivers,
    the sampler CLI, the examples, the plots and the profile digest, and
    imports neither jax nor the JAX package."""
    code = r"""
import sys
before = {m for m in sys.modules if m == "jax" or m.startswith("jax.")}
import torch
torch.set_num_threads(1)
import chip_smoke
from l2hmc_tpu_torch.dynamics.hmc import hmc_chain_u1_fused
from l2hmc_tpu_torch.dynamics import ais, nuts, smc, tempering
from l2hmc_tpu_torch.lattice import u1
from l2hmc_tpu_torch.ops.l2hmc_kernel import l2hmc_chain
from l2hmc_tpu_torch.ops.wilson import make_potential_fn
from l2hmc_tpu_torch.train.checkpoint import load_champion
cfg, params = load_champion(device="cpu")
shape = u1.LatticeShape(4, 4)
pot = make_potential_fn(shape)
g0 = torch.Generator().manual_seed(1)
x = u1.random_links(g0, 8, shape, device="cpu")
final, _ = smc.smc_beta_ladder(g0, x, pot, [1.0, 1.5, 2.0],
                               smc.make_u1_fused_move(shape, 3, 2))
pt = tempering.pt_transition(pot, x.reshape(2, 4, -1),
                             tempering.PTConfig((2.0, 1.0), (0.2, 0.3), 3),
                             g0, 0)
xs, _, _ = nuts.nuts_chain(pot, x, 2.0, g0, 2, eps0=0.2, max_steps=4)
logw = ais.ais_log_weights(g0, x, lambda y: 0.0 * pot(y), pot, num_betas=2,
                           eps=0.2, num_leapfrog=2)
assert all(bool(torch.isfinite(t).all())
           for t in (final.x, final.log_z, pt.x, xs, logw))
g = torch.Generator().manual_seed(0)
links = torch.zeros(2, 16, 16, 2)
links, plaq, _, _ = hmc_chain_u1_fused(links, g, 0.08, 4.0, 5, 2)
out = l2hmc_chain(links, params, g, 0.125, 4.0, cfg.num_steps, 1, hop=True)
assert all(bool(torch.isfinite(t).all()) for t in out)
from l2hmc_tpu_torch import targets
from l2hmc_tpu_torch.benchmarks import h2h_seeds, hmc_ess_sweep, trained_vs_hmc
from l2hmc_tpu_torch.cli import train_sampler
from l2hmc_tpu_torch.examples import (flow_sampler_demo, generic_hmc_demo,
                                      mog_tunneling, scg_experiment,
                                      u1_gauge_demo)
from l2hmc_tpu_torch.train import sampler
tgt = targets.gmm_axes(2, device="cpu")
scfg = sampler.SamplerConfig(x_dim=2, num_chains=4, num_steps=2, num_hidden=4)
st = sampler.init_sampler_state(scfg, tgt.energy, g0, device="cpu")
st, m = sampler.make_sampler_train_chunk(scfg, tgt.energy, 2)(st, g0)
assert bool(torch.isfinite(m["loss"]).all())
from l2hmc_tpu_torch.analysis import plots, profile_digest
from l2hmc_tpu_torch.benchmarks import (beta_campaign, charge_mixing,
                                        freeze_line, fused_hop, local64_h2h,
                                        local_cost_sweep, pt_vs_hop, scaling,
                                        topo_ensemble, volume_sweep)
from l2hmc_tpu_torch.examples import ising_demo
from l2hmc_tpu_torch.lattice import creutz_ratio, ising
from l2hmc_tpu_torch.utils import dtypes
e, mag = ising.ising_chain(g0, 4, 0.5, 3, batch=2, device="cpu")
assert e.shape == (3, 2) and float(creutz_ratio(0.5, 0.8, 0.6, 0.7)) > 0
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
