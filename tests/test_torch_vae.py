"""PyTorch port, the VAE workload (``networks/nets.py`` with ``aux_dim``,
``dynamics/l2hmc.py`` with ``aux`` and ``chain_operator``,
``train/vae.py``, ``cli/train_vae.py``, the bundled data), against the JAX
package.

Parity: both sides start from JAX's init (its leaves carried over by
``vae_params_from_numpy``), and the port replays JAX's draws: a transition
``kv, kd, ka = split(key, 3)``, ``v = normal(kv)``, ``direction =
uniform(kd) > 0.5``, ``u = uniform(ka)``; ``chain_operator`` ``kn, kv, kd,
ka = split(key, 4)``, ``n_comp = randint(kn, 1, max + 1)``; the train step
``k_elbo, k_smp, _ = split(key, 3)``, the ELBO's normals from ``k_elbo``,
the posterior sampler's ``k0, key = split(k_smp)``, its start from ``k0``
and one ``key, sub = split(key)`` per MH step.  JAX's gradients are read
from its Adam state after the step (``mu = (1 - b1) g`` after one update).

Tolerances: the nets 1e-5; a transition and ``chain_operator`` (K=2-3
leapfrog steps, float32 on both sides) 2e-5; the train step rtol 1e-4 and
atol 1e-5 on the loss, its parts, every gradient and every updated
parameter; the AIS oracle 0.25 nats of the exact marginal, as JAX's test.
"""

import contextlib
import importlib.util
import io
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

from l2hmc_tpu.dynamics import l2hmc as jl2hmc
from l2hmc_tpu.networks import nets as jnets
from l2hmc_tpu.train import vae as jvae
from l2hmc_tpu_torch.cli import train_vae as tcli
from l2hmc_tpu_torch.dynamics import l2hmc as tl2hmc
from l2hmc_tpu_torch.networks import nets as tnets
from l2hmc_tpu_torch.train import vae as tvae
from l2hmc_tpu_torch.train.checkpoint import _net_arrays

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
KW = dict(data_dim=12, latent_dim=3, enc_hidden=16, dec_hidden=16,
          num_steps=2, mh_steps=2, sampler_hidden=8, eps_init=0.15)
B = 8


def _t(a):
    return torch.tensor(np.asarray(a))


def _data(seed=0, b=B, d=KW["data_dim"]):
    return (np.random.default_rng(seed).uniform(size=(b, d)) > 0.5).astype(
        np.float32)


def _transition_draws(key, shape):
    kv, kd, ka = jax.random.split(key, 3)
    v = jax.random.normal(kv, shape, jnp.float32)
    d = jnp.where(jax.random.uniform(kd, (shape[0],)) > 0.5, 1.0, -1.0)
    return tuple(_t(a) for a in (v, d, jax.random.uniform(ka, (shape[0],))))


def _chain_draws(key, shape, max_comp):
    kn, kv, kd, ka = jax.random.split(key, 4)
    n = jax.random.randint(kn, (shape[0],), 1, max_comp + 1)
    v = jax.random.normal(kv, shape, jnp.float32)
    d = jnp.where(jax.random.uniform(kd, (shape[0],)) > 0.5, 1.0, -1.0)
    return (_t(n).long(),) + tuple(
        _t(a) for a in (v, d, jax.random.uniform(ka, (shape[0],))))


def _posterior_draws(key, cfg, b):
    k0, key = jax.random.split(key)
    shape = (b, cfg.latent_dim)
    z0 = _t(jax.random.normal(k0, shape))
    mh = []
    for _ in range(cfg.mh_steps):
        key, sub = jax.random.split(key)
        mh.append(_chain_draws(sub, shape, cfg.random_lf_composition)
                  if cfg.random_lf_composition else
                  _transition_draws(sub, shape))
    return z0, tuple(mh)


def _step_draws(key, cfg, b):
    k_elbo, k_smp, _ = jax.random.split(key, 3)
    elbo = _t(jax.random.normal(k_elbo, (b, cfg.latent_dim)))
    return tvae.VAEDraws(elbo, *_posterior_draws(k_smp, cfg, b))


def _pair(cfg_kw=None, seed=0):
    kw = dict(KW, **(cfg_kw or {}))
    jcfg, tcfg = jvae.VAEConfig(**kw), tvae.VAEConfig(**kw)
    jinit, jfns = jvae.build_vae(jcfg)
    jparams = jinit(jax.random.PRNGKey(seed))
    return jcfg, tcfg, jparams, jfns, tvae.vae_params_from_numpy(
        jparams, tcfg, device="cpu")


# ---------------------------------------------------------------------------
# Data, nets and the aux-conditioned dynamics
# ---------------------------------------------------------------------------


def test_torch_vae_digits_file_matches_jax_loader():
    pytest.importorskip("sklearn")
    got = tvae.load_digits_binarized()
    want = jvae.load_digits_binarized()
    assert got.dtype == np.float32 and got.shape == (1797, 64)
    np.testing.assert_array_equal(got, want)


def test_torch_mlp_net_with_aux_matches_jax():
    spec = dict(x_dim=3, num_hidden=8, factor=2.0, bounded_q=True,
                aux_dim=5)
    jinit, japply = jnets.make_mlp_net(jnets.MLPNetSpec(**spec))
    jp = jinit(jax.random.PRNGKey(1))
    net = tnets.make_mlp_net(tnets.MLPNetSpec(**spec),
                             torch.Generator().manual_seed(0))
    assert net.in_w.shape == (3 + 3 + 2 + 5, 8)
    net.load_state_dict({k: _t(v) for k, v in _net_arrays(jp).items()})
    rng = np.random.default_rng(2)
    v, x, aux = (rng.standard_normal((4, d)).astype(np.float32)
                 for d in (3, 3, 5))
    t = rng.standard_normal((4, 2)).astype(np.float32)
    want = japply(jp, v, x, t, aux)
    got = net(_t(v), _t(x), _t(t), _t(aux))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=1e-5)
    with pytest.raises(ValueError, match="aux_dim=5"):
        net(_t(v), _t(x), _t(t))


def test_torch_fused_chain_refuses_an_aux_net():
    from l2hmc_tpu_torch.ops.l2hmc_kernel import (l2hmc_chain,
                                                  pack_weights)

    d = 2 * 4 * 4
    nets = [tnets.make_mlp_net(tnets.MLPNetSpec(
        d, 8, factor=f, x_in_dim=2 * d, v_in_dim=2 * d if f == 1.0 else 0,
        aux_dim=3), torch.Generator().manual_seed(0)) for f in (2.0, 1.0)]
    params = tl2hmc.DynamicsParams(nets[0], nets[1], torch.tensor(0.1),
                                   torch.zeros(2, d))
    with pytest.raises(ValueError, match="aux"):
        pack_weights(params, d)
    with pytest.raises(ValueError, match="aux"):
        l2hmc_chain(torch.zeros(2, 4, 4, 2), params,
                    torch.Generator().manual_seed(0), 0.1, 2.0, 2, 1)


@pytest.mark.parametrize("op", ["transition", "chain_operator"])
def test_torch_aux_dynamics_match_jax(op):
    """An r1 ``use_log_eps`` transition conditioned on aux, and
    ``chain_operator`` at max 3, on the VAE's posterior energy."""
    jcfg, tcfg, jparams, jfns, tparams = _pair(dict(num_steps=3))
    x = _data(1)
    z = np.random.default_rng(3).standard_normal((B, 3)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    jdyn = jl2hmc.make_dynamics(
        jfns["dyn_cfg"], jfns["posterior_energy"](jparams.decoder, x),
        jfns["xnet_apply"], jfns["vnet_apply"])
    _, tfns = tvae.build_vae(tcfg)
    tdyn = tl2hmc.make_dynamics(
        tfns["dyn_cfg"], tfns["posterior_energy"](tparams.decoder, _t(x)))
    with torch.no_grad():
        if op == "transition":
            want = jdyn["transition"](jparams.dynamics, z, 1.0, key, aux=x)
            got = tdyn["transition_with"](tparams.dynamics, _t(z), 1.0,
                                          *_transition_draws(key, z.shape),
                                          aux=_t(x))
        else:
            want = jdyn["chain_operator"](jparams.dynamics, z, 1.0, key,
                                          max_compositions=3, aux=x)
            draws = _chain_draws(key, z.shape, 3)
            assert len(set(draws[0].tolist())) > 1
            got = tdyn["chain_operator_with"](tparams.dynamics, _t(z), 1.0,
                                              3, *draws, aux=_t(x))
    for f in ("x_proposed", "v_proposed", "accept_prob", "x_out",
              "sumlogdet", "accept_mask", "forward_frac"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), atol=2e-5,
                                   err_msg=f)
    with pytest.raises(ValueError, match="aux"):
        tdyn["transition"](tparams.dynamics, _t(z), 1.0,
                           torch.Generator().manual_seed(0))


@pytest.mark.parametrize("lf_comp", [0, 3])
def test_torch_vae_sample_posterior_matches_jax(lf_comp):
    jcfg, tcfg, jparams, jfns, tparams = _pair(
        dict(random_lf_composition=lf_comp))
    x = _data(5)
    key = jax.random.PRNGKey(6)
    want = jfns["sample_posterior"](jparams, x, key)
    _, tfns = tvae.build_vae(tcfg)
    with torch.no_grad():
        got = tfns["sample_posterior"](tparams, _t(x),
                                       draws=_posterior_draws(key, tcfg, B))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------


def _jax_grads(opt_state):
    """The gradients of the first update, from JAX's Adam moments."""
    inner = opt_state.inner_states
    enc = inner["encoder"].inner_state[0].mu.encoder
    dec = inner["decoder"].inner_state[0].mu.decoder
    dyn = inner["dynamics"].inner_state[1][0].mu.dynamics
    return jax.tree.map(lambda m: np.asarray(m) / 0.1,
                        (enc, dec, dyn))


def _port_named(params):
    """``(name, tensor)`` of the port's params in the JAX tree's terms."""
    out = {}
    for group in ("encoder", "decoder"):
        for i, layer in enumerate(getattr(params, group)):
            out[f"{group}/{i}/w"] = layer.w
            out[f"{group}/{i}/b"] = layer.b
    for net in ("xnet", "vnet"):
        for k, v in getattr(params.dynamics, net).named_parameters():
            out[f"dynamics/{net}/{k.replace('.', '/')}"] = v
    out["dynamics/raw_eps"] = params.dynamics.raw_eps
    return out


def _jax_named(enc, dec, dyn):
    out = {}
    for group, layers in (("encoder", enc), ("decoder", dec)):
        for i, layer in enumerate(layers):
            out[f"{group}/{i}/w"] = np.asarray(layer["w"])
            out[f"{group}/{i}/b"] = np.asarray(layer["b"])
    for net in ("xnet", "vnet"):
        for k, v in _net_arrays(getattr(dyn, net)).items():
            out[f"dynamics/{net}/{k.replace('.', '/')}"] = np.asarray(v)
    out["dynamics/raw_eps"] = np.asarray(dyn.raw_eps)
    return out


@pytest.mark.parametrize("lf_comp", [0, 2])
def test_torch_vae_train_step_matches_jax(lf_comp):
    jcfg, tcfg, jparams, jfns, tparams = _pair(
        dict(random_lf_composition=lf_comp, lr_sampler=3e-3))
    jinit, jstep, _ = jvae.make_vae_train_step(jcfg)
    jstate = jinit(jax.random.PRNGKey(0))
    jstate = jstate._replace(params=jparams)
    tinit, tstep, _ = tvae.make_vae_train_step(tcfg)
    tstate = tinit(params=tparams)
    x = _data(7)
    key = jax.random.PRNGKey(8)
    jstate, jaux = jstep(jstate, x, key)
    tstate, taux = tstep(tstate, _t(x), draws=_step_draws(key, tcfg, B))
    assert sorted(taux) == sorted(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    tnamed = _port_named(tstate.params)
    want_g = _jax_named(*_jax_grads(jstate.opt_state))
    want_p = _jax_named(jstate.params.encoder, jstate.params.decoder,
                        jstate.params.dynamics)
    assert sorted(tnamed) == sorted(want_g)
    for k, v in tnamed.items():
        np.testing.assert_allclose(v.grad.numpy(), want_g[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
        np.testing.assert_allclose(v.detach().numpy(), want_p[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(tstate.params.dynamics.masks.numpy(),
                                  np.asarray(jstate.params.dynamics.masks))
    assert tstate.step == int(jstate.step) == 1


def test_torch_vae_train_step_zeroes_nans_on_dynamics_only():
    _, tcfg, _, _, tparams = _pair()
    tinit, tstep, _ = tvae.make_vae_train_step(tcfg)
    state = tinit(params=tparams)
    before = {k: v.detach().clone() for k, v in
              _port_named(state.params).items()}
    enc_w = state.params.encoder[0].w
    xin_w = state.params.dynamics.xnet.in_w
    nan = float("nan")
    hooks = [enc_w.register_hook(lambda g: g * nan),
             xin_w.register_hook(lambda g: g * nan)]
    state, aux = tstep(state, _t(_data(9)), torch.Generator().manual_seed(1))
    for h in hooks:
        h.remove()
    assert torch.isnan(enc_w).all()            # not zeroed: NaN update
    assert torch.equal(xin_w.detach(), before["dynamics/xnet/in_w"])
    assert not torch.isnan(xin_w.grad).any()
    # the other dynamics tensors still train
    assert not torch.equal(state.params.dynamics.vnet.in_w.detach(),
                           before["dynamics/vnet/in_w"])


# ---------------------------------------------------------------------------
# Evaluations
# ---------------------------------------------------------------------------


def test_torch_vae_normal_kl_matches_jax():
    rng = np.random.default_rng(1)
    qm, pm = rng.standard_normal((2, 5, 3)).astype(np.float32)
    qs, ps = rng.uniform(0.5, 2.0, size=(2, 5, 3)).astype(np.float32)
    got = tvae.normal_kl(_t(qm), _t(qs), _t(pm), _t(ps)).numpy()
    np.testing.assert_allclose(got, np.asarray(jvae.normal_kl(qm, qs, pm,
                                                              ps)),
                               rtol=1e-5)
    np.testing.assert_allclose(
        tvae.normal_kl(_t(qm), _t(qs), _t(qm), _t(qs)).numpy(), 0.0,
        atol=1e-6)


def test_torch_vae_ais_linear_gaussian_exact():
    """With p(x|z) = N(x; W z, sigma^2 I) and z ~ N(0, I), p(x) = N(x; 0,
    W^T W + sigma^2 I): the AIS estimate needs no additive constant."""
    d_lat, d_obs, sigma = 2, 3, 0.8
    rng = np.random.default_rng(0)
    W = torch.tensor(rng.normal(size=(d_lat, d_obs)), dtype=torch.float32)
    x = torch.tensor(rng.normal(size=(64, d_obs)) * 1.5, dtype=torch.float32)

    def posterior_energy(w, x_batch):
        def energy(z):
            resid = x_batch - z @ w
            loglik = (-0.5 * torch.sum(resid * resid, dim=-1) / sigma ** 2
                      - 0.5 * d_obs * np.log(2 * np.pi * sigma ** 2))
            return -loglik + 0.5 * torch.sum(z * z, dim=-1)
        return energy

    class _P:
        decoder = W

    logw = tvae.ais_log_likelihood(
        tvae.VAEConfig(data_dim=d_obs, latent_dim=d_lat),
        {"posterior_energy": posterior_energy}, _P, x,
        torch.Generator().manual_seed(0), num_betas=300, eps=0.25).numpy()
    cov = W.numpy().T @ W.numpy() + sigma ** 2 * np.eye(d_obs)
    xn = x.numpy()
    _, logdet = np.linalg.slogdet(cov)
    exact = (-0.5 * np.einsum("bi,ij,bj->b", xn, np.linalg.inv(cov), xn)
             - 0.5 * logdet - 0.5 * d_obs * np.log(2 * np.pi))
    assert abs(logw.mean() - exact.mean()) < 0.25, (logw.mean(),
                                                    exact.mean())


def test_torch_vae_autocovariance_keys():
    _, tcfg, _, _, tparams = _pair()
    _, fns = tvae.build_vae(tcfg)
    out = tvae.posterior_sampler_autocovariance(
        tcfg, fns, tparams, _t(_data(3)), torch.Generator().manual_seed(0),
        num_transitions=12)
    assert set(out) == {"autocorrelation", "ess_per_step", "accept_prob"}
    assert out["autocorrelation"].shape == (12,)
    assert np.isfinite(out["ess_per_step"])
    assert 0.0 < out["accept_prob"] <= 1.0


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

TINY = ["--epoch", "2", "--batch_size", "64", "--latent_dim", "2",
        "--enc_hidden", "8", "--dec_hidden", "8", "--sampler_hidden", "8",
        "--leapfrogs", "2", "--MH", "1", "--ais_betas", "3",
        "--ais_samples", "16", "--eval_transitions", "6",
        "--logging_steps", "10", "--seed", "3"]


def _jax_cli():
    sys.path.insert(0, str(REPO))
    spec = importlib.util.spec_from_file_location(
        "jax_train_vae_cli", REPO / "cli" / "train_vae.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("argv", [[], ["@configs/vae_digits.txt"], TINY])
def test_torch_vae_parser_matches_jax(argv, monkeypatch):
    monkeypatch.chdir(REPO)
    want = vars(_jax_cli().build_parser().parse_args(argv))
    got = vars(tcli.build_parser().parse_args(argv))
    assert got.pop("device") is None
    assert got == want


def test_torch_vae_cli_run_dir_has_the_jax_keys(tmp_path):
    pytest.importorskip("sklearn")
    with contextlib.redirect_stdout(io.StringIO()):
        assert _jax_cli().main(TINY + ["--log_dir",
                                       str(tmp_path / "jax")]) == 0
        assert tcli.main(TINY + ["--log_dir", str(tmp_path / "port"),
                                 "--device", "cpu"]) == 0
    runs = [tmp_path / s / "run_1" for s in ("jax", "port")]
    assert sorted(p.name for p in runs[1].iterdir()) == sorted(
        p.name for p in runs[0].iterdir())
    recs = [[json.loads(line) for line in
             (r / "metrics.jsonl").read_text().splitlines()] for r in runs]
    assert [sorted(r) for r in recs[1]] == [sorted(r) for r in recs[0]]
    assert [r["step"] for r in recs[1]] == [r["step"] for r in recs[0]]
    summaries = [json.loads((r / "summary.json").read_text()) for r in runs]
    assert sorted(summaries[1]) == sorted(summaries[0])
    assert all(np.isfinite(v) for v in summaries[1].values())
    params = [json.loads((r / "params.json").read_text()) for r in runs]
    assert params[1].pop("device") == "cpu"
    assert {k: v for k, v in params[1].items() if k != "log_dir"} == {
        k: v for k, v in params[0].items() if k != "log_dir"}


def test_torch_vae_cli_checkpoints_on_interrupt(tmp_path, monkeypatch):
    from l2hmc_tpu_torch.train import checkpoint as ckpt

    make = tvae.make_vae_train_step

    def interrupting(cfg):
        init_state, step, fns = make(cfg)
        calls = []

        def step_then_stop(*args, **kw):
            calls.append(1)
            if len(calls) == 3:
                raise KeyboardInterrupt
            return step(*args, **kw)

        return init_state, step_then_stop, fns

    monkeypatch.setattr(tvae, "make_vae_train_step", interrupting)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        with pytest.raises(KeyboardInterrupt):
            tcli.main(TINY + ["--log_dir", str(tmp_path), "--device", "cpu"])
    assert "interrupted at step 2" in out.getvalue()
    run = tmp_path / "run_1"
    assert ckpt.latest_step(run / "checkpoints") == 2
    saved = ckpt.load_tensors(run / "checkpoints")
    assert set(saved) == {"params", "optimizer", "step", "generator"}
    assert not (run / "summary.json").exists()


def test_torch_vae_cli_imports_no_jax(tmp_path):
    """A fresh interpreter runs the VAE CLI at tiny flags (and the VI
    fits) and imports neither jax nor the JAX package."""
    code = f"""
import sys
before = {{m for m in sys.modules if m == "jax" or m.startswith("jax.")}}
import torch
torch.set_num_threads(1)
from l2hmc_tpu_torch.cli import train_vae
from l2hmc_tpu_torch.dynamics import vi
assert train_vae.main({TINY!r} + ["--device", "cpu", "--log_dir",
                                  {str(tmp_path)!r}]) == 0
p, elbos = vi.fit_fullrank(lambda x: 0.5 * (x * x).sum(-1), 2,
                           torch.Generator().manual_seed(0), num_steps=5,
                           device="cpu")
assert bool(torch.isfinite(elbos).all())
jax_mods = {{m for m in sys.modules if m == "jax" or m.startswith("jax.")}}
assert jax_mods == before, sorted(jax_mods - before)[:5]
ref = [m for m in sys.modules if m == "l2hmc_tpu" or m.startswith("l2hmc_tpu.")]
assert not ref, ref
assert "sklearn" not in sys.modules
print("NOJAX_OK")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "NOJAX_OK" in proc.stdout
