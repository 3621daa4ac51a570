"""PyTorch port, train/checkpoint.py: checkpoints of the port's training
(as tests/test_infra.py checks the JAX package's), and JAX train states of
the image nets and of r1 carried across.

- Round trip: every tensor of the restored state equals the saved one, and
  a chunk continued from the restored state and generator is the chunk
  continued from the live one, bit for bit.
- Pruning keeps the newest 3; ``config.json`` is the JAX package's text
  for the same config, and each package's ``load_config_dict`` reads the
  other's.
- ``train_state_from_numpy`` of a JAX state two steps into training (Adam's
  moments non-zero) takes one more step as JAX does: loss rtol 1e-4, the
  chain state atol 2e-4, params within 5e-3 lr where the clipped gradient
  is above 1e-6 (as tests/test_torch_train.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from l2hmc_tpu.train import checkpoint as jckpt
from l2hmc_tpu.train import gauge as jgauge
from l2hmc_tpu_torch.train import checkpoint as tckpt
from l2hmc_tpu_torch.train import gauge as tgauge

torch.set_num_threads(1)

CFG = dict(time_size=4, space_size=4, num_chains=8, num_steps=2,
           network_arch="conv", num_hidden=16, num_filters=4, train_steps=20,
           merge_v_halves=False)


def _leaves(state):
    out = {f"params/{k}": v for k, v in state.params.state_dict().items()}
    out.update({f"mu/{k}": v for k, v in state.opt_state.mu.items()})
    out.update({f"nu/{k}": v for k, v in state.opt_state.nu.items()})
    out.update(x=state.x, **{f"da/{i}": v for i, v in enumerate(state.da)})
    return out


def test_torch_checkpoint_roundtrip(tmp_path):
    cfg = tgauge.GaugeConfig(**CFG)
    gen = torch.Generator().manual_seed(0)
    state = tgauge.init_train_state(cfg, gen, "cpu")
    chunk = tgauge.make_train_chunk(cfg, 3)
    state, _ = chunk(state, gen)
    tckpt.save_checkpoint(tmp_path / "ck", state, state.step, cfg,
                          generator_state=gen.get_state())
    gen2 = torch.Generator().manual_seed(9)
    template = tgauge.init_train_state(cfg, gen2, "cpu")
    restored = tckpt.restore_checkpoint(tmp_path / "ck", template,
                                        generator=gen2)
    a, b = _leaves(state), _leaves(restored)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert restored.step == state.step == 3
    assert restored.opt_state.count == state.opt_state.count == 3
    assert torch.equal(gen2.get_state(), gen.get_state())
    assert tckpt.load_config_dict(tmp_path / "ck")["time_size"] == 4
    s1, m1 = chunk(state, gen)
    s2, m2 = chunk(restored, gen2)
    for k in m1:
        assert torch.equal(m1[k], m2[k]), k
    assert torch.equal(s1.x, s2.x)


def test_torch_checkpoint_keeps_latest(tmp_path):
    cfg = tgauge.GaugeConfig(**CFG)
    state = tgauge.init_train_state(cfg, torch.Generator().manual_seed(1),
                                    "cpu")
    assert tckpt.latest_step(tmp_path / "ck") is None
    for step in (1, 2, 3, 4, 5):
        tckpt.save_checkpoint(tmp_path / "ck", state._replace(step=step),
                              step, keep=3)
    assert tckpt.latest_step(tmp_path / "ck") == 5
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "3", "4", "5"]
    r = tckpt.restore_checkpoint(tmp_path / "ck", state, step=4)
    assert r.step == 4
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(tmp_path / "none", state)


def test_torch_config_json_is_the_jax_packages(tmp_path):
    kw = dict(CFG, action="improved", group="r1", eps_init=0.2)
    jcfg = jgauge.GaugeConfig(**kw)
    jstate = jgauge.init_train_state(jcfg, jax.random.PRNGKey(0))
    jckpt.save_checkpoint(tmp_path / "jax", jstate, 0, jcfg)
    tcfg = tgauge.GaugeConfig(**kw)
    tstate = tgauge.init_train_state(tcfg, torch.Generator().manual_seed(0),
                                     "cpu")
    tckpt.save_checkpoint(tmp_path / "torch", tstate, 0, tcfg)
    assert ((tmp_path / "torch" / "config.json").read_text()
            == (tmp_path / "jax" / "config.json").read_text())
    assert tckpt.load_config_dict(tmp_path / "jax") == \
        jckpt.load_config_dict(tmp_path / "torch") == dataclasses.asdict(tcfg)
    assert tgauge.config_from_dict(tckpt.load_config_dict(
        tmp_path / "jax")) == tcfg


def _draws(key, b, d, hop):
    def chain(k):
        kv, kd, ka = jax.random.split(k, 3)
        return (jax.random.normal(kv, (b, d), jnp.float32),
                jnp.where(jax.random.uniform(kd, (b,)) > 0.5, 1.0, -1.0),
                jax.random.uniform(ka, (b,)))

    kx, kz, kzi = jax.random.split(key, 3)
    out = [*chain(kx), jax.random.normal(kzi, (b, d), jnp.float32),
           *chain(kz)]
    if hop:
        k_nu, k_acc = jax.random.split(jax.random.fold_in(key, 77))
        mag = jax.random.randint(k_nu, (b,), 1, 2)
        sign = jax.random.rademacher(jax.random.fold_in(k_nu, 1), (b,))
        out += [mag * sign, jax.random.uniform(k_acc, (b,))]
    return tgauge.TrainDraws(*[torch.from_numpy(np.array(a, np.float32))
                               for a in out])


def _at(tree, name):
    """The leaf at ``xnet/conv_x1/w`` of a reference params-shaped tree."""
    for part in name.split("/"):
        tree = tree[part] if isinstance(tree, dict) else getattr(tree, part)
    return np.asarray(tree)


@pytest.mark.parametrize("over", [
    dict(), dict(network_arch="local", group="r1", train_hops=True,
                 merge_v_halves=True)], ids=["conv_split", "local_r1"])
def test_torch_train_state_from_numpy_continues_jax(over):
    kw = dict(CFG, eps_trainable=True, lr_warmup_steps=0, **over)
    jcfg, tcfg = jgauge.GaugeConfig(**kw), tgauge.GaugeConfig(**kw)
    jstep = jax.jit(jgauge.make_train_step(jcfg))
    js = jgauge.init_train_state(jcfg, jax.random.PRNGKey(4))
    for i in range(2):
        js, _ = jstep(js, jax.random.PRNGKey(100 + i))
    ts = tckpt.train_state_from_numpy(jax.tree.map(np.asarray, js), tcfg,
                                      "cpu")
    assert ts.step == 2 and ts.opt_state.count == 2
    mu0 = tckpt._find_adam(js.opt_state).mu
    key = jax.random.PRNGKey(7)
    js2, jm = jstep(js, key)
    ts2, tm = tgauge.make_train_step(tcfg)[1](
        ts, _draws(key, tcfg.num_chains, tcfg.x_dim, tcfg.train_hops))
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-4)
    np.testing.assert_allclose(ts2.x.numpy(), np.asarray(js2.x), atol=2e-4)
    lr = float(jm["lr"])
    mu1 = tckpt._find_adam(js2.opt_state).mu
    for name, v in tgauge.named_leaves(ts2.params).items():
        head, _, rest = name.partition("/")
        want, m1, m0 = (_at(t, name) for t in (js2.params, mu1, mu0))
        # the step's clipped gradient, from Adam's first moment
        g = np.abs(m1 - 0.9 * m0) / 0.1
        if head in ("xnet", "vnet"):
            conv = getattr(ts2.params, head).from_reference_leaf
            want = conv(rest.replace("/", "."), want)
            g = conv(rest.replace("/", "."), g)
        got = v.detach().numpy()
        big = g >= 1e-6
        np.testing.assert_allclose(got[big], want[big],
                                   atol=5e-3 * lr + 1e-7, err_msg=name)
        np.testing.assert_allclose(got[~big], want[~big], atol=lr + 1e-7,
                                   err_msg=name)
