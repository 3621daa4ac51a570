"""PyTorch port, dp x sp of the full transition and train step: the chains
over 'data' and the lattice's time rows over 'space'
(``parallel/spatial.py``, ``parallel.mesh.lattice_sharding``) on gloo
ranks, and the slab route's plain version of the Wilson kernel.

Four ranks are spawned once (``parallel/dryrun.spawn_local``) and run every
check of this file on a 2x2 and a 1x4 ``(data, space)`` mesh, one task
list.  The parent computes the references: JAX's jitted transition and
train step from the same state with JAX's draws replayed (the
``test_torch_dynamics.py`` and ``test_torch_train.py`` patterns; JAX's own
``tests/test_domain.py`` holds its sharded transition to the replicated
one), and the port's own unsharded run of the same state and draws.

Tolerances.  Against JAX those of ``test_torch_train.py`` (loss rtol 1e-4,
chain states and acceptance atol 2e-4, gradients 1e-4 of each leaf's
largest entry, params 5e-3 lr where the clipped gradient is at least 1e-6,
within lr where Adam's update follows the rounding of a smaller one).
Against the unsharded port the sharded run differs by the order of its
sums only (a per-chain sum is a sum of the slabs' partial sums): loss rtol
1e-5, params (by the same gradient rule) and states atol 1e-6, the
transition's ``x_out`` and acceptance 1e-5, gradients 1e-4 of each leaf's
largest entry: a gradient carries the rounding of K leapfrog steps, and
the sharded port's is as far from the unsharded port's (up to 4.3e-5, the
scalar ``raw_eps`` of mode 3 on 1x4) as the unsharded port's is from JAX's
(up to 7.6e-5, the same leaf).  Adam's first update, lr g / (|g| + 1e-8),
does not see a gradient scaled by a positive factor, so the params alone
could not catch a gradient counted once per 'space' rank: the gradients
are compared directly.  The
other transitions' acceptance: 5e-5, the float32 rounding of an 8x8
Hamiltonian (~250, 1.5e-5 per ulp) reordered, through exp.  The slab plain
version against the whole lattice's: 1e-5 of the largest entry (the same
terms summed in another order; the backward from the same sin P exactly).
"""

import jax
import numpy as np
import pytest
import torch

from l2hmc_tpu.train import gauge as jgauge
from l2hmc_tpu.train import schedules as jsched
from l2hmc_tpu_torch.lattice import u1 as tu1
from l2hmc_tpu_torch.ops import wilson as tw
from l2hmc_tpu_torch.parallel import dryrun
from l2hmc_tpu_torch.parallel import mesh as tmesh
from l2hmc_tpu_torch.parallel.spatial import LatticeSharding
from l2hmc_tpu_torch.train import checkpoint as tckpt
from l2hmc_tpu_torch.train import gauge as tgauge
from tests.test_torch_dynamics import _jax_transition_randomness, _typical_x
from tests.test_torch_train import (_jax_draws, _jax_leaves, _kw,
                                    _port_layout, _states)

torch.set_num_threads(1)

SPACE = (2, 4)          # 'space' ranks of the 4-rank group: 2x2 and 1x4
BETA = 2.0

# tests/test_domain.py:95-122's conv transition: 8x8, 4 filters, hidden 32,
# 4 chains, K=2 (the split integrator, the reference's defaults) at eps 0.1,
# where near-equilibrium chains accept (at the default 0.35 they all
# reject, and the acceptance would test nothing)
CONV = dict(time_size=8, space_size=8, num_chains=4, num_steps=2,
            network_arch="conv", num_filters=4, num_hidden=32, eps_init=0.1)

# the train steps: the dry run's mode 3 (4x4 MLP h16, K=2, 8 chains; the lr
# warmup off so that the step moves the params) and the quick start's shape
# (MLP, merge_v_halves, charge_reward, train_hops) at 8x8.  One step each,
# as the dry run takes and as test_torch_train.py compares: from the second
# step on, Adam's update of a parameter whose gradient sits near Adam's eps
# follows the rounding of that gradient, and the unsharded port then moves
# away from JAX's step as far as the sharded one moves from it (~5e-4 in
# params after two steps of mode 3)
STEPS = {
    "mode3": dict(time_size=4, space_size=4, num_chains=8, num_steps=2,
                  network_arch="mlp", num_hidden=16, train_steps=10,
                  lr_warmup_steps=0),
    "quickstart": _kw(time_size=8, space_size=8, train_hops=True,
                      eps_trainable=True),
}
N_STEPS = 1

# one transition each against the unsharded port (8x8, 4 chains)
VARIANTS = {
    "local_flat": dict(network_arch="local_flat", num_filters=4,
                       local_layers=2, merge_v_halves=True),
    "local": dict(network_arch="local", num_filters=4, local_layers=2),
    "split": dict(network_arch="mlp", num_hidden=16),
    "both_directions": dict(network_arch="mlp", num_hidden=16,
                            both_directions=True, merge_v_halves=True),
    "improved": dict(network_arch="mlp", num_hidden=16, action="improved"),
    "hmc": dict(network_arch="zero", hmc=True),
    "hmc_baseline": dict(network_arch="zero", hmc=True),
}
HMC_BASELINE = (0.15, 3)      # the plain-HMC transition's eps and K
EVAL_STEPS = 3


def _bumped_port_state(cfg, seed):
    """The port's init state with every net tensor moved by N(0, 0.05^2),
    so the nets act (their heads start near zero)."""
    state = tgauge.init_train_state(cfg, torch.Generator().manual_seed(seed),
                                    "cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, t in tgauge.named_leaves(state.params).items():
            if name.startswith(("xnet/", "vnet/")):
                t.add_(0.05 * torch.randn(t.shape, generator=gen))
    return state


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    root = tmp_path_factory.mktemp("space")
    out = {}
    # (i) the conv transition against JAX's, from the same state and draws
    jcfg, js, tcfg, ts = _states(CONV, seed=4)
    x = _typical_x(2, CONV["num_chains"], 8, 8)
    key = jax.random.PRNGKey(9)
    _, jdyn, _ = jgauge.build_dynamics(jcfg)
    want = jax.jit(lambda p, xx, k: jdyn["transition"](p, xx, BETA, k))(
        js.params, x, key)
    tckpt.save_checkpoint(root / "conv", ts, 0, tcfg)
    draws = _jax_transition_randomness(key, CONV["num_chains"], tcfg.x_dim)
    out["conv"] = {
        "args": (tgauge.dataclasses.asdict(tcfg), str(root / "conv"),
                 torch.from_numpy(x), draws, BETA),
        "jax": {k: np.asarray(getattr(want, k))
                for k in ("x_out", "x_proposed", "accept_prob")}}
    # (ii) the train steps against JAX's jitted step
    for case, kw in STEPS.items():
        jcfg, js, tcfg, ts = _states(kw)
        tckpt.save_checkpoint(root / case, ts, 0, tcfg)
        jstep = jax.jit(jgauge.make_train_step(jcfg))
        # JAX's loss gradient at the first step, the train step's own
        _, jdyn, _ = jgauge.build_dynamics(jcfg)
        jloss = jgauge.make_loss_fn(jcfg, jdyn)
        beta0 = jsched.beta_schedule(0, jcfg.train_steps, jcfg.beta_init,
                                     jcfg.beta_final)
        jgrads = jax.jit(jax.grad(lambda p, x, k: jloss(p, x, beta0, k)[0]))(
            js.params, js.x, jax.random.fold_in(jax.random.PRNGKey(6), 0))
        draws, jm = [], []
        for i in range(N_STEPS):
            key = jax.random.fold_in(jax.random.PRNGKey(6), i)
            draws.append(_jax_draws(key, tcfg.num_chains, tcfg.x_dim,
                                    tcfg.train_hops))
            js, m = jstep(js, key)
            jm.append({k: float(v) for k, v in m.items()})
        out[case] = {"args": (tgauge.dataclasses.asdict(tcfg),
                              str(root / case), draws),
                     "jax": (js, jm), "tcfg": tcfg,
                     "jax_grads": _jax_leaves(jgrads),
                     "before": {k: v.detach().clone() for k, v in
                                tgauge.named_leaves(ts.params).items()}}
    # (iii) the other transitions, from the port's own state
    for seed, (case, kw) in enumerate(VARIANTS.items()):
        cfg = tgauge.GaugeConfig(time_size=8, space_size=8, num_chains=4,
                                 num_steps=2, eps_init=0.15, **kw)
        tckpt.save_checkpoint(root / case, _bumped_port_state(cfg, seed), 0,
                              cfg)
        x = torch.from_numpy(_typical_x(10 + seed, 4, 8, 8))
        draws = tgauge.draw_transition(torch.Generator().manual_seed(seed),
                                       x)
        args = (tgauge.dataclasses.asdict(cfg), str(root / case), x, draws,
                BETA)
        out[case] = {"args": args}
    # the eval chunk (metrics and the 2x2 Wilson loop), the local net
    args = out["local"]["args"]
    out["eval"] = {"args": args[:3] + (BETA, EVAL_STEPS, 11)}
    out["root"] = root
    return out


def _tasks(refs):
    """``{(name, num_space): (fn, args)}`` of every rank check."""
    tasks = {}
    for ns in SPACE:
        tasks[("conv", ns)] = (dryrun.sharded_transition,
                               refs["conv"]["args"] + (ns,))
        for case in STEPS:
            tasks[(case, ns)] = (dryrun.replay_train_steps,
                                 refs[case]["args"] + (
                                     True, ns, str(refs["root"]
                                                   / f"saved_{case}_{ns}")))
        tasks[("eval", ns)] = (dryrun.sharded_eval_chunk,
                               refs["eval"]["args"] + (ns,))
        for case in VARIANTS:
            base = HMC_BASELINE if case == "hmc_baseline" else None
            tasks[(case, ns)] = (dryrun.sharded_transition,
                                 refs[case]["args"] + (ns, base))
    return tasks


@pytest.fixture(scope="module")
def ranks(refs):
    """Rank 0's result of every check, one spawn of four gloo ranks."""
    tasks = _tasks(refs)
    out = dryrun.spawn_local(dryrun.run_tasks, 4,
                             args=(list(tasks.values()),))[0]
    return dict(zip(tasks, out))


# ---------------------------------------------------------------------------
# (i) The conv transition
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ns", SPACE)
def test_torch_space_conv_transition_matches_jax(ns, refs, ranks):
    """tests/test_domain.py's conv transition on 2x2 and 1x4 equals JAX's
    on converted weights with JAX's draws replayed, and the unsharded
    port's."""
    got = ranks[("conv", ns)]
    alone = dryrun.sharded_transition(*refs["conv"]["args"])
    want = refs["conv"]["jax"]
    for k in ("x_out", "x_proposed", "accept_prob"):
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=2e-4,
                                   err_msg=k)
        np.testing.assert_allclose(got[k].numpy(), alone[k].numpy(),
                                   atol=1e-5, err_msg=k)
    assert 0.05 < float(got["accept_prob"].mean()) < 1.0


# ---------------------------------------------------------------------------
# (ii) The train steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ns", SPACE)
@pytest.mark.parametrize("case", sorted(STEPS))
def test_torch_space_train_steps_match_jax(case, ns, refs, ranks):
    """A dp x sp train step on 2x2 and 1x4 from the same state and
    JAX's draws: loss and metrics per step, the gradients, params and
    chains against JAX's jitted step and against the unsharded port."""
    ref = refs[case]
    js, jmetrics = ref["jax"]
    got = ranks[(case, ns)]
    alone = dryrun.replay_train_steps(*ref["args"])
    for tm, am, jm in zip(got["metrics"], alone["metrics"], jmetrics):
        assert tm["loss"] == pytest.approx(jm["loss"], rel=1e-4)
        assert tm["loss"] == pytest.approx(am["loss"], rel=1e-5)
        for key in ("accept_prob", "dq", "actions", "plaqs", "charges2"):
            assert tm[key] == pytest.approx(jm[key], abs=2e-4), key
            assert tm[key] == pytest.approx(am[key], rel=1e-5,
                                            abs=1e-6), key
    template = tgauge.init_train_state(ref["tcfg"],
                                       torch.Generator().manual_seed(0),
                                       "cpu")
    # the first step's gradients, all-reduced, leaf by leaf: a replicated
    # parameter's gradient counted once per 'space' rank, or only one
    # rank's share, fails here (Adam's first update does not see a factor)
    assert set(got["grads"]) == set(alone["grads"])
    for name, g in got["grads"].items():
        if name == "masks":
            continue
        want = alone["grads"][name].numpy()
        scale = np.abs(want).max()
        assert scale > 0.0, name
        assert np.abs(g.numpy() - want).max() <= 1e-4 * scale, name
        jg = _port_layout(template.params, name, ref["jax_grads"][name])
        assert np.abs(g.numpy() - jg).max() <= 1e-4 * np.abs(jg).max(), name
    lr = jmetrics[-1]["lr"]
    jl = _jax_leaves(js.params)
    n_big = n_all = 0
    for name, v in got["params"].items():
        want = _port_layout(template.params, name, jl[name])
        # Adam's first update is lr g / (|g| + 1e-8): +-lr where the
        # clipped |g| >= 1e-6, compared at the tolerances; where it is
        # smaller the update follows the rounding of g itself (within lr),
        # as test_torch_train.py's small-gradient rule
        big = np.abs(want - ref["before"][name].numpy()) >= 0.99 * lr
        d_jax = np.abs(v.numpy() - want)
        d_alone = np.abs(v.numpy() - alone["params"][name].numpy())
        assert d_jax[big].max(initial=0.0) <= 5e-3 * lr + 1e-7, name
        assert d_alone[big].max(initial=0.0) <= 1e-6, name
        assert max(d_jax.max(), d_alone.max()) <= lr + 1e-7, name
        if name != "masks":
            n_big, n_all = n_big + big.sum(), n_all + big.size
    assert n_big > 0.9 * n_all      # the rule leaves out a few elements
    np.testing.assert_allclose(got["x"].numpy(), np.asarray(js.x), atol=2e-4)
    np.testing.assert_allclose(got["x"].numpy(), alone["x"].numpy(),
                               atol=1e-6)
    assert got["step"] == N_STEPS
    # the sharded state, checkpointed by the ranks (gathered), restores in
    # one process
    saved = tckpt.restore_checkpoint(refs["root"] / f"saved_{case}_{ns}",
                                     template)
    assert torch.equal(saved.x, got["x"]) and saved.step == N_STEPS
    assert 0.0 < jmetrics[-1]["accept_prob"] < 1.0


# ---------------------------------------------------------------------------
# (iii) The other settings, one transition each
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ns", SPACE)
@pytest.mark.parametrize("case", sorted(VARIANTS))
def test_torch_space_transitions_match_unsharded(case, ns, refs, ranks):
    """``local_flat``, ``local``, the split integrator, both directions,
    the improved action, ``--hmc`` (zero nets) and the plain-HMC baseline
    of ``dynamics/hmc.py``: one transition on 2x2 and 1x4 against the same
    transition unsharded."""
    base = HMC_BASELINE if case == "hmc_baseline" else None
    got = ranks[(case, ns)]
    alone = dryrun.sharded_transition(*refs[case]["args"], 0, base)
    assert set(got) == set(alone)
    for k, v in got.items():
        np.testing.assert_allclose(
            v.numpy(), alone[k].numpy(),
            atol=5e-5 if k == "accept_prob" else 1e-5, err_msg=k)
    assert 0.0 < float(got["accept_prob"].mean())


@pytest.mark.parametrize("ns", SPACE)
def test_torch_space_eval_chunk_matches_unsharded(ns, refs, ranks):
    """``make_eval_chunk`` under ``lattice_sharding`` (the local net,
    three transitions, draws from one seeded generator): the chains and
    every metric (acceptance, actions, plaquettes, charges, the 2x2
    Wilson loop) are the whole lattice's, as unsharded."""
    got = ranks[("eval", ns)]
    alone = dryrun.sharded_eval_chunk(*refs["eval"]["args"])
    np.testing.assert_allclose(got["x"].numpy(), alone["x"].numpy(),
                               atol=1e-5)
    assert set(got["metrics"]) == set(alone["metrics"])
    for k, v in got["metrics"].items():
        assert v.shape == (EVAL_STEPS, 4), k
        np.testing.assert_allclose(v.numpy(), alone["metrics"][k].numpy(),
                                   atol=5e-5 if k == "accept_prob" else 1e-4,
                                   rtol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# (iv) The slab route's plain version against the whole lattice's
# ---------------------------------------------------------------------------


def _close(a, b, rel=1e-5):
    a, b = a.detach(), b.detach()
    scale = float(b.abs().max())
    assert float((a - b).abs().max()) <= rel * max(scale, 1e-6), (
        float((a - b).abs().max()), scale)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_torch_space_slab_plain_matches_whole_lattice(n):
    """The lattice cut into n slabs (halo rows from the neighbours): the
    slab actions add up to the whole action, the slab forces are the
    whole force, and the backward and double backward, their halo rows
    added into their owners, are the whole lattice's."""
    rng = np.random.default_rng(n)
    b, lt, lx = 3, 8, 6
    links = torch.tensor(rng.uniform(-np.pi, np.pi, (b, lt, lx, 2)),
                         dtype=torch.float32)
    g = torch.tensor(rng.uniform(1.0, 3.0, b), dtype=torch.float32)
    w = torch.tensor(rng.standard_normal((b, lt, lx, 2)),
                     dtype=torch.float32)
    exts = tw.cut_slabs(links, n)
    k = lt // n
    s_whole, sinp_whole = tw.wilson_forward_reference(links)
    fwd = [tw.wilson_slab_forward_reference(e) for e in exts]
    _close(sum(s for s, _ in fwd), s_whole)
    for c, (_, sinp) in enumerate(fwd):
        torch.testing.assert_close(sinp[:, 1:-1],
                                   sinp_whole[:, c * k:(c + 1) * k],
                                   rtol=0, atol=1e-6)
        assert not sinp[:, 0].any() and not sinp[:, -1].any()
    # the action's backward from the slabs' own sin P, routed back
    bwd = tw.join_slab_grads(
        [tw.wilson_slab_backward_reference(sinp, g) for _, sinp in fwd], lt)
    _close(bwd, tw.wilson_backward_reference(sinp_whole, g))
    # the complete force on the owned links, no exchange after the halo
    force = torch.cat([tw.wilson_slab_force_reference(e, g) for e in exts],
                      dim=1)
    _close(force, tw.wilson_force_reference(links, g))
    # the force's backward: cotangent on the owned links, routed back
    dl_whole, dg_whole = tw.wilson_double_backward_reference(links, g, w)
    dbl = [tw.wilson_slab_double_backward_reference(
        e, g, w[:, c * k:(c + 1) * k], 0, 1) for c, e in enumerate(exts)]
    _close(tw.join_slab_grads([d for d, _ in dbl], lt), dl_whole)
    _close(sum(dg for _, dg in dbl), dg_whole)
    # the action backward's backward: cotangent on the extended slab
    wext = tw.cut_slabs(w, n)
    act = [tw.wilson_slab_double_backward_reference(e, g, we, 1, 0)
           for e, we in zip(exts, wext)]
    # autograd of the slab form's gradient in the same direction
    for e, we, (dext, dg) in zip(exts, wext, act):
        ee = e.clone().requires_grad_(True)
        gg = g.clone().requires_grad_(True)
        s = tw.wilson_slab_forward_reference(ee)[0]
        (grad,) = torch.autograd.grad((gg * s).sum(), ee, create_graph=True)
        want_dext, want_dg = torch.autograd.grad((grad * we).sum(), (ee, gg))
        _close(dext, want_dext)
        _close(dg, want_dg)


def test_torch_space_slab_functions_on_the_cpu_match_autograd():
    """The slab route's autograd wiring (:class:`WilsonSlabAction`,
    :class:`WilsonSlabForceFn`, on their plain versions here) against
    autograd of the slab's plain action: action, gradient, and the force's
    and gradient's backward."""
    rng = np.random.default_rng(7)
    ext = torch.tensor(rng.uniform(-np.pi, np.pi, (2, 5, 4, 2)),
                       dtype=torch.float32)
    g = torch.tensor([1.5, 2.5])
    w_own = torch.tensor(rng.standard_normal((2, 3, 4, 2)),
                         dtype=torch.float32)
    a = ext.clone().requires_grad_(True)
    b = ext.clone().requires_grad_(True)
    sa = tw.WilsonSlabAction.apply(a)
    sb = tw.wilson_slab_forward_reference(b)[0]
    _close(sa, sb)
    (ga,) = torch.autograd.grad((g * sa).sum(), a, create_graph=True)
    (gb,) = torch.autograd.grad((g * sb).sum(), b, create_graph=True)
    _close(ga, gb)
    # the force is the gradient of the plaquette rows 0..E-2 on the owned
    # links, which the action's gradient on rows 1..E-2 is not (the row
    # below the slab is another rank's plaquette row)
    fa = tw.WilsonSlabForceFn.apply(a, g)
    fb = tw.wilson_slab_force_reference(b, g)
    _close(fa, fb)
    (da,) = torch.autograd.grad((fa * w_own).sum(), a)
    (db,) = torch.autograd.grad((fb * w_own).sum(), b)
    _close(da, db)


# ---------------------------------------------------------------------------
# (vi) Slabs that do not split evenly; the one-rank slab
# ---------------------------------------------------------------------------


def _fake_mesh(n_space, coord=0):
    return tmesh.Mesh({"data": 1, "space": n_space},
                      {"data": 0, "space": coord},
                      {"data": None, "space": None},
                      {"data": [0], "space": list(range(n_space))},
                      torch.device("cpu"))


def test_torch_space_uneven_slabs_raise():
    """Lt not divisible by the 'space' ranks, an odd slab under the conv
    net's stride-2 conv, a halo deeper than the slab, a sharding of
    another lattice, and a mesh other than the sharding's raise
    ``ValueError``."""
    with pytest.raises(ValueError, match="do not split"):
        tmesh.lattice_sharding(_fake_mesh(4), tu1.LatticeShape(6, 8))
    conv = tgauge.GaugeConfig(time_size=6, space_size=6, network_arch="conv",
                              num_filters=2, num_hidden=8)
    with pytest.raises(ValueError, match="stride-2"):
        tgauge.build_dynamics(conv, sharding=tmesh.lattice_sharding(
            _fake_mesh(2), conv.shape))
    sp = tmesh.lattice_sharding(_fake_mesh(4, 1), tu1.LatticeShape(4, 4))
    with pytest.raises(ValueError, match="halo"):
        sp.halo(torch.zeros(1, 1, 4, 2), 1, 0, 2)
    mlp = tgauge.GaugeConfig(time_size=8, space_size=4, network_arch="mlp",
                             num_hidden=8)
    with pytest.raises(ValueError, match="not of"):
        tgauge.build_dynamics(mlp, sharding=sp)
    with pytest.raises(ValueError, match="not the lattice sharding's"):
        tgauge.make_train_step(mlp, mesh=_fake_mesh(4, 1),
                               sharding=tmesh.lattice_sharding(
                                   _fake_mesh(4, 1), mlp.shape))


def test_torch_space_slab_of_a_rank_and_its_placement():
    """Rank 1 of 4 'space' ranks of an 8x4 lattice holds time rows 2-3:
    columns 16-31 of the flat state, rows 2-3 of the links, and the slab
    columns of each copy of a field (``[cos | sin]``, the heads' thirds)."""
    sp = tmesh.lattice_sharding(_fake_mesh(4, 1), tu1.LatticeShape(8, 4))
    assert isinstance(sp, LatticeSharding)
    assert (sp.t0, sp.lt_blk, sp.x_dim) == (2, 2, 16)
    x = torch.arange(3 * 64.0).reshape(3, 64)
    torch.testing.assert_close(sp.shard(x), x[:, 16:32])
    links = x.reshape(3, 8, 4, 2)
    torch.testing.assert_close(sp.shard(links), links[:, 2:4])
    idx = sp.field_index(3, "cpu")
    assert idx.tolist() == [j * 64 + c for j in range(3)
                            for c in range(16, 32)]


# ---------------------------------------------------------------------------
# benchmarks/space_scaling.py on gloo ranks
# ---------------------------------------------------------------------------


def test_torch_space_scaling_on_gloo_ranks(capsys):
    """The dp x sp timing script at 4x4 on a 1x1 and a 1x2 mesh of gloo
    ranks: its JSON keys, and the 1x2 mesh's chains after the first step
    those of the 1x1 mesh (1e-5, the slabs' sums in another order); its
    configs are the quick start's and ``local64_h2h``'s."""
    import json

    from l2hmc_tpu_torch.benchmarks import local64_h2h, space_scaling

    assert space_scaling.make_cfg("quickstart", 4, 4) == (
        tgauge.quickstart_config(time_size=4, space_size=4, num_chains=4))
    assert space_scaling.make_cfg("local64") == local64_h2h.train_config(
        local64_h2h.build_parser().parse_args([]))
    assert space_scaling.main(["--device", "cpu", "--size", "4", "--chains",
                               "4", "--meshes", "1x1", "1x2", "--steps", "1",
                               "--profile_steps", "1"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["lattice"] == [4, 4] and out["chains"] == 4
    assert set(out["meshes"]) == {"1x1", "1x2"}
    for spec, r in out["meshes"].items():
        assert set(r) == {"ms_per_step", "ms_per_step_ranks", "x_diff",
                          "loss", "accept_prob", "profile"}, spec
        assert len(r["ms_per_step_ranks"]) == int(spec[-1])
        assert r["ms_per_step"] > 0 and np.isfinite(r["loss"])
        assert {"halo_host_share", "space_sum_host_share"} <= set(
            r["profile"])
    assert out["meshes"]["1x1"]["x_diff"] == 0.0
    assert out["meshes"]["1x2"]["x_diff"] <= 1e-5
    assert out["meshes"]["1x2"]["profile"]["halo_host_share"] > 0.0
