"""PyTorch port, the multi-device path (``parallel/``) on gloo ranks.

Ranks are spawned by ``parallel/dryrun.spawn_local`` (``file://``
rendezvous, gloo, the workers in the port); each world size is spawned once
and runs every check of this file as one task list.  The parent computes
the references: JAX's jitted single-device ``make_train_step`` on
``train_state_from_numpy`` of the same state with JAX's draws replayed
(the ``test_torch_train.py`` pattern), JAX's SMC ladder with its draws
replayed, the one-process CLI, and the port's own functions with no
process group.

Tolerances: against JAX those of ``test_torch_train.py`` and
``test_torch_ensembles.py`` (loss rtol 1e-4, chain state and accept
statistics atol 2e-4, params 5e-3 lr; SMC 1e-4); an n-rank run against the
same computation with no group differs by the all-reduce's summation order
only: 1e-5 relative on losses, 1e-6 absolute on parameters and states
(bit-for-bit where nothing is reduced).
"""

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

from l2hmc_tpu.dynamics import smc as jsmc
from l2hmc_tpu.lattice import u1 as ju1
from l2hmc_tpu.train import gauge as jgauge
from l2hmc_tpu_torch import _device
from l2hmc_tpu_torch.benchmarks import dp_parity
from l2hmc_tpu_torch.lattice import u1 as tu1
from l2hmc_tpu_torch.parallel import dryrun, mesh as tmesh
from l2hmc_tpu_torch.train import checkpoint as tckpt
from l2hmc_tpu_torch.train import gauge as tgauge
from l2hmc_tpu_torch.utils import io as tio
from tests.test_torch_ensembles import _hmc_draws, _jax_u0, _u1_x
from tests.test_torch_train import (B, _find_adam, _jax_draws, _jax_leaves,
                                    _kw, _port_layout, _states)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SHAPE4 = ju1.LatticeShape(4, 4)
SMC_N, SMC_LF, SMC_MOVES = 16, 3, 2
SMC_BETAS = [1.0, 1.5, 2.0, 2.5]

# the train-step case (one JAX compile): the dual-averaging warmup, whose
# eps update reads the global mean acceptance, its handoff at step 2 and
# a trained eps after it, with an instanton hop per step
DP_CASES = {"eps_warmup_hops": dict(eps_trainable=True, eps_warmup_steps=2,
                                    train_hops=True)}
DP_STEPS = 3

CLI_ARGV = ["--device", "cpu", "--time_size", "4", "--space_size", "4",
            "--num_samples", "8", "--num_steps", "2", "--network_arch",
            "mlp", "--num_hidden", "16", "--train_steps", "10",
            "--logging_steps", "5", "--save_steps", "5", "--run_steps",
            "5", "--seed", "3", "--eval_init", "random"]
# --autotune with its search cut to one cell per tuner and short probes
TUNE_ARGV = CLI_ARGV + ["--autotune", "--autotune_probe_steps", "5"]
TUNE_CUT = {"train_chunk": 5,
            "hmc": dict(k_grid=(3,), da_steps=5, eps_grid=(1.0,),
                        probe_steps=50, estimator="lag1"),
            "l2hmc": dict(k_grid=(2,), eps_grid=(1.0,), probe_steps=50,
                          estimator="lag1")}


# ---------------------------------------------------------------------------
# References computed by the parent
# ---------------------------------------------------------------------------


def _dp_case(case, root: Path):
    """JAX's steps and the port state + global draws for the ranks."""
    kw = _kw(**DP_CASES[case])
    jcfg, js, tcfg, ts = _states(kw)
    state_dir = root / f"state_{case}"
    tckpt.save_checkpoint(state_dir, ts, 0, tcfg)
    jstep = jax.jit(jgauge.make_train_step(jcfg))
    draws, jmetrics = [], []
    for i in range(DP_STEPS):
        key = jax.random.fold_in(jax.random.PRNGKey(5), i)
        draws.append(_jax_draws(key, B, tcfg.x_dim, tcfg.train_hops))
        js, jm = jstep(js, key)
        jmetrics.append({k: float(v) for k, v in jm.items()})
    return {"args": (tgauge.dataclasses.asdict(tcfg), str(state_dir),
                     draws),
            "jax": (js, jmetrics), "tcfg": tcfg}


def _smc_jax(threshold):
    """JAX's ladder on 16 particles and its draws, replayed."""
    x0 = _u1_x(8, SMC_N)
    jpot = ju1.make_potential_fn(SHAPE4)
    key = jax.random.PRNGKey(21)
    jmove = jsmc.make_u1_hmc_move(jpot, ju1.wrap, 16, SMC_LF, SMC_MOVES)
    want, want_ess = jsmc.smc_beta_ladder(
        key, jnp.asarray(x0), jpot, jnp.asarray(SMC_BETAS), jmove,
        ess_threshold=threshold)
    u0s, move_draws = [], []
    for k in jax.random.split(key, len(SMC_BETAS) - 1):
        kr, km = jax.random.split(k)
        u0s.append(torch.tensor(np.asarray(_jax_u0(kr, SMC_N))))
        move_draws.append([_hmc_draws(kk, x0.shape)
                           for kk in jax.random.split(km, SMC_MOVES)])
    args = (torch.from_numpy(x0), SMC_BETAS, SMC_LF, SMC_MOVES, threshold,
            u0s, move_draws)
    return args, (want, want_ess)


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel")
    return {"root": root,
            "dp": {c: _dp_case(c, root) for c in DP_CASES},
            "smc": {t: _smc_jax(t) for t in (0.5, 2.0)}}


def _tasks(refs, n, cli_dir=None):
    """``{name: (fn, args)}`` of the rank checks at world size ``n``."""
    tasks = {"info": (dryrun.rank_info, ())}
    tasks.update({c: (dryrun.replay_train_steps, refs["dp"][c]["args"])
                  for c in DP_CASES})
    if n == 2:
        tasks.update({f"smc{t}": (dryrun.sharded_smc, refs["smc"][t][0])
                      for t in (0.5, 2.0)})
        # no move, resampling forced: the particles sit at the indices
        x0, _, _, _, _, u0s, _ = refs["smc"][2.0][0]
        tasks["smc_idx"] = (dryrun.sharded_smc,
                            (x0, SMC_BETAS[:2], SMC_LF, 0, 2.0, u0s[:1]))
        # the generator's own draws, the fused move (the plain chain here)
        tasks["smc_fused"] = (dryrun.sharded_smc, (
            torch.from_numpy(_u1_x(9, SMC_N)), SMC_BETAS, SMC_LF, SMC_MOVES,
            0.5, None, None, 4, True))
        tasks["cli"] = (dryrun.train_gauge_cli,
                        (CLI_ARGV + ["--log_dir", str(cli_dir)],))
        tasks["cli_tune"] = (dryrun.autotuned_train_gauge_cli, (
            TUNE_ARGV + ["--log_dir", str(cli_dir.parent / "cli2_tune")],
            TUNE_CUT))
    return tasks


@pytest.fixture(scope="module")
def ranks2(refs):
    """Every two-rank check, one spawn: the dry run's modes, train-step
    replays, sharded SMC and the CLI.  ``{name: result}`` per rank."""
    cli_dir = refs["root"] / "cli2"
    tasks = {"modes": (dryrun.run_modes,
                       (2, "cpu", str(refs["root"] / "modes2"))),
             **_tasks(refs, 2, cli_dir)}
    out = dryrun.spawn_local(dryrun.run_tasks, 2,
                             args=(list(tasks.values()),))
    return [dict(zip(tasks, r)) for r in out], cli_dir


@pytest.fixture(scope="module")
def ranks4(refs):
    """``dryrun_multichip(4)``, the four-rank checks on its ranks: rank 0's
    ``{name: result}``."""
    tasks = _tasks(refs, 4)
    res = dryrun.dryrun_multichip(4, workdir=str(refs["root"] / "modes4"),
                                  tasks=list(tasks.values()))
    return {"modes": res, **dict(zip(tasks, res["tasks"]))}


def _rank0(n, ranks2, ranks4):
    return ranks2[0][0] if n == 2 else ranks4


# ---------------------------------------------------------------------------
# Repairs: the device and the primary follow the rank
# ---------------------------------------------------------------------------


def test_torch_resolve_device_follows_local_rank(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert _device.resolve_device(None) == torch.device("cuda", 1)
    monkeypatch.delenv("LOCAL_RANK")
    assert _device.resolve_device(None) == torch.device("cuda", 0)
    assert _device.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        _device.resolve_device(None)


@pytest.mark.parametrize("n", [2, 4])
def test_torch_ranks_know_their_rank_and_primary(n, ranks2, ranks4):
    """``is_primary`` is true on global rank 0 only (and with no group);
    ``local_rank`` follows the rank."""
    infos = ([r["info"] for r in ranks2[0]] if n == 2
             else [ranks4["info"]])
    assert tio.is_primary() and tmesh.is_primary()   # no group here
    for rank, info in enumerate(infos):
        assert info == {"rank": rank, "world": n, "primary": rank == 0,
                        "local_rank": rank}


def test_torch_mesh_without_a_group(monkeypatch):
    """One rank without a process group: every sharding is the identity
    (``lattice_sharding``'s slab is the whole lattice); a mesh that does
    not cover the ranks and an uneven chain split raise; the launcher
    bring-up is a no-op without ``WORLD_SIZE``."""
    mesh = tmesh.get_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "space": 1}
    assert mesh.groups == {"data": None, "space": None}
    x = torch.arange(12.0).reshape(6, 2)
    assert torch.equal(tmesh.shard_chains(x, mesh), x)
    assert torch.equal(tmesh.gather_chains(x, mesh), x)
    with pytest.raises(ValueError, match="does not cover"):
        tmesh.get_mesh(num_data=2, device="cpu")
    sp = tmesh.lattice_sharding(mesh, tu1.LatticeShape(4, 2))
    assert (sp.n, sp.t0, sp.lt_blk, sp.cols) == (1, 0, 4, slice(0, 16))
    assert torch.equal(sp.shard(torch.arange(32.0).reshape(2, 16)),
                       torch.arange(32.0).reshape(2, 16))
    # 'space' innermost: rank 3 of a 2x2 mesh sits at (1, 1)
    two = tmesh.Mesh({"data": 2, "space": 2}, {"data": 1, "space": 0},
                     {"data": None, "space": None},
                     {"data": [0, 2], "space": [2, 3]}, torch.device("cpu"))
    assert torch.equal(tmesh.shard_chains(x[:4], two), x[2:4])
    with pytest.raises(ValueError, match="do not split"):
        tmesh.shard_chains(x[:5], two)
    assert two.peer("space", 1) == 3 and two.peer("space", -1) == 3
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert tmesh.initialize_distributed("cpu") is False


# ---------------------------------------------------------------------------
# The data-parallel train step against JAX's single-device step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", sorted(DP_CASES))
def test_torch_dp_train_steps_match_jax(case, n, refs, ranks2, ranks4):
    """n ranks, each its slice of 8 chains, 3 steps from the same state and
    JAX's draws: per-step loss and global metrics, final params, chain
    state and dual averaging against JAX, and against the one-process
    port."""
    ref = refs["dp"][case]
    js, jmetrics = ref["jax"]
    got = _rank0(n, ranks2, ranks4)[case]
    alone = dryrun.replay_train_steps(*ref["args"])
    eps_rtol = 1e-3 if ref["tcfg"].eps_warmup_steps else 1e-6
    for tm, am, jm in zip(got["metrics"], alone["metrics"], jmetrics):
        assert tm["loss"] == pytest.approx(jm["loss"], rel=1e-4)
        assert tm["loss"] == pytest.approx(am["loss"], rel=1e-5)
        assert tm["eps"] == pytest.approx(jm["eps"], rel=eps_rtol)
        assert tm["eps"] == pytest.approx(am["eps"], rel=1e-5)
        for key in ("accept_prob", "dq", "actions", "plaqs", "charges2"):
            assert tm[key] == pytest.approx(jm[key], abs=2e-4), key
            assert tm[key] == pytest.approx(am[key], rel=1e-5,
                                            abs=1e-6), key
    lr = jmetrics[-1]["lr"]
    jl = _jax_leaves(js.params)
    template = tgauge.init_train_state(ref["tcfg"],
                                       torch.Generator().manual_seed(0),
                                       "cpu")
    for name, v in got["params"].items():
        want = _port_layout(template.params, name, jl[name])
        tol = 5e-3 * lr + 1e-7 if name != "raw_eps" else None
        if tol is None:
            np.testing.assert_allclose(v.numpy(), want, rtol=eps_rtol,
                                       atol=5e-3 * lr)
        else:
            np.testing.assert_allclose(v.numpy(), want, atol=tol,
                                       err_msg=name)
        np.testing.assert_allclose(v.numpy(), alone["params"][name].numpy(),
                                   atol=1e-6, err_msg=name)
    np.testing.assert_allclose(got["x"].numpy(), np.asarray(js.x), atol=2e-4)
    np.testing.assert_allclose(got["x"].numpy(), alone["x"].numpy(),
                               atol=1e-6)
    assert got["step"] == int(js.step) == DP_STEPS
    for a, b, c in zip(got["da"], js.da, alone["da"]):
        assert float(a) == pytest.approx(float(b), rel=eps_rtol, abs=1e-6)
        assert float(a) == pytest.approx(float(c), rel=1e-5, abs=1e-7)
    assert _find_adam(js.opt_state) is not None


# ---------------------------------------------------------------------------
# The dry run's modes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
def test_torch_dryrun_modes_match_no_group(n, refs, ranks2, ranks4):
    """The six modes on n ranks meet the JAX dry run's assertions
    (``dryrun_multichip(4)`` checks them itself) and equal the same
    computation on one process holding the whole batch (mode 3 on a
    ``(n/2, 2)`` mesh against one rank)."""
    res = _rank0(n, ranks2, ranks4)["modes"]
    dryrun.check_modes(res, n)
    ref = dryrun.run_modes(n, "cpu")
    assert res["lattice_step"]["mesh"] == {"data": n // 2, "space": 2}
    for mode in ("train_step", "lattice_step"):
        tr, rt = res[mode], ref[mode]
        assert tr["loss"] == pytest.approx(rt["loss"], rel=1e-5), mode
        np.testing.assert_allclose(tr["x"].numpy(), rt["x"].numpy(),
                                   atol=1e-6, err_msg=mode)
        np.testing.assert_allclose(tr["params"].numpy(),
                                   rt["params"].numpy(), atol=1e-6,
                                   err_msg=mode)
    for key in ("action", "grad", "wgrad", "plaqs", "charges"):
        np.testing.assert_allclose(res["domain"][key].numpy(),
                                   ref["domain"][key].numpy(), atol=1e-4)
    assert res["flow"]["loss"] == pytest.approx(ref["flow"]["loss"],
                                                rel=1e-5)
    np.testing.assert_allclose(res["flow"]["grads"].numpy(),
                               ref["flow"]["grads"].numpy(), atol=1e-5)
    assert res["smc"]["log_z"] == pytest.approx(ref["smc"]["log_z"],
                                                abs=1e-4)
    np.testing.assert_allclose(res["smc"]["x"].numpy(),
                               ref["smc"]["x"].numpy(), atol=1e-5)


@pytest.mark.parametrize("n", [2, 4])
def test_torch_checkpoint_written_by_ranks_restores_in_one_process(
        n, refs, ranks2, ranks4):
    """Mode 6's checkpoint, saved by rank 0 from n ranks (the chains
    gathered), restores bit for bit with no group: the full chains and the
    params of mode 1's state."""
    res = _rank0(n, ranks2, ranks4)["modes"]
    ck = Path(res["checkpoint"]["dir"])
    cfg = tgauge.config_from_dict(tckpt.load_config_dict(ck))
    template = tgauge.init_train_state(cfg, torch.Generator().manual_seed(7),
                                       "cpu")
    state = tckpt.restore_checkpoint(ck, template)
    assert torch.equal(state.x, res["train_step"]["x"])
    flat = torch.cat([v.detach().reshape(-1) for v in
                      tgauge.named_leaves(state.params).values()])
    assert torch.equal(flat, res["train_step"]["params"])
    assert state.step == 1


# ---------------------------------------------------------------------------
# SMC with the population sharded over two ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("threshold", [0.5, 2.0])
def test_torch_sharded_smc_matches_unsharded_and_jax(threshold, refs,
                                                     ranks2):
    """3 rungs on 16 particles with JAX's draws replayed: log Z, the ESS
    trace, the particles and log-weights of 2 ranks against the port's
    unsharded ladder (the same draws) and against JAX's ladder."""
    args, (want, want_ess) = refs["smc"][threshold]
    got = ranks2[0][0][f"smc{threshold}"]
    alone = dryrun.sharded_smc(*args)
    assert got["log_z"] == alone["log_z"]
    assert torch.equal(got["ess"], alone["ess"])
    assert torch.equal(got["x"], alone["x"])
    assert torch.equal(got["log_w"], alone["log_w"])
    assert got["log_z"] == pytest.approx(float(want.log_z), abs=1e-4)
    np.testing.assert_allclose(got["ess"].numpy(), np.asarray(want_ess),
                               rtol=1e-5)
    np.testing.assert_allclose(got["x"].numpy(), np.asarray(want.x),
                               atol=1e-4)
    np.testing.assert_allclose(got["log_w"].numpy(),
                               np.asarray(want.log_w), atol=1e-4)


def test_torch_sharded_smc_resamples_the_global_indices(refs, ranks2):
    """With no move and resampling forced, one rung on 2 ranks leaves the
    particles at JAX's systematic ancestor indices, formed from the
    gathered weights."""
    x0 = refs["smc"][2.0][0][0]
    k0 = jax.random.split(jax.random.PRNGKey(21), 1)[0]
    kr, _ = jax.random.split(k0)
    lw = -np.float32(0.5) * ju1.make_potential_fn(SHAPE4)(
        jnp.asarray(x0.numpy()))
    idx = np.asarray(jsmc.systematic_resample(kr, lw))
    got = ranks2[0][0]["smc_idx"]
    assert torch.equal(got["x"], x0[torch.from_numpy(idx.copy())])


def test_torch_sharded_fused_smc_repeats_the_one_process_draws(ranks2):
    """The fused move's generator draws (the plain chain on the CPU) for
    the global population, sliced: 2 ranks repeat the one-process
    ladder."""
    got = ranks2[0][0]["smc_fused"]
    alone = dryrun.sharded_smc(torch.from_numpy(_u1_x(9, SMC_N)), SMC_BETAS,
                               SMC_LF, SMC_MOVES, 0.5, None, None, 4, True)
    assert got["log_z"] == pytest.approx(alone["log_z"], abs=1e-5)
    np.testing.assert_allclose(got["x"].numpy(), alone["x"].numpy(),
                               atol=1e-6)


# ---------------------------------------------------------------------------
# The CLI on two ranks against the one-process CLI
# ---------------------------------------------------------------------------


def _records(run_dir):
    return [json.loads(line) for line in
            (run_dir / "metrics.jsonl").read_text().splitlines()]


def test_torch_cli_on_two_ranks_reproduces_one_process(tmp_path, ranks2):
    """``train_gauge`` on 2 gloo ranks (tiny MLP config, seed 3) against
    the same command in one process: every metrics record, the final
    checkpoint and the eval summaries, to all-reduce rounding; rank 0
    alone made the run dir."""
    from l2hmc_tpu_torch.cli import train_gauge

    ranks, cli_dir = ranks2
    assert [r["cli"] for r in ranks] == [0, 0]
    assert train_gauge.main(CLI_ARGV + ["--log_dir", str(tmp_path)]) == 0
    one, two = tmp_path / "run_1", cli_dir / "run_1"
    assert sorted(p.name for p in cli_dir.iterdir()) == ["run_1"]
    assert sorted(p.name for p in two.iterdir()) == sorted(
        p.name for p in one.iterdir())
    for a, b in zip(_records(two), _records(one), strict=True):
        assert set(a) == set(b)
        for key in a:
            if key != "dt":
                assert a[key] == pytest.approx(b[key], rel=1e-5,
                                               abs=1e-6), key
    cfg = tgauge.config_from_dict(tckpt.load_config_dict(one /
                                                         "checkpoints"))
    states = [tckpt.restore_checkpoint(
        d / "checkpoints", tgauge.init_train_state(
            cfg, torch.Generator().manual_seed(0), "cpu"))
        for d in (one, two)]
    assert states[0].step == states[1].step == 10
    np.testing.assert_allclose(states[1].x.numpy(), states[0].x.numpy(),
                               atol=1e-5)
    for k, v in tgauge.named_leaves(states[0].params).items():
        np.testing.assert_allclose(
            tgauge.named_leaves(states[1].params)[k].detach().numpy(),
            v.detach().numpy(), atol=1e-6, err_msg=k)
    for beta in ("4", "3"):
        a = json.loads((two / f"eval_beta{beta}.json").read_text())
        b = json.loads((one / f"eval_beta{beta}.json").read_text())
        assert a["plaqs"]["mean"] == pytest.approx(b["plaqs"]["mean"],
                                                   abs=1e-5)
        assert a["accept_prob"]["mean"] == pytest.approx(
            b["accept_prob"]["mean"], abs=1e-5)


def test_torch_cli_autotune_on_two_ranks_tunes_once(tmp_path, refs, ranks2):
    """``--autotune`` on 2 gloo ranks: rank 0 alone runs the search (its
    cells are scored by wall-clock rates, so two searches could disagree)
    and every rank trains its winner, as one process does with the same
    cut search: the same tuned config and every metrics record to
    all-reduce rounding."""
    ranks, _ = ranks2
    assert [r["cli_tune"] for r in ranks] == [(0, 1), (0, 0)]
    assert dryrun.autotuned_train_gauge_cli(
        TUNE_ARGV + ["--log_dir", str(tmp_path)], TUNE_CUT) == (0, 1)
    one, two = tmp_path / "run_1", refs["root"] / "cli2_tune" / "run_1"
    cfgs = [tckpt.load_config_dict(d / "checkpoints") for d in (one, two)]
    assert cfgs[0] == cfgs[1]
    assert cfgs[0]["num_steps"] == 2 and cfgs[0]["eps_trainable"] is False
    for a, b in zip(_records(two), _records(one), strict=True):
        for key in set(a) - {"dt"}:
            assert a[key] == pytest.approx(b[key], rel=1e-5, abs=1e-6), key
    # benchmarks/dp_parity.py's record-by-record comparison agrees
    parity = dp_parity.compare(two, one)
    assert parity["records"] == 2 and parity["first_step_apart_1e-3"] is None
    assert max(parity["max_rel_first_2"].values()) < 1e-5


# ---------------------------------------------------------------------------
# No JAX in the port's parallel and flow modules, nor in spawned ranks
# ---------------------------------------------------------------------------


def test_torch_parallel_and_flow_modules_import_no_jax(tmp_path):
    """A fresh interpreter imports the parallel and flow modules and runs
    the dry run on two spawned gloo ranks; neither it nor its ranks import
    jax, the JAX package or a test module."""
    code = r"""
import sys
import torch
torch.set_num_threads(1)
from l2hmc_tpu_torch.parallel import dryrun, domain, mesh
from l2hmc_tpu_torch.dynamics import flow
from l2hmc_tpu_torch.cli import train_flow
from l2hmc_tpu_torch.benchmarks import config5_multihost, flow_hybrid
res = dryrun.spawn_local(dryrun.run_tasks, 2, args=(
    [(dryrun.run_modes, (2, "cpu", sys.argv[1])),
     (dryrun.imported_roots, ())],))
dryrun.check_modes(res[0][0], 2)
assert dryrun.imported_roots() == [], dryrun.imported_roots()
assert [r[1] for r in res] == [[], []], [r[1] for r in res]
print("NOJAX_OK")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NOJAX_OK" in proc.stdout


# ---------------------------------------------------------------------------
# BASELINE config 5 alone
# ---------------------------------------------------------------------------


def _json_dumps_keys(path: Path):
    """String keys of each dict literal passed to ``json.dumps`` in
    ``path``, in order."""
    import ast

    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
                == "dumps" and node.args
                and isinstance(node.args[0], ast.Dict)):
            out.append((node.lineno, [k.value for k in node.args[0].keys]))
    return [keys for _, keys in sorted(out)]


def test_torch_config5_alone_prints_the_jax_keys(capsys):
    """``python -m l2hmc_tpu_torch.benchmarks.config5_multihost`` on one
    process, tiny: one JSON line per phase with the JAX script's keys."""
    from l2hmc_tpu_torch.benchmarks import config5_multihost

    assert config5_multihost.main([
        "--device", "cpu", "--size", "4", "--hidden", "8", "--train_steps",
        "4", "--chunk", "2", "--chains_per_device", "4",
        "--particles_per_device", "8", "--betas", "3", "--smc_move",
        "l2hmc"]) == 0
    lines = [json.loads(line) for line in
             capsys.readouterr().out.strip().splitlines()]
    assert [list(line) for line in lines] == _json_dumps_keys(
        REPO / "benchmarks" / "config5_multihost.py")
    assert lines[0]["one_device"] == lines[0]["all_devices"]
    assert lines[1]["devices"] == 1 and lines[1]["move"] == "l2hmc"
