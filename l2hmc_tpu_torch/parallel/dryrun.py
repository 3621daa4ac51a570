"""The multi-device dry run (the port's twin of
``__graft_entry__.dryrun_multichip``) and the rank workers that run the
port's data-parallel paths on locally spawned ranks.

Run on n ranks and held against the same modes with no group, one JSON
line (times, largest differences, the card)::

    python -m l2hmc_tpu_torch.parallel.dryrun --ranks 4   # NCCL, a card each
    python -m l2hmc_tpu_torch.parallel.dryrun --ranks 4 --device cpu   # gloo

:func:`spawn_local` starts n ranks with ``torch.multiprocessing.spawn``;
the group is initialized by ``file://`` rendezvous in a temporary
directory, so concurrent runs never contend for a TCP port.  The workers
live here, so a spawned child imports the port and nothing else.

:func:`dryrun_multichip` runs the reference's six sharding modes
(:func:`run_modes`) on n ranks and holds them to the reference's own
assertions (:func:`check_modes`); mode 3 is dp x sp of the full train step
on a ``(n/2, 2)`` mesh (``parallel.mesh.lattice_sharding``).

Every mode draws its inputs for the GLOBAL batch from one seeded generator
and slices them, so the same call with no process group (one rank holding
everything) is the yardstick an n-rank run is held against.
"""

from __future__ import annotations

import os
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

# ---------------------------------------------------------------------------
# Spawning
# ---------------------------------------------------------------------------


def _rank_main(rank, fn, n, backend, device, init_file, out_dir, args):
    os.environ["LOCAL_RANK"] = str(rank)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank)
    torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=n)
    try:
        out = fn(*args)
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn_local(fn, n: int, backend: str = "gloo", device="cpu", args=()):
    """Run ``fn(*args)`` on ``n`` spawned ranks of one process group
    (``backend`` 'gloo' on the CPU, 'nccl' with a card per rank) and return
    each rank's result, in rank order.  ``fn`` must be importable (a module
    function) and its result ``torch.save``-able."""
    with tempfile.TemporaryDirectory() as td:
        torch.multiprocessing.spawn(
            _rank_main, args=(fn, n, backend, str(device),
                              os.path.join(td, "rendezvous"), td, args),
            nprocs=n, join=True)
        return [torch.load(Path(td) / f"rank{r}.pt", weights_only=False)
                for r in range(n)]


def _mesh(device, num_space=1):
    from l2hmc_tpu_torch.parallel.mesh import get_mesh

    return get_mesh(num_space=num_space, device=device)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# The dry run's modes
# ---------------------------------------------------------------------------


def mode_train_step(n: int, device, seed: int = 0, plain: bool = False):
    """Mode 1: one data-parallel train step, 4x4 MLP h16, K=2, 2n chains;
    ``plain``: on the plain Wilson potential.  Returns ``(numbers, cfg,
    state)`` with the state's chains this rank's."""
    from l2hmc_tpu_torch.ops.wilson import make_plain_potential_fn
    from l2hmc_tpu_torch.parallel.mesh import gather_chains, shard_train_state
    from l2hmc_tpu_torch.train.gauge import (GaugeConfig, init_train_state,
                                             make_train_step, named_leaves)

    mesh = _mesh(device)
    cfg = GaugeConfig(time_size=4, space_size=4, num_chains=2 * n,
                      num_steps=2, network_arch="mlp", num_hidden=16,
                      train_steps=10)
    gen = torch.Generator(device=device).manual_seed(seed)
    state = shard_train_state(init_train_state(cfg, gen, device), mesh)
    pot = make_plain_potential_fn(cfg.shape) if plain else None
    step, _ = make_train_step(cfg, pot, mesh=mesh)
    state, m = step(state, gen)
    leaves = named_leaves(state.params)
    return {"loss": float(m["loss"]), "accept_prob": float(m["accept_prob"]),
            "x": gather_chains(state.x, mesh).cpu(),
            "params": torch.cat([v.detach().reshape(-1).cpu()
                                 for v in leaves.values()])}, cfg, state


def mode_lattice_step(n: int, device, seed: int = 0, plain: bool = False):
    """Mode 3: mode 1's train step (4x4 MLP h16, K=2, 2n chains) with the
    chains over 'data' and the lattice's time rows over 'space' on a
    ``(n / n_sp, n_sp)`` mesh, ``n_sp = min(2, n)``, as
    ``__graft_entry__.py:113-130`` runs it (with no process group: one rank
    holding everything, the same code with its halos wrapped locally);
    ``plain``: on the slab route's plain versions.  Returns the loss, the
    acceptance, the gathered chains and the parameters."""
    from l2hmc_tpu_torch.ops.wilson import make_slab_potential_fn
    from l2hmc_tpu_torch.parallel.mesh import (lattice_sharding,
                                               shard_train_state)
    from l2hmc_tpu_torch.train.gauge import (GaugeConfig, init_train_state,
                                             make_train_step, named_leaves)

    world = dist.get_world_size() if dist.is_initialized() else 1
    mesh = _mesh(device, min(2, n) if world > 1 else 1)
    cfg = GaugeConfig(time_size=4, space_size=4, num_chains=2 * n,
                      num_steps=2, network_arch="mlp", num_hidden=16,
                      train_steps=10)
    sp = lattice_sharding(mesh, cfg.shape)
    gen = torch.Generator(device=device).manual_seed(seed)
    state = shard_train_state(init_train_state(cfg, gen, device), mesh, sp)
    pot = make_slab_potential_fn(cfg.shape, sp, plain=True) if plain else None
    step, _ = make_train_step(cfg, pot, mesh=mesh, sharding=sp)
    state, m = step(state, gen)
    leaves = named_leaves(state.params)
    return {"loss": float(m["loss"]), "accept_prob": float(m["accept_prob"]),
            "x": sp.gather(state.x).cpu(), "mesh": dict(mesh.shape),
            "params": torch.cat([v.detach().reshape(-1).cpu()
                                 for v in leaves.values()])}


def domain_numbers(links: torch.Tensor, weights: torch.Tensor, device,
                   num_space: int):
    """The domain action of global ``links (B, Lt, Lx, 2)`` on a mesh of
    ``num_space`` 'space' ranks: value, gradient and ``weights``-weighted
    gradient (gathered to the global lattice), observables."""
    from l2hmc_tpu_torch.lattice import u1
    from l2hmc_tpu_torch.parallel.domain import make_domain_action

    world = dist.get_world_size() if dist.is_initialized() else 1
    mesh = _mesh(device, num_space) if world > 1 else _mesh(device)
    shape = u1.LatticeShape(links.shape[1], links.shape[2])
    dom = make_domain_action(mesh, shape)
    blk = dom["sharding"](links.to(device)).detach().requires_grad_(True)
    act = dom["action"](blk)
    (grad,) = torch.autograd.grad(torch.sum(act), blk)
    (wgrad,) = torch.autograd.grad(
        torch.sum(weights.to(device) * dom["action"](blk)), blk)

    def gather_time(t):
        return mesh.all_gather(t.transpose(0, 1).contiguous(),
                               "space").transpose(0, 1).cpu()

    obs = dom["observables"](blk.detach())
    act = act.detach()
    return {"action": act.cpu(), "value": float(torch.sum(act)),
            "grad": gather_time(grad), "wgrad": gather_time(wgrad),
            **{k: v.cpu() for k, v in obs.items()}}


def mode_flow_step(n: int, device, seed: int = 0, plain: bool = False):
    """Mode 4: the flow's reverse-KL loss and gradient (beta=1) on a
    'data'-sharded batch of 4n base samples, 4x4, 8 layers, 3 mixtures,
    8 channels; the gradients are all-reduced as a mean over 'data'.
    ``plain``: on the plain Wilson action."""
    from l2hmc_tpu_torch.dynamics import flow as F
    from l2hmc_tpu_torch.ops import wilson
    from l2hmc_tpu_torch.parallel.mesh import replicate, shard_chains

    mesh = _mesh(device)
    cfg = F.FlowConfig(time_size=4, space_size=4, num_layers=8, n_mix=3,
                       hidden_channels=8)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = replicate(F.init_flow(gen, cfg, device), mesh)
    # a flow at its identity init has a zero c1 gradient: move the output
    # convs off zero, from the same generator on every rank
    with torch.no_grad():
        for layer in params:
            layer.c2.w.copy_(0.3 * torch.randn(layer.c2.w.shape,
                                               generator=gen, device=device))
    z = shard_chains(F.draw_base(gen, 4 * n, cfg, device), mesh)
    loss, aux = F.reverse_kl_loss_with(
        params, z, 1.0, cfg,
        wilson.wilson_action if plain else F.wilson_action)
    named = dict(params.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()))
    flat = mesh.all_reduce(torch.cat([g.reshape(-1) for g in grads]),
                           "data", "mean")
    return {"loss": float(mesh.all_reduce(loss.detach(), "data", "mean")),
            "grads": flat.cpu(),
            "c1_grad_finite": bool(torch.isfinite(
                grads[list(named).index("0.c1.w")]).all())}


def mode_smc(n: int, device, seed: int = 0, moves: str = "philox"):
    """Mode 5: SMC over 6 rungs, beta 1 -> 2, at 4x4, 8n particles sharded
    over 'data', two fused HMC moves (K=4) per rung: one ``hmc_chain``
    launch per rung on each rank on the card.  ``moves`` (see
    :func:`run_modes`): "injected" runs the chain on the generator's
    draws; "plain" runs its plain version on them and reweights on the
    plain action."""
    from l2hmc_tpu_torch.dynamics.smc import (hmc_chain_on_draws,
                                              make_u1_fused_move,
                                              smc_beta_ladder,
                                              u1_log_z_exact_factorized)
    from l2hmc_tpu_torch.lattice import u1
    from l2hmc_tpu_torch.ops.leapfrog import hmc_chain_reference
    from l2hmc_tpu_torch.ops.wilson import (make_plain_potential_fn,
                                            make_potential_fn)
    from l2hmc_tpu_torch.parallel.mesh import gather_chains, shard_chains

    mesh = _mesh(device)
    shape = u1.LatticeShape(4, 4)
    gen = torch.Generator(device=device).manual_seed(seed + 5)
    x0 = shard_chains(u1.random_links(gen, 8 * n, shape, device=device),
                      mesh)
    chain = {"philox": None, "injected": hmc_chain_on_draws,
             "plain": hmc_chain_reference}[moves]
    pot = (make_plain_potential_fn if moves == "plain"
           else make_potential_fn)(shape)
    move = make_u1_fused_move(shape, 4, 2, mesh=mesh, chain=chain)
    final, ess = smc_beta_ladder(gen, x0, pot,
                                 np.linspace(1.0, 2.0, 6), move, mesh=mesh)
    return {"log_z": float(final.log_z),
            "log_z_exact": u1_log_z_exact_factorized(
                shape.num_plaquettes, 1.0, 2.0),
            "ess": ess.cpu(), "x": gather_chains(final.x, mesh).cpu()}


def mode_checkpoint(cfg, state, workdir, device):
    """Mode 6: the data-parallel train state saved (gathered, by rank 0)
    and restored on the same ranks (re-sliced)."""
    from l2hmc_tpu_torch.parallel.mesh import shard_train_state
    from l2hmc_tpu_torch.train import checkpoint as ckpt
    from l2hmc_tpu_torch.train.gauge import init_train_state, named_leaves

    mesh = _mesh(device)
    ckpt_dir = Path(workdir) / "mode6"
    ckpt.save_checkpoint(ckpt_dir, state, int(state.step), cfg, mesh=mesh)
    template = shard_train_state(
        init_train_state(cfg, torch.Generator(device=device).manual_seed(1),
                         device), mesh)
    restored = ckpt.restore_checkpoint(ckpt_dir, template, mesh=mesh)
    want, got = named_leaves(state.params), named_leaves(restored.params)
    same = all(torch.equal(want[k], got[k]) for k in want)
    return {"params_equal": same and torch.equal(restored.x, state.x),
            "step": int(restored.step), "want_step": int(state.step),
            "dir": str(ckpt_dir)}


def run_modes(n: int, device="cpu", workdir=None, seed: int = 0,
              moves: str = "philox"):
    """The six modes at the reference dry run's shapes for ``n``
    'data' ranks, in the current process group (or with none: one process
    holding the whole batch).  ``workdir`` (mode 6's checkpoints) must be
    one directory for every rank; ``None``: a temporary one, with no
    group only.  Returns ``{mode: numbers}`` with each
    mode's ``seconds`` (host clock, the device synchronized).

    ``moves`` holds the kernels of modes 1, 3, 4 and 5 against their plain
    versions: "philox" is the path as it runs; "injected" the same but
    mode 5's chain on the generator's draws; "plain" every mode on the
    plain Wilson action (mode 3 on the slab route's plain versions) and
    mode 5's chain the plain version on those draws."""
    from l2hmc_tpu_torch.ops.wilson import wilson_action

    device = torch.device(device)
    out = {}

    def timed(name, fn):
        _sync(device)
        t0 = time.perf_counter()
        res = fn()
        _sync(device)
        dt = time.perf_counter() - t0
        out[name] = res[0] if isinstance(res, tuple) else res
        out[name]["seconds"] = dt
        return res

    plain = moves == "plain"
    _, cfg, state = timed("train_step",
                          lambda: mode_train_step(n, device, seed, plain))
    timed("lattice_step", lambda: mode_lattice_step(n, device, seed, plain))
    n_dom = min(4, n)
    gen = torch.Generator().manual_seed(seed + 2)
    links = -3.0 + 6.0 * torch.rand((4, 4 * n_dom, 8, 2), generator=gen)
    weights = torch.arange(1.0, 5.0)
    timed("domain", lambda: domain_numbers(links, weights, device, n_dom))
    out["domain"]["ref_value"] = float(torch.sum(wilson_action(links)))
    timed("flow", lambda: mode_flow_step(n, device, seed, plain))
    timed("smc", lambda: mode_smc(n, device, seed, moves))
    if workdir is None:
        with tempfile.TemporaryDirectory() as td:
            timed("checkpoint",
                  lambda: mode_checkpoint(cfg, state, td, device))
    else:
        timed("checkpoint",
              lambda: mode_checkpoint(cfg, state, workdir, device))
    return out


def check_modes(res: dict, n: int):
    """The reference dry run's assertions (``__graft_entry__.py:90-130,
    157-158, 184-186, 201-202``); raises ``AssertionError``."""
    tr = res["train_step"]
    assert tr["x"].shape == (2 * n, 32), tr["x"].shape
    assert np.isfinite(tr["loss"]), tr["loss"]
    ls = res["lattice_step"]
    assert ls["x"].shape == (2 * n, 32), ls["x"].shape
    assert np.isfinite(ls["loss"]), ls["loss"]
    dom = res["domain"]
    ref = dom["ref_value"]
    assert abs(dom["value"] - ref) < 1e-2 * max(1.0, abs(ref)), (
        dom["value"], ref)
    assert bool(torch.isfinite(dom["grad"]).all())
    fl = res["flow"]
    assert np.isfinite(fl["loss"]) and fl["c1_grad_finite"], fl
    sm = res["smc"]
    assert np.isfinite(sm["log_z"])
    assert abs(sm["log_z"] - sm["log_z_exact"]) < (
        0.5 * abs(sm["log_z_exact"]) + 5.0), (sm["log_z"], sm["log_z_exact"])
    ck = res["checkpoint"]
    assert ck["params_equal"], "sharded ckpt round-trip mismatch"
    assert ck["step"] == ck["want_step"]


def modes_diff(a: dict, b: dict) -> dict:
    """Largest difference per mode between two :func:`run_modes` results
    (states, gradients and scalars)."""
    keys = {"train_step": ("x", "params"), "lattice_step": ("x", "params"),
            "domain": ("grad", "wgrad"),
            "flow": ("grads",), "smc": ("x",)}
    out = {}
    for mode, ks in keys.items():
        d = max(float((a[mode][k] - b[mode][k]).abs().max()) for k in ks)
        for k in ("loss", "value", "log_z"):
            if k in a[mode]:
                d = max(d, abs(a[mode][k] - b[mode][k]))
        out[mode] = d
    return out


def dryrun_multichip(n: int, backend: str = "gloo", device="cpu",
                     workdir=None, tasks=()) -> dict:
    """Run the six modes on ``n`` spawned ranks
    (:func:`spawn_local`), check them as the reference checks its own, print
    its summary line and return rank 0's numbers.  ``tasks``, ``(fn,
    args)`` pairs, run on the same ranks after the modes (one spawn); their
    rank-0 results are under ``"tasks"``."""
    with tempfile.TemporaryDirectory() as td:
        # the ranks share one directory for mode 6
        todo = [(run_modes, (n, device, workdir or td)), *tasks]
        res, *extra = spawn_local(run_tasks, n, backend, device,
                                  args=(todo,))[0]
    res["tasks"] = extra
    check_modes(res, n)
    n_dom = min(4, n)
    print(f"dryrun_multichip({n}): ok — loss={res['train_step']['loss']:.4f} "
          f"acc={res['train_step']['accept_prob']:.3f} "
          f"dpxsp{tuple(res['lattice_step']['mesh'].values())}_loss="
          f"{res['lattice_step']['loss']:.4f} "
          f"domain_action({n_dom} shards)={res['domain']['value']:.2f} "
          f"(ref {res['domain']['ref_value']:.2f}) "
          f"flow_loss={res['flow']['loss']:.4f} "
          f"smc_logZ={res['smc']['log_z']:.1f} "
          f"(exact {res['smc']['log_z_exact']:.1f}) ckpt=roundtrip-ok")
    return res


# ---------------------------------------------------------------------------
# Rank workers of the port's data-parallel paths
# ---------------------------------------------------------------------------


def _place(t, mesh, sharding):
    """A global draw's part on this rank: chains over 'data', and per-link
    tensors' columns over 'space' with a ``sharding``."""
    from l2hmc_tpu_torch.parallel.mesh import shard_chains

    if t is None:
        return None
    if sharding is not None and t.dim() == 2:
        return sharding.shard(t)
    return shard_chains(t, mesh)


def _sharding(cfg, num_space):
    """``(mesh, sharding)``: a ``(world / num_space, num_space)`` mesh with
    a lattice sharding bound to ``cfg``'s lattice, or the 'data' mesh and
    ``None`` for ``num_space=0``."""
    from l2hmc_tpu_torch.parallel.mesh import lattice_sharding

    if not num_space:
        return _mesh("cpu"), None
    mesh = _mesh("cpu", num_space)
    return mesh, lattice_sharding(mesh, cfg.shape)


def replay_train_steps(cfg_dict: dict, state_dir: str, draws, remat=True,
                       num_space: int = 0, save_dir=None):
    """Restore the checkpoint under ``state_dir`` on this process group's
    'data' ranks and run one data-parallel train step per entry of
    ``draws`` (global ``TrainDraws``, sliced to each rank's chains).
    ``num_space > 0``: dp x sp steps on a ``(world / num_space,
    num_space)`` mesh under ``lattice_sharding`` (the draws' momenta
    sliced to each rank's columns too).  ``save_dir``: the final state
    checkpointed there (gathered).  Returns the per-step metrics (floats),
    the first step's gradients by name (``make_grad_fn``: all-reduced, the
    optimizer's input), the final parameters by name, the gathered chains
    and the dual-averaging state."""
    from l2hmc_tpu_torch.parallel.mesh import gather_chains
    from l2hmc_tpu_torch.train import checkpoint as ckpt
    from l2hmc_tpu_torch.train.gauge import (TrainDraws, build_dynamics,
                                             config_from_dict,
                                             init_train_state, make_grad_fn,
                                             make_train_step, named_leaves)
    from l2hmc_tpu_torch.train.schedules import beta_schedule

    cfg = config_from_dict(cfg_dict)
    mesh, sp = _sharding(cfg, num_space)
    template = init_train_state(cfg, torch.Generator().manual_seed(0),
                                "cpu")
    state = ckpt.restore_checkpoint(state_dir, template, mesh=mesh,
                                    sharding=sp)
    _, step_with = make_train_step(cfg, remat=remat, mesh=mesh, sharding=sp)
    grad_fn = make_grad_fn(cfg, build_dynamics(cfg, None, remat, sp)[1],
                           mesh, sp)
    metrics, grads = [], None
    for d in draws:
        local = TrainDraws(*(_place(t, mesh, sp) for t in d))
        if grads is None:
            beta = beta_schedule(state.step, cfg.train_steps, cfg.beta_init,
                                 cfg.beta_final)
            grads = {k: v.detach().clone() for k, v in grad_fn(
                state.params, state.x, beta, local)[2].items()}
        state, m = step_with(state, local)
        metrics.append({k: float(v) for k, v in m.items()})
    if save_dir is not None:
        ckpt.save_checkpoint(save_dir, state, state.step, cfg, mesh=mesh,
                             sharding=sp)
    return {"metrics": metrics, "grads": grads,
            "params": {k: v.detach().clone()
                       for k, v in named_leaves(state.params).items()},
            "x": (gather_chains(state.x, mesh) if sp is None
                  else sp.gather(state.x)),
            "step": state.step, "da": [t.clone() for t in state.da]}


def sharded_eval_chunk(cfg_dict: dict, state_dir: str, x, beta,
                       steps: int, seed: int, num_space: int = 0):
    """``train.gauge.make_eval_chunk`` of ``steps`` transitions from the
    global chains ``x`` with the checkpointed params, its draws from a
    generator seeded with ``seed`` (global, sliced), under
    ``lattice_sharding`` on a ``(world / num_space, num_space)`` mesh
    (``num_space=0``: one process, unsharded).  Returns the gathered chains
    and the ``(steps, B)`` metrics."""
    from l2hmc_tpu_torch.train import checkpoint as ckpt
    from l2hmc_tpu_torch.train.gauge import (config_from_dict,
                                             init_train_state,
                                             make_eval_chunk)

    cfg = config_from_dict(cfg_dict)
    mesh, sp = (_sharding(cfg, num_space) if num_space else (None, None))
    template = init_train_state(cfg, torch.Generator().manual_seed(0),
                                "cpu")
    params = ckpt.restore_checkpoint(state_dir, template).params
    chunk = make_eval_chunk(cfg, steps, mesh, sp)
    x_loc = x if sp is None else sp.shard(x)
    x_out, metrics = chunk(params, x_loc, beta,
                           torch.Generator().manual_seed(seed))
    return {"x": x_out if sp is None else sp.gather(x_out),
            "metrics": metrics}


def sharded_transition(cfg_dict: dict, state_dir: str, x, draws, beta,
                       num_space: int = 0, baseline=None):
    """One transition of the checkpointed params under ``state_dir`` from
    the global chains ``x (B, x_dim)`` with the global draws ``(v,
    direction, u)``, under ``lattice_sharding`` on a ``(world / num_space,
    num_space)`` mesh (``num_space=0``: unsharded, one process).
    ``baseline=(eps, K)``: the plain-HMC transition of
    ``dynamics/hmc.py`` on the config's potential instead (``v`` and
    ``u`` of the draws).  Returns the gathered ``x_out`` and the accept
    probabilities (and, for L2HMC, ``x_proposed`` and ``sumlogdet``)."""
    from l2hmc_tpu_torch.parallel.mesh import gather_chains
    from l2hmc_tpu_torch.train import checkpoint as ckpt
    from l2hmc_tpu_torch.train.gauge import (build_dynamics,
                                             config_from_dict,
                                             init_train_state)

    cfg = config_from_dict(cfg_dict)
    mesh, sp = _sharding(cfg, num_space) if num_space else (None, None)
    template = init_train_state(cfg, torch.Generator().manual_seed(0),
                                "cpu")
    params = ckpt.restore_checkpoint(state_dir, template).params

    def place(t):
        return t if mesh is None else _place(t, mesh, sp)

    def gather(t):
        if mesh is None:
            return t
        return gather_chains(t, mesh) if sp is None or t.dim() == 1 \
            else sp.gather(t)

    _, dyn = build_dynamics(cfg, sharding=sp)
    v, direction, u = (place(t) for t in draws)
    with torch.no_grad():
        if baseline is not None:
            from l2hmc_tpu_torch.dynamics.hmc import hmc_transition
            from l2hmc_tpu_torch.ops.wilson import (make_potential_fn,
                                                    make_slab_potential_fn)

            eps, k = baseline
            pot = (make_potential_fn(cfg.shape) if sp is None
                   else make_slab_potential_fn(cfg.shape, sp))
            out = hmc_transition(pot, place(x), beta, eps, k, v=v, u=u,
                                 sharding=sp)
            return {"x_out": gather(out.x_out),
                    "accept_prob": gather(out.accept_prob)}
        out = dyn["transition_with"](params, place(x), beta, v, direction, u)
    return {k: gather(getattr(out, k)) for k in
            ("x_out", "x_proposed", "accept_prob", "sumlogdet")}


def sharded_smc(x0: torch.Tensor, betas, leapfrog: int, moves: int,
                threshold: float, u0s=None, move_draws=None, seed: int = 0,
                fused: bool = False):
    """SMC on U(1) with the population ``x0 (n, d)`` sharded over this
    process group's 'data' ranks (or whole, with no group), on the CPU.
    ``u0s`` (one per rung) and ``move_draws`` (per rung, a global ``(v,
    u)`` per move) replace the generator's draws; ``fused`` moves with the
    fused chain instead of the HMC transition.  Returns log Z, the ESS
    trace and the gathered final particles and log-weights."""
    from l2hmc_tpu_torch.dynamics.smc import (make_u1_fused_move,
                                              make_u1_hmc_move,
                                              smc_beta_ladder)
    from l2hmc_tpu_torch.lattice import u1
    from l2hmc_tpu_torch.ops.wilson import make_potential_fn
    from l2hmc_tpu_torch.parallel.mesh import gather_chains, shard_chains

    mesh = _mesh("cpu")
    lt = int(round(np.sqrt(x0.shape[1] // 2)))
    shape = u1.LatticeShape(lt, lt)
    pot = make_potential_fn(shape)
    if fused:
        move = make_u1_fused_move(shape, leapfrog, moves, mesh=mesh)
    else:
        hmc = make_u1_hmc_move(pot, u1.wrap, shape.num_plaquettes, leapfrog,
                               moves, mesh=mesh)
        rung = iter(range(len(betas)))

        def move(x, b, g):
            if move_draws is None:
                return hmc(x, b, g)
            draws = move_draws[next(rung)]
            return hmc(x, b, g, draws=[(shard_chains(v, mesh),
                                        shard_chains(u, mesh))
                                       for v, u in draws])
    gen = torch.Generator().manual_seed(seed)
    final, ess = smc_beta_ladder(gen, shard_chains(x0, mesh), pot, betas,
                                 move, ess_threshold=threshold, u0s=u0s,
                                 mesh=mesh)
    return {"log_z": float(final.log_z), "ess": ess,
            "x": gather_chains(final.x, mesh),
            "log_w": gather_chains(final.log_w, mesh)}


def run_tasks(tasks):
    """Run ``(fn, args)`` pairs in order on this rank, returning their
    results: one spawn for several checks."""
    return [fn(*args) for fn, args in tasks]


def rank_info():
    """This process's global rank, world size, ``utils.io.is_primary()``
    and ``_device.local_rank()``."""
    from l2hmc_tpu_torch._device import local_rank
    from l2hmc_tpu_torch.utils.io import is_primary

    return {"rank": dist.get_rank(), "world": dist.get_world_size(),
            "primary": is_primary(), "local_rank": local_rank()}


def imported_roots(roots=("jax", "l2hmc_tpu", "tests")):
    """The modules of this process under the top-level names ``roots``."""
    import sys

    return sorted(m for m in sys.modules if m.split(".")[0] in roots)


def train_gauge_cli(argv):
    """``python -m l2hmc_tpu_torch.cli.train_gauge`` with ``argv`` on this
    rank (the CLI finds the process group initialized)."""
    from l2hmc_tpu_torch.cli import train_gauge

    return train_gauge.main(list(argv))


def autotuned_train_gauge_cli(argv, tune: dict):
    """:func:`train_gauge_cli` with ``--autotune``'s search cut by ``tune``:
    keyword arguments of ``train.autotune``'s ``tune_hmc`` and
    ``tune_l2hmc`` under the keys "hmc" and "l2hmc", and under
    "train_chunk" the length of the probe trainings' chunks (250).  Returns
    the exit code and the number of searches this rank ran."""
    from l2hmc_tpu_torch.train import autotune, gauge

    saved = autotune.tune_hmc, autotune.tune_l2hmc, gauge.make_train_chunk
    searches = []

    def tune_hmc(*a, **kw):
        searches.append(1)
        return saved[0](*a, **kw, **tune["hmc"])

    def tune_l2hmc(*a, **kw):
        gauge.make_train_chunk = lambda cfg, n, *b, **k: saved[2](
            cfg, tune["train_chunk"], *b, **k)
        try:
            return saved[1](*a, **kw, **tune["l2hmc"])
        finally:
            gauge.make_train_chunk = saved[2]

    autotune.tune_hmc, autotune.tune_l2hmc = tune_hmc, tune_l2hmc
    try:
        return train_gauge_cli(argv), len(searches)
    finally:
        autotune.tune_hmc, autotune.tune_l2hmc = saved[:2]


def main(argv=None):
    import argparse
    import json

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--device", default=None,
                   help="'cpu' for gloo ranks; default: a card per rank "
                        "(NCCL)")
    args = p.parse_args(argv)
    on_card = args.device != "cpu"
    device = "cuda" if on_card else "cpu"
    if on_card:
        from l2hmc_tpu_torch.ops import _cuda

        _cuda.library()           # build once, before the ranks load it
    res = dryrun_multichip(args.ranks, "nccl" if on_card else "gloo",
                           device)
    alone = run_modes(args.ranks, "cuda:0" if on_card else "cpu")
    line = {"ranks": args.ranks, "backend": "nccl" if on_card else "gloo",
            "modes_seconds": {k: v["seconds"] for k, v in res.items()
                              if isinstance(v, dict)},
            "modes_seconds_no_group": {k: v["seconds"]
                                       for k, v in alone.items()},
            "max_diff_no_group": modes_diff(res, alone),
            "smc_log_z": [res["smc"]["log_z"], alone["smc"]["log_z"],
                          res["smc"]["log_z_exact"]]}
    if on_card:
        from l2hmc_tpu_torch.benchmarks import device_info

        line["device"] = device_info()
        line["device_count"] = torch.cuda.device_count()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
