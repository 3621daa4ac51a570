"""BASELINE config 5: U(1) 32x32 data-parallel sampler training + SMC over
beta (port of ``benchmarks/config5_multihost.py``).

1. **Data-parallel L2HMC training** at 32x32 with the chain batch sharded
   over the 'data' ranks; the gradients are all-reduced as a mean before
   the optimizer (``train/gauge.py`` with a ``parallel.mesh.Mesh``).
   Weak scaling: the same per-rank load on rank 0 alone, then on every
   rank.
2. **SMC over the beta ladder** with the particle population sharded over
   the same ranks (``dynamics/smc.py``): the log-weights are gathered for
   the normalizations and log Z, the resample gathers the particles.  The
   log-Z estimate is checked against the factorized analytic anchor.  The
   ladder runs under ``utils/trace.py``'s recorder, and every rank prints
   on stderr one JSON line of its seconds in each span of the rung
   (``smc.rung`` and its phases, the gathers, the waits for the card).

Run alone (one rank), or under a launcher::

    python -m l2hmc_tpu_torch.benchmarks.config5_multihost
    torchrun --standalone --nproc_per_node=4 \\
        -m l2hmc_tpu_torch.benchmarks.config5_multihost
    torchrun --standalone --nproc_per_node=2 \\
        -m l2hmc_tpu_torch.benchmarks.config5_multihost --device cpu \\
        --size 8 --hidden 16 --train_steps 4 --chunk 2

Prints one JSON line per phase (from global rank 0), with the JAX script's
keys and, on the card, its name and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--size", type=int, default=32)
    p.add_argument("--chains_per_device", type=int, default=16)
    p.add_argument("--hidden", type=int, default=256, help="net width")
    p.add_argument("--train_steps", type=int, default=100)
    p.add_argument("--chunk", type=int, default=25)
    p.add_argument("--particles_per_device", type=int, default=32)
    p.add_argument("--betas", type=int, default=13)
    p.add_argument("--beta_init", type=float, default=1.0)
    p.add_argument("--beta_final", type=float, default=4.0)
    p.add_argument("--moves_per_rung", type=int, default=3)
    p.add_argument("--leapfrog", type=int, default=4)
    p.add_argument("--phases", default="train,smc",
                   help="comma-separated subset of {train, smc}")
    p.add_argument("--smc_move", default="hmc",
                   choices=["hmc", "l2hmc", "fused"],
                   help="SMC move kernel: plain HMC (the Wilson kernels' "
                        "force on the card), the L2HMC kernel trained "
                        "in the train phase, or every move of a rung in "
                        "one launch of the fused HMC chain kernel")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: this rank's card)")
    return p


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_run(args, mesh, device):
    """Phase 1 on ``mesh`` (``None``: this process alone): the chunks after
    the first are timed."""
    from l2hmc_tpu_torch.parallel.mesh import shard_train_state
    from l2hmc_tpu_torch.train.gauge import (GaugeConfig, init_train_state,
                                             make_train_chunk)

    nd = mesh.size("data") if mesh is not None else 1
    cfg = GaugeConfig(
        time_size=args.size, space_size=args.size,
        num_chains=args.chains_per_device * nd, num_steps=3,
        network_arch="mlp", num_hidden=args.hidden,
        train_steps=args.train_steps, beta_init=args.beta_init,
        beta_final=args.beta_final)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = shard_train_state(init_train_state(cfg, gen, device), mesh)
    chunk = make_train_chunk(cfg, args.chunk, mesh=mesh)
    n_chunks = max(2, round(args.train_steps / args.chunk))
    if n_chunks * args.chunk != args.train_steps:
        print(f"# train_steps rounded to {n_chunks * args.chunk} "
              f"({n_chunks} chunks of {args.chunk})", file=sys.stderr)
    state, metrics = chunk(state, gen)       # first chunk: warm-up
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(n_chunks - 1):
        state, metrics = chunk(state, gen)
    _sync(device)
    dt = time.perf_counter() - t0
    steps = (n_chunks - 1) * args.chunk
    return {
        "devices": nd,
        "chains": cfg.num_chains,
        "train_steps_per_s": round(steps / dt, 3),
        "chain_steps_per_s": round(steps * cfg.num_chains / dt, 1),
        "final_accept": round(float(metrics["accept_prob"].mean()), 3),
        "final_plaq": round(float(metrics["plaqs"][-1]), 4),
    }, state.params, cfg


def rank_spans(summary, mesh, wall_s) -> dict:
    """This rank's line of the SMC phase: its seconds in each span path of
    the ladder (total and self), each span's count, the waits for the card,
    and the ladder's wall seconds."""
    return {
        "phase": "smc_rank_spans",
        "rank": mesh.coords["data"] if mesh is not None else 0,
        "wall_s": round(wall_s, 4),
        "spans": {p: {"count": v["count"], "total_s": round(v["total_s"], 4),
                      "self_s": round(v["self_s"], 4)}
                  for p, v in sorted(summary["spans"].items())},
        "counters": summary["counters"],
    }


def main(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    phases = set(args.phases.split(","))
    if args.smc_move == "l2hmc" and "train" not in phases:
        p.error("--smc_move l2hmc requires the train phase")

    import torch.distributed as dist

    from l2hmc_tpu_torch._device import resolve_device
    from l2hmc_tpu_torch.dynamics.smc import (
        make_u1_fused_move, make_u1_hmc_move, smc_beta_ladder,
        u1_log_z_exact_factorized, weighted_mean,
    )
    from l2hmc_tpu_torch.lattice import u1
    from l2hmc_tpu_torch.ops.wilson import make_potential_fn
    from l2hmc_tpu_torch.parallel.mesh import (
        gather_chains, get_mesh, initialize_distributed, is_primary,
        shard_chains,
    )
    from l2hmc_tpu_torch.utils import trace

    launched = initialize_distributed(args.device)
    device = resolve_device(args.device)
    mesh = get_mesh(device=device) if dist.is_initialized() else None
    n_dev = mesh.world if mesh is not None else 1
    info = {}
    if device.type == "cuda" and is_primary():
        from l2hmc_tpu_torch.benchmarks import device_info

        info = {"device": device_info()}

    def emit(line):
        if is_primary():
            print(json.dumps({**line, **info}), flush=True)

    # ---- Phase 1: DP training, weak scaling 1 -> n_dev ranks ----
    trained = None
    if "train" in phases:
        r1 = None
        if is_primary():
            r1, p1, c1 = train_run(args, None, device)
        if mesh is not None:
            mesh.barrier()
        if n_dev > 1:
            rn, pn, cn = train_run(args, mesh, device)
            trained = (pn, cn)
        else:
            rn, trained = r1, (p1, c1)
        if is_primary():
            eff = rn["chain_steps_per_s"] / (r1["chain_steps_per_s"] * n_dev)
            emit({
                "phase": "dp_training_weak_scaling",
                "lattice": f"{args.size}x{args.size}",
                "one_device": r1, "all_devices": rn,
                "scaling_efficiency": round(eff, 3),
                "platform": device.type,
            })
    if "smc" in phases:
        # ---- Phase 2: SMC over beta, particles sharded over the ranks ----
        shape = u1.LatticeShape(args.size, args.size)
        pot = make_potential_fn(shape)
        n_particles = args.particles_per_device * n_dev
        gen = torch.Generator(device=device).manual_seed(args.seed + 1)
        x0 = shard_chains(u1.random_links(gen, n_particles, shape,
                                          device=device), mesh)
        if args.smc_move == "l2hmc":
            from l2hmc_tpu_torch.train.gauge import (build_dynamics,
                                                     draw_transition)

            t_params, t_cfg = trained
            _, dyn = build_dynamics(t_cfg)

            @torch.no_grad()
            def move(x, b, g):
                for _ in range(args.moves_per_rung):
                    tr = dyn["transition_with"](
                        t_params, x, b, *draw_transition(g, x, mesh))
                    x = u1.wrap(tr.x_out)
                return x
        elif args.smc_move == "fused":
            move = make_u1_fused_move(shape, args.leapfrog,
                                      args.moves_per_rung, mesh=mesh)
        else:
            move = make_u1_hmc_move(pot, u1.wrap, shape.num_plaquettes,
                                    args.leapfrog, args.moves_per_rung,
                                    mesh=mesh)
        betas = np.linspace(args.beta_init, args.beta_final, args.betas)
        # equilibrate at beta_init, then anneal
        x_eq = x0
        for _ in range(max(1, 40 // args.moves_per_rung)):
            x_eq = move(x_eq, args.beta_init, gen)
        _sync(device)
        trace.reset()
        t0 = time.perf_counter()
        with trace.recording():
            final, ess_trace = smc_beta_ladder(gen, x_eq, pot, betas, move,
                                               mesh=mesh)
            log_z = float(final.log_z)
        wall = time.perf_counter() - t0
        print(json.dumps(rank_spans(trace.summary(), mesh, wall)),
              file=sys.stderr, flush=True)
        # the final population carries residual log-weights: weight the mean
        plaqs = gather_chains(u1.observables(final.x, shape)["plaqs"], mesh)
        plaq = float(weighted_mean(gather_chains(final.log_w, mesh), plaqs))
        emit({
            "phase": "smc_beta_ladder_sharded",
            "devices": n_dev,
            "move": args.smc_move,
            "particles": n_particles,
            "plaq": round(plaq, 5),
            "plaq_exact": round(float(u1.u1_plaq_exact(args.beta_final)), 5),
            "log_z": round(log_z, 2),
            "log_z_exact_factorized": round(u1_log_z_exact_factorized(
                shape.num_plaquettes, args.beta_init, args.beta_final), 2),
            "min_ess_frac": round(
                float(ess_trace.min()) / n_particles, 3),
            "wall_s": round(wall, 2),
        })
    if launched:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
