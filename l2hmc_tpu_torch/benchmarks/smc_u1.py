"""SMC over the beta ladder on U(1) lattice gauge theory (BASELINE config
5), the port of ``benchmarks/smc_u1.py``.

Anneals a particle ensemble from ``beta_init`` to ``beta_final`` with
importance reweighting, systematic resampling and HMC moves, and prints one
JSON line (the JAX script's keys, then the device): the weighted plaquette
against I1/I0, the log Z estimate against the factorized analytic value,
the least ESS fraction and the ladder's wall seconds.

``--move hmc`` moves with the eager HMC transition (every force through
the Wilson kernel on the card) and thermalizes with the generic HMC chain,
as the JAX script does; ``--move fused`` runs each rung's moves, and the
thermalization, in one call of the fused chain (``csrc/hmc_chain.cu`` on
the card, its plain version on the CPU)::

    python -m l2hmc_tpu_torch.benchmarks.smc_u1 --size 16 --particles 256 \
        --betas 31 --move fused
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def run(args):
    from l2hmc_tpu_torch._device import resolve_device
    from l2hmc_tpu_torch.dynamics.hmc import hmc_chain, hmc_chain_u1_fused
    from l2hmc_tpu_torch.dynamics.smc import (
        _eps, make_u1_fused_move, make_u1_hmc_move, smc_beta_ladder,
        u1_log_z_exact_factorized, weighted_mean,
    )
    from l2hmc_tpu_torch.lattice import u1
    from l2hmc_tpu_torch.ops.wilson import make_potential_fn

    device = resolve_device(args.device)
    shape = u1.LatticeShape(args.size, args.size)
    pot = make_potential_fn(shape)
    gen = torch.Generator(device=device).manual_seed(args.seed)

    # equilibrate the ensemble at beta_init
    x0 = u1.random_links(gen, args.particles, shape, device=device)
    eps0 = _eps(shape.num_plaquettes, args.beta_init)
    fused = args.move == "fused"
    if fused:
        links, _, _, _ = hmc_chain_u1_fused(
            u1.to_links(x0, shape), gen, eps0, args.beta_init, args.leapfrog,
            args.thermalize)
        x0 = u1.to_flat(links)
    else:
        xs, _ = hmc_chain(pot, x0, args.beta_init, gen, eps0, args.leapfrog,
                          args.thermalize, wrap_fn=u1.wrap)
        x0 = xs[-1]
        del xs

    if fused:
        move = make_u1_fused_move(shape, args.leapfrog, args.moves_per_rung)
    else:
        move = make_u1_hmc_move(pot, u1.wrap, shape.num_plaquettes,
                                args.leapfrog, args.moves_per_rung)
    betas = np.linspace(args.beta_init, args.beta_final, args.betas)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    final, ess_trace = smc_beta_ladder(gen, x0, pot, betas, move)
    log_z = float(final.log_z)
    wall = time.perf_counter() - t0

    obs = u1.observables(final.x, shape)
    plaq = float(weighted_mean(final.log_w, obs["plaqs"]))
    result = {
        "lattice": f"{args.size}x{args.size}",
        "particles": args.particles,
        "beta": [args.beta_init, args.beta_final],
        "plaq": round(plaq, 5),
        "plaq_exact": round(float(u1.u1_plaq_exact(args.beta_final)), 5),
        "log_z": round(log_z, 2),
        "log_z_exact_factorized": round(u1_log_z_exact_factorized(
            shape.num_plaquettes, args.beta_init, args.beta_final), 2),
        "min_ess_frac": round(float(ess_trace.min()) / args.particles, 3),
        "wall_s": round(wall, 2),
        "move": args.move,
    }
    if device.type == "cuda":
        from l2hmc_tpu_torch.benchmarks import device_info

        result["device"] = device_info()
    return result, final


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--size", type=int, default=16)
    p.add_argument("--particles", type=int, default=256)
    p.add_argument("--beta_init", type=float, default=1.0)
    p.add_argument("--beta_final", type=float, default=4.0)
    p.add_argument("--betas", type=int, default=31, help="ladder rungs")
    p.add_argument("--moves_per_rung", type=int, default=5)
    p.add_argument("--leapfrog", type=int, default=5)
    p.add_argument("--thermalize", type=int, default=500,
                   help="HMC steps to equilibrate at beta_init first")
    p.add_argument("--move", default="hmc", choices=["hmc", "fused"],
                   help="move kernel: the eager HMC transition, or the "
                        "fused HMC chain (one launch per rung on the card)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA device)")
    return p


def main(argv=None):
    result, _ = run(build_parser().parse_args(argv))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
