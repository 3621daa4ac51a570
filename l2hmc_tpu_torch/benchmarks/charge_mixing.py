"""Topological charge mixing: trained L2HMC against tuned HMC on U(1)
16x16 (port of ``benchmarks/charge_mixing.py``).

The reference's claim is faster topological-charge tunneling: plain HMC
gets stuck in a charge sector as beta grows, and the learned kernel is
trained (the charge loss) to hop sectors.  This measures it end to end:

  1. train the L2HMC sampler at the canonical 16x16 config (beta 2 -> 4,
     conv nets),
  2. sample with the trained kernel at beta=4 from the annealed chains,
  3. sample with HMC at its ESS-optimal step size (eps 0.10) and the same
     trajectory length from the trained sampler's final state,
  4. report the per-step tunneling rate <|Q_{t+1} - Q_t|>, the integrated
     autocorrelation time of Q, Q-ESS per wall-second and <Q^2> against
     the exact finite-volume value.

Both samplers run on the eager harness (``train.gauge.make_eval_chunk``,
every force and Hamiltonian through the Wilson kernels on the card); the
wall clock is per sampler, so HMC's cheaper transition is credited to it.
One ``torch.Generator`` seeded with ``--seed`` makes the init and every
draw in order (JAX splits its key).  One JSON line on stdout with the JAX
script's keys; progress on stderr.

Usage::

    python -m l2hmc_tpu_torch.benchmarks.charge_mixing [--train_steps N] \\
        [--eval_steps N]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch


def _trace(msg):
    print(f"[charge_mixing {time.strftime('%H:%M:%S')}] {msg}",
          file=sys.stderr, flush=True)


def run_eval(cfg, params, x, beta, generator, num_steps, chunk_size=500):
    """Timed eval: ``(Q trace (steps, chains), accept, wall_s, x)``; one
    chunk of ``min(chunk_size, num_steps)`` warms outside the timing."""
    from l2hmc_tpu_torch.train.gauge import make_eval_chunk

    chunk_size = min(chunk_size, num_steps)
    chunk = make_eval_chunk(cfg, chunk_size)
    x, m = chunk(params, x, beta, generator)
    float(m["charges"].sum())
    charges, accepts = [], []
    t0 = time.perf_counter()
    done = 0
    while done < num_steps:
        x, m = chunk(params, x, beta, generator)
        charges.append(m["charges"].cpu().numpy())
        accepts.append(m["accept_prob"].cpu().numpy())
        done += chunk_size
    wall = time.perf_counter() - t0
    return (np.concatenate(charges), float(np.concatenate(accepts).mean()),
            wall, x)


def charge_stats(q, wall, label):
    """Tunneling rate, tau_int, ESS/s for a (steps, chains) charge trace."""
    from l2hmc_tpu_torch.analysis import stats

    dq = np.abs(np.diff(q, axis=0))
    rate = float(dq.mean())
    taus, reliable, ess = [], [], []
    for c in range(q.shape[1]):
        tau, ok = stats.integrated_time(q[:, c])
        taus.append(tau)
        reliable.append(ok)
        ess.append(stats.calc_ess(q[:, c]))
    ess_ratio = float(np.mean(ess))
    return {
        "sampler": label,
        "tunneling_rate_per_step": round(rate, 5),
        "tau_int_Q": round(float(np.mean(taus)), 2),
        "tau_int_reliable_frac": round(float(np.mean(reliable)), 2),
        "Q_ess_ratio": round(ess_ratio, 5),
        "Q_ess_per_s": round(ess_ratio * q.shape[0] * q.shape[1] / wall, 1),
        "steps_per_s": round(q.shape[0] / wall, 1),
        "susceptibility": round(float((q ** 2).mean()), 3),
    }


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--train_steps", type=int, default=5000)
    p.add_argument("--eval_steps", type=int, default=4000)
    p.add_argument("--size", type=int, default=16)
    p.add_argument("--num_chains", type=int, default=128)
    p.add_argument("--hmc_eps", type=float, default=0.10,
                   help="ESS-optimal from the RESULTS.md sweep")
    p.add_argument("--charge_weight", type=float, default=1.0)
    p.add_argument("--num_steps", type=int, default=3, help="leapfrog steps")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA device)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from l2hmc_tpu_torch._device import float32_matmuls, resolve_device
    from l2hmc_tpu_torch.benchmarks.trained_vs_hmc import device_name
    from l2hmc_tpu_torch.lattice import u1
    from l2hmc_tpu_torch.train.gauge import (GaugeConfig, init_train_state,
                                             make_train_chunk)

    float32_matmuls()
    device = resolve_device(args.device)
    cfg = GaugeConfig(
        time_size=args.size, space_size=args.size,
        num_chains=args.num_chains, num_steps=args.num_steps,
        network_arch="conv", train_steps=args.train_steps,
        charge_weight=args.charge_weight,
    )
    gen = torch.Generator(device=device).manual_seed(args.seed)
    _trace(f"device: {device_name(device)}")

    # --- train ---
    state = init_train_state(cfg, gen, device)
    chunk_size = min(250, max(cfg.train_steps, 1))
    chunk = make_train_chunk(cfg, chunk_size)
    _trace(f"training {cfg.train_steps} steps...")
    t0 = time.perf_counter()
    for c in range(cfg.train_steps // chunk_size):
        state, m = chunk(state, gen)
        if c % 4 == 3:
            _trace(f"  step {state.step}: "
                   f"acc={float(m['accept_prob'][-1]):.3f} "
                   f"plaq={float(m['plaqs'][-1]):.5f}")
    _trace(f"trained in {time.perf_counter()-t0:.1f}s wall")

    beta = cfg.beta_final
    # --- trained kernel eval (annealed chains; the reference protocol) ---
    q_l2, acc_l2, wall_l2, x_end = run_eval(
        cfg, state.params, state.x, beta, gen, args.eval_steps)
    res_l2 = charge_stats(q_l2, wall_l2, "l2hmc_trained")
    res_l2["accept_prob"] = round(acc_l2, 4)
    _trace(json.dumps(res_l2))

    # --- HMC at its ESS-optimal eps, started from the equilibrated state ---
    hmc_cfg = dataclasses.replace(
        cfg, hmc=True, network_arch="zero", eps_init=args.hmc_eps,
        eps_trainable=False)
    hmc_state = init_train_state(hmc_cfg, gen, device)
    q_hmc, acc_hmc, wall_hmc, _ = run_eval(
        hmc_cfg, hmc_state.params, x_end, beta, gen, args.eval_steps)
    res_hmc = charge_stats(q_hmc, wall_hmc, f"hmc_eps{args.hmc_eps}")
    res_hmc["accept_prob"] = round(acc_hmc, 4)
    _trace(json.dumps(res_hmc))

    result = {
        "benchmark": "topological_charge_mixing",
        "config": f"U(1) {args.size}x{args.size}, {args.num_chains} chains, "
                  f"{args.num_steps} leapfrog steps, beta={beta}",
        "q2_exact": round(float(u1.topological_susceptibility_exact(
            beta, cfg.shape.num_plaquettes)), 3),
        "l2hmc": res_l2,
        "hmc": res_hmc,
        "tunneling_speedup_per_step": round(
            res_l2["tunneling_rate_per_step"]
            / max(res_hmc["tunneling_rate_per_step"], 1e-12), 2),
        "Q_ess_per_s_speedup": round(
            res_l2["Q_ess_per_s"] / max(res_hmc["Q_ess_per_s"], 1e-12), 2),
    }
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
