"""Beta-robustness campaign: autotune-driven head-to-heads off beta=4
(port of ``benchmarks/beta_campaign.py``).

Makes the head-to-head claim a property of the method, not of one point:
for the requested (size, beta) it

1. cold-starts the joint (K, eps) search for both samplers
   (``train/autotune.py``: ``tune_hmc``, then ``tune_l2hmc`` over
   ``--probe_seeds`` trainings and a +-10% eps refine pass at the winning
   K; the probes run each cell's serving path, ``hmc_chain`` and
   ``l2hmc_chain`` on the card),
2. runs the ``h2h_seeds`` interleaved multi-seed protocol at the tuned
   cells (independent trainings, Metropolis-warm evals on the eager
   harness, jackknife errors).

Writes the h2h line to ``<out>.h2h`` and the campaign line to ``--out``
(default ``runs/beta_<size>_<beta>.json``), and prints the latter.
Randomness: ``h2h_seeds.stream_generator(97 + int(10 beta) + size,
stream)``, JAX's key numbers: 0 the links, 7 the 1500-sweep warm start, 1
``tune_hmc``, 2 ``tune_l2hmc``, 3 the refine pass.

Usage::

    python -m l2hmc_tpu_torch.benchmarks.beta_campaign --size 16 \\
        --beta 3.0 --seeds 3
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


# the keys of the JAX tuner's trained cells; the port's cells add the probe
# route and seconds, which its tuner logs
CELL_KEYS = ("K", "eps", "accept", "accept_train_end", "score",
             "seed_scores")


def _trace(msg):
    print(f"[beta {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--size", type=int, default=16)
    p.add_argument("--beta", type=float, default=3.0)
    p.add_argument("--seeds", type=int, default=3)
    p.add_argument("--seed0", type=int, default=3000)
    p.add_argument("--train_steps", type=int, default=12000)
    p.add_argument("--eval_steps", type=int, default=16000)
    p.add_argument("--eval_chains", type=int, default=2048)
    p.add_argument("--num_hidden", type=int, default=64)
    p.add_argument("--arch", default="mlp", choices=["mlp", "conv", "local"],
                   help="conditioner family for the trained cell (local = "
                        "the weight-shared per-link conv family)")
    p.add_argument("--num_filters", type=int, default=8)
    p.add_argument("--lr_init", type=float, default=1e-3)
    p.add_argument("--num_chains", type=int, default=128)
    p.add_argument("--train_hops", action="store_true",
                   help="interleave exact instanton hops into the training "
                        "chains (probes AND campaign trainings): the "
                        "beta>=5 frozen-training-distribution fix")
    p.add_argument("--retrain_acc", type=float, default=0.0,
                   help="forwarded to h2h_seeds: detect-and-retrain "
                        "threshold on end-of-training acceptance (0=off)")
    p.add_argument("--max_retrains", type=int, default=3)
    p.add_argument("--hmc_k", type=int, default=0,
                   help="reuse a previously auto-tuned HMC optimum "
                        "(skip tune_hmc); 0 = tune cold")
    p.add_argument("--hmc_eps", type=float, default=0.0)
    p.add_argument("--probe_train_steps", type=int, default=8000)
    p.add_argument("--probe_seeds", type=int, default=2)
    p.add_argument("--probe_chains", type=int, default=1024)
    p.add_argument("--therm_sweeps", type=int, default=1500)
    p.add_argument("--hmc_k_grid", default="3,4,5,6,8")
    p.add_argument("--l2hmc_k_grid", default="2,3,4,5")
    p.add_argument("--out", default="")
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA device)")
    return p


def main(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    if args.hmc_k > 0 and args.hmc_eps <= 0:
        # a cached optimum needs both values; eps=0 would build a
        # never-moving HMC baseline and inflate every ratio
        p.error("--hmc_k requires --hmc_eps > 0 (the cached optimum's "
                "step size)")

    from l2hmc_tpu_torch._device import float32_matmuls, resolve_device
    from l2hmc_tpu_torch.benchmarks import h2h_seeds
    from l2hmc_tpu_torch.benchmarks.trained_vs_hmc import device_name
    from l2hmc_tpu_torch.lattice import u1
    from l2hmc_tpu_torch.lattice.metropolis import thermalize
    from l2hmc_tpu_torch.train.autotune import (TuneResult, tune_hmc,
                                                tune_l2hmc)
    from l2hmc_tpu_torch.train.gauge import GaugeConfig

    float32_matmuls()
    device = resolve_device(args.device)
    _trace(f"device: {device_name(device)}; size {args.size} "
           f"beta {args.beta}")
    base = GaugeConfig(
        time_size=args.size, space_size=args.size,
        num_chains=args.num_chains,
        network_arch=args.arch, num_hidden=args.num_hidden,
        num_filters=args.num_filters, lr_init=args.lr_init,
        train_hops=args.train_hops, merge_v_halves=True,
        eps_init=0.35 * (64.0 / (args.size * args.size)) ** 0.25,
        beta_init=2.0, beta_final=args.beta,
        charge_reward=True, charge_weight=1.0,
    )
    seed = 97 + int(10 * args.beta) + args.size

    def stream(n):
        return h2h_seeds.stream_generator(seed, n, device)

    x0 = u1.random_links(stream(0), base.num_chains, base.shape,
                         device=device)
    x0 = thermalize(stream(7), x0, base.shape, args.beta, 1500)
    _trace("thermalized")

    t0 = time.perf_counter()
    if args.hmc_k > 0:
        # reuse a previously auto-tuned optimum: still tuner-produced,
        # just cached
        hmc_opt = TuneResult(num_steps=args.hmc_k, eps=args.hmc_eps,
                             score=0.0, accept=0.0, cells=())
        _trace(f"HMC optimum (cached): K={hmc_opt.num_steps} "
               f"eps={hmc_opt.eps}")
    else:
        hmc_opt = tune_hmc(
            base, x0, args.beta, stream(1),
            k_grid=tuple(int(k) for k in args.hmc_k_grid.split(",")),
            probe_chains=args.probe_chains)
        _trace(f"HMC optimum: K={hmc_opt.num_steps} eps={hmc_opt.eps} "
               f"acc={hmc_opt.accept:.3f} ({time.perf_counter()-t0:.0f}s)")

    t0 = time.perf_counter()
    l2_opt = tune_l2hmc(
        base, stream(2), hmc_opt,
        k_grid=tuple(int(k) for k in args.l2hmc_k_grid.split(",")),
        probe_train_steps=args.probe_train_steps,
        probe_chains=args.probe_chains,
        probe_seeds=args.probe_seeds, device=device)
    _trace(f"trained cell: K={l2_opt.num_steps} eps={l2_opt.eps} "
           f"({time.perf_counter()-t0:.0f}s)")
    # refine: +-10% eps at the winning K
    anchor = TuneResult(num_steps=l2_opt.num_steps, eps=l2_opt.eps,
                        score=0.0, accept=0.0, cells=())
    ref = tune_l2hmc(
        base, stream(3), anchor,
        k_grid=(l2_opt.num_steps,), eps_grid=(0.9, 1.1),
        probe_train_steps=args.probe_train_steps,
        probe_chains=args.probe_chains,
        probe_seeds=args.probe_seeds, device=device)
    merged = sorted(l2_opt.cells + ref.cells, key=lambda c: -c["score"])
    k_t, eps_t = merged[0]["K"], merged[0]["eps"]
    _trace(f"refined trained cell: K={k_t} eps={eps_t}")

    # the h2h campaign at the tuned cells
    out_path = args.out or f"runs/beta_{args.size}_{args.beta}.json"
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    h2h_argv = [
        "--size", str(args.size), "--beta", str(args.beta),
        "--seeds", str(args.seeds), "--seed0", str(args.seed0),
        "--train_steps", str(args.train_steps),
        "--eval_steps", str(args.eval_steps),
        "--eval_chains", str(args.eval_chains),
        "--num_chains", str(args.num_chains),
        "--num_hidden", str(args.num_hidden),
        "--arch", args.arch, "--num_filters", str(args.num_filters),
        "--lr_init", str(args.lr_init),
        "--therm_sweeps", str(args.therm_sweeps),
        "--num_steps", str(k_t), "--eps", str(eps_t),
        "--hmc_num_steps", str(hmc_opt.num_steps),
        "--hmc_eps", str(hmc_opt.eps),
        "--charge_reward", "--eval_init", "metropolis",
        "--out", out_path + ".h2h", "--device", str(device),
    ]
    if args.train_hops:
        h2h_argv.append("--train_hops")
    if args.retrain_acc > 0:
        h2h_argv += ["--retrain_acc", str(args.retrain_acc),
                     "--max_retrains", str(args.max_retrains)]
    _trace(f"h2h: {' '.join(h2h_argv)}")
    h2h_seeds.main(h2h_argv)

    h2h_res = json.loads(Path(out_path + ".h2h").read_text())
    result = {
        "benchmark": "beta_campaign",
        "size": args.size, "beta": args.beta,
        "arch": args.arch, "train_hops": args.train_hops,
        "retrain_acc": args.retrain_acc,
        "lr_init": args.lr_init,
        "hmc_opt": {"K": hmc_opt.num_steps, "eps": hmc_opt.eps,
                    "accept": hmc_opt.accept},
        "trained_cell": {"K": k_t, "eps": eps_t,
                         "cells": [{k: c[k] for k in CELL_KEYS}
                                   for c in merged[:4]]},
        "h2h_summary": h2h_res["summary"],
        "h2h_per_seed": h2h_res["per_seed"],
        "plaq_exact": h2h_res["plaq_exact"],
    }
    out_s = json.dumps(result)
    print(out_s, flush=True)
    Path(out_path).write_text(out_s)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
