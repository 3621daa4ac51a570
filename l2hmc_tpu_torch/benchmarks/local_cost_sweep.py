"""Sampling-cost sweep of the local-conditioner family at large volume
(port of ``benchmarks/local_cost_sweep.py``).

Sampling throughput does not depend on the weights, so the cost frontier
of the family maps in seconds per variant without training: this times
the eager harness (``train.gauge.make_eval_chunk``, every force and
Hamiltonian through the Wilson kernels on the card) for local variants
(channels x layers x kernel), the MLP h64 reference and the HMC baseline
at the campaign batch, best of three timed chunks after a warm one.

Randomness: ``h2h_seeds.stream_generator(3, stream)``: 0 the links, 1
every variant's init, ``2 + i`` timed chunk i (JAX folds key 3 alike).
One JSON line on stdout with the JAX script's keys; progress on stderr.

Usage::

    python -m l2hmc_tpu_torch.benchmarks.local_cost_sweep --size 64 \\
        --chains 1024
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import torch

SEED = 3


def _trace(msg):
    print(f"[lcs {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def variants(base, args):
    """``[(tag, cfg)]``: HMC, the MLP h64 and the local family."""
    rep = dataclasses.replace
    return [
        ("hmc_K8", rep(base, hmc=True, network_arch="zero",
                       num_steps=args.hmc_num_steps, eps_init=args.hmc_eps)),
        ("mlp_h64", rep(base, network_arch="mlp", num_hidden=64)),
        ("local_c8_L2_k3", rep(base, network_arch="local", num_filters=8,
                               local_layers=2, local_kernel=3)),
        ("local_c8_L1_k3", rep(base, network_arch="local", num_filters=8,
                               local_layers=1, local_kernel=3)),
        ("local_c4_L1_k3", rep(base, network_arch="local", num_filters=4,
                               local_layers=1, local_kernel=3)),
        ("local_c8_L1_k5", rep(base, network_arch="local", num_filters=8,
                               local_layers=1, local_kernel=5)),
        ("local_c16_L1_k3", rep(base, network_arch="local", num_filters=16,
                                local_layers=1, local_kernel=3)),
        ("localflat_c8_L2", rep(base, network_arch="local_flat",
                                num_filters=8, local_layers=2)),
        ("localflat_c8_L1", rep(base, network_arch="local_flat",
                                num_filters=8, local_layers=1)),
    ]


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--chains", type=int, default=1024)
    p.add_argument("--beta", type=float, default=4.0)
    p.add_argument("--num_steps", type=int, default=4)
    p.add_argument("--hmc_num_steps", type=int, default=8)
    p.add_argument("--hmc_eps", type=float, default=0.04552)
    p.add_argument("--eps", type=float, default=0.10014)
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--out", default="")
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA device)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from l2hmc_tpu_torch._device import float32_matmuls, resolve_device
    from l2hmc_tpu_torch.benchmarks.h2h_seeds import stream_generator
    from l2hmc_tpu_torch.benchmarks.trained_vs_hmc import device_name
    from l2hmc_tpu_torch.lattice import u1
    from l2hmc_tpu_torch.train.gauge import (GaugeConfig, init_train_state,
                                             make_eval_chunk)

    float32_matmuls()
    device = resolve_device(args.device)
    _trace(f"device: {device_name(device)}")
    base = GaugeConfig(
        time_size=args.size, space_size=args.size, num_chains=args.chains,
        num_steps=args.num_steps, eps_init=args.eps, eps_trainable=False,
        merge_v_halves=True, beta_final=args.beta)
    x0 = u1.random_links(stream_generator(SEED, 0, device), args.chains,
                         base.shape, device=device)

    res = {}
    for tag, cfg in variants(base, args):
        state = init_train_state(cfg, stream_generator(SEED, 1, device),
                                 device)
        chunk = make_eval_chunk(cfg, args.steps)

        def run(x, gen):
            x, m = chunk(state.params, x, args.beta, gen)
            return x, float(m["plaqs"][:, :8].sum())      # drains

        x, _ = run(x0, stream_generator(SEED, 1, device))      # warm
        best = float("inf")
        for i in range(3):
            t0 = time.perf_counter()
            x, _ = run(x, stream_generator(SEED, 2 + i, device))
            best = min(best, time.perf_counter() - t0)
        res[tag] = {
            "steps_per_s": round(args.steps / best, 2),
            "us_per_transition": round(best / args.steps * 1e6, 1),
        }
        _trace(f"{tag}: {res[tag]}")

    hmc_thr = res["hmc_K8"]["steps_per_s"]
    for tag in res:
        res[tag]["thr_vs_hmc"] = round(res[tag]["steps_per_s"] / hmc_thr, 4)
    result = {
        "benchmark": "local_cost_sweep",
        "config": {"size": args.size, "chains": args.chains,
                   "K_trained": args.num_steps,
                   "K_hmc": args.hmc_num_steps, "steps": args.steps},
        "variants": res,
        "note": ("ratio_needed_for_win = 1/per_step_quality; r4 measured "
                 "per-step 1.597 for local c8L2 at 64x64 -> any variant "
                 "with thr_vs_hmc > 0.63 that keeps that quality wins"),
    }
    out_s = json.dumps(result)
    print(out_s, flush=True)
    if args.out:
        Path(args.out).write_text(out_s)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
