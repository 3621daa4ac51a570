"""Time the two chain kernels against the number of chains on one GPU.

Run from the repository root on a machine with a CUDA device::

    python3 -m l2hmc_tpu_torch.sweep_chains [--chains 512 1024 2048 4096 8192]
                                            [--transitions 100] [--reps 5]

Loads the shipped champion, thermalizes 2048 chains at beta=4 with the HMC
kernel (K=5, eps=0.08, 500 transitions), tiles them to each batch size and
times one call of ``num_transitions`` with ``l2hmc_chain`` (champion, hop
off) and with ``hmc_chain`` (K=5, eps=0.08) by CUDA events, after one
warm-up call.  Prints the card's name and power limit, then per batch size
the median and the least us/transition over ``--reps`` calls and the median
leapfrog steps per second.
"""

from __future__ import annotations

import argparse
import subprocess

import numpy as np
import torch

from l2hmc_tpu_torch.dynamics.l2hmc import get_eps
from l2hmc_tpu_torch.ops.l2hmc_kernel import l2hmc_chain
from l2hmc_tpu_torch.ops.leapfrog import hmc_chain
from l2hmc_tpu_torch.train.checkpoint import load_champion
from l2hmc_tpu_torch.train.gauge import build_dynamics

BETA, HMC_K, HMC_EPS = 4.0, 5, 0.08


def _us_per_transition(fn, n, reps):
    fn()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        out.append(1e3 * start.elapsed_time(end) / n)
    return float(np.median(out)), min(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chains", type=int, nargs="+",
                    default=[512, 1024, 2048, 4096, 8192])
    ap.add_argument("--transitions", type=int, default=100)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("sweep_chains needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    cfg, params = load_champion(device=dev)
    eps = float(get_eps(params, build_dynamics(cfg)[0]).detach())
    K = cfg.num_steps
    gen = torch.Generator(device=dev).manual_seed(0)
    therm = hmc_chain(torch.zeros((2048, cfg.time_size, cfg.space_size, 2),
                                  device=dev), gen, HMC_EPS, BETA, HMC_K,
                      500)[0]
    n = args.transitions
    for b in args.chains:
        links = therm.repeat((b + 2047) // 2048, 1, 1, 1)[:b].contiguous()
        l2 = _us_per_transition(lambda: l2hmc_chain(
            links, params, gen, eps, BETA, K, n), n, args.reps)
        hm = _us_per_transition(lambda: hmc_chain(
            links, gen, HMC_EPS, BETA, HMC_K, n), n, args.reps)
        print(f"B={b}: l2hmc_chain {l2[0]:.1f} us/transition (min "
              f"{l2[1]:.1f}) = {K * b / (l2[0] * 1e-6):.4g} lf-steps/s; "
              f"hmc_chain {hm[0]:.2f} us/transition (min {hm[1]:.2f}) = "
              f"{HMC_K * b / (hm[0] * 1e-6):.4g} lf-steps/s", flush=True)


if __name__ == "__main__":
    main()
