"""Time the two chain kernels against the number of chains on one GPU, and
the champion kernel at each chains-per-block cap.

Run from the repository root on a machine with a CUDA device::

    python3 -m l2hmc_tpu_torch.sweep_chains [--chains 512 1024 2048 4096 8192]
                                            [--transitions 100] [--reps 5]
                                            [--variants 8 4 2]

Loads the shipped champion, thermalizes 2048 chains at beta=4 with the HMC
kernel (K=5, eps=0.08, 500 transitions), tiles them to each batch size and
times one call of ``num_transitions`` with ``l2hmc_chain`` (champion, hop
off; float32 and bf16 weights) and with ``hmc_chain`` (K=5, eps=0.08) by
CUDA events, after one warm-up call.  Prints the card's name and power
limit, then per batch size the median and the least us/transition over
``--reps`` calls and the median leapfrog steps per second.

``--variants C ...`` runs the same in one process per cap, each with its
own build of ``csrc/l2hmc_chain.cu`` at most C chains per block
(``L2HMC_NVCC_DEFINES``, see ops/_cuda.py), after holding that build's
kernel against the plain version on 16 chains.  The cap binds the block
route only; the route each run takes (``chain_route_plan``) is printed.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

from l2hmc_tpu_torch.dynamics.l2hmc import get_eps
from l2hmc_tpu_torch.ops import _cuda
from l2hmc_tpu_torch.ops.l2hmc_kernel import (chain_route_plan, l2hmc_chain,
                                              l2hmc_chain_reference)
from l2hmc_tpu_torch.ops.leapfrog import hmc_chain
from l2hmc_tpu_torch.train.checkpoint import load_champion
from l2hmc_tpu_torch.train.gauge import build_dynamics

BETA, HMC_K, HMC_EPS = 4.0, 5, 0.08
CHECK_CHAINS, CHECK_N, CHECK_ATOL = 16, 2, 1e-4


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


def _check(links, params, eps, K):
    """max |dprob| of this build's kernel against the plain version."""
    b, d = CHECK_CHAINS, links.shape[1] * links.shape[2]
    rng = np.random.default_rng(5)
    rand = [torch.tensor(a, dtype=torch.float32, device=links.device) for a in
            (rng.standard_normal((CHECK_N, b, d)),
             rng.standard_normal((CHECK_N, b, d)),
             rng.choice([-1.0, 1.0], (CHECK_N, b)),
             rng.uniform(size=(CHECK_N, b)))]
    x = links[:b].contiguous()
    got = l2hmc_chain(x, params, None, eps, BETA, K, CHECK_N,
                      rand_arrays=rand)
    want = l2hmc_chain_reference(x, params, *rand, eps, BETA, K)
    torch.cuda.synchronize()
    return float((got[3] - want[3]).abs().max())


def _variants(args):
    for v in args.variants:
        env = dict(os.environ,
                   L2HMC_NVCC_DEFINES=f"-DL2HMC_CHAIN_MAX_C={int(v)}")
        cmd = [sys.executable, "-m", "l2hmc_tpu_torch.sweep_chains",
               "--chains", *map(str, args.chains), "--transitions",
               str(args.transitions), "--reps", str(args.reps)]
        print(f"== variant {v}: {env['L2HMC_NVCC_DEFINES']}", flush=True)
        proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                              timeout=args.variant_timeout)
        print(proc.stdout.strip(), flush=True)
        if proc.returncode != 0:
            print(proc.stderr.strip()[-3000:], flush=True)
            raise SystemExit(f"variant {v} failed ({proc.returncode})")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chains", type=int, nargs="+",
                    default=[512, 1024, 2048, 4096, 8192])
    ap.add_argument("--transitions", type=int, default=100)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--variants", nargs="*", default=[],
                    help="builds of at most C chains per block")
    ap.add_argument("--variant_timeout", type=float, default=300.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("sweep_chains needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    if args.variants:
        return _variants(args)
    dev = torch.device("cuda", 0)
    cfg, params = load_champion(device=dev)
    eps = float(get_eps(params, build_dynamics(cfg)[0]).detach())
    K = cfg.num_steps
    gen = torch.Generator(device=dev).manual_seed(0)
    therm = hmc_chain(torch.zeros((2048, cfg.time_size, cfg.space_size, 2),
                                  device=dev), gen, HMC_EPS, BETA, HMC_K,
                      500)[0]
    lib = _cuda.library()
    plan = chain_route_plan(cfg.time_size, cfg.space_size, cfg.hidden,
                            b=max(args.chains),
                            max_chains=lib.l2hmc_chain_max_chains())
    err = _check(therm, params, eps, K)
    print(f"build {_cuda.build()[0].parent.name}: {plan.route} route, "
          f"{plan.cl} CTAs per cluster, {plan.chains} chains per block, "
          f"{plan.stages} ring stages; kernel vs plain on {CHECK_CHAINS} "
          f"chains: max|dprob| {err:.3e}", flush=True)
    if not err <= CHECK_ATOL:
        raise SystemExit(f"kernel disagrees with its plain version "
                         f"(atol {CHECK_ATOL})")
    n = args.transitions
    for b in args.chains:
        links = therm.repeat((b + 2047) // 2048, 1, 1, 1)[:b].contiguous()
        l2 = _us_per_transition(lambda: l2hmc_chain(
            links, params, gen, eps, BETA, K, n), n, args.reps)
        l16 = _us_per_transition(lambda: l2hmc_chain(
            links, params, gen, eps, BETA, K, n, precision="bf16"), n,
            args.reps)
        hm = _us_per_transition(lambda: hmc_chain(
            links, gen, HMC_EPS, BETA, HMC_K, n), n, args.reps)
        print(f"B={b}: l2hmc_chain {l2[0]:.1f} us/transition (min "
              f"{l2[1]:.1f}) = {K * b / (l2[0] * 1e-6):.4g} lf-steps/s; bf16 "
              f"{l16[0]:.1f} (min {l16[1]:.1f}); hmc_chain {hm[0]:.2f} "
              f"us/transition (min {hm[1]:.2f}) = "
              f"{HMC_K * b / (hm[0] * 1e-6):.4g} lf-steps/s", flush=True)


if __name__ == "__main__":
    main()
