"""Joint (num_leapfrog, eps) sweep of plaquette ESS/s on the fused HMC chain
(port of ``benchmarks/hmc_ess_sweep.py``).

The cost-normalized optimum is a joint property of (K, eps): transitions/s
fall ~1/K while the per-transition ESS ratio rises with the trajectory
length eps*K.  This sweep measures effective plaquette samples/s across the
grid on ``dynamics.hmc.hmc_chain_u1_fused`` (the kernel of
``csrc/hmc_chain.cu`` on the card, its plain version on the CPU) and prints
one JSON line per point of :data:`GRID`, then a ``best`` line.
Randomness: one generator on the device seeded with 7.

Usage::

    python -m l2hmc_tpu_torch.benchmarks.hmc_ess_sweep [--size 16] \\
        [--chains 2048]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

# for each K, eps values bracketing the acceptance sweet spot; the
# leapfrog energy error per trajectory grows with both, so the usable eps
# band shrinks slowly with K
GRID = {
    1: (0.10, 0.15, 0.20, 0.25),
    2: (0.10, 0.125, 0.15, 0.20),
    3: (0.08, 0.10, 0.125, 0.15),
    5: (0.08, 0.10, 0.125),
    8: (0.06, 0.08, 0.10),
    12: (0.05, 0.0667, 0.08),
}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--size", type=int, default=16)
    p.add_argument("--chains", type=int, default=2048)
    p.add_argument("--beta", type=float, default=4.0)
    p.add_argument("--therm", type=int, default=500)
    p.add_argument("--record", type=int, default=1000)
    p.add_argument("--trace_chains", type=int, default=16,
                   help="chains read back for the ESS estimate")
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA device)")
    args = p.parse_args(argv)

    from l2hmc_tpu_torch._device import float32_matmuls, resolve_device
    from l2hmc_tpu_torch.analysis import stats
    from l2hmc_tpu_torch.benchmarks.trained_vs_hmc import device_name
    from l2hmc_tpu_torch.dynamics.hmc import hmc_chain_u1_fused

    float32_matmuls()
    device = resolve_device(args.device)
    print(f"[sweep] device: {device_name(device)}", file=sys.stderr,
          flush=True)
    gen = torch.Generator(device=device).manual_seed(7)

    def record(links, eps, num_lf):
        links, pl_tr, _, pr_tr = hmc_chain_u1_fused(
            links, gen, eps, args.beta, num_lf, args.record)
        return (links, pl_tr[:, :args.trace_chains], torch.mean(pr_tr),
                torch.sum(pl_tr))

    best = None
    with torch.no_grad():
        for num_lf, eps_list in GRID.items():
            for eps in eps_list:
                links = torch.zeros((args.chains, args.size, args.size, 2),
                                    device=device)
                # thermalize from cold: at least --therm transitions in
                # record-length calls
                for _ in range(max(1, -(-args.therm // args.record))):
                    links, _, _, d = record(links, eps, num_lf)
                float(d)
                t0 = time.perf_counter()
                links, pl16, acc, d = record(links, eps, num_lf)
                float(d)
                wall = time.perf_counter() - t0
                pl = pl16.cpu().numpy()
                ess_ratio = float(np.mean(
                    [stats.calc_ess(pl[:, c]) for c in range(pl.shape[1])]))
                ess_per_s = ess_ratio * args.record * args.chains / wall
                frozen = float(acc) < 0.2
                row = {
                    "num_leapfrog": num_lf, "eps": eps,
                    "accept": round(float(acc), 3),
                    "ess_ratio": round(ess_ratio, 4),
                    "transitions_per_s": round(args.record / wall, 1),
                    "ess_per_s": round(ess_per_s, 1),
                }
                if frozen:
                    # a (nearly) frozen chain has a constant trace, whose
                    # ESS estimate is ~1: meaningless, excluded
                    row["frozen"] = True
                print(json.dumps(row), flush=True)
                if not frozen and (best is None
                                   or ess_per_s > best["ess_per_s"]):
                    best = row
    print(json.dumps({"best": best}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
