"""4-D SU(N) Lie-group HMC throughput and physics check on one card (port
of ``benchmarks/sun_nd_bench.py``).

Runs the d-dimensional path (``lattice/sun_nd.py``, complex64 links) at a
4-D SU(3) config and prints one JSON line with the reference script's
keys: link updates/s, ms per transition (the best of ``--chunks`` timed
chunks of ``--chunk`` transitions, after one warm chunk) and the measured
plaquette beside the strong-coupling value (``main`` returns it as a
dict).  The device goes to stderr.
Randomness: one generator on the device seeded with 0.

Usage::

    python -m l2hmc_tpu_torch.benchmarks.sun_nd_bench [--n 3] [--l 8] \\
        [--beta 1.0]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n", type=int, default=3)
    p.add_argument("--l", type=int, default=8, help="lattice extent (L^4)")
    p.add_argument("--beta", type=float, default=1.0)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--eps", type=float, default=0.0,
                   help="0 -> volume-scaled 0.32/L (leapfrog error ~ V eps^4)")
    p.add_argument("--num_steps", type=int, default=4)
    p.add_argument("--chunk", type=int, default=50)
    p.add_argument("--chunks", type=int, default=4)
    p.add_argument("--rect_c1", type=float, default=0.0)
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA device)")
    args = p.parse_args(argv)
    if args.eps == 0.0:
        args.eps = 0.32 / args.l

    from l2hmc_tpu_torch._device import float32_matmuls, resolve_device
    from l2hmc_tpu_torch.benchmarks.trained_vs_hmc import device_name
    from l2hmc_tpu_torch.lattice.sun_nd import (
        avg_plaq_nd, make_action, random_links_nd, sun_nd_hmc_transition,
        sun_plaq_strong_coupling,
    )

    float32_matmuls()
    device = resolve_device(args.device)
    print(f"[sun_nd_bench] device: {device_name(device)}", file=sys.stderr,
          flush=True)
    dims = (args.l,) * 4
    action = make_action(args.beta, args.rect_c1)
    gen = torch.Generator(device=device).manual_seed(0)
    links = random_links_nd(gen, args.n, args.batch, dims, scale=0.5,
                            device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def chunk(u):
        plaqs, probs = [], []
        for _ in range(args.chunk):
            out = sun_nd_hmc_transition(u, gen, args.eps, args.num_steps,
                                        action)
            u = out.links
            plaqs.append(avg_plaq_nd(u))
            probs.append(out.accept_prob)
        return u, torch.stack(plaqs), torch.stack(probs)

    t0 = time.perf_counter()
    links, plaqs, probs = chunk(links)
    sync()
    compile_s = time.perf_counter() - t0

    best = float("inf")
    all_plaqs = []
    for _ in range(args.chunks):
        t0 = time.perf_counter()
        links, plaqs, probs = chunk(links)
        sync()
        best = min(best, time.perf_counter() - t0)
        all_plaqs.append(plaqs.cpu().numpy())

    num_links = args.batch * int(np.prod(dims)) * 4
    link_updates_per_s = num_links * args.num_steps * args.chunk / best
    meas = (float(np.concatenate(all_plaqs[1:]).mean()) if args.chunks > 1
            else float(all_plaqs[0][args.chunk // 2:].mean()))
    res = {
        "metric": "sun4d_link_updates_per_s",
        "value": round(link_updates_per_s, 1),
        "config": f"SU({args.n}) {args.l}^4 beta={args.beta} "
                  f"batch={args.batch} {args.num_steps} lf-steps "
                  f"c1={args.rect_c1}",
        "plaq": round(meas, 5),
        "plaq_strong_coupling_lo": sun_plaq_strong_coupling(args.n,
                                                            args.beta),
        "accept_prob": round(float(probs.mean()), 4),
        "ms_per_transition": round(best * 1e3 / args.chunk, 3),
        "compile_s": round(compile_s, 1),
        "platform": "gpu" if device.type == "cuda" else device.type,
    }
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
