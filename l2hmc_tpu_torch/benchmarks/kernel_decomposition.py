"""Measured cost decomposition of the fused trained-L2HMC chain kernel.

Port of ``benchmarks/kernel_decomposition.py``.  Four variants of one call
of ``N`` transitions at the same K, each timed on the card with CUDA events
(least of 3 calls after a warm-up):

1. ``full``    — ``l2hmc_chain`` (``csrc/l2hmc_chain.cu``), f32 weights;
2. ``ablated`` — the same kernel with ``ablate_nets=True``: S = T = Q = 0
   without the features, the MLP products or the heads, while the circle
   map, log-Jacobian, masks, direction fusion and exp factors still run.
   full - ablated = the conditioner;
3. ``bf16``    — the full kernel with bfloat16 matmul weights, which halve
   the bytes each MLP call streams from L2 (and add a conversion per weight
   and per rounded activation): a time well under ``full`` would say those
   reads bound the kernel; no change leaves the question open;
4. ``hmc``     — ``hmc_chain`` (``csrc/hmc_chain.cu``) at the same K and
   eps: the bare Wilson-force flow.  ablated - hmc = the L2HMC machinery.

At the shipped champion's shape (``--size 16 --hidden 64 --K 3``, the
defaults) the weights and eps are the champion's
(``benchmarks/champion_16x16.npz``); at any other shape the port's seeded
init and its eps, as the JAX script takes.  2048 chains at beta 4,
thermalized by HMC.

Usage (on the card)::

    python3 -m l2hmc_tpu_torch.benchmarks.kernel_decomposition [--nt 400]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

VARIANTS = ("full", "ablated", "bf16", "hmc")


def _trace(msg):
    print(f"[decomp {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def time_variants(links, params, generator, eps, beta, K, nt,
                  variants=VARIANTS, reps=3):
    """Seconds per transition of each variant: the least of ``reps`` calls
    of ``nt`` transitions (after a warm-up call) from ``links``, in-kernel
    randomness from ``generator``."""
    from l2hmc_tpu_torch.benchmarks import best_ms
    from l2hmc_tpu_torch.ops.l2hmc_kernel import l2hmc_chain
    from l2hmc_tpu_torch.ops.leapfrog import hmc_chain

    runs = {
        "full": lambda: l2hmc_chain(links, params, generator, eps, beta, K,
                                    nt),
        "ablated": lambda: l2hmc_chain(links, params, generator, eps, beta,
                                       K, nt, ablate_nets=True),
        "bf16": lambda: l2hmc_chain(links, params, generator, eps, beta, K,
                                    nt, precision="bf16"),
        "hmc": lambda: hmc_chain(links, generator, eps, beta, K, nt),
    }
    return {v: best_ms(runs[v], reps) * 1e-3 / nt for v in variants}


def decomposition(t, K, b, config):
    """The result dict of the four variants' seconds per transition ``t``
    (``K`` leapfrog steps, ``b`` chains)."""
    conditioner = t["full"] - t["ablated"]
    machinery = t["ablated"] - t["hmc"]
    bf16_vs_f32 = t["full"] / t["bf16"]
    if bf16_vs_f32 > 1.1:
        l2 = (f"bf16 weights, which halve the bytes streamed from L2, cut "
              f"it by {100 * (1 - 1 / bf16_vs_f32):.0f}%: the weight reads "
              "bound the conditioner")
    else:
        l2 = (f"bf16 weights, which halve the bytes streamed from L2, move "
              f"it by {100 * (1 / bf16_vs_f32 - 1):+.0f}%: no sign that the "
              "weight reads from L2 bound it, but the conversions they add "
              "may hide a gain, so the question stays open")
    return {
        "benchmark": "kernel_decomposition",
        "config": config,
        "us_per_transition": {k: v * 1e6 for k, v in t.items()},
        "lf_steps_per_s": {k: K * b / v for k, v in t.items()},
        "component_us": {
            "conditioner (feats+matmuls+heads)": conditioner * 1e6,
            "l2hmc machinery (circle map, masks, direction fusion, exps)":
                machinery * 1e6,
            "base hmc trig flow": t["hmc"] * 1e6,
        },
        "component_share_pct": {
            "conditioner": 100 * conditioner / t["full"],
            "machinery": 100 * machinery / t["full"],
            "base_flow": 100 * t["hmc"] / t["full"],
        },
        "bf16_vs_f32": bf16_vs_f32,
        "trained_over_hmc_cost_sameK": t["full"] / t["hmc"],
        "floor_statement": (
            "the trained fused kernel's cost over plain HMC at the same K is "
            f"{100 * (1 - t['hmc'] / t['full']):.0f}% conditioner + "
            f"machinery; the conditioner (float32 FMA products on the CUDA "
            f"cores, no tensor cores) takes "
            f"{100 * conditioner / t['full']:.0f}%, and {l2}; the machinery "
            "(circle map, log-Jacobian, exp factors: libdevice routines on "
            f"the CUDA cores) takes {100 * machinery / t['full']:.0f}%"),
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--chains", type=int, default=2048)
    p.add_argument("--size", type=int, default=16)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--K", type=int, default=3)
    p.add_argument("--nt", type=int, default=400)
    args = p.parse_args(argv)
    from l2hmc_tpu_torch._device import resolve_device
    from l2hmc_tpu_torch.benchmarks import device_info
    from l2hmc_tpu_torch.dynamics.hmc import hmc_chain_u1_fused
    from l2hmc_tpu_torch.dynamics.l2hmc import get_eps
    from l2hmc_tpu_torch.train.checkpoint import load_champion
    from l2hmc_tpu_torch.train.gauge import (GaugeConfig, build_dynamics,
                                             init_params)

    device = resolve_device(None)
    b, K, beta = args.chains, args.K, 4.0
    cfg, params = load_champion(device=device)
    weights = "champion"
    if (cfg.time_size, cfg.space_size, cfg.hidden, cfg.num_steps) != (
            args.size, args.size, args.hidden, K):
        cfg = GaugeConfig(time_size=args.size, space_size=args.size,
                          num_chains=b, num_steps=K, network_arch="mlp",
                          num_hidden=args.hidden, merge_v_halves=True)
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             device=device)
        weights = "init"
    eps = float(get_eps(params, build_dynamics(cfg)[0]))
    gen = torch.Generator(device=device).manual_seed(0)
    links = torch.zeros((b, args.size, args.size, 2), device=device)
    links = hmc_chain_u1_fused(links, gen, 0.08, beta, 5, 200)[0]
    t = time_variants(links, params, gen, eps, beta, K, args.nt)
    for name, v in t.items():
        _trace(f"{name}: {v * 1e6:.1f} us/transition")
    result = decomposition(
        t, K, b, f"U(1) {args.size}x{args.size}, {b} chains, MLP "
                 f"h{args.hidden} ({weights} weights), K={K}, "
                 f"eps={eps}, merge_v fused chain")
    result["device"] = device_info()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
