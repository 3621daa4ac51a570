"""Fused HMC + instanton-hop chain: throughput and physics on the card
(port of ``benchmarks/fused_hop.py``).

The best-against-best topological sampler: the whole-chain HMC kernel
(``ops/leapfrog.py hmc_chain``, ``csrc/hmc_chain.cu``) with the exact
winding hop fused in (dS from the carried plaquette sums, no extra
plaquette pass).  At the HMC joint optimum this measures:

- leapfrog steps/s of the hop chain against the plain fused chain (the
  hop's true fused-tier cost),
- tunneling/s and pooled tau_int(Q) for both,
- plaquette and <Q^2> against the analytic anchors.

With ``--champion`` the shipped champion's chain kernel
(``ops/l2hmc_kernel.py l2hmc_chain``, ``csrc/l2hmc_chain.cu``) runs too,
plain and with the fused hop.  On CPU tensors the chain wrappers run their
plain versions.

Randomness: JAX folds key 11; here each stream is a generator of its own
(``h2h_seeds.stream_generator(11, stream)``): 0 the initial links, 3 the
Metropolis warm start, 7 every variant's warm call, ``100 + i`` timed call
i.  One JSON line on stdout with the JAX script's keys; progress on
stderr.

Usage::

    python -m l2hmc_tpu_torch.benchmarks.fused_hop [--size 16] [--beta 4.0] \\
        [--champion]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 11
LINKS_STREAM, THERM_STREAM, WARM_STREAM, CALL_STREAM0 = 0, 3, 7, 100


def _trace(msg):
    print(f"[fhop {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def champion_calls(nt, calls):
    """``(transitions per call, calls)`` of the champion tiers: JAX's
    ``nt_c = min(nt, 500)`` chunking.  The TPU's VMEM set that limit; the
    card's kernel has none, but the same chunking keeps the JSON's
    ``transitions`` and the call counts equal to JAX's."""
    nt_c = min(nt, 500)
    return nt_c, max(1, (nt * calls) // nt_c)


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--size", type=int, default=16)
    p.add_argument("--beta", type=float, default=4.0)
    p.add_argument("--chains", type=int, default=2048)
    p.add_argument("--num_steps", type=int, default=5)
    p.add_argument("--eps", type=float, default=0.08)
    p.add_argument("--nt", type=int, default=1500, help="transitions/call")
    p.add_argument("--calls", type=int, default=4, help="timed calls")
    p.add_argument("--therm_sweeps", type=int, default=1500)
    p.add_argument("--champion", action="store_true",
                   help="also run the trained champion chain kernel "
                        "(benchmarks/champion_16x16.npz) plain and with the "
                        "fused hop (ops/l2hmc_kernel.py hop=True): the "
                        "best-vs-best topological sampler")
    p.add_argument("--out", default="")
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA device)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from l2hmc_tpu_torch._device import float32_matmuls, resolve_device
    from l2hmc_tpu_torch.analysis import stats
    from l2hmc_tpu_torch.benchmarks.h2h_seeds import stream_generator
    from l2hmc_tpu_torch.benchmarks.trained_vs_hmc import device_name
    from l2hmc_tpu_torch.lattice import u1
    from l2hmc_tpu_torch.lattice.metropolis import thermalize
    from l2hmc_tpu_torch.ops.leapfrog import hmc_chain

    float32_matmuls()
    device = resolve_device(args.device)
    shape = u1.LatticeShape(args.size, args.size)
    _trace(f"device: {device_name(device)}")
    x0 = u1.random_links(stream_generator(SEED, LINKS_STREAM, device),
                         args.chains, shape, device=device)
    x0 = thermalize(stream_generator(SEED, THERM_STREAM, device), x0, shape,
                    args.beta, args.therm_sweeps)
    links0 = u1.to_links(x0, shape).contiguous()
    _trace("thermalized")

    res = {}

    @torch.no_grad()
    def run_variant(tag, run, nt, calls, k_lf):
        links, pl, ch, pr = run(links0,
                                stream_generator(SEED, WARM_STREAM, device))
        float(pr.sum())                        # build + thermalize
        pls, chs, wall = [], [], 0.0
        for i in range(calls):
            t0 = time.perf_counter()
            links, pl, ch, pr = run(
                links, stream_generator(SEED, CALL_STREAM0 + i, device))
            pla = pl.cpu().numpy()             # drains
            wall += time.perf_counter() - t0
            pls.append(pla[:, :256])
            chs.append(ch[:, :256].cpu().numpy())
        pla = np.concatenate(pls)
        cha = np.concatenate(chs)
        nt_total = nt * calls
        lf_rate = nt_total * k_lf * args.chains / wall
        tun = float(np.abs(np.diff(cha, axis=0)).mean())
        tau_q, tau_ok = stats.pooled_integrated_time(cha)
        res[tag] = {
            "lf_steps_per_s": round(lf_rate, 1),
            "us_per_transition": round(wall / nt_total * 1e6, 2),
            "tunneling_per_step": round(tun, 4),
            "tunneling_per_s": round(tun * nt_total / wall, 1),
            "q_tau_pooled": round(tau_q, 2),
            "q_tau_reliable": bool(tau_ok),
            "q_ess_per_s_pooled": round(
                (1.0 / max(tau_q, 1.0)) * nt_total * args.chains / wall, 1),
            "plaq_mean": round(float(pla.mean()), 6),
            "q2_mean": round(float((cha ** 2).mean()), 4),
        }
        _trace(f"{tag}: {res[tag]}")

    for tag, hop in (("plain", False), ("hop", True)):
        def run(links, gen, h=hop):
            return hmc_chain(links, gen, args.eps, args.beta, args.num_steps,
                             args.nt, hop=h)
        run_variant(tag, run, args.nt, args.calls, args.num_steps)

    if args.champion:
        from l2hmc_tpu_torch.benchmarks.topo_ensemble import load_champion
        from l2hmc_tpu_torch.dynamics.l2hmc import get_eps
        from l2hmc_tpu_torch.ops.l2hmc_kernel import l2hmc_chain
        from l2hmc_tpu_torch.train.gauge import build_dynamics

        champ = load_champion(args.size, device)
        if champ is None:
            _trace("no champion npz for this size; skipping champion tiers")
        else:
            ccfg, cparams = champ
            eps_c = float(get_eps(cparams, build_dynamics(ccfg)[0]).detach())
            nt_c, calls_c = champion_calls(args.nt, args.calls)
            for tag, hop in (("champ", False), ("champ_hop", True)):
                def run(links, gen, h=hop):
                    return l2hmc_chain(links, cparams, gen, eps_c, args.beta,
                                       ccfg.num_steps, nt_c,
                                       bounded_q=ccfg.bounded_q, hop=h)
                run_variant(tag, run, nt_c, calls_c, ccfg.num_steps)

    result = {
        "benchmark": "fused_hop",
        "config": {"size": args.size, "beta": args.beta,
                   "chains": args.chains,
                   "hmc": f"K={args.num_steps} eps={args.eps}",
                   "transitions": args.nt * args.calls},
        "plaq_exact": round(float(u1.u1_plaq_exact(args.beta)), 6),
        "q2_exact": round(u1.topological_susceptibility_exact(
            args.beta, shape.num_plaquettes), 4),
        "hop_cost_pct": round(
            100.0 * (res["hop"]["us_per_transition"]
                     / res["plain"]["us_per_transition"] - 1.0), 2),
        "tunneling_ratio": round(
            res["hop"]["tunneling_per_s"]
            / max(res["plain"]["tunneling_per_s"], 1e-9), 2),
        "q_ess_ratio_pooled": round(
            res["hop"]["q_ess_per_s_pooled"]
            / max(res["plain"]["q_ess_per_s_pooled"], 1e-9), 2),
        **{f"{k}_{tag}": v for tag, r in res.items() for k, v in r.items()},
    }
    if "champ_hop" in res:
        result["champ_hop_tunneling_vs_hmc"] = round(
            res["champ_hop"]["tunneling_per_s"]
            / max(res["plain"]["tunneling_per_s"], 1e-9), 2)
        result["champ_hop_q_ess_vs_hmc_pooled"] = round(
            res["champ_hop"]["q_ess_per_s_pooled"]
            / max(res["plain"]["q_ess_per_s_pooled"], 1e-9), 2)
        result["champ_hop_cost_pct"] = round(
            100.0 * (res["champ_hop"]["us_per_transition"]
                     / res["champ"]["us_per_transition"] - 1.0), 2)
    out_s = json.dumps(result)
    print(out_s, flush=True)
    if args.out:
        Path(args.out).write_text(out_s)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
