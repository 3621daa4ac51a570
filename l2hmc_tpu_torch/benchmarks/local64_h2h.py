"""64x64 campaign for the in-kernel stencil conditioner (port of
``benchmarks/local64_h2h.py``).

Scores the local stencil chain kernel (``ops/l2hmc_kernel.py
l2hmc_local_chain``, ``csrc/l2hmc_local_chain.cu``) with the h2h protocol:

- N seeds, each its own training of a ``local_flat`` cell
  (``train.gauge.train_to_convergence``, eager, the Wilson kernels on the
  card);
- every sampler advances its own chains from the same Metropolis-warm
  state; timed chunks interleaved round-robin;
- three samplers per seed:
    trained_fused   the stencil kernel (in-kernel randomness),
    hmc_fused       the fused HMC chain (``ops/leapfrog.py hmc_chain``) at
                    its tuned (K, eps): the best-implementation baseline,
    hmc_xla         HMC on the eager harness (``make_eval_chunk``; JAX's
                    tier name, kept so the keys match; ``--no_xla_tier``
                    drops it);
- jackknife-over-seeds errors on the ratios.

vs hmc_xla asks "does the kernel beat the plain-implementation baseline?";
vs hmc_fused "does the learned sampler win when both sides get their best
kernels?".  On CPU tensors the chain wrappers run their plain versions.

Randomness: ``h2h_seeds.stream_generator``: (640, 0) the links, (640, 9)
the Metropolis warm start, HMC's parameters from seed 640; per training
seed s, (s, 99900 + i) sampler i's warm call and (s, 7) the timed calls;
training takes the integer seed itself.  One JSON line on stdout with the
JAX script's keys; progress on stderr.

Usage::

    python -m l2hmc_tpu_torch.benchmarks.local64_h2h --seeds 3 \\
        --channels 4 --layers 1
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 640


def _trace(msg):
    print(f"[l64 {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--beta", type=float, default=4.0)
    p.add_argument("--seeds", type=int, default=3)
    p.add_argument("--seed0", type=int, default=5000)
    p.add_argument("--channels", type=int, default=4)
    p.add_argument("--layers", type=int, default=1)
    p.add_argument("--k", type=int, default=4)
    p.add_argument("--eps", type=float, default=0.10014,
                   help="auto-tuned 64x64 trained-cell eps")
    p.add_argument("--train_steps", type=int, default=12000)
    p.add_argument("--train_chains", type=int, default=128)
    p.add_argument("--lr_init", type=float, default=1e-3)
    p.add_argument("--eval_steps", type=int, default=4000)
    p.add_argument("--eval_chains", type=int, default=512)
    p.add_argument("--chunk", type=int, default=250,
                   help="transitions per timed kernel call")
    p.add_argument("--trace_chains", type=int, default=256)
    p.add_argument("--hmc_k", type=int, default=8)
    p.add_argument("--hmc_eps", type=float, default=0.04552,
                   help="auto-tuned 64x64 HMC optimum")
    p.add_argument("--therm_sweeps", type=int, default=1500)
    p.add_argument("--no_xla_tier", action="store_true")
    p.add_argument("--out", default="")
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA device)")
    return p


def train_config(args):
    """The trained cell's ``GaugeConfig`` from the parsed flags: ``local_flat``
    nets, ``merge_v_halves``, fixed eps, ``charge_reward``."""
    from l2hmc_tpu_torch.train import gauge as G

    return G.GaugeConfig(
        time_size=args.size, space_size=args.size,
        num_chains=args.train_chains, num_steps=args.k,
        network_arch="local_flat", num_filters=args.channels,
        local_layers=args.layers, merge_v_halves=True,
        eps_init=args.eps, eps_trainable=False, lr_init=args.lr_init,
        train_steps=args.train_steps, beta_final=args.beta,
        charge_reward=True, charge_weight=1.0)


def main(argv=None):
    args = build_parser().parse_args(argv)

    from l2hmc_tpu_torch._device import float32_matmuls, resolve_device
    from l2hmc_tpu_torch.analysis import stats
    from l2hmc_tpu_torch.benchmarks.h2h_seeds import (jackknife_mean_err,
                                                      stream_generator)
    from l2hmc_tpu_torch.benchmarks.trained_vs_hmc import (device_name,
                                                           trace_stats)
    from l2hmc_tpu_torch.dynamics.l2hmc import get_eps
    from l2hmc_tpu_torch.lattice import u1
    from l2hmc_tpu_torch.lattice.metropolis import thermalize
    from l2hmc_tpu_torch.ops.l2hmc_kernel import l2hmc_local_chain
    from l2hmc_tpu_torch.ops.leapfrog import hmc_chain
    from l2hmc_tpu_torch.train import gauge as G

    float32_matmuls()
    device = resolve_device(args.device)
    _trace(f"device: {device_name(device)}")
    shape = u1.LatticeShape(args.size, args.size)
    n_tr = args.trace_chains

    tcfg = train_config(args)
    dyn_cfg, _ = G.build_dynamics(tcfg)

    _trace(f"Metropolis warm start ({args.therm_sweeps} sweeps)...")
    x0 = u1.random_links(stream_generator(SEED, 0, device), args.eval_chains,
                         shape, device=device)
    x0 = thermalize(stream_generator(SEED, 9, device), x0, shape, args.beta,
                    args.therm_sweeps)
    links0 = u1.to_links(x0, shape).contiguous()

    # HMC samplers (seed-independent; each seed re-warms its own chains)
    def run_hf(links, gen):
        links, pl, ch, pr = hmc_chain(links, gen, args.hmc_eps, args.beta,
                                      args.hmc_k, args.chunk)
        return links, pl[:, :n_tr], ch[:, :n_tr], pr.sum()

    hcfg = G.GaugeConfig(
        time_size=args.size, space_size=args.size,
        num_chains=args.eval_chains, num_steps=args.hmc_k, hmc=True,
        network_arch="zero", eps_init=args.hmc_eps, eps_trainable=False,
        beta_final=args.beta)
    hparams = G.init_train_state(
        hcfg, torch.Generator(device=device).manual_seed(SEED),
        device).params
    base_hx = G.make_eval_chunk(hcfg, args.chunk)

    def run_hx(x, gen):
        x, m = base_hx(hparams, x, args.beta, gen)
        return (x, m["plaqs"][:, :n_tr], m["charges"][:, :n_tr],
                m["accept_prob"].sum())

    per_seed = []
    for s in range(args.seeds):
        seed = args.seed0 + s
        t0 = time.perf_counter()
        state, m, attempts = G.train_to_convergence(tcfg, seed,
                                                    device=device)
        train_s = time.perf_counter() - t0
        acc_end = attempts[-1]["end_accept"]
        _trace(f"seed {seed}: trained {args.train_steps} steps in "
               f"{train_s:.0f}s, end acc={acc_end:.3f}")
        eps_v = float(get_eps(state.params, dyn_cfg).detach())

        def run_t(links, gen, prm=state.params):
            links, pl, ch, pr = l2hmc_local_chain(
                links, prm, gen, eps_v, args.beta, args.k, args.chunk,
                args.layers)
            return links, pl[:, :n_tr], ch[:, :n_tr], pr.sum()

        samplers = [("trained_fused", run_t, "links"),
                    ("hmc_fused", run_hf, "links")]
        if not args.no_xla_tier:
            samplers.append(("hmc_xla", run_hx, "flat"))

        st8 = {tag: (links0 if kind == "links" else x0)
               for tag, _, kind in samplers}
        acc = {tag: {"pl": [], "q": [], "wall": 0.0, "acc": 0.0}
               for tag, _, _ in samplers}
        with torch.no_grad():
            # warm (untimed; the first calls build the kernels)
            for i, (tag, run, _) in enumerate(samplers):
                st8[tag], pl, q, dg = run(
                    st8[tag], stream_generator(seed, 99900 + i, device))
                float(dg)
            n_rounds = args.eval_steps // args.chunk
            gen = stream_generator(seed, 7, device)
            for _ in range(n_rounds):
                for tag, run, _ in samplers:
                    a = acc[tag]
                    t0 = time.perf_counter()
                    st8[tag], pl, q, dg = run(st8[tag], gen)
                    a["acc"] += float(dg)          # drains the chunk
                    a["wall"] += time.perf_counter() - t0
                    a["pl"].append(pl.cpu().numpy())
                    a["q"].append(q.cpu().numpy())

        rec = {"seed": seed, "end_accept": acc_end, "eps": eps_v,
               "train_s": round(train_s, 1)}
        for tag, _, _ in samplers:
            a = acc[tag]
            pl = np.concatenate(a["pl"])
            q = np.concatenate(a["q"])
            st = trace_stats(pl, a["wall"], max_chains=n_tr,
                             total_chains=args.eval_chains)
            tau_q, tau_ok = stats.pooled_integrated_time(q)
            tun = float(np.abs(np.diff(q, axis=0)).mean()) * st["steps_per_s"]
            rec[tag] = {
                "plaq": st, "plaq_mean": round(float(pl.mean()), 6),
                "accept": round(a["acc"] / (n_rounds * args.chunk
                                            * args.eval_chains), 4),
                "q_tau_pooled": round(tau_q, 2),
                "q_tau_pooled_reliable": bool(tau_ok),
                "q_ess_per_s_pooled": round(
                    (1.0 / max(tau_q, 1.0)) * q.shape[0]
                    * args.eval_chains / a["wall"], 1),
                "tunneling_per_s": round(tun, 2),
                "us_per_transition": round(
                    a["wall"] / (n_rounds * args.chunk) * 1e6, 1),
            }
        for tier, base in (("vs_xla", "hmc_xla"), ("vs_fused", "hmc_fused")):
            if base not in rec:
                continue
            rec[tier] = {
                "ratio_plaq_ess_per_s": round(
                    rec["trained_fused"]["plaq"]["eff_samples_per_s"]
                    / rec[base]["plaq"]["eff_samples_per_s"], 4),
                "ratio_ess_per_step": round(
                    rec["trained_fused"]["plaq"]["ess_ratio"]
                    / rec[base]["plaq"]["ess_ratio"], 4),
                "ratio_q_ess_per_s_pooled": round(
                    rec["trained_fused"]["q_ess_per_s_pooled"]
                    / max(rec[base]["q_ess_per_s_pooled"], 1e-9), 4),
            }
        per_seed.append(rec)
        msg = " ".join(
            f"{t}={rec[t]['plaq']['eff_samples_per_s']:,.0f}/s"
            for t, _, _ in samplers)
        _trace(f"seed {seed}: {msg}; vs_xla "
               f"{rec.get('vs_xla', {}).get('ratio_plaq_ess_per_s')} "
               f"vs_fused {rec['vs_fused']['ratio_plaq_ess_per_s']} "
               f"(per-step {rec['vs_fused']['ratio_ess_per_step']})")

    summary = {}
    for tier in ("vs_xla", "vs_fused"):
        if tier not in per_seed[0]:
            continue
        summary[tier] = {}
        for k in per_seed[0][tier]:
            mean, err = jackknife_mean_err([r[tier][k] for r in per_seed])
            summary[tier][k] = {"mean": round(mean, 4),
                                "err_jk": round(err, 4)}
    result = {
        "benchmark": "local64_h2h",
        "config": {
            "size": args.size, "beta": args.beta, "seeds": args.seeds,
            "trained": (f"local_flat c{args.channels} L{args.layers} "
                        f"K={args.k} eps={args.eps} fixed merge_v "
                        f"charge_reward, fused kernel"),
            "hmc": f"K={args.hmc_k} eps={args.hmc_eps}",
            "train_steps": args.train_steps,
            "eval_steps": args.eval_steps,
            "eval_chains": args.eval_chains,
        },
        "plaq_exact": round(float(u1.u1_plaq_exact(args.beta)), 6),
        "per_seed": per_seed,
        "summary": summary,
    }
    out_s = json.dumps(result)
    print(out_s, flush=True)
    if args.out:
        Path(args.out).write_text(out_s)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
