"""Parallel tempering against the instanton hop at the freezing point
(port of ``benchmarks/pt_vs_hop.py``).

PT is the one shipped topological mechanism that generalizes beyond 2-D
U(1) (the hop's closed form does not).  The topo_ensemble protocol at
16x16 beta=5, the freezing-regime point:

- samplers: tuned HMC, HMC+hop, and a PT ladder (R rungs beta 5 -> 2, all
  rungs' wall counted: they run as one flat ``(R*C, d)`` batch,
  ``dynamics/tempering.make_pt_chunk`` on ``ops/wilson.make_potential_fn``,
  the Wilson kernels' force on the card);
- every sampler's usable output is its target-beta chains; ESS/s is over
  usable chains and the total wall, so PT's R-fold ensemble cost counts;
- interleaved timed chunks, pooled multi-chain tau_int(Q), jackknife over
  reps.

HMC and HMC+hop run on the eager harness (``make_eval_chunk``,
``topo.make_hop_eval_chunk``).  Randomness: JAX folds key 77; here each
stream is a generator of its own (``h2h_seeds.stream_generator(77,
stream[, substream])``): 0 and 9 the HMC batch's links and warm start,
``20 + i`` and ``40 + i`` rung i's, ``100 + rep`` a repetition's timed
chunks and ``(100 + rep, 999901..999903)`` its three warm chunks.  One
JSON line on stdout with the JAX script's keys; progress on stderr.

Usage::

    python -m l2hmc_tpu_torch.benchmarks.pt_vs_hop --beta 5.0 --rungs 5 \\
        --reps 3
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 77
WARM_STREAMS = {"hmc": 999901, "hmc+hop": 999902, "pt": 999903}


def _trace(msg):
    print(f"[pt {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def ladder(beta, beta_min, rungs, hmc_eps):
    """``(betas, eps)``: linear in beta, target first; per-rung eps from
    the tuned target eps by the leapfrog-error scaling eps ~ beta^(-1/2)
    (error per step ~ beta eps^2 at fixed K)."""
    betas = tuple(float(b) for b in np.linspace(beta, beta_min, rungs))
    eps = tuple(round(hmc_eps * float(np.sqrt(beta / b)), 5) for b in betas)
    return betas, eps


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--size", type=int, default=16)
    p.add_argument("--beta", type=float, default=5.0)
    p.add_argument("--beta_min", type=float, default=2.0)
    p.add_argument("--rungs", type=int, default=5)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--eval_steps", type=int, default=6000)
    p.add_argument("--chunk_size", type=int, default=500)
    p.add_argument("--chains", type=int, default=2048,
                   help="HMC / HMC+hop batch")
    p.add_argument("--pt_chains", type=int, default=512,
                   help="chains PER RUNG (usable output = this)")
    p.add_argument("--hmc_num_steps", type=int, default=4)
    p.add_argument("--hmc_eps", type=float, default=0.079,
                   help="auto-tuned 16x16 beta=5 optimum (freeze_line)")
    p.add_argument("--therm_sweeps", type=int, default=1500)
    p.add_argument("--trace_chains", type=int, default=256)
    p.add_argument("--out", default="")
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA device)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from l2hmc_tpu_torch._device import float32_matmuls, resolve_device
    from l2hmc_tpu_torch.analysis import stats
    from l2hmc_tpu_torch.benchmarks.h2h_seeds import (jackknife_mean_err,
                                                      stream_generator)
    from l2hmc_tpu_torch.benchmarks.topo_ensemble import sliced
    from l2hmc_tpu_torch.benchmarks.trained_vs_hmc import (device_name,
                                                           trace_stats)
    from l2hmc_tpu_torch.dynamics import topo
    from l2hmc_tpu_torch.dynamics.tempering import PTConfig, make_pt_chunk
    from l2hmc_tpu_torch.lattice import u1
    from l2hmc_tpu_torch.lattice.metropolis import thermalize
    from l2hmc_tpu_torch.ops.wilson import make_potential_fn
    from l2hmc_tpu_torch.train.gauge import (GaugeConfig, init_train_state,
                                             make_eval_chunk)

    float32_matmuls()
    device = resolve_device(args.device)
    _trace(f"device: {device_name(device)}")
    shape = u1.LatticeShape(args.size, args.size)
    n_tr = args.trace_chains

    betas, eps = ladder(args.beta, args.beta_min, args.rungs, args.hmc_eps)
    pt_cfg = PTConfig(betas=betas, eps=eps, num_steps=args.hmc_num_steps)
    _trace(f"ladder: betas={betas} eps={eps}")

    hcfg = GaugeConfig(
        time_size=args.size, space_size=args.size, num_chains=args.chains,
        num_steps=args.hmc_num_steps, hmc=True, network_arch="zero",
        eps_init=args.hmc_eps, eps_trainable=False, beta_final=args.beta)
    hparams = init_train_state(
        hcfg, torch.Generator(device=device).manual_seed(1), device).params
    ch_h = sliced(make_eval_chunk(hcfg, args.chunk_size), n_tr)
    ch_hop = sliced(topo.make_hop_eval_chunk(hcfg, args.chunk_size), n_tr)

    potential = make_potential_fn(shape)

    def obs_fn(x0):
        o = u1.observables(x0, shape)
        return {"plaqs": o["plaqs"][:n_tr], "charges": o["charges"][:n_tr]}

    pt_chunk = make_pt_chunk(potential, pt_cfg, args.chunk_size,
                             wrap_fn=u1.wrap, observables_fn=obs_fn)

    _trace(f"thermalizing HMC batch + {args.rungs} PT rungs...")
    x0 = u1.random_links(stream_generator(SEED, 0, device), args.chains,
                         shape, device=device)
    x0 = thermalize(stream_generator(SEED, 9, device), x0, shape, args.beta,
                    args.therm_sweeps)
    rungs = []
    for i, b in enumerate(betas):
        xr = u1.random_links(stream_generator(SEED, 20 + i, device),
                             args.pt_chains, shape, device=device)
        rungs.append(thermalize(stream_generator(SEED, 40 + i, device), xr,
                                shape, b, args.therm_sweeps))
    x_pt = torch.stack(rungs)

    per_rep = []
    for rep in range(args.reps):
        states = {"hmc": x0, "hmc+hop": x0, "pt": x_pt}
        acc = {t: {"plaqs": [], "charges": [], "wall": 0.0, "extra": {}}
               for t in states}
        rnd = 0

        def warm(tag):
            return stream_generator(SEED, 100 + rep, device,
                                    WARM_STREAMS[tag])

        # warm (untimed)
        states["hmc"], m = ch_h(hparams, states["hmc"], args.beta,
                                warm("hmc"))
        float(m["charges"].sum())
        states["hmc+hop"], m = ch_hop(hparams, states["hmc+hop"], args.beta,
                                      warm("hmc+hop"))
        float(m["charges"].sum())
        states["pt"], m = pt_chunk(states["pt"], warm("pt"), rnd)
        rnd += args.chunk_size
        float(m["charges"].sum())

        gen = stream_generator(SEED, 100 + rep, device)
        n_chunks = args.eval_steps // args.chunk_size
        for _ in range(n_chunks):
            for tag in ("hmc", "hmc+hop", "pt"):
                a = acc[tag]
                t0 = time.perf_counter()
                if tag == "pt":
                    states[tag], m = pt_chunk(states[tag], gen, rnd)
                    rnd += args.chunk_size
                else:
                    ch = ch_h if tag == "hmc" else ch_hop
                    states[tag], m = ch(hparams, states[tag], args.beta, gen)
                pl = m["plaqs"].cpu().numpy()       # drains the chunk
                a["wall"] += time.perf_counter() - t0
                a["plaqs"].append(pl)
                a["charges"].append(m["charges"].cpu().numpy())
                if tag == "pt":
                    a["extra"].setdefault("swap_rate", []).append(
                        m["swap_rate"].cpu().numpy())
                if "hop_accept" in m:
                    a["extra"].setdefault("hop_accept", []).append(
                        m["hop_accept"].cpu().numpy())

        rec = {}
        for tag in states:
            a = acc[tag]
            pl = np.concatenate(a["plaqs"])
            q = np.concatenate(a["charges"])
            usable = args.pt_chains if tag == "pt" else args.chains
            st = trace_stats(pl, a["wall"], max_chains=n_tr,
                             total_chains=usable)
            tau_q, tau_ok = stats.pooled_integrated_time(q)
            tun = (float(np.abs(np.diff(q, axis=0)).mean())
                   * st["steps_per_s"])
            rec[tag] = {
                "plaq": st, "plaq_mean": round(float(pl.mean()), 6),
                "q2_mean": round(float((q ** 2).mean()), 4),
                "q_tau_pooled": round(tau_q, 2),
                "q_tau_pooled_reliable": bool(tau_ok),
                "q_ess_per_s_pooled": round(
                    (1.0 / max(tau_q, 1.0)) * q.shape[0] * usable
                    / a["wall"], 1),
                "tunneling_per_s_per_chain": round(tun, 4),
                "tunneling_per_step": round(
                    float(np.abs(np.diff(q, axis=0)).mean()), 4),
                "usable_chains": usable,
            }
            if "swap_rate" in a["extra"]:
                sw = np.concatenate(a["extra"]["swap_rate"])
                rec[tag]["swap_rate_per_pair"] = [
                    round(float(s), 3) for s in sw.mean(axis=0)]
            if "hop_accept" in a["extra"]:
                rec[tag]["hop_accept"] = round(float(np.concatenate(
                    a["extra"]["hop_accept"]).mean()), 4)
        base = rec["hmc"]
        for tag in rec:
            r = rec[tag]
            r["ratio_q_ess_per_s_pooled"] = round(
                r["q_ess_per_s_pooled"]
                / max(base["q_ess_per_s_pooled"], 1e-9), 4)
            r["ratio_plaq_ess_per_s"] = round(
                r["plaq"]["eff_samples_per_s"]
                / base["plaq"]["eff_samples_per_s"], 4)
        per_rep.append(rec)
        for tag in rec:
            r = rec[tag]
            _trace(f"rep {rep} {tag}: Q-ESS/s(pooled) "
                   f"x{r['ratio_q_ess_per_s_pooled']} "
                   f"tau_Q {r['q_tau_pooled']} "
                   f"tun/step {r['tunneling_per_step']} "
                   f"q2 {r['q2_mean']}"
                   + (f" swaps {r['swap_rate_per_pair']}"
                      if "swap_rate_per_pair" in r else ""))

    summary = {}
    for tag in per_rep[0]:
        s = {}
        for k in ("ratio_q_ess_per_s_pooled", "ratio_plaq_ess_per_s"):
            mean, err = jackknife_mean_err([r[tag][k] for r in per_rep])
            s[k] = {"mean": round(mean, 4), "err_jk": round(err, 4)}
        s["q_tau_pooled"] = round(float(np.mean(
            [r[tag]["q_tau_pooled"] for r in per_rep])), 2)
        s["q2_mean"] = round(float(np.mean(
            [r[tag]["q2_mean"] for r in per_rep])), 4)
        summary[tag] = s

    result = {
        "benchmark": "pt_vs_hop",
        "config": {
            "size": args.size, "beta": args.beta, "reps": args.reps,
            "ladder": {"betas": betas, "eps": eps,
                       "K": args.hmc_num_steps,
                       "chains_per_rung": args.pt_chains},
            "hmc": f"K={args.hmc_num_steps} eps={args.hmc_eps} "
                   f"@{args.chains}",
            "eval_steps": args.eval_steps,
        },
        "plaq_exact": round(float(u1.u1_plaq_exact(args.beta)), 6),
        "q2_exact": round(u1.topological_susceptibility_exact(
            args.beta, shape.num_plaquettes), 4),
        "per_rep": per_rep,
        "summary": summary,
    }
    out_s = json.dumps(result)
    print(out_s, flush=True)
    if args.out:
        Path(args.out).write_text(out_s)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
