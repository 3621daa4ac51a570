"""Topological-channel head-to-head: instanton hops against tuned HMC
(port of ``benchmarks/topo_ensemble.py``).

Measures the ensemble move that escapes the single-kernel L2HMC family:
the exact winding (instanton-hop) proposal of ``dynamics/topo.py``
interleaved with the local kernel.  The h2h_seeds protocol:

- every sampler advances its own batch from the same Metropolis-warm state;
- timed chunks interleaved round-robin (a/b/c/a/b/c...), so drift of the
  host or the card hits every sampler alike;
- the hop's cost inside the timed chunk;
- ``--reps`` independent repetitions, jackknife errors on every ratio.

Samplers, all on the eager harness (``train.gauge.make_eval_chunk`` and
``dynamics.topo.make_hop_eval_chunk``: every force and Hamiltonian through
the Wilson kernels of ``ops/wilson.py`` on the card):

  hmc        K/eps at the measured joint optimum
  hmc+hop    the same local kernel + ``--n_hops`` winding proposals per step
  champ+hop  the shipped champion + winding proposals (only where
             ``benchmarks/champion_16x16.npz`` matches ``--size``, or
             trained inline with ``--train_champion``)

Randomness: JAX folds its key; here each stream is a ``torch.Generator``
of its own (``h2h_seeds.stream_generator``) with JAX's stream numbers: seed
7, stream 0 the initial links, 9 the Metropolis warm start, ``100 + rep``
a repetition's timed chunks, and ``(100 + rep, 999900 + i)`` sampler i's
warm chunk.  The inline champion trains from ``--champ_seed``.  One JSON
line on stdout with the JAX script's keys; progress on stderr.

Usage::

    python -m l2hmc_tpu_torch.benchmarks.topo_ensemble --size 16 \\
        --beta 4.0 --reps 3
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 7
LINKS_STREAM, THERM_STREAM, REP_STREAM0, WARM_STREAM0 = 0, 9, 100, 999900


def _trace(msg):
    print(f"[topo {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def load_champion(size, device=None):
    """``(cfg, params)`` of the shipped champion npz on ``device``, or
    ``None`` where the file is absent or its lattice is not ``size``."""
    from l2hmc_tpu_torch.train import checkpoint as ckpt

    path = Path(ckpt.CHAMPION_PATH)
    if not path.exists():
        return None
    with np.load(path, allow_pickle=False) as z:
        cfg_d = json.loads(str(z["config"]))
    if int(cfg_d.get("time_size", 0)) != size:
        return None
    return ckpt.load_champion(path, device)


def sliced(base, n_tr):
    """``base``'s chunk with its traces cut to the first ``n_tr`` chains
    on the device."""
    def chunk(params, x, beta, generator):
        x, m = base(params, x, beta, generator)
        return x, {k: v[:, :n_tr] for k, v in m.items()}
    return chunk


def train_inline_champion(args, device):
    """The r3-recipe trained cell at this size (MLP, merge_v, fixed eps,
    charge reward), ``--champ_train_steps`` steps in chunks of 250."""
    from l2hmc_tpu_torch.train.gauge import (GaugeConfig, init_train_state,
                                             make_train_chunk)

    tcfg = GaugeConfig(
        time_size=args.size, space_size=args.size, num_chains=128,
        num_steps=args.champ_k, network_arch="mlp",
        num_hidden=args.champ_hidden, merge_v_halves=True,
        eps_init=args.champ_eps, eps_trainable=False,
        train_steps=args.champ_train_steps, beta_final=args.beta,
        charge_reward=True, train_hops=args.champ_train_hops)
    gen = torch.Generator(device=device).manual_seed(args.champ_seed)
    tstate = init_train_state(tcfg, gen, device)
    tchunk = make_train_chunk(tcfg, 250)
    t0 = time.time()
    for _ in range(max(args.champ_train_steps // 250, 1)):
        tstate, tm = tchunk(tstate, gen)
    _trace(f"inline champion trained ({time.time()-t0:.0f}s): end acc "
           f"{float(tm['accept_prob'][-1]):.3f}")
    return tcfg, tstate.params


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--size", type=int, default=16)
    p.add_argument("--beta", type=float, default=4.0)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--eval_steps", type=int, default=6000)
    p.add_argument("--eval_chains", type=int, default=2048)
    p.add_argument("--chunk_size", type=int, default=1000)
    p.add_argument("--hmc_num_steps", type=int, default=5)
    p.add_argument("--hmc_eps", type=float, default=0.08)
    p.add_argument("--n_hops", type=int, default=1)
    p.add_argument("--nu_max", type=int, default=1)
    p.add_argument("--therm_sweeps", type=int, default=1500)
    p.add_argument("--trace_chains", type=int, default=64,
                   help="on-device trace slice width; raise at large volume "
                        "so the POOLED tau_int(Q) window stays reliable "
                        "(pooling cuts rho-noise by sqrt(chains))")
    p.add_argument("--no_champion", action="store_true")
    p.add_argument("--train_champion", action="store_true",
                   help="when no shipped npz matches this size, train the "
                        "r3-recipe trained cell inline (e.g. the 32x32 "
                        "auto-tuned K=4 eps=0.095 cell) so the champ+hop "
                        "row exists at volume")
    p.add_argument("--champ_k", type=int, default=4)
    p.add_argument("--champ_eps", type=float, default=0.095)
    p.add_argument("--champ_train_steps", type=int, default=12000)
    p.add_argument("--champ_hidden", type=int, default=64)
    p.add_argument("--champ_train_hops", action="store_true",
                   help="train the inline champion with instanton hops in "
                        "the training chain (required at beta>=5: frozen "
                        "training distribution)")
    p.add_argument("--champ_seed", type=int, default=11,
                   help="inline-training seed (retrain-on-detect: pick "
                        "another if end acc lands in the beta=5 "
                        "half-acceptance basin)")
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
    from l2hmc_tpu_torch.benchmarks.trained_vs_hmc import (device_name,
                                                           trace_stats)
    from l2hmc_tpu_torch.dynamics import topo
    from l2hmc_tpu_torch.lattice import u1
    from l2hmc_tpu_torch.lattice.metropolis import thermalize
    from l2hmc_tpu_torch.train.gauge import (GaugeConfig, init_train_state,
                                             make_eval_chunk)

    float32_matmuls()
    device = resolve_device(args.device)
    _trace(f"device: {device_name(device)}")
    shape = u1.LatticeShape(args.size, args.size)

    hcfg = GaugeConfig(
        time_size=args.size, space_size=args.size,
        num_chains=args.eval_chains, num_steps=args.hmc_num_steps,
        hmc=True, network_arch="zero", eps_init=args.hmc_eps,
        eps_trainable=False, beta_final=args.beta)
    hparams = init_train_state(
        hcfg, torch.Generator(device=device).manual_seed(1), device).params

    n_tr = args.trace_chains
    samplers = [
        ("hmc", sliced(make_eval_chunk(hcfg, args.chunk_size), n_tr),
         hparams),
        ("hmc+hop", sliced(topo.make_hop_eval_chunk(
            hcfg, args.chunk_size, n_hops=args.n_hops, nu_max=args.nu_max),
            n_tr), hparams),
    ]
    champ = None if args.no_champion else load_champion(args.size, device)
    if champ is None and args.train_champion and not args.no_champion:
        champ = train_inline_champion(args, device)
    if champ is not None:
        ccfg, cparams = champ
        ccfg = dataclasses.replace(ccfg, num_chains=args.eval_chains)
        samplers.append(
            ("champ+hop", sliced(topo.make_hop_eval_chunk(
                ccfg, args.chunk_size, n_hops=args.n_hops,
                nu_max=args.nu_max), n_tr), cparams))
        _trace(f"champion loaded: K={ccfg.num_steps} h{ccfg.num_hidden}")

    _trace(f"Metropolis thermalization ({args.therm_sweeps} sweeps)...")
    x0 = u1.random_links(stream_generator(SEED, LINKS_STREAM, device),
                         args.eval_chains, shape, device=device)
    x0 = thermalize(stream_generator(SEED, THERM_STREAM, device), x0, shape,
                    args.beta, args.therm_sweeps)

    per_rep = []
    for rep in range(args.reps):
        xs = {tag: x0 for tag, _, _ in samplers}
        acc = {tag: {"plaqs": [], "charges": [], "wall": 0.0,
                     "accept": [], "hop_accept": []}
               for tag, _, _ in samplers}
        # warm (untimed; the first chunk builds the kernels)
        for i, (tag, ch, prm) in enumerate(samplers):
            xs[tag], m = ch(prm, xs[tag], args.beta, stream_generator(
                SEED, REP_STREAM0 + rep, device, WARM_STREAM0 + i))
            float(m["charges"].sum())
        gen = stream_generator(SEED, REP_STREAM0 + rep, device)
        n_chunks = args.eval_steps // args.chunk_size
        for _ in range(n_chunks):
            for tag, ch, prm in samplers:
                a = acc[tag]
                t0 = time.perf_counter()
                xs[tag], m = ch(prm, xs[tag], args.beta, gen)
                pl = m["plaqs"].cpu().numpy()          # drains the chunk
                a["wall"] += time.perf_counter() - t0
                a["plaqs"].append(pl)
                a["charges"].append(m["charges"].cpu().numpy())
                a["accept"].append(m["accept_prob"].cpu().numpy())
                if "hop_accept" in m:
                    a["hop_accept"].append(m["hop_accept"].cpu().numpy())

        rec = {}
        for tag, _, _ in samplers:
            a = acc[tag]
            pl = np.concatenate(a["plaqs"])
            q = np.concatenate(a["charges"])
            st = trace_stats(pl, a["wall"], total_chains=args.eval_chains)
            qt = trace_stats(q, a["wall"], total_chains=args.eval_chains)
            # pooled multi-chain tau_int(Q): at large tau the per-chain
            # Sokal window is noise; pooling the estimator chains extends
            # the reliable range
            tau_q, tau_ok = stats.pooled_integrated_time(q)
            qt["tau_pooled"] = round(tau_q, 2)
            qt["tau_pooled_reliable"] = bool(tau_ok)
            qt["eff_samples_per_s_pooled"] = round(
                (1.0 / max(tau_q, 1.0)) * q.shape[0] * args.eval_chains
                / a["wall"], 1)
            tun = float(np.abs(np.diff(q, axis=0)).mean()) * st["steps_per_s"]
            rec[tag] = {
                "plaq": st, "charge": qt,
                "steps_per_s": st["steps_per_s"],
                "tunneling_per_s": round(tun, 2),
                "tunneling_per_step": round(
                    float(np.abs(np.diff(q, axis=0)).mean()), 4),
                "accept": round(float(np.concatenate(a["accept"]).mean()), 4),
                "plaq_mean": round(float(pl.mean()), 6),
                "q2_mean": round(float((q ** 2).mean()), 4),
            }
            if a["hop_accept"]:
                rec[tag]["hop_accept"] = round(
                    float(np.concatenate(a["hop_accept"]).mean()), 4)
        base = rec["hmc"]
        for tag in rec:
            r = rec[tag]
            r["ratio_plaq_ess_per_s"] = round(
                r["plaq"]["eff_samples_per_s"]
                / base["plaq"]["eff_samples_per_s"], 4)
            r["ratio_q_ess_per_s"] = round(
                r["charge"]["eff_samples_per_s"]
                / max(base["charge"]["eff_samples_per_s"], 1e-9), 4)
            r["ratio_q_ess_per_s_pooled"] = round(
                r["charge"]["eff_samples_per_s_pooled"]
                / max(base["charge"]["eff_samples_per_s_pooled"], 1e-9), 4)
            r["ratio_tunneling_per_s"] = round(
                r["tunneling_per_s"] / max(base["tunneling_per_s"], 1e-9), 4)
        per_rep.append(rec)
        for tag in rec:
            r = rec[tag]
            _trace(f"rep {rep} {tag}: plaq-ESS/s x{r['ratio_plaq_ess_per_s']}"
                   f" Q-ESS/s x{r['ratio_q_ess_per_s']}"
                   f" tun/s x{r['ratio_tunneling_per_s']}"
                   f" (tun/step {r['tunneling_per_step']},"
                   f" acc {r['accept']}"
                   + (f", hop_acc {r['hop_accept']}" if "hop_accept" in r
                      else "") + f", q2 {r['q2_mean']})")

    summary = {}
    for tag, _, _ in samplers:
        s = {}
        for k in ("ratio_plaq_ess_per_s", "ratio_q_ess_per_s",
                  "ratio_q_ess_per_s_pooled", "ratio_tunneling_per_s"):
            mean, err = jackknife_mean_err([r[tag][k] for r in per_rep])
            s[k] = {"mean": round(mean, 4), "err_jk": round(err, 4)}
        s["q2_mean"], s["q2_err"] = (round(v, 4) for v in jackknife_mean_err(
            [r[tag]["q2_mean"] for r in per_rep]))
        s["plaq_mean"] = round(float(np.mean(
            [r[tag]["plaq_mean"] for r in per_rep])), 6)
        summary[tag] = s

    result = {
        "benchmark": "topo_ensemble",
        "config": {
            "size": args.size, "beta": args.beta, "reps": args.reps,
            "eval_steps": args.eval_steps, "eval_chains": args.eval_chains,
            "hmc": f"K={args.hmc_num_steps} eps={args.hmc_eps}",
            "n_hops": args.n_hops, "nu_max": args.nu_max,
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
