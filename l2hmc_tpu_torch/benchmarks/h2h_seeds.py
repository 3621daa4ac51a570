"""Multi-seed, error-barred cost-normalized head-to-head (port of
``benchmarks/h2h_seeds.py``).

- N independent seeds, each with its own training run (the claim is about
  the recipe, not one checkpoint);
- the two samplers' timed chunks interleaved (t/h/t/h...) inside each seed,
  so drift of the host or the card hits both alike; each chunk is drained
  by its host copy inside its own timing;
- a jackknife-over-seeds error bar on the mean ESS/s ratio; the claim
  stands only if mean - 2 sigma_jk > 1.

Both samplers run on the eager harness (``train.gauge.make_eval_chunk``,
every force through the Wilson kernels on the card).  One JSON line on
stdout with the JAX script's keys; progress, with the device, on stderr.

Randomness.  JAX derives every stream of a seed from its key by
``fold_in``; here each stream is a ``torch.Generator`` of its own on the
device, seeded from the pair ``(seed, stream)`` by
:func:`stream_generator` with JAX's stream numbers: 9 the Metropolis warm
start, 1 the HMC parameters, 2 the timed eval chunks, 999901 and 999902
the trained and HMC warm chunks.  Training takes the integer seed itself
(``train_to_convergence``).

Usage::

    python -m l2hmc_tpu_torch.benchmarks.h2h_seeds --seeds 5 \\
        --eval_steps 20000
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

THERM_STREAM, HMC_INIT_STREAM, EVAL_STREAM = 9, 1, 2
WARM_STREAMS = (999901, 999902)


def _trace(msg):
    print(f"[seeds {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def stream_generator(seed: int, stream: int, device,
                     *substreams: int) -> torch.Generator:
    """A generator on ``device`` seeded from ``(seed, stream, *substreams)``
    (numpy's ``SeedSequence`` of the tuple; a substream stands for a second
    ``fold_in``): distinct streams of one seed, and one stream across
    seeds, draw independently."""
    s = np.random.SeedSequence([seed, stream, *substreams]).generate_state(
        1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(s[0]))


def interleaved_eval(cfg_t, params_t, cfg_h, params_h, x0_t, x0_h, beta,
                     seed, num_steps, chunk_size=1000):
    """Alternate trained/HMC timed chunks; per-sampler total walls.

    Both samplers advance their own chains; traces are sliced to 64
    estimator chains on the device before the host copy.  The timed chunks
    draw from the eval stream of ``seed``, the two warm chunks (outside the
    timed window; the first builds the kernels) from streams of their own.
    Returns ``(traces, walls)``: ``traces[tag]`` holds ``plaqs``,
    ``charges`` and ``accept`` as ``(T, 64)`` arrays, ``tag`` in t, h.
    """
    from l2hmc_tpu_torch.train.gauge import make_eval_chunk

    device = x0_t.device
    chunk_size = min(chunk_size, num_steps)

    def make(cfg):
        base = make_eval_chunk(cfg, chunk_size)

        def chunk(params, x, generator):
            x, m = base(params, x, beta, generator)
            return x, {k: v[:, :64] for k, v in m.items()}

        return chunk

    ch_t, ch_h = make(cfg_t), make(cfg_h)
    warm_t, warm_h = (stream_generator(seed, s, device)
                      for s in WARM_STREAMS)
    x_t, m = ch_t(params_t, x0_t, warm_t)
    float(m["charges"].sum())
    x_h, m = ch_h(params_h, x0_h, warm_h)
    float(m["charges"].sum())

    gen = stream_generator(seed, EVAL_STREAM, device)
    out = {"t": {"plaqs": [], "charges": [], "accept": []},
           "h": {"plaqs": [], "charges": [], "accept": []}}
    wall = {"t": 0.0, "h": 0.0}
    x = {"t": x_t, "h": x_h}
    for _ in range(num_steps // chunk_size):
        for tag, ch, params in (("t", ch_t, params_t), ("h", ch_h, params_h)):
            t0 = time.perf_counter()
            x[tag], m = ch(params, x[tag], gen)
            pl = m["plaqs"].cpu().numpy()          # drains the chunk
            wall[tag] += time.perf_counter() - t0
            out[tag]["plaqs"].append(pl)
            out[tag]["charges"].append(m["charges"].cpu().numpy())
            out[tag]["accept"].append(m["accept_prob"].cpu().numpy())
    for tag in out:
        out[tag] = {k: np.concatenate(v) for k, v in out[tag].items()}
    return out, wall


def jackknife_mean_err(vals):
    """Delete-one jackknife mean and standard error."""
    vals = np.asarray(vals, dtype=np.float64)
    n = len(vals)
    if n < 2:
        return float(vals.mean()), float("nan")
    loo = np.array([np.delete(vals, i).mean() for i in range(n)])
    err = np.sqrt((n - 1) / n * ((loo - loo.mean()) ** 2).sum())
    return float(vals.mean()), float(err)


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--size", type=int, default=16)
    p.add_argument("--seeds", type=int, default=5)
    p.add_argument("--seed0", type=int, default=1000)
    p.add_argument("--train_steps", type=int, default=12000)
    p.add_argument("--eval_steps", type=int, default=20000)
    p.add_argument("--eval_chains", type=int, default=2048)
    p.add_argument("--num_chains", type=int, default=128)
    p.add_argument("--num_hidden", type=int, default=64)
    p.add_argument("--arch", default="mlp", choices=["mlp", "conv", "local"],
                   help="trained-kernel conditioner family")
    p.add_argument("--num_filters", type=int, default=8)
    p.add_argument("--lr_init", type=float, default=1e-3)
    p.add_argument("--train_hops", action="store_true",
                   help="interleave exact instanton hops into the training "
                        "chain (GaugeConfig.train_hops)")
    p.add_argument("--num_steps", type=int, default=3)
    p.add_argument("--eps", type=float, default=0.125)
    p.add_argument("--hmc_num_steps", type=int, default=5)
    p.add_argument("--hmc_eps", type=float, default=0.08)
    p.add_argument("--beta", type=float, default=4.0)
    p.add_argument("--metric", default="cos_diff")
    p.add_argument("--charge_reward", action="store_true")
    p.add_argument("--charge_weight", type=float, default=1.0)
    p.add_argument("--eval_init", default="train",
                   choices=["train", "metropolis"],
                   help="exact checkerboard warm start for the eval chains")
    p.add_argument("--therm_sweeps", type=int, default=1500)
    p.add_argument("--retrain_acc", type=float, default=0.0,
                   help="detect-and-retrain threshold on end-of-training "
                        "acceptance (0 = off; train_to_convergence)")
    p.add_argument("--max_retrains", type=int, default=3)
    p.add_argument("--out", default="")
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA device)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from l2hmc_tpu_torch._device import float32_matmuls, resolve_device
    from l2hmc_tpu_torch.benchmarks.trained_vs_hmc import (device_name,
                                                           trace_stats)
    from l2hmc_tpu_torch.lattice import u1
    from l2hmc_tpu_torch.lattice.metropolis import thermalize
    from l2hmc_tpu_torch.train.gauge import (
        GaugeConfig, init_train_state, train_to_convergence,
    )

    float32_matmuls()
    device = resolve_device(args.device)
    base = GaugeConfig(
        time_size=args.size, space_size=args.size,
        num_chains=args.num_chains, num_steps=args.num_steps,
        network_arch=args.arch, num_hidden=args.num_hidden,
        num_filters=args.num_filters, lr_init=args.lr_init,
        train_hops=args.train_hops,
        merge_v_halves=True, eps_init=args.eps, eps_trainable=False,
        train_steps=args.train_steps, beta_final=args.beta,
        metric=args.metric, charge_reward=args.charge_reward,
        charge_weight=args.charge_weight,
    )
    _trace(f"device: {device_name(device)}")

    per_seed = []
    for s in range(args.seeds):
        seed = args.seed0 + s
        t0 = time.perf_counter()
        state, m, attempts = train_to_convergence(
            base, seed, retrain_acc=args.retrain_acc,
            max_retrains=args.max_retrains, trace=_trace, device=device)
        acc_end = attempts[-1]["end_accept"]
        _trace(f"seed {seed}: trained {args.train_steps} steps x "
               f"{len(attempts)} attempt(s) in "
               f"{time.perf_counter()-t0:.0f}s, end acc={acc_end:.3f}")

        ecfg = dataclasses.replace(base, num_chains=args.eval_chains)
        reps = int(np.ceil(args.eval_chains / base.num_chains))
        x0 = state.x.repeat(reps, 1)[:args.eval_chains]
        if args.eval_init == "metropolis":
            x0 = thermalize(stream_generator(seed, THERM_STREAM, device), x0,
                            base.shape, args.beta, args.therm_sweeps)
        hcfg = dataclasses.replace(
            ecfg, hmc=True, network_arch="zero", eps_init=args.hmc_eps,
            eps_trainable=False, num_steps=args.hmc_num_steps,
            merge_v_halves=False)
        hstate = init_train_state(
            hcfg, stream_generator(seed, HMC_INIT_STREAM, device), device)

        out, wall = interleaved_eval(
            ecfg, state.params, hcfg, hstate.params, x0, x0, args.beta,
            seed, args.eval_steps)

        st_t = trace_stats(out["t"]["plaqs"], wall["t"],
                           total_chains=args.eval_chains)
        st_h = trace_stats(out["h"]["plaqs"], wall["h"],
                           total_chains=args.eval_chains)
        qt = trace_stats(out["t"]["charges"], wall["t"],
                         total_chains=args.eval_chains)
        qh = trace_stats(out["h"]["charges"], wall["h"],
                         total_chains=args.eval_chains)
        tun_t = float(np.abs(np.diff(out["t"]["charges"], axis=0)).mean()) \
            * st_t["steps_per_s"]
        tun_h = float(np.abs(np.diff(out["h"]["charges"], axis=0)).mean()) \
            * st_h["steps_per_s"]
        rec = {
            "seed": seed,
            "train_attempts": attempts,
            "trained": {"accept": round(float(out["t"]["accept"].mean()), 4),
                        "plaq": st_t, "charge": qt,
                        "plaq_mean": round(float(out["t"]["plaqs"].mean()),
                                           6)},
            "hmc": {"accept": round(float(out["h"]["accept"].mean()), 4),
                    "plaq": st_h, "charge": qh,
                    "plaq_mean": round(float(out["h"]["plaqs"].mean()), 6)},
            "ratio_ess_per_s": round(
                st_t["eff_samples_per_s"] / st_h["eff_samples_per_s"], 4),
            "ratio_ess_per_step": round(
                st_t["ess_ratio"] / st_h["ess_ratio"], 4),
            "ratio_q_ess_per_s": round(
                qt["eff_samples_per_s"] / max(qh["eff_samples_per_s"], 1e-9),
                4),
            "ratio_tunneling_per_s": round(tun_t / max(tun_h, 1e-9), 4),
        }
        per_seed.append(rec)
        _trace(f"seed {seed}: ESS/s ratio {rec['ratio_ess_per_s']} "
               f"(per-step {rec['ratio_ess_per_step']}), "
               f"Q-ESS/s {rec['ratio_q_ess_per_s']}, "
               f"tunneling/s {rec['ratio_tunneling_per_s']}")

    summary = {}
    for k in ("ratio_ess_per_s", "ratio_ess_per_step", "ratio_q_ess_per_s",
              "ratio_tunneling_per_s"):
        mean, err = jackknife_mean_err([r[k] for r in per_seed])
        summary[k] = {"mean": round(mean, 4), "err_jk": round(err, 4),
                      "excludes_1": bool(abs(mean - 1.0) > 2 * err)}
    result = {
        "benchmark": "h2h_seeds",
        "config": {
            "size": args.size, "beta": args.beta, "seeds": args.seeds,
            "train_steps": args.train_steps, "eval_steps": args.eval_steps,
            "eval_chains": args.eval_chains,
            "trained": f"{args.arch} h{args.num_hidden} K={args.num_steps} "
                       f"eps={args.eps} fixed merge_v"
                       + (f" charge_reward w={args.charge_weight}"
                          if args.charge_reward else ""),
            "hmc": f"K={args.hmc_num_steps} eps={args.hmc_eps}",
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
