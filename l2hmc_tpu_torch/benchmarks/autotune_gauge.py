"""Cold-start (K, eps) auto-tune (port of ``benchmarks/autotune_gauge.py``).

Runs the probe-based joint search of ``train/autotune.py`` at a given
volume with no hand-tuned inputs: 1500 Metropolis sweeps at the target
beta, ``tune_hmc``, then ``tune_l2hmc`` around HMC's trajectory length,
optionally a +-10% eps refine pass at the winning K (``--refine``).  With
``--train_steps`` > 0 the probe's top two trained cells are trained
full-length and evaluated (``--eval_steps`` transitions of
``--eval_chains`` chains) against the tuned HMC optimum on the cells'
serving paths; the better one on the real eval is the result.  Prints one
JSON line (the JAX script's keys, then the device)::

    python -m l2hmc_tpu_torch.benchmarks.autotune_gauge --size 16
    python -m l2hmc_tpu_torch.benchmarks.autotune_gauge --size 16 --refine \
        --probe_train_steps 12000 --probe_seeds 2

Probes and evals time each cell's serving path on the card (the fused HMC
chain for HMC, the fused MLP chain for the MLP family, ``make_eval_chunk``
for ``--arch local``, whose score is then host-bound; see
``train/autotune.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from l2hmc_tpu_torch.train.autotune import _trace


def run_eval(cfg, params, x, beta, generator, num_steps,
             chunk_size: int = 1000):
    """Timed eval on the cell's serving path: ``(plaq trace (T, 64),
    accept, wall seconds, x)``, the wall over every chunk after one untimed
    warm chunk."""
    from l2hmc_tpu_torch.train.autotune import _make_probe_chunk, _timed_probe

    run = _make_probe_chunk(cfg, chunk_size)
    return _timed_probe(cfg, params, x, beta, generator, num_steps,
                        chunk_size, run)


def trace_stats(arr, wall, max_chains=64, total_chains=None):
    """ESS ratio, tau_int and eff-samples per second of a ``(T, chains)``
    trace; ``total_chains`` is the batch the timed run advanced."""
    from l2hmc_tpu_torch.analysis import stats

    total = total_chains or arr.shape[1]
    cols = range(min(max_chains, arr.shape[1]))
    ess = float(np.mean([stats.calc_ess(arr[:, c]) for c in cols]))
    taus = [stats.integrated_time(arr[:, c]) for c in cols]
    return {
        "ess_ratio": round(ess, 5),
        "tau_int": round(float(np.mean([t for t, _ in taus])), 2),
        "tau_reliable_frac": round(float(np.mean([ok for _, ok in taus])), 2),
        "eff_samples_per_s": round(ess * arr.shape[0] * total / wall, 1),
        "steps_per_s": round(arr.shape[0] / wall, 1),
    }


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--size", type=int, default=16)
    p.add_argument("--beta", type=float, default=4.0)
    p.add_argument("--num_chains", type=int, default=128)
    p.add_argument("--eval_chains", type=int, default=1024)
    p.add_argument("--num_hidden", type=int, default=64)
    p.add_argument("--arch", default="mlp", choices=["mlp", "local"],
                   help="conditioner family for the trained-kernel search")
    p.add_argument("--num_filters", type=int, default=8,
                   help="channels for --arch local")
    p.add_argument("--hmc_k_grid", default="3,4,5,6,8")
    p.add_argument("--l2hmc_k_grid", default="2,3,4,5")
    p.add_argument("--probe_train_steps", type=int, default=2000)
    p.add_argument("--probe_seeds", type=int, default=1)
    p.add_argument("--lr_init", type=float, default=1e-3)
    p.add_argument("--refine", action="store_true",
                   help="second +-10%% eps pass at the winning K")
    p.add_argument("--train_steps", type=int, default=12000,
                   help="full training for the top-2 cells (0 = tune only)")
    p.add_argument("--eval_steps", type=int, default=6000)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--out", default="")
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA device)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from l2hmc_tpu_torch._device import resolve_device
    from l2hmc_tpu_torch.lattice import u1
    from l2hmc_tpu_torch.lattice.metropolis import thermalize
    from l2hmc_tpu_torch.train.autotune import (
        TuneResult, _tile_chains, tune_hmc, tune_l2hmc,
    )
    from l2hmc_tpu_torch.train.gauge import (
        GaugeConfig, init_params, init_train_state, make_train_chunk,
    )

    device = resolve_device(args.device)
    base = GaugeConfig(
        time_size=args.size, space_size=args.size,
        num_chains=args.num_chains, network_arch=args.arch,
        num_hidden=args.num_hidden, num_filters=args.num_filters,
        merge_v_halves=True,
        # volume-scaled starting eps for the DA search (the CLI's --eps auto)
        eps_init=0.35 * (64.0 / (args.size * args.size)) ** 0.25,
        beta_init=2.0, beta_final=args.beta, lr_init=args.lr_init,
    )
    gen = torch.Generator(device=device).manual_seed(args.seed)
    _trace(f"device {device}; size {args.size}, eps_init(DA start) "
           f"{base.eps_init:.4f}")

    # tune at the target distribution: exact checkerboard warm start
    x0 = u1.random_links(gen, base.num_chains, base.shape, device=device)
    x0 = thermalize(gen, x0, base.shape, args.beta, 1500)
    _trace("thermalized (1500 Metropolis sweeps)")

    t0 = time.perf_counter()
    hmc_opt = tune_hmc(
        base, x0, args.beta, gen,
        k_grid=tuple(int(k) for k in args.hmc_k_grid.split(",")),
        probe_chains=args.eval_chains)
    t_hmc = time.perf_counter() - t0
    _trace(f"HMC optimum: K={hmc_opt.num_steps} eps={hmc_opt.eps} "
           f"acc={hmc_opt.accept:.3f} ({t_hmc:.0f}s)")
    for c in hmc_opt.cells:
        _trace(f"  {c}")

    t0 = time.perf_counter()
    l2_opt = tune_l2hmc(
        base, gen, hmc_opt,
        k_grid=tuple(int(k) for k in args.l2hmc_k_grid.split(",")),
        probe_train_steps=args.probe_train_steps,
        probe_chains=args.eval_chains, probe_seeds=args.probe_seeds,
        device=device)
    t_l2 = time.perf_counter() - t0
    _trace(f"L2HMC choice: K={l2_opt.num_steps} eps={l2_opt.eps} "
           f"probe-acc={l2_opt.accept:.3f} ({t_l2:.0f}s)")
    for c in l2_opt.cells:
        _trace(f"  {c}")

    if args.refine:
        # a +-10% eps grid at the winning K, anchored on the winner (the
        # coarse x0.8/1.0/1.2 grid straddles the optimum)
        anchor = TuneResult(num_steps=l2_opt.num_steps, eps=l2_opt.eps,
                            score=0.0, accept=0.0, cells=())
        t0 = time.perf_counter()
        ref_opt = tune_l2hmc(
            base, gen, anchor, k_grid=(l2_opt.num_steps,),
            eps_grid=(0.9, 1.1, 1.2),
            probe_train_steps=args.probe_train_steps,
            probe_chains=args.eval_chains, probe_seeds=args.probe_seeds,
            device=device)
        _trace(f"refine pass ({time.perf_counter() - t0:.0f}s):")
        for c in ref_opt.cells:
            _trace(f"  {c}")
        merged = sorted(l2_opt.cells + ref_opt.cells,
                        key=lambda c: -c["score"])
        l2_opt = dataclasses.replace(
            l2_opt, num_steps=merged[0]["K"], eps=merged[0]["eps"],
            score=merged[0]["score"], cells=tuple(merged))

    result = {
        "benchmark": "autotune_gauge",
        "size": args.size, "beta": args.beta,
        "hmc_opt": dataclasses.asdict(hmc_opt),
        "l2hmc_opt": dataclasses.asdict(l2_opt),
        "tune_wall_s": round(t_hmc + t_l2, 1),
    }

    if args.train_steps:
        # the probe's top two cells are often within a few percent: train
        # both full-length and keep the winner on the real eval against the
        # tuned HMC optimum
        def full_cell(k_steps, eps, tag, x_start):
            cfg = dataclasses.replace(
                base, num_steps=k_steps, eps_init=eps,
                eps_trainable=False, train_steps=args.train_steps)
            state = init_train_state(cfg, gen, device)
            chunk = make_train_chunk(cfg, 250)
            t0 = time.perf_counter()
            for _ in range(args.train_steps // 250):
                state, m = chunk(state, gen)
            _trace(f"{tag}: trained {args.train_steps} steps in "
                   f"{time.perf_counter() - t0:.0f}s; end acc="
                   f"{float(m['accept_prob'][-1]):.3f}")
            ecfg = dataclasses.replace(cfg, num_chains=args.eval_chains)
            pl_t, acc_t, wall_t, x_end = run_eval(
                ecfg, state.params, x_start, args.beta, gen, args.eval_steps)
            st = trace_stats(pl_t, wall_t, total_chains=args.eval_chains)
            return {"K": k_steps, "eps": eps, "accept": round(acc_t, 4),
                    "plaq": st,
                    "plaq_mean": round(float(pl_t[1000:].mean()), 6)}, x_end

        top = sorted(l2_opt.cells, key=lambda c: -c["score"])[:2]
        x_e = _tile_chains(x0, args.eval_chains)
        finalists = []
        for i, c in enumerate(top):
            r, x_e = full_cell(c["K"], c["eps"],
                               f"finalist{i} K={c['K']} eps={c['eps']}", x_e)
            finalists.append(r)
        best_t = max(finalists,
                     key=lambda r: r["plaq"]["eff_samples_per_s"])

        hcfg = dataclasses.replace(
            base, num_chains=args.eval_chains, hmc=True,
            network_arch="zero", eps_init=hmc_opt.eps,
            eps_trainable=False, num_steps=hmc_opt.num_steps,
            merge_v_halves=False)
        pl_h, acc_h, wall_h, _ = run_eval(
            hcfg, init_params(hcfg, gen, device), x_e, args.beta, gen,
            args.eval_steps)
        st_h = trace_stats(pl_h, wall_h, total_chains=args.eval_chains)
        result.update(
            finalists=finalists,
            trained=best_t,
            hmc={"accept": round(acc_h, 4), "plaq": st_h,
                 "plaq_mean": round(float(pl_h[1000:].mean()), 6)},
            plaq_exact=round(float(u1.u1_plaq_exact(args.beta)), 6),
            plaq_ess_per_s_ratio=round(
                best_t["plaq"]["eff_samples_per_s"]
                / max(st_h["eff_samples_per_s"], 1e-9), 3),
        )
        _trace(f"cold-start result: trained K={best_t['K']} "
               f"eps={best_t['eps']} "
               f"{best_t['plaq']['eff_samples_per_s']:,.0f} vs HMC "
               f"{st_h['eff_samples_per_s']:,.0f} eff/s -> "
               f"{result['plaq_ess_per_s_ratio']}x")

    if device.type == "cuda":
        from l2hmc_tpu_torch.benchmarks import device_info

        result["device"] = device_info()
    out = json.dumps(result)
    print(out)
    if args.out:
        Path(args.out).write_text(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
