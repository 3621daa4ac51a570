"""Trained L2HMC vs tuned HMC, cost-normalized, on U(1) 16x16 at beta=4
(port of ``benchmarks/trained_vs_hmc.py``).

Trains an L2HMC kernel (or loads one), then measures both samplers'
effective samples per second from the same thermalized state:

  - plaquette ESS/s (the generic-observable metric), and
  - topological-charge ESS/s and tunneling rate.

HMC runs at its own joint (K, eps) ESS/s optimum (K=5, eps=0.08,
``hmc_ess_sweep``) unless overridden.  Two tiers:

  - the eager harness (``train.gauge.make_eval_chunk``: one transition of
    PyTorch operations at a time, every force and Hamiltonian through the
    Wilson kernels of ``csrc/wilson.cu`` on the card).  The JSON's top-level
    ratios and its ``"xla"`` names (``l2hmc_fused_vs_xla_speedup``, the
    ``--tier xla`` choice) keep the JAX script's words; here "xla" means
    this eager harness;
  - with ``--tier both``, the fused chain kernels: ``ops.l2hmc_kernel
    .l2hmc_chain`` (``csrc/l2hmc_chain.cu``; the MLP + merge_v + u1 family)
    against ``ops.leapfrog.hmc_chain`` (``csrc/hmc_chain.cu``), under
    ``"fused_tier"``.  The tier runs on the script's device: on the CPU the
    chain wrappers run their plain versions.

Both tiers warm each sampler with one chunk outside the timed window (the
first eager chunk also builds the kernels), slice the traces to the 64
chains the estimators read on the device before the host copy, and time
the whole wall over all chunks.  Randomness: one ``torch.Generator`` on the
device, seeded with ``--seed``, makes the initial state and every draw in
order.  One JSON line on stdout (the JAX script's keys); progress, with the
device's name, on stderr.

Usage::

    python -m l2hmc_tpu_torch.benchmarks.trained_vs_hmc --arch mlp \\
        --num_hidden 64 --num_steps 3 --merge_v --eps_init 0.125 \\
        --eps_fixed --charge_reward \\
        --params_from benchmarks/champion_16x16.npz --eval_chains 2048 \\
        --tier both
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch


def _trace(msg):
    print(f"[h2h {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def device_name(device) -> str:
    """The device's name, for the log: the card's, or ``cpu``."""
    device = torch.device(device)
    if device.type != "cuda":
        return str(device)
    return f"{device} {torch.cuda.get_device_name(device)}"


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def run_eval(cfg, params, x, beta, generator, num_steps, chunk_size=1000):
    """Timed eval on the eager harness: ``(plaqs, charges, mean accept,
    wall seconds, x)`` with ``(T, 64)`` traces.  The chunk is
    ``min(chunk_size, num_steps)`` transitions; one chunk warms outside the
    timed window."""
    from l2hmc_tpu_torch.train.gauge import make_eval_chunk

    chunk_size = min(chunk_size, num_steps)
    base_chunk = make_eval_chunk(cfg, chunk_size)

    def chunk(x):
        x, m = base_chunk(params, x, beta, generator)
        return x, {k: v[:, :64] for k, v in m.items()}

    x, m = chunk(x)
    float(m["charges"].sum())
    plaqs, charges, accepts = [], [], []
    t0 = time.perf_counter()
    done = 0
    while done < num_steps:
        x, m = chunk(x)
        done += chunk_size
        plaqs.append(_host(m["plaqs"]))
        charges.append(_host(m["charges"]))
        accepts.append(_host(m["accept_prob"]))
    # the host copies above drained every chunk
    wall = time.perf_counter() - t0
    return (np.concatenate(plaqs), np.concatenate(charges),
            float(np.concatenate(accepts).mean()), wall, x)


def run_eval_fused(kind, cfg, params, x, beta, generator, num_steps,
                   eps=None, hmc_k=5, chunk_size=0):
    """Timed eval on the fused chain kernels, the trace contract of
    :func:`run_eval`.  ``kind='l2hmc'`` runs the trained chain (MLP +
    merge_v + u1; chunks of 600), ``kind='hmc'`` the HMC chain (chunks of
    1500), as the JAX script chunks them."""
    from l2hmc_tpu_torch.dynamics.l2hmc import get_eps
    from l2hmc_tpu_torch.lattice import u1
    from l2hmc_tpu_torch.ops.l2hmc_kernel import l2hmc_chain
    from l2hmc_tpu_torch.ops.leapfrog import hmc_chain
    from l2hmc_tpu_torch.train.gauge import build_dynamics

    links = u1.to_links(x, cfg.shape)
    if kind == "l2hmc":
        if not (cfg.network_arch == "mlp" and cfg.merge_v_halves
                and cfg.group == "u1"):
            raise ValueError("the fused trained chain covers the MLP + "
                             "merge_v + u1 family")
        chunk_size = chunk_size or 600
        dyn_cfg, _ = build_dynamics(cfg)
        eps_v = float(get_eps(params, dyn_cfg).detach())

        def base(links):
            return l2hmc_chain(links, params, generator, eps_v, beta,
                               cfg.num_steps, chunk_size,
                               bounded_q=cfg.bounded_q)
    else:
        chunk_size = chunk_size or 1500

        def base(links):
            return hmc_chain(links, generator, eps, beta, hmc_k, chunk_size)

    def run(links):
        links, pl, ch, pr = base(links)
        return links, pl[:, :64], ch[:, :64], pr[:, :64]

    with torch.no_grad():
        links, pl, ch, pr = run(links)      # warm (and thermalize) chunk
        float(pr.sum())
        plaqs, charges, probs = [], [], []
        t0 = time.perf_counter()
        done = 0
        while done < num_steps:
            links, pl, ch, pr = run(links)
            done += chunk_size
            plaqs.append(_host(pl))
            charges.append(_host(ch))
            probs.append(_host(pr))
        wall = time.perf_counter() - t0
    return (np.concatenate(plaqs), np.concatenate(charges),
            float(np.concatenate(probs).mean()), wall, u1.to_flat(links))


def trace_stats(arr, wall, max_chains=64, total_chains=None):
    """ESS ratio / tau_int / eff-samples-per-second for a (T, chains) trace.

    ``total_chains``: chains the timed run actually advanced (the trace may
    be an on-device slice of the batch); eff samples/s scales with it.
    """
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


def sampler_result(label, plaq, q, acc, wall, eval_steps, eval_chains):
    """One sampler's record: acceptance, plaquette and charge statistics,
    tunneling per step, plaquette mean past the first quarter, <Q^2>."""
    return {
        "sampler": label,
        "accept_prob": round(acc, 4),
        "plaq": trace_stats(plaq, wall, total_chains=eval_chains),
        "charge": trace_stats(q, wall, total_chains=eval_chains),
        "tunneling_rate_per_step": round(
            float(np.abs(np.diff(q, axis=0)).mean()), 5),
        "plaq_mean": round(float(plaq[eval_steps // 4:].mean()), 6),
        "q2": round(float((q ** 2).mean()), 3),
        "wall_s": round(wall, 2),
    }


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    # trained-kernel config
    p.add_argument("--arch", default="conv",
                   choices=["conv", "mlp", "local"])
    p.add_argument("--num_filters", type=int, default=8)
    p.add_argument("--local_kernel", type=int, default=3)
    p.add_argument("--local_layers", type=int, default=2)
    p.add_argument("--num_hidden", type=int, default=0, help="0 -> 2*x_dim")
    p.add_argument("--num_steps", type=int, default=3, help="leapfrog steps K")
    p.add_argument("--merge_v", action="store_true")
    p.add_argument("--use_bf16", action="store_true",
                   help="bfloat16 matmuls (f32 accumulation) in the S/T/Q "
                        "nets; MH accept stays f32-exact")
    p.add_argument("--charge_reward", action="store_true")
    p.add_argument("--charge_weight", type=float, default=1.0)
    p.add_argument("--eps_init", type=float, default=0.35)
    p.add_argument("--eps_cap", type=float, default=0.0)
    p.add_argument("--eps_fixed", action="store_true",
                   help="freeze eps at --eps_init: train only the S/T/Q "
                        "conditioners around a fixed integrator step")
    p.add_argument("--train_steps", type=int, default=5000)
    p.add_argument("--lr_init", type=float, default=1e-3)
    p.add_argument("--metric", default="cos_diff",
                   help="ESJD metric (see train_gauge --metric)")
    p.add_argument("--num_chains", type=int, default=128)
    p.add_argument("--eval_chains", type=int, default=0,
                   help="chains for the timed eval (0 = same as training)")
    p.add_argument("--eval_init", default="train",
                   choices=["train", "metropolis"],
                   help="eval start: annealed training chains, or exact "
                        "checkerboard-Metropolis thermalization")
    p.add_argument("--therm_sweeps", type=int, default=1500)
    # HMC baseline at its own optimum
    p.add_argument("--hmc_eps", type=float, default=0.08)
    p.add_argument("--hmc_num_steps", type=int, default=5)
    # protocol
    p.add_argument("--size", type=int, default=16)
    p.add_argument("--eval_steps", type=int, default=6000)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--tier", default="xla", choices=["xla", "both"],
                   help="'both' adds the fused-chain-kernel tier (trained "
                        "MLP+merge_v kernel vs the HMC chain kernel) to the "
                        "eager-harness comparison")
    p.add_argument("--save_params", default="",
                   help="checkpoint dir to save the full train state")
    p.add_argument("--save_npz", default="",
                   help="flat-leaf npz of the trained params + config "
                        "(champion format: arr_i = the JAX tree_flatten "
                        "leaves in order, config = json string)")
    p.add_argument("--params_from", default="",
                   help="skip training; load params from a --save_npz npz "
                        "or a --save_params dir")
    p.add_argument("--label", default="")
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA device)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from l2hmc_tpu_torch._device import float32_matmuls, resolve_device
    from l2hmc_tpu_torch.lattice import u1
    from l2hmc_tpu_torch.lattice.metropolis import thermalize
    from l2hmc_tpu_torch.train import checkpoint as ckpt
    from l2hmc_tpu_torch.train.gauge import (
        GaugeConfig, init_train_state, make_train_chunk,
    )

    float32_matmuls()
    device = resolve_device(args.device)
    cfg = GaugeConfig(
        time_size=args.size, space_size=args.size,
        num_chains=args.num_chains, num_steps=args.num_steps,
        network_arch=args.arch, num_filters=args.num_filters,
        local_kernel=args.local_kernel, local_layers=args.local_layers,
        num_hidden=args.num_hidden, train_steps=args.train_steps,
        charge_weight=args.charge_weight, charge_reward=args.charge_reward,
        merge_v_halves=args.merge_v, eps_init=args.eps_init,
        eps_cap=args.eps_cap, eps_trainable=not args.eps_fixed,
        metric=args.metric, use_bf16=args.use_bf16, lr_init=args.lr_init,
    )
    gen = torch.Generator(device=device).manual_seed(args.seed)
    _trace(f"device: {device_name(device)}")

    state = init_train_state(cfg, gen, device)
    if args.params_from and args.params_from.endswith(".npz"):
        # flat-leaf npz: params only, so thermalize the eval start with
        # exact checkerboard Metropolis sweeps instead of the (absent)
        # annealed chain state
        with np.load(args.params_from, allow_pickle=False) as z:
            n = 2 * len(ckpt.net_leaf_order(cfg)) + 2
            params = ckpt.params_from_leaves(
                [z[f"arr_{i}"] for i in range(n)], cfg, device)
        x_th = thermalize(gen, state.x, cfg.shape, cfg.beta_final, 500)
        state = state._replace(params=params, x=x_th)
        _trace(f"restored params npz {args.params_from}; "
               f"500-sweep Metropolis thermalization done")
        train_wall = 0.0
    elif args.params_from:
        state = ckpt.restore_checkpoint(args.params_from, state)
        _trace(f"restored params from {args.params_from} "
               f"(step {state.step})")
        train_wall = 0.0
    else:
        chunk = make_train_chunk(cfg, 250)
        _trace(f"training {cfg.train_steps} steps "
               f"(arch={args.arch} filters={args.num_filters} "
               f"hidden={cfg.hidden} K={args.num_steps} "
               f"merge_v={args.merge_v} charge_reward={args.charge_reward})...")
        t0 = time.perf_counter()
        for c in range(cfg.train_steps // 250):
            state, m = chunk(state, gen)
            if c % 4 == 3:
                _trace(f"  step {state.step}: "
                       f"acc={float(m['accept_prob'][-1]):.3f} "
                       f"plaq={float(m['plaqs'][-1]):.5f} "
                       f"eps={float(m['eps'][-1]):.4f}")
        train_wall = time.perf_counter() - t0
        _trace(f"trained in {train_wall:.1f}s wall")
        if args.save_params:
            ckpt.save_checkpoint(args.save_params, state, state.step, cfg)
            _trace(f"saved params to {args.save_params}")
        if args.save_npz:
            np.savez(args.save_npz,
                     *ckpt.leaves_from_params(state.params, cfg),
                     config=json.dumps(dataclasses.asdict(cfg)))
            _trace(f"saved flat params npz to {args.save_npz}")

    beta = cfg.beta_final
    eval_chains = args.eval_chains or cfg.num_chains
    x0 = state.x
    if eval_chains != cfg.num_chains:
        # tile/trim the annealed chains to the eval batch
        reps = int(np.ceil(eval_chains / cfg.num_chains))
        x0 = state.x.repeat(reps, 1)[:eval_chains]
        cfg = dataclasses.replace(cfg, num_chains=eval_chains)
    if args.eval_init == "metropolis":
        x0 = thermalize(gen, x0, cfg.shape, beta, args.therm_sweeps)
        _trace(f"eval chains thermalized ({args.therm_sweeps} exact "
               f"Metropolis sweeps)")

    def result(label, evaluated):
        plaq, q, acc, wall = evaluated[:4]
        return sampler_result(label, plaq, q, acc, wall, args.eval_steps,
                              eval_chains)

    # --- trained kernel, timed on the eager harness ---
    ev = run_eval(cfg, state.params, x0, beta, gen, args.eval_steps)
    x_end = ev[4]
    res_l2 = result("l2hmc_trained", ev)
    _trace(json.dumps(res_l2))

    # --- HMC at its own optimum, same thermalized state, same harness ---
    hmc_cfg = dataclasses.replace(
        cfg, hmc=True, network_arch="zero", eps_init=args.hmc_eps,
        eps_trainable=False, num_steps=args.hmc_num_steps,
        merge_v_halves=False)
    hmc_state = init_train_state(hmc_cfg, gen, device)
    res_hmc = result(f"hmc_K{args.hmc_num_steps}_eps{args.hmc_eps}",
                     run_eval(hmc_cfg, hmc_state.params, x_end, beta, gen,
                              args.eval_steps))
    _trace(json.dumps(res_hmc))

    def ratio(a, b):
        return round(a / max(b, 1e-9), 3)

    result_line = {
        "benchmark": "trained_vs_hmc",
        "label": args.label,
        "config": {
            "size": args.size, "beta": beta, "eval_chains": eval_chains,
            "eval_steps": args.eval_steps, "arch": args.arch,
            "num_filters": args.num_filters, "num_hidden": cfg.hidden,
            "K": args.num_steps, "merge_v": args.merge_v,
            "charge_reward": args.charge_reward,
            "charge_weight": args.charge_weight,
            "train_steps": args.train_steps,
            "eps_init": args.eps_init, "eps_fixed": args.eps_fixed,
            "metric": args.metric,
            "hmc_K": args.hmc_num_steps, "hmc_eps": args.hmc_eps,
        },
        "plaq_exact": round(float(u1.u1_plaq_exact(beta)), 6),
        "q2_exact": round(float(u1.topological_susceptibility_exact(
            beta, cfg.shape.num_plaquettes)), 3),
        "l2hmc": res_l2,
        "hmc": res_hmc,
        "plaq_ess_per_s_ratio": ratio(res_l2["plaq"]["eff_samples_per_s"],
                                      res_hmc["plaq"]["eff_samples_per_s"]),
        "plaq_ess_per_step_ratio": ratio(res_l2["plaq"]["ess_ratio"],
                                         res_hmc["plaq"]["ess_ratio"]),
        "q_ess_per_s_ratio": ratio(res_l2["charge"]["eff_samples_per_s"],
                                   res_hmc["charge"]["eff_samples_per_s"]),
        "tunneling_per_s_ratio": ratio(
            res_l2["tunneling_rate_per_step"] * res_l2["plaq"]["steps_per_s"],
            res_hmc["tunneling_rate_per_step"]
            * res_hmc["plaq"]["steps_per_s"]),
        "train_wall_s": round(train_wall, 1),
    }

    if args.tier == "both":
        # the fused tier: both samplers on their chain kernels
        def fused_res(kind, label, **kw):
            return result(label, run_eval_fused(
                kind, cfg, state.params, x0, beta, gen, args.eval_steps,
                **kw))

        fused = {}
        if args.arch == "mlp" and args.merge_v:
            fused["l2hmc"] = fused_res("l2hmc", "l2hmc_trained_fused")
            _trace(json.dumps(fused["l2hmc"]))
        fused["hmc"] = fused_res(
            "hmc", f"hmc_fused_K{args.hmc_num_steps}_eps{args.hmc_eps}",
            eps=args.hmc_eps, hmc_k=args.hmc_num_steps)
        _trace(json.dumps(fused["hmc"]))
        if "l2hmc" in fused:
            fl, fh = fused["l2hmc"], fused["hmc"]
            fused["plaq_ess_per_s_ratio"] = ratio(
                fl["plaq"]["eff_samples_per_s"],
                fh["plaq"]["eff_samples_per_s"])
            fused["q_ess_per_s_ratio"] = ratio(
                fl["charge"]["eff_samples_per_s"],
                fh["charge"]["eff_samples_per_s"])
            fused["l2hmc_fused_vs_xla_speedup"] = ratio(
                fl["plaq"]["steps_per_s"], res_l2["plaq"]["steps_per_s"])
        result_line["fused_tier"] = fused

    print(json.dumps(result_line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
