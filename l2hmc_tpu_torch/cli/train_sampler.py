"""Analytic-target L2HMC sampler training CLI (port of
``cli/train_sampler.py``).

Pick a target (Gaussian-mixture arrangements, ring, strongly-correlated
Gaussian, rough well, funnel), train the sampler with the squared-jump
loss, optionally anneal the temperature with the schedule adapted from
measured tunneling rates, then report ESS, acceptance, moments and
tunneling against plain HMC at the trained eps.  The flags, the run dir
(``params.json``, ``metrics.jsonl`` with the reference's columns,
``checkpoints/`` on interrupt, ``summary.json``) and the summary's keys
are the reference CLI's; ``--device`` picks the device (default: the
card).

Usage::

    python -m l2hmc_tpu_torch.cli.train_sampler @configs/scg_2d.txt
    python -m l2hmc_tpu_torch.cli.train_sampler @configs/mog_2d.txt
    python -m l2hmc_tpu_torch.cli.train_sampler --device cpu --target scg \\
        --train_steps 200 --eval_steps 200

``--target gmm_axes`` is the pair of modes at ``+-sep`` on the first axis
(``gmm_single_axis``, which ``configs/mog_2d.txt`` relies on), not one mode
per axis (``gmm_one_per_axis``).

Randomness: one ``torch.Generator`` on the device, seeded with ``--seed``,
makes the initial state and then every draw (training, diagnostics, the
final evals).  SIGTERM (and Ctrl-C) checkpoints the state at the start of
the interrupted chunk (params, optimizer state, chains, temperature,
generator) under ``checkpoints/<step>/`` and exits non-zero.
"""

from __future__ import annotations

import copy
import json
import time

from l2hmc_tpu_torch.utils.flags import ArgfileParser


def build_parser():
    p = ArgfileParser(description=__doc__)
    p.add_argument("--target", default="scg",
                   choices=["scg", "tilted", "gmm_axes", "gmm_single_axis",
                            "gmm_one_per_axis", "gmm_diagonal", "gmm_ring",
                            "rough_well", "funnel"],
                   help="gmm_axes == reference 'single_axis' (pair at +-sep "
                        "on axis 0); gmm_one_per_axis == reference 'axes' "
                        "(one mode per coordinate axis); gmm_diagonal == "
                        "reference 'diagonal' (pair at +-sep*ones)")
    p.add_argument("--dim", type=int, default=2)
    p.add_argument("--sep", type=float, default=2.0,
                   help="GMM mode separation")
    p.add_argument("--var", type=float, default=0.1,
                   help="GMM component variance")
    p.add_argument("--nb_mixtures", type=int, default=4, help="ring modes")
    # sampler / training
    p.add_argument("--num_samples", type=int, default=200)
    p.add_argument("--num_steps", type=int, default=10)
    p.add_argument("--eps", type=float, default=0.1)
    p.add_argument("--num_hidden", type=int, default=10)
    p.add_argument("--loss_scale", type=float, default=0.1)
    p.add_argument("--lr_init", type=float, default=1e-3)
    p.add_argument("--train_steps", type=int, default=5000)
    p.add_argument("--hmc", action="store_true")
    # annealing
    p.add_argument("--annealing", action="store_true")
    p.add_argument("--temp_init", type=float, default=10.0)
    p.add_argument("--annealing_steps", type=int, default=100)
    p.add_argument("--annealing_factor", type=float, default=0.98)
    p.add_argument("--tunneling_rate_steps", type=int, default=500,
                   help="diagnostics + schedule adaptation interval")
    # eval
    p.add_argument("--eval_steps", type=int, default=2000)
    p.add_argument("--log_dir", default="runs/sampler")
    p.add_argument("--logging_steps", type=int, default=100)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA device; "
                        "'cpu' runs the plain versions on the CPU)")
    return p


def make_target(args, device):
    """``(target, modes)``: the target of ``args.target`` on ``device`` and
    its mode centres as a numpy array (``None`` for a one-mode target)."""
    from l2hmc_tpu_torch import targets as T

    def with_modes(t):
        return t, t.mus.cpu().numpy()

    kw = dict(sep=args.sep, var=args.var, device=device)
    if args.target == "scg":
        return T.scg_2d(device), None
    if args.target == "tilted":
        return T.random_tilted_gaussian(args.seed, args.dim,
                                        device=device), None
    if args.target in ("gmm_axes", "gmm_single_axis"):
        return with_modes(T.gmm_single_axis(args.dim, **kw))
    if args.target == "gmm_one_per_axis":
        return with_modes(T.gmm_one_per_axis(args.dim, **kw))
    if args.target == "gmm_diagonal":
        return with_modes(T.gmm_diagonal(args.dim, **kw))
    if args.target == "gmm_ring":
        return with_modes(T.gen_ring(r=args.sep, var=args.var,
                                     nb_mixtures=args.nb_mixtures,
                                     device=device))
    if args.target == "rough_well":
        return T.RoughWell(dim=args.dim, eps=0.1), None
    if args.target == "funnel":
        return T.GaussianFunnel(dim=args.dim), None
    raise ValueError(args.target)


def main(argv=None):
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from l2hmc_tpu_torch._device import float32_matmuls, resolve_device
    from l2hmc_tpu_torch.analysis import stats
    from l2hmc_tpu_torch.dynamics.hmc import hmc_chain
    from l2hmc_tpu_torch.train import checkpoint as ckpt
    from l2hmc_tpu_torch.train import schedules
    from l2hmc_tpu_torch.train.sampler import (
        SamplerConfig, init_sampler_state, make_sample_chain,
        make_sampler_train_chunk,
    )
    from l2hmc_tpu_torch.utils.io import (
        MetricsLogger, install_sigterm_handler, log, make_run_dir,
        save_params_json,
    )

    float32_matmuls()
    install_sigterm_handler()
    device = resolve_device(args.device)
    target, modes = make_target(args, device)
    dim = 2 if args.target in ("scg", "gmm_ring") else args.dim
    cfg = SamplerConfig(
        x_dim=dim, num_chains=args.num_samples, num_steps=args.num_steps,
        eps_init=args.eps, num_hidden=args.num_hidden, hmc=args.hmc,
        loss_scale=args.loss_scale, lr_init=args.lr_init,
        train_steps=args.train_steps, use_annealing=args.annealing,
        temp_init=args.temp_init, annealing_steps=args.annealing_steps,
        annealing_factor=args.annealing_factor,
    )
    gen = torch.Generator(device=device).manual_seed(args.seed)
    run_dir = make_run_dir(args.log_dir)
    save_params_json(run_dir, vars(args))
    log(f"run dir: {run_dir}; target={args.target} dim={dim}")

    state = init_sampler_state(cfg, target.energy, gen, device=device)
    chunk = make_sampler_train_chunk(cfg, target.energy, args.logging_steps)
    sample = make_sample_chain(cfg, target.energy)

    logger = MetricsLogger(run_dir)
    logger.COLUMNS = [
        ("step", "{:>7d}"), ("dt", "{:>8.3f}"), ("loss", "{:>12.4g}"),
        ("accept_prob", "{:>7.4f}"), ("eps", "{:>7.4f}"),
        ("temperature", "{:>6.2f}"), ("tunneling_rate", "{:>7.4f}"),
    ]

    def snapshot(steps):
        """What a checkpoint holds, copied: the train step updates the
        params in place, so the state at a chunk's start is kept."""
        opt = state.opt_state
        return steps, {
            "params": copy.deepcopy(state.params.state_dict()),
            "opt_count": opt.count,
            "mu": {k: v.clone() for k, v in opt.mu.items()},
            "nu": {k: v.clone() for k, v in opt.nu.items()},
            "x": state.x.clone(), "step": state.step,
            "temp": [float(state.temp.temperature),
                     float(state.temp.annealing_factor),
                     int(state.temp.steps_since_update)],
            "generator": gen.get_state(),
        }

    t_prev = time.perf_counter()
    steps_done = 0
    snap = snapshot(0)
    try:
        while steps_done < cfg.train_steps:
            state, m = chunk(state, gen)
            steps_done += args.logging_steps
            t_now = time.perf_counter()
            rec = {k: float(v[-1]) for k, v in m.items()}
            rec.update(step=steps_done,
                       dt=(t_now - t_prev) / args.logging_steps)
            t_prev = t_now

            # periodic tunneling diagnostics + schedule adaptation
            if (modes is not None and steps_done % args.tunneling_rate_steps
                    < args.logging_steps):
                xs, _ = sample(state.params, state.x, gen, 200)
                xs = xs.cpu().numpy()
                rates = [stats.tunneling_rate(xs[:, c], modes)
                         for c in range(min(16, xs.shape[1]))]
                jk_mean, jk_err = stats.jackknife(np.asarray(rates),
                                                  num_blocks=4)
                rec["tunneling_rate"] = jk_mean
                if args.annealing:
                    state = state._replace(
                        temp=schedules.adapt_temperature_schedule(
                            state.temp, jk_mean))
                log(f"  tunneling rate: {jk_mean:.4f} +- {jk_err:.4f}")
            logger.write(rec)
            snap = snapshot(steps_done)
    except (KeyboardInterrupt, SystemExit):
        log(f"interrupted at step {snap[0]}; checkpointing...")
        ckpt.save_tensors(run_dir / "checkpoints", snap[1], snap[0])
        logger.close()
        raise

    # final eval: ESS + moments, and HMC at the trained eps
    x0 = torch.zeros((cfg.num_chains, dim), device=device)
    xs, probs = sample(state.params, x0, gen, args.eval_steps)
    xs_hmc, probs_hmc = hmc_chain(
        target.energy, x0, 1.0, gen, float(m["eps"][-1]), cfg.num_steps,
        args.eval_steps)
    xs, probs = xs.cpu().numpy(), probs.cpu().numpy()
    xs_hmc, probs_hmc = xs_hmc.cpu().numpy(), probs_hmc.cpu().numpy()

    def ess_of(arr):
        return float(np.mean([stats.calc_ess(arr[:, c, 0])
                              for c in range(min(16, arr.shape[1]))]))

    def tunneling_of(arr):
        return float(np.mean([stats.tunneling_rate(arr[:, c], modes)
                              for c in range(min(16, arr.shape[1]))]))

    kept = xs[args.eval_steps // 4:]
    summary = {
        "l2hmc": {
            "ess_per_step": ess_of(xs),
            "accept": float(probs.mean()),
            "mean": kept.mean(axis=(0, 1)).tolist(),
            "std": kept.std(axis=(0, 1)).tolist(),
        },
        "hmc": {
            "ess_per_step": ess_of(xs_hmc),
            "accept": float(probs_hmc.mean()),
        },
    }
    if modes is not None:
        summary["l2hmc"]["tunneling_rate"] = tunneling_of(xs)
        summary["hmc"]["tunneling_rate"] = tunneling_of(xs_hmc)
    (run_dir / "summary.json").write_text(json.dumps(summary, indent=2))
    log(json.dumps(summary, indent=2))
    logger.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
