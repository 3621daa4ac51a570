"""Gauge-equivariant normalizing-flow training CLI for U(1) lattice gauge
theory (port of ``cli/train_flow.py``).

Trains the plaquette-coupling flow (``dynamics/flow.py``) by reverse KL
against the Wilson action, optionally fine-tunes it with a forward-KL term
on HMC samples, then evaluates: importance-reweighted observables with the
weight ESS and the direct log Z, and a flow-proposal independence-Metropolis
chain.  The flags, the run dir (``params.json``, ``metrics.jsonl``,
``checkpoints/``, ``opt_state/``, ``summary.json``) and the summary's keys
are the reference CLI's; ``--device`` picks the device (default: the
card).

Usage::

    python -m l2hmc_tpu_torch.cli.train_flow @configs/flow_8x8.txt
    python -m l2hmc_tpu_torch.cli.train_flow --device cpu --size 4 \\
        --num_layers 8 --batch 64 --train_steps 200

Randomness: one ``torch.Generator`` on the device, seeded with ``--seed``,
makes the initial parameters and then every draw (base samples, the fKL
buffer's HMC chain and batches, the evals).  Every checkpoint holds the
parameters, the optimizer state and the generator's state, so ``--resume``
continues the run with the draws it would have made.  SIGTERM (and Ctrl-C)
saves the state at the start of the interrupted chunk and exits 1.

Two differences from the reference: the optimizer zeroes NaN gradients
before the clip (``train.gauge.Optimizer``; the identity on finite ones),
and on the card every Wilson action runs the kernels of ``csrc/wilson.cu``
and the fKL buffer's HMC chain the kernel of ``csrc/hmc_chain.cu``.
"""

from __future__ import annotations

import copy
import json
import time
from pathlib import Path

from l2hmc_tpu_torch.utils.flags import ArgfileParser


def build_parser():
    p = ArgfileParser(description=__doc__)
    p.add_argument("--size", type=int, default=8)
    p.add_argument("--time_size", type=int, default=0,
                   help="defaults to --size")
    p.add_argument("--beta", type=float, default=2.0)
    p.add_argument("--beta_init", type=float, default=0.0,
                   help="anneal training from here to --beta (0 = off)")
    p.add_argument("--num_layers", type=int, default=16)
    p.add_argument("--n_mix", type=int, default=6)
    p.add_argument("--hidden_channels", type=int, default=32)
    p.add_argument("--conditioner_depth", type=int, default=1,
                   help="hidden conv layers per conditioner")
    p.add_argument("--kernel_size", type=int, default=3,
                   help="conditioner conv kernel (Kanwar et al. use large "
                        "kernels for long-range context at high beta)")
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--train_steps", type=int, default=3000)
    p.add_argument("--lr_init", type=float, default=1e-3)
    p.add_argument("--lr_decay_steps", type=int, default=1000)
    p.add_argument("--lr_decay_rate", type=float, default=0.7)
    p.add_argument("--warmup_steps", type=int, default=100)
    p.add_argument("--clip_grad", type=float, default=10.0)
    p.add_argument("--fkl_steps", type=int, default=0,
                   help="fine-tune steps with loss = reverse_kl + "
                        "fkl_weight * forward_kl(HMC samples)")
    p.add_argument("--fkl_weight", type=float, default=1.0)
    p.add_argument("--fkl_lr", type=float, default=2e-4,
                   help="the fine-tune phase uses its own fresh Adam "
                        "(the restored optimizer carries the main phase's "
                        "decayed schedule count)")
    p.add_argument("--fkl_batch", type=int, default=256)
    p.add_argument("--fkl_buffer", type=int, default=4096,
                   help="HMC-generated target-sample buffer size")
    p.add_argument("--fkl_hmc_eps", type=float, default=0.08)
    p.add_argument("--eval_batch", type=int, default=4096)
    p.add_argument("--mh_steps", type=int, default=1000,
                   help="0 skips the independence-MH eval")
    p.add_argument("--resume", default="",
                   help="run dir of a previous train_flow run: restore "
                        "params + optimizer state and train --train_steps "
                        "MORE steps into the same dir (config comes from "
                        "the checkpoint; size/layer flags are ignored)")
    p.add_argument("--log_dir", default="runs/flow")
    p.add_argument("--logging_steps", type=int, default=100)
    p.add_argument("--ckpt_steps", type=int, default=0,
                   help="checkpoint every N steps during training "
                        "(0 = only at the end)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: this rank's "
                        "CUDA device; without a card it raises: pass "
                        "'cpu' there)")
    return p


def make_optimizers(args):
    """``(main, fkl)`` optimizers: clip by global norm then Adam, the main
    one on the warmup-plus-exponential-decay schedule, the fKL one at the
    constant ``--fkl_lr``."""
    from l2hmc_tpu_torch.train.gauge import Optimizer
    from l2hmc_tpu_torch.train.schedules import make_lr_schedule

    sched = make_lr_schedule(args.lr_init, args.lr_decay_steps,
                             args.lr_decay_rate, args.warmup_steps)
    fkl_lr = float(args.fkl_lr)
    return (Optimizer(sched, args.clip_grad, lambda name: True),
            Optimizer(lambda count: fkl_lr, args.clip_grad,
                      lambda name: True))


def _opt_tensors(opt_state) -> dict:
    return {"count": opt_state.count, "mu": opt_state.mu, "nu": opt_state.nu}


def _apply(params, opt, opt_state, loss):
    """One optimizer step on the flow's parameters from ``loss``."""
    import torch

    named = dict(params.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    updates, opt_state = opt.update(grads, opt_state)
    with torch.no_grad():
        for k, u in updates.items():
            named[k].add_(u)
    return opt_state


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from l2hmc_tpu_torch._device import float32_matmuls, resolve_device
    from l2hmc_tpu_torch.dynamics import flow as F
    from l2hmc_tpu_torch.lattice import u1
    from l2hmc_tpu_torch.train import checkpoint as ckpt
    from l2hmc_tpu_torch.train.gauge import OptState
    from l2hmc_tpu_torch.utils.io import (MetricsLogger,
                                          install_sigterm_handler, is_primary,
                                          log, make_run_dir, save_params_json)

    float32_matmuls()
    device = resolve_device(args.device)
    if args.resume:
        run_dir = Path(args.resume)
        cfg_dict = ckpt.load_config_dict(run_dir / "checkpoints")
        if cfg_dict is None:
            raise FileNotFoundError(
                f"no config.json under {run_dir}/checkpoints — is this a "
                "train_flow run dir?")
        cfg = F.FlowConfig(**cfg_dict)
    else:
        cfg = F.FlowConfig(time_size=args.time_size or args.size,
                           space_size=args.size,
                           num_layers=args.num_layers, n_mix=args.n_mix,
                           hidden_channels=args.hidden_channels,
                           kernel_size=args.kernel_size,
                           conditioner_depth=args.conditioner_depth)
        run_dir = make_run_dir(args.log_dir)
        save_params_json(run_dir, vars(args))
    log(f"run dir: {run_dir}; {cfg.time_size}x{cfg.space_size} "
        f"beta={args.beta} layers={cfg.num_layers} mix={cfg.n_mix} "
        f"ch={cfg.hidden_channels}" + (" (resumed)" if args.resume else ""))

    opt, opt_f = make_optimizers(args)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = F.init_flow(gen, cfg, device)
    opt_state = opt.init(dict(params.named_parameters()))
    start_step = 0
    if args.resume:
        saved = ckpt.load_tensors(run_dir / "checkpoints", device=device)
        params.load_state_dict(saved["params"])
        gen.set_state(saved["generator"].cpu())
        start_step = ckpt.latest_step(run_dir / "checkpoints") or 0
        try:
            o = ckpt.load_tensors(run_dir / "opt_state", device=device)
            opt_state = OptState(count=int(o["count"]), mu=o["mu"],
                                 nu=o["nu"])
        except FileNotFoundError:
            log("no optimizer state in checkpoint; Adam restarts fresh")
        # resumed training continues at the requested beta (no re-anneal)
        args.beta_init = 0.0

    def beta_at(step):
        if args.beta_init <= 0.0:
            return args.beta
        frac = min(1.0, step / max(1, args.train_steps // 2))
        return args.beta_init + (args.beta - args.beta_init) * frac

    def save(snap):
        p, o, g, step = snap
        ckpt.save_tensors(run_dir / "checkpoints",
                          {"params": p.state_dict(), "generator": g}, step,
                          cfg)
        ckpt.save_tensors(run_dir / "opt_state", _opt_tensors(o), step)

    def snapshot(steps_done, o):
        return (copy.deepcopy(params), copy.deepcopy(o), gen.get_state(),
                start_step + steps_done)

    logger = MetricsLogger(run_dir)
    logger.COLUMNS = [
        ("step", "{:>7d}"), ("dt", "{:>8.4f}"), ("beta", "{:>5.2f}"),
        ("loss", "{:>12.4f}"), ("ess_frac", "{:>8.4f}"),
        ("plaq", "{:>8.5f}"),
    ]
    install_sigterm_handler()

    t_prev = time.perf_counter()
    steps_done = 0
    snap = snapshot(0, opt_state)
    try:
        while steps_done < args.train_steps:
            beta = beta_at(steps_done)
            for _ in range(args.logging_steps):
                loss, aux = F.reverse_kl_loss(params, gen, args.batch, beta,
                                              cfg)
                opt_state = _apply(params, opt, opt_state, loss)
            steps_done += args.logging_steps
            rec = {k: float(v) for k, v in aux.items()}
            t_now = time.perf_counter()
            rec.update(step=start_step + steps_done, beta=beta,
                       dt=(t_now - t_prev) / args.logging_steps)
            t_prev = t_now
            logger.write(rec)
            snap = snapshot(steps_done, opt_state)
            if (args.ckpt_steps
                    and steps_done % args.ckpt_steps < args.logging_steps):
                save(snap)

        # ---- phase 2 (optional): forward-KL fine-tune on HMC samples
        if args.fkl_steps > 0:
            from l2hmc_tpu_torch.dynamics.hmc import hmc_chain_u1_fused

            n_chains = args.fkl_buffer // 2
            links = torch.zeros((n_chains, cfg.time_size, cfg.space_size, 2),
                                device=device)
            links, plaq1, _, _ = hmc_chain_u1_fused(
                links, gen, args.fkl_hmc_eps, args.beta, 5, 600)
            links2, plaq2, _, _ = hmc_chain_u1_fused(
                links, gen, args.fkl_hmc_eps, args.beta, 5, 100)
            buffer = torch.cat([links, links2])
            # the chain's plaquette after its first 300 transitions, and
            # the buffer's own: the target's check
            chain_plaq = float(torch.cat([plaq1[300:], plaq2]).mean())
            buf_plaq = u1.avg_plaquette(buffer)
            log(f"fkl buffer: {buffer.shape[0]} HMC-equilibrated configs; "
                f"mean plaquette {float(buf_plaq.mean()):.5f} +- "
                f"{float(buf_plaq.std() / buf_plaq.numel() ** 0.5):.5f}, "
                f"chain {chain_plaq:.5f} (exact "
                f"{float(u1.u1_plaq_exact(args.beta)):.5f})")
            opt_state_f = opt_f.init(dict(params.named_parameters()))
            done = 0
            while done < args.fkl_steps:
                for _ in range(args.logging_steps):
                    idx = torch.randint(0, buffer.shape[0],
                                        (args.fkl_batch,), generator=gen,
                                        device=device)
                    rkl, aux = F.reverse_kl_loss(params, gen, args.batch,
                                                 args.beta, cfg)
                    fkl = F.forward_kl_loss(params, buffer[idx], cfg)
                    opt_state_f = _apply(params, opt_f, opt_state_f,
                                         rkl + args.fkl_weight * fkl)
                done += args.logging_steps
                rec = {k: float(v) for k, v in aux.items()}
                rec.update(fkl=float(fkl.detach()),
                           step=start_step + steps_done + done,
                           beta=args.beta, dt=0.0)
                logger.write(rec)
                log(f"  fkl step {done}: -E_p[logq] {rec['fkl']:.2f} "
                    f"rkl-ess {rec['ess_frac']:.4f}")
                steps_done += args.logging_steps
                snap = snapshot(steps_done, opt_state)
    except (KeyboardInterrupt, SystemExit):
        # SIGTERM (e.g. `timeout`) and Ctrl-C: save the last consistent
        # state (a chunk's start: the steps update params in place)
        log(f"interrupted at step {snap[3]} — saving")
        save(snap)
        logger.close()
        return 1

    save(snapshot(steps_done, opt_state))

    # ---- eval 1: importance-reweighted observables + weight ESS
    x, log_w, log_z = F.importance_weights(params, gen, args.eval_batch,
                                           args.beta, cfg)
    w = torch.exp(log_w)
    plaq_rw = float(torch.sum(w * u1.avg_plaquette(x)))
    q = u1.topological_charge(x)
    chi_rw = float(torch.sum(w * q * q))
    ess_frac = float(1.0 / torch.sum(w * w) / args.eval_batch)
    exact = float(u1.u1_plaq_exact(args.beta))
    # the self-normalized estimate's standard error (delta method)
    plaq_se = float(torch.sqrt(torch.sum(
        torch.square(w * (u1.avg_plaquette(x) - plaq_rw)))))
    log(f"reweighted plaquette {plaq_rw:.5f} +- {plaq_se:.5f} (exact "
        f"{exact:.5f}), weight ESS {ess_frac * args.eval_batch:.1f} of "
        f"{args.eval_batch}")

    # ---- eval 2: flow-proposal independence MH (skipped if --mh_steps 0)
    if args.mh_steps > 0:
        with torch.no_grad():
            x0, logq0 = F.sample_and_logq(params, gen, args.eval_batch // 4,
                                          cfg)
        _, plaqs, accs = F.independence_mh_chain(
            params, gen, x0, logq0, args.beta, args.mh_steps, cfg)
        therm = args.mh_steps // 4
        mh_accept = round(float(torch.mean(accs)), 4)
        mh_plaq = round(float(torch.mean(plaqs[therm:])), 5)
    else:
        mh_accept = mh_plaq = None
    summary = {
        "lattice": f"{cfg.time_size}x{cfg.space_size}",
        "beta": args.beta,
        "weight_ess_frac": round(ess_frac, 4),
        "plaq_reweighted": round(plaq_rw, 5),
        "plaq_exact": round(exact, 5),
        "chi_q_reweighted": round(chi_rw, 4),
        "chi_q_exact": round(float(u1.topological_susceptibility_exact(
            args.beta, cfg.shape.num_plaquettes)), 4),
        "mh_accept": mh_accept,
        "mh_plaq": mh_plaq,
        "log_z_flow": round(float(log_z), 2),
        "log_z_exact_factorized": round(
            u1.log_z_exact_factorized(cfg.shape, args.beta), 2),
    }
    if is_primary():
        (run_dir / "summary.json").write_text(json.dumps(summary, indent=2))
    log(json.dumps(summary))
    logger.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
