"""SU(N) lattice gauge sampling / training CLI (port of
``cli/train_sun.py``).

Sample 2-D SU(2)/SU(3) lattice gauge theory with Lie-group HMC, or train
the augmented (L2HMC-style) momentum kernel and evaluate it; every run
reports the measured average plaquette beside the exact Weyl-measure
single-plaquette value.  ``--dims`` runs the d-dimensional HMC path
(``lattice/sun_nd.py``) against the strong-coupling value.  The flags, the
run dir (``params.json``, ``metrics.jsonl``, ``checkpoints/`` on
interrupt, ``eval.json``) and ``eval.json``'s keys are the reference
CLI's; ``--device`` picks the device (default: the card).

Links are complex64 on every device (the reference switches to float32
(re, im) pairs off the CPU because its TPU runtime rejects complex
dtypes).  ``--learn_position`` raises: the JAX package has no learned
position update for SU(N) (its CLI passes the flag to a config without
such a field).

Usage::

    python -m l2hmc_tpu_torch.cli.train_sun --n 3 --beta 4.0 --hmc --run_steps 2000
    python -m l2hmc_tpu_torch.cli.train_sun --n 2 --beta 2.0 --train_steps 1000
    python -m l2hmc_tpu_torch.cli.train_sun --dims 3 3 3 3 --n 2 --beta 0.5

Randomness: one ``torch.Generator`` on the device, seeded with ``--seed``,
makes the links, the init and every draw.
"""

from __future__ import annotations

import json
import time

from l2hmc_tpu_torch.utils.flags import ArgfileParser


def build_parser():
    p = ArgfileParser(description=__doc__)
    p.add_argument("--n", type=int, default=2, choices=[2, 3], help="SU(N)")
    p.add_argument("--time_size", type=int, default=8)
    p.add_argument("--space_size", type=int, default=8)
    p.add_argument("--dims", type=int, nargs="+", default=None,
                   help="d-dimensional lattice extents (e.g. --dims 4 4 4 4 "
                        "for 4-D); HMC-only path via lattice.sun_nd")
    p.add_argument("--rect_c1", type=float, default=0.0,
                   help="rectangle-improved action coefficient "
                        "(with --dims; 0 = Wilson, -1/12 = tree Symanzik)")
    p.add_argument("--beta", type=float, default=2.0)
    p.add_argument("--num_samples", type=int, default=32, help="chains")
    p.add_argument("--num_steps", type=int, default=3, help="leapfrog steps")
    p.add_argument("--eps", type=float, default=0.15)
    p.add_argument("--hmc", action="store_true", help="plain HMC, no training")
    p.add_argument("--learn_position", action="store_true",
                   help="not available: the JAX package has no learned "
                        "position update for SU(N)")
    p.add_argument("--num_hidden", type=int, default=32)
    p.add_argument("--train_steps", type=int, default=1000)
    p.add_argument("--lr_init", type=float, default=1e-3)
    p.add_argument("--warmup_steps", type=int, default=100)
    p.add_argument("--loss_scale", type=float, default=0.1)
    p.add_argument("--run_steps", type=int, default=1000, help="eval transitions")
    p.add_argument("--therm_frac", type=float, default=0.25)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--log_dir", default="runs/sun")
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA device)")
    return p


def _dims_path(args, device, gen, run_dir, logger):
    """The d-dimensional HMC path; writes ``eval.json``."""
    import numpy as np

    from l2hmc_tpu_torch.lattice.sun_nd import (
        sun_nd_hmc_chain, sun_plaq_strong_coupling,
    )
    from l2hmc_tpu_torch.utils.io import log

    if not args.hmc:
        log("--dims implies --hmc (the learned kernel is 2-D); "
            "sampling with plain Lie-group HMC")
    t0 = time.perf_counter()
    plaqs, probs = sun_nd_hmc_chain(
        gen, n=args.n, dims=tuple(args.dims), beta=args.beta,
        num_samples=args.run_steps, batch=args.num_samples, eps=args.eps,
        num_steps=args.num_steps, c1=args.rect_c1, device=device)
    plaqs, probs = plaqs.cpu().numpy(), probs.cpu().numpy()
    secs = time.perf_counter() - t0
    cut = int(args.therm_frac * args.run_steps)
    meas = float(plaqs[cut:].mean())
    summary = {
        "n": args.n, "beta": args.beta, "dims": list(args.dims),
        "rect_c1": args.rect_c1, "plaq": meas,
        "plaq_strong_coupling_lo": sun_plaq_strong_coupling(args.n,
                                                            args.beta),
        "accept_prob": float(probs.mean()),
        "mode": "hmc_nd",
    }
    (run_dir / "eval.json").write_text(json.dumps(summary, indent=2))
    log(f"SU({args.n}) {'x'.join(map(str, args.dims))} beta={args.beta:g}"
        f" c1={args.rect_c1:g}: plaq={meas:.5f} "
        f"(strong-coupling LO {summary['plaq_strong_coupling_lo']:.5f}) "
        f"acc={summary['accept_prob']:.3f} "
        f"({1e3 * secs / args.run_steps:.3f} ms/transition) -> {run_dir}")
    logger.close()
    return 0


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.learn_position:
        raise NotImplementedError(
            "--learn_position: the JAX package has no learned position "
            "update for SU(N) (its SUNL2HMCConfig has no such field), so the "
            "port has none either")

    import numpy as np
    import torch

    from l2hmc_tpu_torch._device import float32_matmuls, resolve_device
    from l2hmc_tpu_torch.dynamics.sun_hmc import (
        avg_plaquette, sun_hmc_transition, sun_plaq_exact,
    )
    from l2hmc_tpu_torch.dynamics.sun_l2hmc import (
        SUNL2HMCConfig, init_sun_l2hmc, make_sun_optimizer,
        make_sun_train_step, named_leaves, plaq_trace_distance,
    )
    from l2hmc_tpu_torch.lattice.sun import random_sun
    from l2hmc_tpu_torch.train import checkpoint as ckpt
    from l2hmc_tpu_torch.utils.io import (
        MetricsLogger, install_sigterm_handler, log, make_run_dir,
        save_params_json,
    )

    float32_matmuls()
    install_sigterm_handler()
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    run_dir = make_run_dir(args.log_dir)
    save_params_json(run_dir, vars(args))
    logger = MetricsLogger(run_dir)

    if args.dims is not None:
        return _dims_path(args, device, gen, run_dir, logger)

    n, beta = args.n, args.beta
    exact = sun_plaq_exact(n, beta)
    u = random_sun(gen, n, (args.num_samples, args.time_size,
                            args.space_size, 2), scale=0.5, device=device)
    cfg = SUNL2HMCConfig(n=n, num_steps=args.num_steps, eps_init=args.eps,
                         hidden=args.num_hidden, eps_trainable=not args.hmc)
    opt = make_sun_optimizer(args.lr_init, args.warmup_steps)
    train_step, dyn = make_sun_train_step(cfg, beta, opt,
                                          loss_scale=args.loss_scale)
    params = init_sun_l2hmc(gen, cfg, device)

    if not args.hmc and args.train_steps:
        opt_state = opt.init(named_leaves(params))
        chunk_len = min(args.train_steps, 100)
        t0 = time.time()
        done = 0
        snap = (0, {"params": {k: v.detach().clone() for k, v in
                               params.state_dict().items()},
                    "links": u.clone()})
        try:
            while done < args.train_steps:
                for _ in range(chunk_len):
                    params, opt_state, u, m = train_step(params, opt_state,
                                                         u, gen)
                done += chunk_len
                rec = {k_: float(v) for k_, v in m.items()}
                rec.update(step=done, wall_s=round(time.time() - t0, 2))
                logger.write(rec)
                log(f"step {done}: loss={rec['loss']:.3f} "
                    f"acc={rec['accept_prob']:.3f} eps={rec['eps']:.4f}")
                snap = (done, {
                    "params": {k: v.detach().clone() for k, v in
                               params.state_dict().items()},
                    "links": u.clone(), "opt_count": opt_state.count,
                    "mu": dict(opt_state.mu), "nu": dict(opt_state.nu),
                    "generator": gen.get_state()})
        except (KeyboardInterrupt, SystemExit):
            # the state at the end of the last whole chunk
            log(f"interrupted at step {snap[0]}; checkpointing...")
            ckpt.save_tensors(run_dir / "checkpoints", snap[1], snap[0])
            logger.close()
            raise

    # evaluation (trained kernel, or plain HMC with --hmc)
    plaqs, probs, dists = [], [], []
    t0 = time.perf_counter()
    with torch.no_grad():
        for _ in range(args.run_steps):
            if args.hmc:
                out = sun_hmc_transition(u, beta, gen, args.eps,
                                         args.num_steps, n)
                links, prob = out.links, out.accept_prob
            else:
                o = dyn["transition"](params, u, gen)
                links, prob = o["x_out"], o["accept_prob"]
            dists.append(plaq_trace_distance(u, links))
            u = links
            plaqs.append(avg_plaquette(links))
            probs.append(prob)
    plaqs = torch.stack(plaqs).cpu().numpy()
    probs = torch.stack(probs).cpu().numpy()
    dists = torch.stack(dists).cpu().numpy()
    ms = 1e3 * (time.perf_counter() - t0) / max(args.run_steps, 1)
    cut = int(args.therm_frac * args.run_steps)
    meas = float(plaqs[cut:].mean())
    summary = {
        "n": n, "beta": beta,
        "plaq": meas, "plaq_exact": float(exact),
        "plaq_err": abs(meas - float(exact)),
        "accept_prob": float(probs.mean()),
        "esjd_plaq_trace": float(dists[cut:].mean()),
        "mode": "hmc" if args.hmc else "l2hmc",
    }
    (run_dir / "eval.json").write_text(json.dumps(summary, indent=2))
    np.save(run_dir / "eval_plaq.npy", plaqs)
    log(f"SU({n}) beta={beta:g}: plaq={meas:.5f} (exact {float(exact):.5f}) "
        f"acc={summary['accept_prob']:.3f} "
        f"ESJD={summary['esjd_plaq_trace']:.5f} ({ms:.3f} ms/transition)"
        f" -> {run_dir}")
    logger.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
