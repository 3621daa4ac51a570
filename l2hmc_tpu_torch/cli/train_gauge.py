"""U(1) gauge L2HMC training CLI (port of ``cli/train_gauge.py``).

Train the learned sampler, checkpoint, and finish with the eval protocol at
``beta_final`` and ``beta_final - 1`` (``--run_steps`` transitions each).
The flags, their defaults, the run-dir files (``params.json``,
``metrics.jsonl``, ``checkpoints/``, ``eval_beta*.json``,
``eval_beta*.npz``) and the log lines are the reference CLI's, so
``cli/analyze_run.py`` of either package reads a run dir of either.  The
run is on the first CUDA device unless ``--device`` says otherwise.

Usage::

    python -m l2hmc_tpu_torch.cli.train_gauge @configs/gauge_8x8.txt
    python -m l2hmc_tpu_torch.cli.train_gauge --space_size 8 --train_steps 5000 --hmc
    python -m l2hmc_tpu_torch.cli.train_gauge --device cpu --time_size 4 \
        --space_size 4 --num_samples 8 --train_steps 100 --run_steps 100

Randomness: one ``torch.Generator`` on the device, seeded with ``--seed``,
makes the initial state and then every train step's draws, as
``train.gauge.train_to_convergence`` does (so the two agree for the same
seed and a chunk of ``--logging_steps``); a retraining attempt ``a``
starts a generator seeded with ``seed + 7700 + a``.  Each checkpoint holds
the generator's state after its step, so ``--restore`` continues the run
with the draws it would have made.  The eval protocol goes on drawing from
the same generator.

``--autotune`` runs the cold-start (K, eps) search of ``train/autotune.py``
before training (skipped when ``--restore`` finds a checkpoint).

Retraining (``--retrain_acc``): each checkpoint records its training
attempt and the attempts finished so far; checkpoints are ordered by
(attempt, step), so ``--restore`` re-enters the newest attempt at its
step with that attempt's generator state, and a restored finished attempt
whose end acceptance is below ``--retrain_acc`` goes on to the next
attempt.  An interrupt inside a chunk checkpoints the state at the chunk's
start (the train step updates the params in place).

Data parallelism: under a launcher the run trains data-parallel over
every rank, as the reference CLI shards its train state over the mesh::

    torchrun --standalone --nproc_per_node=N -m l2hmc_tpu_torch.cli.train_gauge ...

(``--device cpu`` for gloo ranks on the CPU; by default NCCL, one card per
rank).  Every rank seeds the same generator and keeps its slice of the
chains (``parallel/mesh.py``); only global rank 0 writes the run dir, the
checkpoints (the full state, gathered) and the eval files, and logs.  With
no launcher nothing changes.

``--profile`` traces the first logging chunk with ``torch.profiler``
(``<run_dir>/profile/trace.json.gz``) and writes its op table to
``<run_dir>/profile_top_ops.txt`` (``analysis/profile_digest.py``: device
time on the card, CPU self time on the CPU; on the card also the card's
idle time by program span, ``utils/trace.py``); with ``--profile_every N``
every N-th chunk too, into ``<run_dir>/timeline_<step>/``, as the JAX CLI
does.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

from l2hmc_tpu_torch.utils.flags import ArgfileParser


def build_parser() -> argparse.ArgumentParser:
    p = ArgfileParser(description=__doc__)
    # lattice / dynamics (names follow the reference flags)
    p.add_argument("--time_size", type=int, default=8)
    p.add_argument("--space_size", type=int, default=8)
    p.add_argument("--num_samples", type=int, default=128, help="number of chains")
    p.add_argument("--num_steps", type=int, default=3, help="leapfrog steps")
    p.add_argument("--eps", default="0.35",
                   help="initial step size, or 'auto' for the volume-scaled "
                        "rule 0.35*(64/V)^(1/4) (leapfrog error grows ~V*eps^4; "
                        "a constant eps at large V starts in the zero-acceptance "
                        "dead-gradient trap)")
    p.add_argument("--eps_fixed", action="store_true", help="freeze step size")
    p.add_argument("--eps_cap", type=float, default=0.0,
                   help="upper bound on trainable eps (0 = unbounded)")
    p.add_argument("--eps_warmup_steps", type=int, default=0,
                   help="dual-averaging warmup: adapt eps to the target "
                        "acceptance for the first N steps, then hand off to "
                        "gradient training (replaces hand-tuned eps at "
                        "large volume; don't combine with --eps_cap)")
    p.add_argument("--eps_target_accept", type=float, default=0.7,
                   help="acceptance target for --eps_warmup_steps")
    p.add_argument("--autotune", action="store_true",
                   help="cold-start joint (K, eps) search before training "
                        "(train/autotune.py): tunes HMC's optimum at this "
                        "volume/beta, then probe-trains coarse-K trained "
                        "cells around its trajectory length and overrides "
                        "--num_steps/--eps with the winner; implies "
                        "--eps_fixed")
    p.add_argument("--autotune_probe_steps", type=int, default=8000,
                   help="probe-training depth per autotune cell (coarse-K "
                        "acceptance rescue needs ~10k steps to mature)")
    p.add_argument("--hmc", action="store_true", help="plain-HMC mode (zero nets)")
    p.add_argument("--network_arch", default="conv",
                   choices=["conv", "mlp", "local", "local_flat", "zero"])
    p.add_argument("--num_hidden", type=int, default=0, help="0 -> 2*x_dim")
    p.add_argument("--num_filters", type=int, default=8,
                   help="conv stack width; channel count for --network_arch local")
    p.add_argument("--local_kernel", type=int, default=3,
                   help="conv kernel size for the weight-shared local conditioner")
    p.add_argument("--local_layers", type=int, default=2,
                   help="conv depth for the local conditioner")
    p.add_argument("--bf16", action="store_true", help="bfloat16 network matmuls")
    p.add_argument("--group", default="u1", choices=["u1", "r1"],
                   help="kernel state space: exact torus (u1) or flat+wrap (r1)")
    p.add_argument("--train_hops", action="store_true",
                   help="interleave exact instanton hops (dynamics/topo.py) "
                        "into the training chain: keeps the training-state "
                        "distribution Q-sector-complete where annealed "
                        "chains freeze (beta >= 5)")
    p.add_argument("--eval_hops", type=int, default=0,
                   help="interleave N exact instanton hops (dynamics/topo.py)"
                        " per step into EVERY eval chain — the topological-"
                        "channel winner (16x16 beta=5: tunneling/s ~165x "
                        "tuned HMC, all hop cost counted).  Surfaces "
                        "hop_accept/hop_dq in the eval summary")
    p.add_argument("--nu_max", type=int, default=1,
                   help="max |winding| per hop proposal (--eval_hops)")
    p.add_argument("--retrain_acc", type=float, default=0.0,
                   help="detect-and-retrain threshold on end-of-training "
                        "acceptance (0 = off).  beta >= 5 trainings land in "
                        "two separable basins (end acc ~0.55 failed vs "
                        "~0.87 converged, RESULTS.md); 0.7 auto-reseeds "
                        "the failures so the shipped recipe is "
                        "unconditional.  Attempts are recorded in "
                        "params.json")
    p.add_argument("--max_retrains", type=int, default=3,
                   help="extra training attempts for --retrain_acc")
    p.add_argument("--merge_v_halves", action="store_true",
                   help="merge adjacent momentum half-steps across leapfrog "
                        "steps (K+1 VNet calls instead of 2K; exact kernel, "
                        "different learned family)")
    # loss
    p.add_argument("--action", default="wilson", choices=["wilson", "improved"],
                   help="gauge action: Wilson or tree-level Symanzik-improved")
    p.add_argument("--rect_c1", type=float, default=-1.0 / 12.0,
                   help="rectangle coefficient for --action improved")
    p.add_argument("--metric", default="cos_diff",
                   help="ESJD metric: l1|l2|cos|cos2|cos_diff (link space, "
                        "reference zoo) or plaq_cos|plaq_cos2 (observable "
                        "space: jump in the plaquette field cos P)")
    p.add_argument("--loss_scale", type=float, default=0.1)
    p.add_argument("--std_weight", type=float, default=1.0)
    p.add_argument("--aux_weight", type=float, default=1.0)
    p.add_argument("--charge_weight", type=float, default=1.0)
    p.add_argument("--charge_reward", action="store_true",
                   help="flip the charge term to REWARD accepted charge "
                        "movement (loss -= w*px*dq); default keeps the "
                        "reference's literal penalizing sign "
                        "(gauge_model.py:783-795)")
    p.add_argument("--ref_z_term", action="store_true",
                   help="literal reference z-term dataflow: z std/charge "
                        "terms computed against the X-chain proposal "
                        "(gauge_model.py:776,788); default uses the z "
                        "proposal")
    # optimization / annealing
    p.add_argument("--lr_init", type=float, default=1e-3)
    p.add_argument("--lr_decay_steps", type=int, default=1000)
    p.add_argument("--lr_decay_rate", type=float, default=0.96)
    p.add_argument("--clip_value", type=float, default=1.0)
    p.add_argument("--train_steps", type=int, default=5000)
    p.add_argument("--beta_init", type=float, default=2.0)
    p.add_argument("--beta_final", type=float, default=4.0)
    # run management
    p.add_argument("--log_dir", default="runs/gauge")
    p.add_argument("--logging_steps", type=int, default=50)
    p.add_argument("--save_steps", type=int, default=1000)
    p.add_argument("--eval_steps", type=int, default=0,
                   help="in-training eval every N steps (0=off)")
    p.add_argument("--run_steps", type=int, default=2000,
                   help="post-training eval steps per beta")
    p.add_argument("--eval_init", default="train",
                   choices=["train", "random", "metropolis"],
                   help="eval chain start: annealed training chains (default; "
                        "fresh random chains can freeze in metastable defects "
                        "at large beta), reference-parity random, or the "
                        "annealed chains equilibrated by exact checkerboard "
                        "Metropolis sweeps at the eval beta (the standard "
                        "lattice warm start; required at 64x64 where a fast "
                        "anneal leaves chains in a >10k-step metastable "
                        "plateau -- RESULTS.md)")
    p.add_argument("--eval_therm_sweeps", type=int, default=2000,
                   help="Metropolis sweeps for --eval_init metropolis")
    p.add_argument("--restore", action="store_true")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--tensorboard", action="store_true", help="write TB scalar summaries")
    p.add_argument("--summary_steps", type=int, default=0,
                   help="per-variable param summaries every N steps (0=off; "
                        "reference variable_summaries, utils/tf_logging.py:74-86)")
    p.add_argument("--grad_summaries", action="store_true",
                   help="per-variable parameter AND gradient "
                        "mean/std/min/max/l2 stats computed on-device each "
                        "step, written into every metrics.jsonl record "
                        "(reference _create_summaries, gauge_model.py:853-886)")
    p.add_argument("--profile", action="store_true",
                   help="torch.profiler trace of the first logging chunk "
                        "and its op digest (profile_top_ops.txt)")
    p.add_argument("--profile_every", type=int, default=0,
                   help="with --profile: re-trace one chunk every N "
                        "logging chunks into timeline_<step>/ dirs — the "
                        "reference's per-logging-step Chrome-trace "
                        "timelines (gauge_model.py:1250-1265)")
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: this rank's "
                        "CUDA device; without a card it raises: pass "
                        "'cpu' there)")
    return p


def resolve_eps(a) -> float:
    if str(a.eps) != "auto":
        return float(a.eps)
    vol = a.time_size * a.space_size
    return 0.35 * (64.0 / vol) ** 0.25


def flags_to_config(a):
    from l2hmc_tpu_torch.train.gauge import GaugeConfig

    return GaugeConfig(
        time_size=a.time_size, space_size=a.space_size,
        num_chains=a.num_samples, num_steps=a.num_steps,
        eps_init=resolve_eps(a),
        eps_cap=a.eps_cap, eps_trainable=not a.eps_fixed, hmc=a.hmc,
        network_arch="zero" if a.hmc else a.network_arch,
        num_hidden=a.num_hidden, num_filters=a.num_filters, use_bf16=a.bf16,
        local_kernel=a.local_kernel, local_layers=a.local_layers,
        metric=a.metric, loss_scale=a.loss_scale, std_weight=a.std_weight,
        aux_weight=a.aux_weight, charge_weight=a.charge_weight,
        charge_reward=a.charge_reward, ref_z_term=a.ref_z_term,
        lr_init=a.lr_init, lr_decay_steps=a.lr_decay_steps,
        lr_decay_rate=a.lr_decay_rate, clip_value=a.clip_value,
        train_steps=a.train_steps, beta_init=a.beta_init,
        beta_final=a.beta_final, group=a.group,
        action=a.action, rect_c1=a.rect_c1,
        merge_v_halves=a.merge_v_halves, train_hops=a.train_hops,
        eps_warmup_steps=a.eps_warmup_steps,
        eps_target_accept=a.eps_target_accept,
        grad_summaries=a.grad_summaries,
    )


def _autotune(cfg, args, device):
    """Cold-start joint (K, eps) search (``train/autotune.py``): HMC's
    optimum at the target distribution (1000 Metropolis sweeps at
    ``beta_final`` first), then the trained kernel's coarse-K cells around
    its trajectory length.  Returns ``cfg`` with the winner's K and fixed
    eps.  Draws from a generator of its own (seeded ``seed + 1``), so the
    training that follows draws as ``train_to_convergence`` would with the
    tuned config."""
    import dataclasses

    import torch

    from l2hmc_tpu_torch.lattice import u1
    from l2hmc_tpu_torch.lattice.metropolis import thermalize
    from l2hmc_tpu_torch.train.autotune import tune_hmc, tune_l2hmc
    from l2hmc_tpu_torch.utils.io import log

    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    x0 = u1.random_links(gen, cfg.num_chains, cfg.shape, device=device)
    x_th = thermalize(gen, x0, cfg.shape, cfg.beta_final, 1000)
    probe_chains = max(cfg.num_chains, 512)
    hmc_opt = tune_hmc(cfg, x_th, cfg.beta_final, gen,
                       probe_chains=probe_chains)
    log(f"autotune: HMC optimum K={hmc_opt.num_steps} eps={hmc_opt.eps} "
        f"acc={hmc_opt.accept:.3f}")
    l2_opt = tune_l2hmc(cfg, gen, hmc_opt,
                        probe_train_steps=args.autotune_probe_steps,
                        probe_chains=probe_chains, device=device)
    log(f"autotune: trained cell K={l2_opt.num_steps} eps={l2_opt.eps} "
        f"(probe acc {l2_opt.accept:.3f})")
    return dataclasses.replace(cfg, num_steps=l2_opt.num_steps,
                               eps_init=l2_opt.eps, eps_trainable=False)


def _run_number(path: Path) -> int:
    tail = path.parent.name.split("_")[-1]
    return int(tail) if tail.isdigit() else -1


def main(argv=None, tf32: bool = False):
    """The CLI; ``tf32=True`` runs matmuls and convolutions in TF32 (an
    explicit choice for ``benchmarks/dp_parity.py``), else float32
    (``_device.float32_matmuls``)."""
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    import torch.distributed as dist

    from l2hmc_tpu_torch._device import float32_matmuls, resolve_device
    from l2hmc_tpu_torch.analysis import stats
    from l2hmc_tpu_torch.lattice import u1
    from l2hmc_tpu_torch.parallel.mesh import (
        gather_chains, get_mesh, initialize_distributed, shard_chains,
        shard_train_state,
    )
    from l2hmc_tpu_torch.train import checkpoint as ckpt
    from l2hmc_tpu_torch.train.gauge import (
        clone_train_state, init_train_state, make_eval_chunk,
        make_train_chunk,
    )
    from l2hmc_tpu_torch.utils.io import (
        MetricsLogger, install_sigterm_handler, is_primary, log,
        make_run_dir, save_params_json,
    )

    float32_matmuls(tf32)
    install_sigterm_handler()
    launched = initialize_distributed(args.device)
    device = resolve_device(args.device)
    cfg = flags_to_config(args)
    # the reference builds its mesh on every run; here a mesh exists where
    # a process group does, and a lone process keeps the plain path
    mesh = get_mesh(device=device) if dist.is_initialized() else None

    run_dir = make_run_dir(args.log_dir)
    save_params_json(run_dir, vars(args))
    log(f"run dir: {run_dir}")
    log(f"devices: [{device}"
        + (f" {torch.cuda.get_device_name(device)}]" if device.type == "cuda"
           else "]")
        + (f" x {mesh.world} ranks (data-parallel)" if mesh else ""))
    x_dim = 2 * cfg.time_size * cfg.space_size
    if (not cfg.hmc and x_dim > 16384 and cfg.eps_warmup_steps == 0
            and (cfg.lr_init > 5e-5 or cfg.eps_trainable)):
        log(f"WARNING: x_dim={x_dim} with lr_init={cfg.lr_init} and "
            f"eps_trainable={cfg.eps_trainable} — at this volume the "
            "dead-gradient trap closes easily; use --eps_warmup_steps "
            "(dual-averaging warmup finds the stable eps automatically) "
            "and a small lr (e.g. --lr_init 2e-5, RESULTS.md)")

    # --autotune composes badly with --restore: the search could change
    # num_steps (masks shape (K, d)) after a checkpoint already fixed it.
    # When a checkpoint exists, the tuned (K, eps) are already baked into
    # the restored state: skip the search.
    has_ckpt = args.restore and any(
        Path(args.log_dir).glob("run_*/checkpoints"))
    if args.autotune and has_ckpt:
        log("autotune: skipped — restoring from an existing checkpoint "
            "(its (K, eps) are fixed by the saved state)")
    if args.autotune and not cfg.hmc and not has_ckpt:
        # one search for every rank: its cells are scored by wall-clock
        # rates, so ranks tuning on their own could pick different (K,
        # eps); rank 0 tunes and sends the winner
        box = [_autotune(cfg, args, device) if is_primary() else None]
        if mesh is not None:
            dist.broadcast_object_list(box, src=0)
        cfg = box[0]

    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = shard_train_state(init_train_state(cfg, gen, device), mesh)
    start_step = 0
    attempt = 0
    # finished attempts, {"attempt", "end_accept"}
    attempts = []
    ckpt_dir = run_dir / "checkpoints"
    if args.restore:
        # restore from the newest run (by run number) that has checkpoints,
        # its newest checkpoint by (attempt, step)
        prev = sorted(Path(args.log_dir).glob("run_*/checkpoints"),
                      key=_run_number)
        if prev:
            ckpt_src = prev[-1]
            key = ckpt.latest_checkpoint(ckpt_src)
            if key is not None:
                attempt, step = key
                state = ckpt.restore_checkpoint(ckpt_src, state, step,
                                                generator=gen,
                                                attempt=attempt, mesh=mesh)
                attempts = ckpt.checkpoint_attempts(ckpt_src, step,
                                                    attempt)[1]
                start_step = int(state.step)
                log(f"restored step {start_step} of training attempt "
                    f"{attempt} from {ckpt_src}")

    chunk_size = args.logging_steps
    train_chunk = make_train_chunk(cfg, chunk_size, mesh=mesh)
    eval_chunk = (make_eval_chunk(cfg, 500, mesh)
                  if args.eval_steps else None)

    logger = MetricsLogger(run_dir, print_every=1, tensorboard=args.tensorboard)
    t_prev = time.perf_counter()
    # the generator's state that goes with `state` (saved with it)
    gen_state = gen.get_state()
    max_attempts = 1 + (args.max_retrains if args.retrain_acc > 0 else 0)
    # the newest consistent (state, generator state, finished attempts,
    # attempt): the train step updates the params in place, so an interrupt
    # inside a chunk checkpoints this snapshot, not the half-updated params
    snapshot = (clone_train_state(state), gen_state, list(attempts), attempt)

    def save(st, g_state, done, att):
        ckpt.save_checkpoint(ckpt_dir, st, int(st.step), cfg,
                             generator_state=g_state, attempt=att,
                             attempts=done, mesh=mesh)

    try:
        while True:
            n_chunks = max((cfg.train_steps - start_step) // chunk_size, 0)
            if n_chunks:
                # a restored attempt trained on (a larger --train_steps) is
                # judged again at its new end
                attempts = [a for a in attempts if a["attempt"] != attempt]
            end_acc = float("nan")
            for c in range(n_chunks):
                if args.profile and (c == 0 or (args.profile_every > 0
                                                and c % args.profile_every
                                                == 0)):
                    # the JAX CLI's traced chunks: the first into profile/
                    # (digest in the run dir), every profile_every-th into
                    # timeline_<step>/ with its digest
                    from l2hmc_tpu_torch.analysis import profile_digest

                    tdir = run_dir / ("profile" if c == 0
                                      else f"timeline_{int(state.step)}")
                    with profile_digest.trace(tdir, device,
                                              is_primary()) as prof:
                        state, metrics = train_chunk(state, gen)
                    if is_primary():
                        digest = profile_digest.write_digest(
                            prof, run_dir if c == 0 else tdir)
                        if digest is not None:
                            log(f"profile digest: {digest}")
                else:
                    state, metrics = train_chunk(state, gen)
                gen_state = gen.get_state()
                metrics = {k: v.cpu().numpy() for k, v in metrics.items()}
                step = int(state.step)
                t_now = time.perf_counter()
                acc_arr = metrics["accept_prob"]
                end_acc = float(acc_arr[-min(50, chunk_size):].mean())
                if c == n_chunks - 1:
                    attempts.append({"attempt": attempt,
                                     "end_accept": round(end_acc, 4)})
                rec = {k: float(v[-1]) for k, v in metrics.items()}
                rec.update(
                    step=step,
                    dt=(t_now - t_prev) / chunk_size,
                    plaq_exact=float(u1.u1_plaq_exact(rec["beta"])),
                )
                t_prev = t_now
                logger.write(rec)

                if args.summary_steps and step % args.summary_steps < chunk_size:
                    logger.write_summaries(step, state.params)
                if eval_chunk is not None and step % args.eval_steps < chunk_size:
                    x_eval = shard_chains(u1.random_links(
                        gen, cfg.num_chains, cfg.shape, device=device), mesh)
                    _, em = eval_chunk(state.params, x_eval, rec["beta"], gen)
                    gen_state = gen.get_state()
                    log(
                        f"  eval@{step}: acc={float(em['accept_prob'].mean()):.4f} "
                        f"plaq={float(em['plaqs'][250:].mean()):.5f}"
                    )
                if (c == n_chunks - 1 or args.save_steps
                        and step % args.save_steps < chunk_size):
                    save(state, gen_state, attempts, attempt)
                snapshot = (clone_train_state(state), gen_state,
                            list(attempts), attempt)
            record = next((a for a in attempts if a["attempt"] == attempt),
                          None)
            if record is None:
                # nothing trained and nothing recorded (--train_steps 0):
                # no attempt to judge
                attempts.append({"attempt": attempt, "end_accept": end_acc})
                break
            end_acc = record["end_accept"]
            if (args.retrain_acc <= 0 or end_acc >= args.retrain_acc
                    or attempt + 1 >= max_attempts):
                break
            log(f"training attempt {attempt}: end acc {end_acc:.3f} < "
                f"{args.retrain_acc} (half-acceptance basin) — retraining "
                f"with a fresh seed")
            attempt += 1
            gen = torch.Generator(device=device).manual_seed(
                args.seed + 7700 + attempt)
            state = shard_train_state(init_train_state(cfg, gen, device),
                                      mesh)
            start_step = 0
            gen_state = gen.get_state()
            snapshot = (clone_train_state(state), gen_state, list(attempts),
                        attempt)
    except (KeyboardInterrupt, SystemExit):
        st, g_state, done, att = snapshot
        log(f"interrupted at step {int(st.step)} of training attempt "
            f"{att}; checkpointing...")
        save(st, g_state, done, att)
        logger.close()
        raise

    if attempts:
        save_params_json(run_dir, dict(vars(args),
                                       train_attempts=attempts))
    if n_chunks == 0:
        # nothing trained in this run: its run dir still gets the state
        save(state, gen_state, attempts, attempt)

    # post-training eval protocol; --eval_hops interleaves exact instanton
    # hops into every eval chain (dynamics/topo.py)
    if args.run_steps:
        n_eval = min(args.run_steps, 1000)
        if args.eval_hops > 0:
            from l2hmc_tpu_torch.dynamics import topo

            eval_chunk = topo.make_hop_eval_chunk(
                cfg, n_eval, n_hops=args.eval_hops, nu_max=args.nu_max,
                mesh=mesh)
        else:
            eval_chunk = make_eval_chunk(cfg, n_eval, mesh)
        for beta in (cfg.beta_final, cfg.beta_final - 1.0):
            if args.eval_init == "train":
                x = state.x
            elif args.eval_init == "metropolis":
                from l2hmc_tpu_torch.lattice.metropolis import thermalize

                # the sweeps draw per link: every rank sweeps the whole
                # batch (the one-process draws) and keeps its chains
                x = shard_chains(thermalize(
                    gen, gather_chains(state.x, mesh), cfg.shape, beta,
                    args.eval_therm_sweeps), mesh)
                log(f"  eval init: {args.eval_therm_sweeps} Metropolis "
                    f"sweeps at beta={beta:g}")
            else:
                x = shard_chains(u1.random_links(
                    gen, cfg.num_chains, cfg.shape, device=device), mesh)
            all_metrics = {}
            done = 0
            t_eval = time.perf_counter()
            while done < args.run_steps:
                x, em = eval_chunk(state.params, x, beta, gen)
                for k, v in em.items():
                    all_metrics.setdefault(k, []).append(v.cpu().numpy())
                done += n_eval
            t_eval = time.perf_counter() - t_eval
            merged = {k: np.concatenate(v) for k, v in all_metrics.items()}
            summary = stats.observables_stats(
                {k: v.mean(axis=-1) for k, v in merged.items()}
            )
            # <Q^2> squares per-chain charges (the chain average would bias
            # it low by ~1/num_chains)
            q_full = stats.therm_cut(merged["charges"])
            summary["charges"]["susceptibility"] = float((q_full ** 2).mean())
            summary["charges"]["histogram"] = stats.charge_histogram(q_full)
            tau_q, tau_ok = stats.pooled_integrated_time(q_full)
            summary["charges"]["tau_int_pooled"] = round(float(tau_q), 2)
            summary["charges"]["tau_int_pooled_reliable"] = bool(tau_ok)
            tau_q1, _ = stats.integrated_time(q_full.mean(axis=-1))
            summary["charges"]["tau_int_sokal_single"] = round(
                float(tau_q1), 2)
            summary["plaq_exact"] = float(u1.u1_plaq_exact(beta))
            summary["wloop22_exact"] = float(u1.wilson_loop_exact(beta, 4))
            if args.action == "wilson":
                summary["q2_exact"] = float(
                    u1.topological_susceptibility_exact(
                        beta, cfg.shape.num_plaquettes)
                )
            out_file = run_dir / f"eval_beta{beta:g}.json"
            if is_primary():
                out_file.write_text(json.dumps(summary, indent=2,
                                               default=str))
                np.savez_compressed(run_dir / f"eval_beta{beta:g}.npz",
                                    **merged)
            q2_note = (f" <Q^2>={summary['charges']['susceptibility']:.4f}"
                       f" (exact {summary['q2_exact']:.4f})"
                       if "q2_exact" in summary else "")
            hop_note = ""
            if "hop_accept" in summary:
                hop_note = (
                    f" hop_acc={summary['hop_accept']['mean']:.4f}"
                    f" hop_dq={summary['hop_dq']['mean']:.4f}")
            tau_note = (
                f" tau_Q(pooled)={summary['charges']['tau_int_pooled']:g}"
                + ("" if summary["charges"]["tau_int_pooled_reliable"]
                   else "(unreliable)"))
            log(f"eval beta={beta:g}: plaq={summary['plaqs']['mean']:.5f} "
                f"(exact {summary['plaq_exact']:.5f}) "
                f"acc={summary['accept_prob']['mean']:.4f}{q2_note}"
                f"{hop_note}{tau_note}"
                f" -> {out_file}")
            log(f"eval beta={beta:g}: {done} transitions of "
                f"{cfg.num_chains} chains in {t_eval:.3f} s "
                f"({done / t_eval:.1f} transitions/s)")

    logger.close()
    if launched:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
