"""VAE-with-L2HMC-posterior-sampler training CLI (port of
``cli/train_vae.py``).

Train a VAE whose posterior over latents is refined by an L2HMC sampler
conditioned on the data batch, then run the two evaluations: the AIS
log-likelihood on held-out data and the autocovariance / ESS / acceptance
of the trained posterior sampler.  The flags (the reference's HParams
names ``--epoch --leapfrogs --MH --batch_size --latent_dim --eps
--learning_rate``), the data split and batch order (numpy
``default_rng(seed)``), the run dir (``params.json``, ``metrics.jsonl``
with the reference's columns, ``checkpoints/`` on interrupt,
``summary.json``) and the summary's keys are the reference CLI's;
``--device`` picks the device (default: the card).

The default data are the bundled binarized 8x8 digits
(``l2hmc_tpu_torch/data/digits_binarized.npz``); ``--data path.npy`` takes
any (N, D) binary array.

Usage::

    python -m l2hmc_tpu_torch.cli.train_vae @configs/vae_digits.txt
    python -m l2hmc_tpu_torch.cli.train_vae --device cpu --epoch 2

Randomness: one ``torch.Generator`` on the device, seeded with ``--seed``,
makes the initial parameters and then every draw.  SIGTERM (and Ctrl-C)
checkpoints the state (params, the three Adam groups' state, step,
generator) under ``checkpoints/<step>/`` and exits non-zero.
"""

from __future__ import annotations

import json
import time

from l2hmc_tpu_torch.utils.flags import ArgfileParser


def build_parser():
    p = ArgfileParser(description=__doc__)
    # reference HParams
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--epoch", type=int, default=20)
    p.add_argument("--leapfrogs", type=int, default=5)
    p.add_argument("--MH", type=int, default=2,
                   help="sequential L2HMC transitions per step")
    p.add_argument("--random_lf_composition", type=int, default=0,
                   help="each MH step composes a random 1..N full leapfrog "
                        "integrations before one accept (chain_operator; "
                        "0=off)")
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--latent_dim", type=int, default=8)
    p.add_argument("--eps", type=float, default=0.1)
    # architecture
    p.add_argument("--enc_hidden", type=int, default=256)
    p.add_argument("--dec_hidden", type=int, default=256)
    p.add_argument("--sampler_hidden", type=int, default=64)
    # data / eval
    p.add_argument("--data", default="",
                   help="optional .npy of binary pixels; default bundled digits")
    p.add_argument("--ais_betas", type=int, default=100,
                   help="AIS annealing rungs for the log-lik eval")
    p.add_argument("--ais_samples", type=int, default=256,
                   help="held-out data points for the AIS eval")
    p.add_argument("--eval_transitions", type=int, default=200,
                   help="chain length for the sampler autocovariance eval")
    p.add_argument("--log_dir", default="runs/vae")
    p.add_argument("--logging_steps", type=int, default=20)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA device)")
    return p


METRIC_COLUMNS = [
    ("step", "{:>7d}"), ("epoch", "{:>5d}"), ("dt", "{:>8.4f}"),
    ("elbo", "{:>12.4f}"), ("sampler_loss", "{:>12.4g}"),
    ("decoder_nll", "{:>12.4f}"), ("accept_prob", "{:>7.4f}"),
]


def main(argv=None):
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from l2hmc_tpu_torch._device import float32_matmuls, resolve_device
    from l2hmc_tpu_torch.train import checkpoint as ckpt
    from l2hmc_tpu_torch.train.vae import (
        VAEConfig, ais_log_likelihood, load_digits_binarized,
        make_vae_train_step, posterior_sampler_autocovariance,
    )
    from l2hmc_tpu_torch.utils.io import (
        MetricsLogger, install_sigterm_handler, log, make_run_dir,
        save_params_json,
    )

    float32_matmuls()
    install_sigterm_handler()
    device = resolve_device(args.device)
    if args.data:
        data = np.load(args.data).astype(np.float32)
    else:
        data = load_digits_binarized()
    rng = np.random.default_rng(args.seed)
    perm = rng.permutation(len(data))
    n_test = min(args.ais_samples, len(data) // 5)
    test, train = data[perm[:n_test]], data[perm[n_test:]]

    cfg = VAEConfig(
        data_dim=data.shape[1], latent_dim=args.latent_dim,
        enc_hidden=args.enc_hidden, dec_hidden=args.dec_hidden,
        num_steps=args.leapfrogs, mh_steps=args.MH, eps_init=args.eps,
        sampler_hidden=args.sampler_hidden,
        random_lf_composition=args.random_lf_composition,
        lr_elbo=args.learning_rate, lr_sampler=args.learning_rate,
        lr_decoder=args.learning_rate,
    )
    gen = torch.Generator(device=device).manual_seed(args.seed)
    run_dir = make_run_dir(args.log_dir)
    save_params_json(run_dir, vars(args))
    log(f"run dir: {run_dir}; data {train.shape} train / {test.shape} test")

    init_state, train_step, fns = make_vae_train_step(cfg)
    state = init_state(gen, device)
    train_dev = torch.as_tensor(train, device=device)

    logger = MetricsLogger(run_dir)
    logger.COLUMNS = METRIC_COLUMNS

    steps_per_epoch = max(1, len(train) // args.batch_size)
    step = 0
    t_prev = time.perf_counter()
    try:
        for epoch in range(args.epoch):
            order = rng.permutation(len(train))
            for i in range(steps_per_epoch):
                idx = order[i * args.batch_size:(i + 1) * args.batch_size]
                if len(idx) < args.batch_size:  # the reference's padding
                    idx = np.concatenate(
                        [idx, np.arange(args.batch_size - len(idx))])
                batch = train_dev[torch.as_tensor(idx, device=device)]
                state, aux = train_step(state, batch, gen)
                step += 1
                if step % args.logging_steps == 0:
                    t_now = time.perf_counter()
                    rec = {k: float(v) for k, v in aux.items()}
                    rec.update(step=step, epoch=epoch,
                               dt=(t_now - t_prev) / args.logging_steps)
                    t_prev = t_now
                    logger.write(rec)
    except (KeyboardInterrupt, SystemExit):
        log(f"interrupted at step {step}; checkpointing...")
        ckpt.save_tensors(run_dir / "checkpoints", {
            "params": state.params.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "step": step, "generator": gen.get_state()}, step)
        logger.close()
        raise

    log("AIS log-likelihood eval...")
    test_dev = torch.as_tensor(test, device=device)
    logw = ais_log_likelihood(cfg, fns, state.params, test_dev, gen,
                              num_betas=args.ais_betas,
                              eps=args.eps).cpu().numpy()
    log("sampler autocovariance eval...")
    mix = posterior_sampler_autocovariance(
        cfg, fns, state.params, test_dev[: args.batch_size], gen,
        num_transitions=args.eval_transitions)

    summary = {
        "ais_log_likelihood_mean": float(logw.mean()),
        "ais_log_likelihood_sem": float(logw.std() / np.sqrt(len(logw))),
        "sampler_ess_per_step": mix["ess_per_step"],
        "sampler_accept_prob": mix["accept_prob"],
        "final_elbo": float(aux["elbo"]),
    }
    (run_dir / "summary.json").write_text(json.dumps(summary, indent=2))
    log(json.dumps(summary, indent=2))
    logger.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
