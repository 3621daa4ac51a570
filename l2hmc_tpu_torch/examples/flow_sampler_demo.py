"""Gauge-equivariant normalizing flow on U(1), end to end (port of
``examples/flow_sampler_demo.py``).

Trains a plaquette-coupling flow (``dynamics/flow.py``) by reverse KL,
then checks three exactness anchors:

  1. the importance-reweighted plaquette against ``I1(beta)/I0(beta)``,
  2. the direct log Z from the weights against the factorized value,
  3. a flow-proposal independence-Metropolis chain's plaquette.

Exits 1 unless all three hit.

Usage: python -m l2hmc_tpu_torch.examples.flow_sampler_demo [--size 8 --beta 1.5]
"""

import argparse


def run(args):
    """Train and check: ``{"plaq", "exact", "log_z", "log_z_exact",
    "mh_plaq", "mh_accept"}``."""
    import torch

    from l2hmc_tpu_torch._device import float32_matmuls, resolve_device
    from l2hmc_tpu_torch.cli.train_flow import _apply
    from l2hmc_tpu_torch.dynamics import flow as F
    from l2hmc_tpu_torch.lattice import u1
    from l2hmc_tpu_torch.train.gauge import Optimizer

    float32_matmuls()
    device = resolve_device(args.device)
    cfg = F.FlowConfig(time_size=args.size, space_size=args.size,
                       num_layers=12, n_mix=4, hidden_channels=16)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = F.init_flow(gen, cfg, device)
    # Adam at lr 2e-3, no clip
    opt = Optimizer(lambda count: 2e-3, 0.0, lambda name: True)
    opt_state = opt.init(dict(params.named_parameters()))

    print(f"{args.size}x{args.size} beta={args.beta}: training "
          f"{args.train_steps} steps...", flush=True)
    for i in range(args.train_steps):
        loss, aux = F.reverse_kl_loss(params, gen, args.batch, args.beta,
                                      cfg)
        opt_state = _apply(params, opt, opt_state, loss)
        if (i + 1) % 100 == 0:
            print(f"  step {i+1:4d}  KL-loss {float(aux['loss']):9.2f}  "
                  f"weight-ESS {float(aux['ess_frac']):.3f}", flush=True)

    x, log_w, log_z = F.importance_weights(params, gen, 4096, args.beta, cfg)
    with torch.no_grad():
        x0, logq0 = F.sample_and_logq(params, gen, 256, cfg)
    _, plaqs, accs = F.independence_mh_chain(params, gen, x0, logq0,
                                             args.beta, 300, cfg)
    return {"plaq": float(torch.sum(torch.exp(log_w) * u1.avg_plaquette(x))),
            "exact": float(u1.u1_plaq_exact(args.beta)),
            "log_z": float(log_z),
            "log_z_exact": float(u1.log_z_exact_factorized(cfg.shape,
                                                           args.beta)),
            "mh_plaq": float(plaqs[75:].mean()),
            "mh_accept": float(accs.mean())}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--size", type=int, default=8,
                   help="lattice side (must be divisible by 4: the mod-4 "
                        "coupling stripes require it)")
    p.add_argument("--beta", type=float, default=1.5)
    p.add_argument("--train_steps", type=int, default=500)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA device)")
    args = p.parse_args(argv)

    r = run(args)
    print(f"reweighted plaquette {r['plaq']:.5f}   exact {r['exact']:.5f}")
    print(f"direct log Z {r['log_z']:9.2f}   factorized exact "
          f"{r['log_z_exact']:9.2f}")
    print(f"independence-MH plaquette {r['mh_plaq']:.5f}  accept "
          f"{r['mh_accept']:.3f}")
    ok = (abs(r["plaq"] - r["exact"]) < 0.02
          and abs(r["log_z"] - r["log_z_exact"]) < 1.0
          and abs(r["mh_plaq"] - r["exact"]) < 0.02)
    print("OK: all three anchors hit" if ok else "MISMATCH — investigate")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
