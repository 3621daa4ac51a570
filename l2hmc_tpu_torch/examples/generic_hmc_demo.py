"""Plain HMC across the analytic target zoo, with exact-moment checks (port
of ``examples/generic_hmc_demo.py``).

Runs the HMC baseline (``dynamics.hmc.hmc_chain``, autograd forces) on each
analytic target and prints acceptance, ESS and the largest errors of the
first two moments against 20000 exact draws of the target.

Usage: python -m l2hmc_tpu_torch.examples.generic_hmc_demo
"""

import argparse


def zoo(device):
    """``[(name, target, eps)]``: the targets and HMC step sizes."""
    import numpy as np

    from l2hmc_tpu_torch.targets import Gaussian, gen_ring, gmm_axes, scg_2d

    return [
        ("gaussian_4d", Gaussian.create(np.zeros(4), np.eye(4), device),
         0.5),
        ("scg_2d", scg_2d(device), 0.12),
        ("gmm_axes_2d", gmm_axes(2, device=device), 0.2),
        ("gmm_ring", gen_ring(r=1.0, var=0.1, nb_mixtures=4,
                              device=device), 0.2),
    ]


def run(args):
    """``{name: (accept, ess, mean_err, var_err)}`` over :func:`zoo`."""
    import numpy as np
    import torch

    from l2hmc_tpu_torch._device import float32_matmuls, resolve_device
    from l2hmc_tpu_torch.analysis import stats
    from l2hmc_tpu_torch.dynamics.hmc import hmc_chain

    float32_matmuls()
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    out = {}
    for name, tgt, eps in zoo(device):
        x0 = tgt.sample(gen, args.num_chains)
        xs, probs = hmc_chain(tgt.energy, x0, 1.0, gen, eps, 10,
                              args.num_samples)
        xs = xs[args.num_samples // 4:].cpu().numpy()
        ref = tgt.sample(gen, 20000).cpu().numpy()
        mean_err = float(np.abs(xs.mean(axis=(0, 1))
                                - ref.mean(axis=0)).max())
        var_err = float(np.abs(xs.var(axis=(0, 1)) - ref.var(axis=0)).max())
        ess = float(np.mean([stats.calc_ess(xs[:, c, 0])
                             for c in range(min(8, xs.shape[1]))]))
        out[name] = (float(probs.mean()), ess, mean_err, var_err)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--num_chains", type=int, default=128)
    p.add_argument("--num_samples", type=int, default=2000)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA device)")
    args = p.parse_args(argv)

    print(f"{'target':>14} {'acc':>6} {'ess':>7} {'mean_err':>9} "
          f"{'var_err':>8}")
    for name, (acc, ess, mean_err, var_err) in run(args).items():
        print(f"{name:>14} {acc:6.3f} {ess:7.4f} {mean_err:9.4f} "
              f"{var_err:8.4f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
