"""SCG experiment: trained L2HMC vs HMC on the strongly-correlated Gaussian
(port of ``examples/scg_experiment.py``).

A 2-D Gaussian with condition number 1e4: plain HMC mixes slowly along the
stiff direction; the learned kernel rescales it away.  Prints the ESS per
sample of both samplers, averaged over 8 chains and both coordinates, and
exits 1 if the trained sampler does not beat HMC.

Usage: python -m l2hmc_tpu_torch.examples.scg_experiment [--train_steps 3000]
"""

import argparse
import time


def run(args):
    """Train, then sample both samplers from exact draws of the target:
    ``{"l2hmc": (accept, ess), "hmc": (accept, ess)}``."""
    import numpy as np
    import torch

    from l2hmc_tpu_torch._device import float32_matmuls, resolve_device
    from l2hmc_tpu_torch.analysis import stats
    from l2hmc_tpu_torch.dynamics.hmc import hmc_chain
    from l2hmc_tpu_torch.targets import scg_2d
    from l2hmc_tpu_torch.train.sampler import (
        SamplerConfig, init_sampler_state, make_sample_chain,
        make_sampler_train_chunk,
    )

    float32_matmuls()
    device = resolve_device(args.device)
    target = scg_2d(device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    cfg = SamplerConfig(x_dim=2, num_chains=args.num_chains, num_steps=10,
                        eps_init=0.1, num_hidden=10,
                        train_steps=args.train_steps)

    state = init_sampler_state(cfg, target.energy, gen, device=device)
    chunk_size = min(500, cfg.train_steps)
    chunk = make_sampler_train_chunk(cfg, target.energy, chunk_size)
    t0 = time.perf_counter()
    done = 0
    while done < cfg.train_steps:
        state, m = chunk(state, gen)
        done += chunk_size
        print(f"step {done:5d}  loss {float(m['loss'][-1]):10.3f}  "
              f"acc {float(m['accept_prob'][-1]):.3f}  "
              f"eps {float(m['eps'][-1]):.4f}", flush=True)
    print(f"trained in {time.perf_counter() - t0:.1f}s")

    sample = make_sample_chain(cfg, target.energy)
    x0 = target.sample(gen, args.num_chains)
    xs, probs = sample(state.params, x0, gen, args.eval_steps)
    # the HMC baseline at a tuned step size
    xs_h, probs_h = hmc_chain(target.energy, x0, 1.0, gen, 0.15, 10,
                              args.eval_steps)

    def ess(arr):
        arr = arr.cpu().numpy()
        return float(np.mean([stats.calc_ess(arr[:, c, d])
                              for c in range(min(8, arr.shape[1]))
                              for d in range(2)]))

    return {"l2hmc": (float(probs.mean()), ess(xs)),
            "hmc": (float(probs_h.mean()), ess(xs_h))}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--train_steps", type=int, default=3000)
    p.add_argument("--num_chains", type=int, default=200)
    p.add_argument("--eval_steps", type=int, default=2000)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA device)")
    args = p.parse_args(argv)

    res = run(args)
    (acc_l, e_l), (acc_h, e_h) = res["l2hmc"], res["hmc"]
    print(f"\nL2HMC: acc {acc_l:.3f}  ESS/sample {e_l:.4f}")
    print(f"HMC:   acc {acc_h:.3f}  ESS/sample {e_h:.4f}")
    print(f"ESS gain: {e_l / max(e_h, 1e-9):.1f}x")
    if e_l <= e_h:
        print("MISMATCH: the trained sampler should beat HMC on the SCG "
              "target")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
