"""Transition time against lattice volume (port of
``benchmarks/volume_sweep.py``, the reference's ``training_times.ipynb``).

The reference notebook fits time per step against the target's
dimensionality as a power law ``a * x^b``.  This times sampling
transitions of the configured dynamics (eager torch, every force and
Hamiltonian through the Wilson kernels on the card) at a fixed chain count
across L in {8, 16, 32, 64}, best of three chunks after a warm one, then
fits the power law by least squares in log-log.

Each size's row goes to stderr as it is measured; the fit, with the rows,
is one JSON line on stdout with the JAX script's keys (``platform``:
"gpu" on the card, else the device's type).  Randomness: one
``torch.Generator`` seeded 0 per size makes the init, the links and every
draw in order.

Usage::

    python -m l2hmc_tpu_torch.benchmarks.volume_sweep [--num_chains 128]
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--num_chains", type=int, default=128)
    p.add_argument("--sizes", type=int, nargs="+", default=[8, 16, 32, 64])
    p.add_argument("--arch", default="conv")
    p.add_argument("--chunk", type=int, default=50)
    p.add_argument("--hidden_cap", type=int, default=4096,
                   help="cap on the dense-trunk width (the default 2*x_dim "
                        "grows as L^2)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA device)")
    return p


def power_law_fit(dims, ms):
    """``(b, a)`` of the least-squares fit ``log ms = log a + b log dims``."""
    import numpy as np

    b, log_a = np.polyfit(np.log(np.asarray(dims, float)),
                          np.log(np.asarray(ms, float)), 1)
    return float(b), float(np.exp(log_a))


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from l2hmc_tpu_torch._device import float32_matmuls, resolve_device
    from l2hmc_tpu_torch.lattice import u1
    from l2hmc_tpu_torch.train import gauge as G

    float32_matmuls()
    device = resolve_device(args.device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    rows = []
    for l in args.sizes:
        cfg = G.GaugeConfig(
            time_size=l, space_size=l, num_chains=args.num_chains,
            num_steps=3, network_arch=args.arch, eps_init=0.32 / l * 2.5,
            # the default hidden = 2*x_dim grows as L^2: cap it as the
            # 32x32 training runs do
            num_hidden=min(2 * 2 * l * l, args.hidden_cap),
        )
        gen = torch.Generator(device=device).manual_seed(0)
        state = G.init_train_state(cfg, gen, device)
        _, dyn = G.build_dynamics(cfg)

        @torch.no_grad()
        def chunk(params, x):
            probs = []
            for _ in range(args.chunk):
                out = dyn["transition_with"](
                    params, x, 4.0, *G.draw_transition(gen, x))
                x = u1.wrap(out.x_out)
                probs.append(out.accept_prob)
            return x, torch.stack(probs).mean()

        x = u1.random_links(gen, cfg.num_chains, cfg.shape, device=device)
        x, acc = chunk(state.params, x)
        sync()
        best = 1e9
        for _ in range(3):
            t0 = time.perf_counter()
            x, acc = chunk(state.params, x)
            float(x.sum())                     # drains
            best = min(best, time.perf_counter() - t0)
        ms = best / args.chunk * 1e3
        rows.append({"l": l, "x_dim": 2 * l * l,
                     "ms_per_transition": round(ms, 4),
                     "accept": round(float(acc), 3)})
        print(json.dumps(rows[-1]), file=sys.stderr, flush=True)

    b, a = power_law_fit([r["x_dim"] for r in rows],
                         [r["ms_per_transition"] for r in rows])
    print(json.dumps({
        "metric": "transition_ms_vs_dim_power_law",
        "exponent_b": round(b, 3),
        "coeff_a_ms": round(a, 6),
        "rows": rows,
        "platform": "gpu" if device.type == "cuda" else device.type,
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
