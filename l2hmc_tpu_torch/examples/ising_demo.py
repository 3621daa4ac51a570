"""2-D Ising sweep across the critical temperature (port of
``examples/ising_demo.py``).

Checkerboard Metropolis chains at a ladder of temperatures: |magnetization|
is ~1 deep in the ordered phase, ~0 in the disordered phase, crossing near
the exact Onsager critical temperature ``T_c = 2 / ln(1 + sqrt 2) = 2.269``.
Exits 1 unless |m| > 0.9 at T = 1.5 and < 0.3 at T = 3.5.

Usage: python -m l2hmc_tpu_torch.examples.ising_demo [--l 16]
"""

import argparse


def run(args):
    """``{T: (|m|, E per site)}`` past the first third of each chain."""
    import torch

    from l2hmc_tpu_torch._device import float32_matmuls, resolve_device
    from l2hmc_tpu_torch.lattice.ising import ising_chain

    float32_matmuls()
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    out = {}
    for t in (1.5, 2.0, 2.27, 2.6, 3.5):
        e, m = ising_chain(gen, args.l, 1.0 / t, args.num_sweeps,
                           batch=args.batch, device=device)
        cut = args.num_sweeps // 3
        out[t] = (float(m[cut:].mean()),
                  float(e[cut:].mean()) / (args.l * args.l))
    return out


def main(argv=None):
    import numpy as np

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--l", type=int, default=16)
    p.add_argument("--num_sweeps", type=int, default=600)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA device)")
    args = p.parse_args(argv)

    t_c = 2.0 / np.log(1.0 + np.sqrt(2.0))
    print(f"L={args.l}, exact T_c = {t_c:.4f}")
    print(f"{'T':>6} {'|m|':>7} {'E/site':>8}")
    res = run(args)
    for t, (mm, ee) in res.items():
        print(f"{t:6.2f} {mm:7.4f} {ee:8.4f}")
    ok = res[1.5][0] > 0.9 and res[3.5][0] < 0.3
    print("OK" if ok else "MISMATCH: the ordered phase should be ~fully "
          "magnetized and the disordered ~unmagnetized")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
