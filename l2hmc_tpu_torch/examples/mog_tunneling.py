"""MoG experiment: mode tunneling, trained L2HMC (annealed) vs HMC (port of
``examples/mog_tunneling.py``).

A 2-D mixture of two Gaussians at +-2 on the first axis: HMC stays in one
mode; the temperature-annealed learned kernel hops between them.  A thin
wrapper over the CLI recipe (``cli.train_sampler --target gmm_axes
--annealing``): training with the tunneling-driven schedule adaptation, an
eval of both samplers from one start, then the tunneling rates read from
the run dir's ``summary.json``.  Exits 1 unless the learned kernel tunnels
more than 5x as often as HMC.

Usage: python -m l2hmc_tpu_torch.examples.mog_tunneling [--train_steps 4000]
"""

import argparse
import json
from pathlib import Path


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--train_steps", type=int, default=4000)
    p.add_argument("--eval_steps", type=int, default=2000)
    p.add_argument("--log_dir", default="runs/examples/mog")
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA device)")
    args = p.parse_args(argv)

    from l2hmc_tpu_torch.cli.train_sampler import main as sampler_main
    from l2hmc_tpu_torch.utils.io import latest_run_dir

    sampler_main([
        "--target", "gmm_axes", "--annealing",
        "--train_steps", str(args.train_steps),
        "--eval_steps", str(args.eval_steps),
        "--log_dir", args.log_dir,
    ] + (["--device", args.device] if args.device else []))
    run_dir = latest_run_dir(args.log_dir)
    summary = json.loads((Path(run_dir) / "summary.json").read_text())
    r_l = summary["l2hmc"]["tunneling_rate"]
    r_h = summary["hmc"]["tunneling_rate"]
    print(f"\ntunneling rate  L2HMC: {r_l:.4f}   HMC: {r_h:.4f}  "
          f"({r_l / max(r_h, 1e-4):.0f}x)")
    if not r_l > 5 * max(r_h, 1e-3):
        print("MISMATCH: the learned kernel should tunnel far more")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
