"""Seed-to-seed spread of the estimators that ``chip_smoke.py`` phase 11
gates, at its settings, to set and check its bounds.

For each seed: the SMC ladder of ``benchmarks/smc_u1.py`` (log Z and the
weighted plaquette; ``--move hmc`` by default), AIS on 8x8 from uniform
links to beta=2 (log Z) and ``tune_hmc``'s dual-averaging eps at K=5 on
``autotune_gauge.py``'s base config (128 chains after 1500 Metropolis
sweeps at beta=4).  Prints one JSON line: each quantity's values, mean,
sample standard deviation and the exact value it is gated against::

    python -m l2hmc_tpu_torch.benchmarks.ensemble_spread --device cpu --seeds 10
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def smc_once(seed, device, move):
    from l2hmc_tpu_torch.benchmarks.smc_u1 import build_parser, run

    args = build_parser().parse_args(["--seed", str(seed), "--move", move])
    args.device = device
    result, _ = run(args)
    return result["log_z"], result["plaq"]


def ais_once(seed, device):
    from l2hmc_tpu_torch.dynamics.ais import ais_log_weights, log_mean_exp
    from l2hmc_tpu_torch.lattice import u1
    from l2hmc_tpu_torch.ops.wilson import make_potential_fn

    shape = u1.LatticeShape(8, 8)
    pot = make_potential_fn(shape)
    gen = torch.Generator(device=device).manual_seed(seed)
    x0 = u1.random_links(gen, 1024, shape, device=device)
    logw = ais_log_weights(
        gen, x0, lambda y: torch.zeros(y.shape[0], device=y.device),
        lambda y: 2.0 * pot(y))
    return float(log_mean_exp(logw))


def da_once(seed, device):
    from l2hmc_tpu_torch.lattice import u1
    from l2hmc_tpu_torch.lattice.metropolis import thermalize
    from l2hmc_tpu_torch.train.autotune import _da_tune_eps, _hmc_cfg
    from l2hmc_tpu_torch.train.gauge import GaugeConfig

    base = GaugeConfig(time_size=16, space_size=16, num_chains=128,
                       network_arch="mlp", num_hidden=64, merge_v_halves=True,
                       eps_init=0.35 * (64.0 / 256) ** 0.25, beta_init=2.0,
                       beta_final=4.0)
    gen = torch.Generator(device=device).manual_seed(seed)
    x = u1.random_links(gen, 128, base.shape, device=device)
    x = thermalize(gen, x, base.shape, 4.0, 1500)
    return _da_tune_eps(_hmc_cfg(base, 5, base.eps_init), x, 4.0, gen, 300,
                        0.8)


def summary(values, exact):
    v = np.asarray(values, np.float64)
    return {"values": [round(float(x), 5) for x in v],
            "mean": float(v.mean()), "sd": float(v.std(ddof=1)),
            "exact": exact}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--seeds", type=int, default=10)
    p.add_argument("--move", default="hmc", choices=["hmc", "fused"])
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA device)")
    args = p.parse_args(argv)

    from l2hmc_tpu_torch._device import resolve_device
    from l2hmc_tpu_torch.dynamics.smc import u1_log_z_exact_factorized
    from l2hmc_tpu_torch.lattice import u1

    device = resolve_device(args.device)
    seeds = range(args.seeds)
    smc = [smc_once(s, device, args.move) for s in seeds]
    result = {
        "device": str(device),
        "smc_log_z": summary([a for a, _ in smc],
                             u1_log_z_exact_factorized(256, 1.0, 4.0)),
        "smc_plaq": summary([b for _, b in smc], u1.u1_plaq_exact(4.0)),
        "ais_log_z": summary([ais_once(s, device) for s in seeds],
                             u1_log_z_exact_factorized(64, 0.0, 2.0)),
        "da_eps_k5": summary([da_once(s, device) for s in seeds],
                             0.0822 / 0.85),
    }
    if device.type == "cuda":
        from l2hmc_tpu_torch.benchmarks import device_info

        result["card"] = device_info()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
